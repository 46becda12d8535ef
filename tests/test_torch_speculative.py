"""The port's speculative decoding against the JAX reference on the
reduced smollm-135m (f32, weights carried across by ``params_from_jax``):
the drafters, greedy parity across ``draft_k``, the paged dataflows, the
sampling paths, chunked prefill, the prefix cache, preemption and the
int8 pool; ``reserve_lookahead`` counting the drafts; all-accept windows
across a block boundary; rollback that leaks nothing; and the
accept/resample rule's exact marginals, tested on the port with inputs
that can show them (the reference's own gate draws a draft of zero mass,
and its preemption case does not preempt with speculation on)."""
import math
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.serving import drafter as jax_drafter
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.drafter import (ModelDrafter, NGramDrafter,
                                         make_drafter)
from repro_torch.serving.engine import LPUEngine, Request
from repro_torch.serving.kv_cache import BlockPool
from repro_torch.serving.sampler import (SamplingParams, filter_rows,
                                         spec_verify_rows,
                                         speculative_verify_batched)
from repro_torch.serving.scheduler import Scheduler
from repro_torch.weights import params_from_jax
from tests.torch_dense_util import one_torch_thread  # noqa: F401

SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")
VOCAB = 512     # smollm reduced()


def _prompts(seed, ns):
    """tests/test_speculative.py's seeded prompts (seeds picked there for
    robust greedy top-2 margins)."""
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, VOCAB, size=n))) for n in ns]


def _shared_prompts(seed, sys_len, tails):
    """A shared system prompt + random tails, the last request the bare
    prompt itself (a tail written into a shared block: copy-on-write)."""
    rng = np.random.RandomState(seed)
    sysp = list(map(int, rng.randint(1, VOCAB, size=sys_len)))
    return [sysp + list(map(int, rng.randint(1, VOCAB, size=n)))
            for n in tails] + [list(sysp)]


PROMPTS = _prompts(7, (12, 9, 20))


@pytest.fixture(scope="module")
def jax_setup():
    jcfg = jax_get_config("smollm-135m").reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jmodel = jax_build_model(jcfg, jplan)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams


@pytest.fixture(scope="module")
def setup(jax_setup):
    _, jparams = jax_setup
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    model = build_model(cfg, plan, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, plan,
                             "cpu")
    return model, params


def _engine(setup, drafter=None, **kw):
    model, params = setup
    return LPUEngine(model, params, EngineConfig(**kw), device="cpu",
                     drafter=drafter)


class OracleDrafter:
    """Proposes the reference continuation: every draft is accepted."""

    def __init__(self, prompts, outs):
        self.ref = {tuple(p): o for p, o in zip(prompts, outs)}

    def propose(self, tokens, k):
        for p, out in self.ref.items():
            if len(p) <= len(tokens) and tuple(tokens[:len(p)]) == p:
                done = len(tokens) - len(p)
                return list(out[done:done + k])
        return []


class AdversarialDrafter:
    """Proposes tokens the model (almost) never emits: rejection-heavy
    windows, so rollback runs constantly."""

    def propose(self, tokens, k):
        return [(int(tokens[-1]) + 101 + 17 * i) % VOCAB for i in range(k)]


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

def test_ngram_drafter_suffix_match():
    d = NGramDrafter()
    assert d.propose([1, 2, 3, 1, 2, 3, 1, 2], 4) == [3, 1, 2, 3]
    assert d.propose([4, 4, 4, 4], 3) == [4, 4, 4]
    assert d.propose([1, 2, 3, 4, 5], 4) == []
    assert d.propose([7], 4) == []
    assert d.propose([], 4) == []
    with pytest.raises(ValueError):
        NGramDrafter(max_n=1, min_n=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_drafter_matches_reference(seed):
    """Seeded streams over a small alphabet (many repeats): the same
    proposals as the reference's drafter, for n-gram orders 1..3."""
    rng = np.random.RandomState(seed)
    for n in (5, 17, 40):
        toks = list(map(int, rng.randint(0, 6, size=n)))
        for max_n, k in ((3, 4), (2, 2), (1, 5)):
            assert NGramDrafter(max_n).propose(toks, k) == \
                jax_drafter.NGramDrafter(max_n).propose(toks, k)


def test_make_drafter_validation(setup):
    model, params = setup
    assert make_drafter("off") is None
    assert isinstance(make_drafter("ngram"), NGramDrafter)
    assert isinstance(make_drafter("model", draft_model=model,
                                   draft_params=params), ModelDrafter)
    with pytest.raises(ValueError):
        make_drafter("model")           # needs draft_model/draft_params
    with pytest.raises(ValueError):
        make_drafter("banana")


def test_model_drafter_matches_reference(jax_setup, setup):
    """The port's model drafter (bucketed prefill forwards) proposes the
    reference drafter's greedy continuation with the same weights."""
    jmodel, jparams = jax_setup
    model, params = setup
    mine = ModelDrafter(model, params, max_seq=64)
    ref = jax_drafter.ModelDrafter(jmodel, jparams, max_seq=64)
    for ctx in PROMPTS:
        assert mine.propose(ctx, 4) == ref.propose(ctx, 4)
    assert mine.propose(list(range(1, 63)), 4) == ref.propose(
        list(range(1, 63)), 4)          # capped at max_seq


# ---------------------------------------------------------------------------
# greedy parity across the engine axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft_k", [1, 2, 4])
def test_greedy_parity_draft_k(jax_setup, setup, draft_k):
    """Speculative streams equal the plain engine's and the reference's
    speculative engine's at each draft length."""
    jmodel, jparams = jax_setup
    kw = dict(slots=2, max_seq=64)
    plain = _engine(setup, **kw).generate(PROMPTS, max_new_tokens=12)
    eng = _engine(setup, speculate="ngram", draft_k=draft_k, **kw)
    got = eng.generate(PROMPTS, max_new_tokens=12)
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(
        speculate="ngram", draft_k=draft_k, **kw)).generate(
            PROMPTS, max_new_tokens=12)
    assert got == plain == ref
    assert eng.stats.spec_rounds > 0 and eng.stats.draft_tokens > 0
    eng.check_pool_balanced()


@pytest.mark.parametrize("sampling", ["fused", "host"])
@pytest.mark.parametrize("kernel", ["stream", "gather"])
def test_greedy_parity_kernel_and_sampling(setup, kernel, sampling):
    """Verify through kernel 1's plain version (stream) and the gather
    oracle, with fused and host-read verify rows."""
    kw = dict(slots=2, max_seq=64, block_size=16, paged_kernel=kernel,
              sampling=sampling)
    plain = _engine(setup, **kw).generate(PROMPTS, max_new_tokens=10)
    eng = _engine(setup, speculate="ngram", draft_k=4, **kw)
    assert eng.generate(PROMPTS, max_new_tokens=10) == plain
    assert eng.stats.spec_rounds > 0
    eng.check_pool_balanced()


def test_fused_verify_reads_back_token_vectors_only(setup):
    """With fused sampling a verify round reads back (out, n_acc), int32
    vectors of slots*(K+1) and slots entries; the host oracle reads the
    verify rows.  Each round is one host sync either way."""
    kw = dict(slots=2, max_seq=64, block_size=16)
    eng = _engine(setup, drafter=AdversarialDrafter(), draft_k=3, **kw)
    eng.generate(PROMPTS[:2], max_new_tokens=6)
    st = eng.stats
    assert st.spec_rounds > 0
    # prefill syncs (4 B each) + one (slots*(K+1) + slots) * 4 B per round
    # (every round speculates: the adversary always proposes)
    assert st.host_syncs == st.prefill_syncs + st.spec_rounds
    assert st.bytes_to_host == 4 * st.prefill_syncs \
        + st.spec_rounds * 4 * (2 * 4 + 2)
    host = _engine(setup, drafter=AdversarialDrafter(), draft_k=3,
                   sampling="host", **kw)
    host.generate(PROMPTS[:2], max_new_tokens=6)
    assert host.stats.bytes_to_host > 100 * st.bytes_to_host


def test_greedy_parity_chunked_prefill(jax_setup, setup):
    jmodel, jparams = jax_setup
    prompts = _prompts(11, (7, 5, 39))
    kw = dict(slots=2, max_seq=64, block_size=16)
    plain = _engine(setup, **kw).generate(prompts, max_new_tokens=10)
    eng = _engine(setup, prefill_chunk=8, speculate="ngram", draft_k=4, **kw)
    got = eng.generate(prompts, max_new_tokens=10)
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(
        prefill_chunk=8, speculate="ngram", draft_k=4, **kw)).generate(
            prompts, max_new_tokens=10)
    assert got == plain == ref
    assert eng.stats.prefill_chunks > 0 and eng.stats.spec_rounds > 0
    eng.check_pool_balanced()


def test_greedy_parity_prefix_cache(jax_setup, setup):
    jmodel, jparams = jax_setup
    prompts = _shared_prompts(3, 32, (6, 9, 3))
    kw = dict(slots=2, max_seq=64, block_size=16, prefix_cache=True)
    plain = _engine(setup, **kw).generate(prompts, max_new_tokens=10)
    eng = _engine(setup, speculate="ngram", draft_k=4, **kw)
    got = eng.generate(prompts, max_new_tokens=10)
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(
        speculate="ngram", draft_k=4, **kw)).generate(
            prompts, max_new_tokens=10)
    assert got == plain == ref
    assert eng.stats.prefix_hit_blocks > 0
    eng.check_pool_balanced()


def test_greedy_parity_mid_stream_preemption(jax_setup, setup):
    """A pool of 9 blocks of 8 preempts mid-decode with speculation on
    and off (the reference's case, 7 blocks of 16, preempts only the
    plain run): both runs preempt and their streams are equal, and equal
    the reference's speculative engine's under the same pool."""
    jmodel, jparams = jax_setup
    kw = dict(slots=3, max_seq=64, block_size=8, num_blocks=9)
    plain_eng = _engine(setup, **kw)
    plain = plain_eng.generate(PROMPTS, max_new_tokens=16)
    eng = _engine(setup, speculate="ngram", draft_k=4, **kw)
    got = eng.generate(PROMPTS, max_new_tokens=16)
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(
        speculate="ngram", draft_k=4, **kw)).generate(
            PROMPTS, max_new_tokens=16)
    assert plain_eng.stats.preemptions > 0 and eng.stats.preemptions > 0
    assert got == plain == ref
    eng.check_pool_balanced()


def test_greedy_parity_model_drafter(setup):
    """``speculate="model"`` with a draft model (the same reduced model,
    other weights): streams equal the plain run's."""
    model, params = setup
    kw = dict(slots=2, max_seq=64, block_size=16)
    plain = _engine(setup, **kw).generate(PROMPTS, max_new_tokens=8)
    eng = LPUEngine(model, params, EngineConfig(speculate="model",
                                                draft_k=2, **kw),
                    device="cpu", draft_model=model,
                    draft_params=model.init(seed=1))
    assert eng.speculate == "model"
    assert eng.generate(PROMPTS, max_new_tokens=8) == plain
    assert eng.stats.spec_rounds > 0 and eng.stats.draft_tokens > 0


def test_model_drafter_needs_the_target_vocabulary(setup):
    """A draft model over another vocabulary cannot read the target's
    tokens (on the card its embedding lookup would fault): refused."""
    from dataclasses import replace
    model, params = setup
    dcfg = replace(model.cfg, vocab_size=256)
    dmodel = build_model(dcfg, plan_model(dcfg, None, (1,), "serve",
                                          **SERVE_F32), "cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        LPUEngine(model, params, EngineConfig(speculate="model"),
                  device="cpu", draft_model=dmodel,
                  draft_params=dmodel.init(seed=1))


def test_int8_pool_speculative_parity(setup):
    """Rejection sampling stays exact on the int8 pool: draft, verify and
    rollback read and write the same stored (code, scale) pairs, so
    speculative streams equal the plain int8 run's."""
    motif = [3, 1, 4, 1]
    prompts = [motif * 6, motif * 5]
    kw = dict(slots=2, max_seq=128, block_size=16, kv_dtype="int8")
    plain = _engine(setup, **kw).generate(prompts, max_new_tokens=12)
    eng = _engine(setup, speculate="ngram", draft_k=4, **kw)
    assert eng.generate(prompts, max_new_tokens=12) == plain
    assert eng.stats.accepted_tokens > 0
    eng.check_pool_balanced()


# ---------------------------------------------------------------------------
# lookahead: the window's extra rows are reserved
# ---------------------------------------------------------------------------

def test_reserve_lookahead_accounts_draft_k():
    """The verify window writes KV at pos .. pos + K before the host
    knows what was accepted: the reservation covers the K extra rows,
    all or nothing."""
    pool = BlockPool(8, 8)
    sched = Scheduler(2, 64, pool)
    sched.submit(Request(0, [1] * 6, 8))
    seq = sched.admit_next()
    assert seq.pos == 6 and len(seq.blocks) == 1
    assert sched.reserve_lookahead(1)            # pos 6 fits block 1
    assert len(seq.blocks) == 1
    assert sched.reserve_lookahead(1, draft_k=3)  # rows up to pos 9
    assert len(seq.blocks) == 2
    before = pool.num_free
    assert not sched.reserve_lookahead(1, draft_k=63)
    assert pool.num_free == before and len(seq.blocks) == 2


def test_all_accept_window_crosses_block_boundary(setup):
    """The oracle drafter on prompts one token short of a block boundary:
    every window is accepted whole and its last rows land past the
    boundary, in reserved blocks (a row lost to the null block would
    break parity)."""
    prompts = _prompts(3, (15, 31))
    kw = dict(slots=2, max_seq=64, block_size=16)
    plain = _engine(setup, **kw).generate(prompts, max_new_tokens=12)
    eng = _engine(setup, drafter=OracleDrafter(prompts, plain), draft_k=4,
                  **kw)
    assert eng.speculate == "custom"
    assert eng.generate(prompts, max_new_tokens=12) == plain
    st = eng.stats
    assert st.acceptance_rate == 1.0
    assert st.spec_rounds <= math.ceil(12 / 5) + 2
    assert st.accepted_per_window > 1.0
    eng.check_pool_balanced()


# ---------------------------------------------------------------------------
# rollback: rejection-heavy windows leak nothing
# ---------------------------------------------------------------------------

def test_rollback_leak_accounting(setup):
    kw = dict(slots=2, max_seq=64, block_size=16)
    plain = _engine(setup, **kw).generate(PROMPTS, max_new_tokens=12)
    eng = _engine(setup, drafter=AdversarialDrafter(), draft_k=4, **kw)
    assert eng.generate(PROMPTS, max_new_tokens=12) == plain
    st = eng.stats
    assert st.draft_tokens > 0 and st.acceptance_rate < 1.0
    pool = eng.sched.pool
    assert all(r == 0 for r in pool.ref[1:])
    assert pool.num_free == pool.num_blocks - 1
    eng.check_pool_balanced()


def test_rollback_prefix_index_and_cow_intact(setup):
    """Rejection-heavy speculation over copy-on-write-shared blocks: a
    rejected row never lands in a block another table or the index
    references, and after the drain the index, refcounts and free list
    equal the plain run's."""
    prompts = _shared_prompts(3, 32, (6, 9, 3))
    kw = dict(slots=2, max_seq=64, block_size=16, prefix_cache=True)

    def snapshot(eng):
        pool, idx = eng.sched.pool, eng.prefix
        return (set(idx._by_hash), sorted(pool.ref), pool.num_free)

    plain_eng = _engine(setup, **kw)
    plain = plain_eng.generate(prompts, max_new_tokens=10)
    eng = _engine(setup, drafter=AdversarialDrafter(), draft_k=4, **kw)
    assert eng.generate(prompts, max_new_tokens=10) == plain
    assert eng.stats.acceptance_rate < 1.0
    assert eng.stats.cow_blocks > 0
    assert snapshot(eng) == snapshot(plain_eng)
    eng.check_pool_balanced()


# ---------------------------------------------------------------------------
# the accept/resample rule: exact marginals
# ---------------------------------------------------------------------------

V, K = 8, 2
TEMP, TOP_K, TOP_P = 1.0, 5, 0.85


def _target(rows):
    """softmax of the filtered rows: the distribution each position must
    emit from."""
    n = rows.shape[0]
    lg = filter_rows(rows, torch.full((n,), TEMP),
                     torch.full((n,), TOP_K, dtype=torch.int32),
                     torch.full((n,), TOP_P))
    return torch.softmax(lg, -1)


def _marginal_case():
    rows = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (K + 1, V)).astype(np.float32) * 2.0)
    p = _target(rows)
    # drafts from tokens that keep mass after the filter: the second
    # most likely at position 0, the most likely at position 1
    draft = torch.stack([p[0].argsort(descending=True)[1], p[1].argmax()])
    return rows, p, draft


def _draws(rows, draft, n, seed):
    g = torch.Generator().manual_seed(seed)
    return speculative_verify_batched(
        rows.expand(n, K + 1, V), draft.expand(n, K), g,
        torch.full((n,), TEMP), torch.full((n,), TOP_K, dtype=torch.int32),
        torch.full((n,), TOP_P))


def test_rejection_sampling_exact_marginals():
    """With a one-hot proposal, P(out_i = x) must equal the filtered
    target p_i(x) at every position: N = 20000 windows, TV distance at
    position 0 and (given draft 0 accepted) at position 1, and the
    accept rate at position 0 within 5 sigma of p_0(draft_0)."""
    rows, p, draft = _marginal_case()
    assert (p[0, draft[0]] > 0.05) and (p[1, draft[1]] > 0.05)
    N = 20000
    out, n_acc = _draws(rows, draft, N, seed=3)
    out, n_acc, p = out.numpy(), n_acc.numpy(), p.numpy().astype(np.float64)
    freq0 = np.bincount(out[:, 0], minlength=V) / N
    assert 0.5 * np.abs(freq0 - p[0]).sum() < 0.02, (freq0, p[0])
    p_d0 = p[0, int(draft[0])]
    acc0 = (n_acc >= 1).mean()
    sigma = math.sqrt(p_d0 * (1 - p_d0) / N)
    assert abs(acc0 - p_d0) < 5 * sigma, (acc0, p_d0)
    # the masked resample never re-emits the rejected draft
    assert (out[n_acc == 0, 0] != int(draft[0])).all()
    sel = out[n_acc >= 1]
    freq1 = np.bincount(sel[:, 1], minlength=V) / len(sel)
    assert 0.5 * np.abs(freq1 - p[1]).sum() < 0.03, (freq1, p[1])
    # the bonus row after two accepts draws from p_2
    both = out[n_acc >= 2]
    freq2 = np.bincount(both[:, 2], minlength=V) / len(both)
    assert 0.5 * np.abs(freq2 - p[2]).sum() < 0.05, (freq2, p[2])
    assert (freq0[p[0] == 0] == 0).all()


def test_zero_mass_draft_is_never_accepted():
    """A draft the filter gives no mass (outside top-k / top-p) is
    always rejected, and the window emits from p_0 all the same."""
    rows, p, _ = _marginal_case()
    dead = int((p[0] == 0).nonzero()[0])
    draft = torch.tensor([dead, int(p[1].argmax())])
    out, n_acc = _draws(rows, draft, 4000, seed=4)
    assert (n_acc == 0).all()
    assert (out[:, 0] != dead).all()
    freq0 = np.bincount(out[:, 0].numpy(), minlength=V) / 4000
    assert 0.5 * np.abs(freq0 - p[0].numpy()).sum() < 0.05


def test_greedy_verify_is_argmax_run():
    """temperature 0: out is the argmax of each row and n_acc the leading
    run of drafts equal to it; no random numbers are drawn."""
    rows = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, V)).astype(np.float32))
    am = rows.argmax(-1)
    draft = torch.tensor([int(am[0]), int(am[1]), (int(am[2]) + 1) % V])
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    out, n_acc = spec_verify_rows(rows, draft, g, SamplingParams(0.0, 0,
                                                                 1.0))
    assert out.tolist() == am.tolist() and n_acc == 2
    assert torch.equal(g.get_state(), state)
    # the batched form: a greedy slot beside a stochastic one
    out2, n2 = speculative_verify_batched(
        torch.stack([rows, rows]), torch.stack([draft, draft]), g,
        torch.tensor([0.0, 1.0]), torch.tensor([0, 0], dtype=torch.int32),
        torch.tensor([1.0, 1.0]))
    assert out2[0].tolist() == am.tolist() and int(n2[0]) == 2


def test_engine_stochastic_distribution_matches_nonspec(setup):
    """Outcome frequencies of 2-token stochastic generations (temperature
    1, top-k 2) from the speculative engine match the plain engine's
    within TV 0.15.  The drafter proposes the greedy continuation, so it
    fires every round with drafts inside the top-2: both the accept and
    the masked-resample paths run."""
    prompt = [7, 391, 44, 208] * 3
    sp = SamplingParams(1.0, 2, 1.0)
    n = 220
    kw = dict(slots=1, max_seq=32, block_size=16)
    greedy = _engine(setup, **kw).generate([prompt], max_new_tokens=2)[0]

    def collect(drafter=None, **extra):
        model, params = setup
        eng = LPUEngine(model, params, EngineConfig(**kw, **extra),
                        device="cpu", seed=123, drafter=drafter)
        counts = Counter()
        for _ in range(n):
            counts[tuple(eng.generate([prompt], max_new_tokens=2,
                                      params=sp)[0])] += 1
        return counts, eng.stats

    base, _ = collect()
    spec, st = collect(OracleDrafter([prompt], [greedy * 3]), draft_k=2)
    assert st.spec_rounds > 0 and st.accepted_tokens > 0
    assert st.accepted_tokens < st.draft_tokens
    tv = 0.5 * sum(abs(base[k] - spec[k]) / n for k in set(base) | set(spec))
    assert tv < 0.15, (tv, dict(base), dict(spec))
