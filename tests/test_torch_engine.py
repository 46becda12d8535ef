"""The port's serving engine against the JAX reference engine on the
reduced smollm-135m (weights carried across by ``params_from_jax``):
greedy streams, block-pool replay, the host helpers and the sampler."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.serving import kv_cache as jax_kv
from repro.serving import sampler as jax_sampler
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.serving import kv_cache, sampler
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from repro_torch.weights import params_from_jax

SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")
# tests/test_kv_cache.py's trace
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11],
           [3, 1, 4, 1, 5, 9, 2, 6], [2, 7]]
MAX_NEW = 20


@pytest.fixture(scope="module")
def jax_setup():
    jcfg = jax_get_config("smollm-135m").reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jmodel = jax_build_model(jcfg, jplan)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams


@pytest.fixture(scope="module")
def setup(jax_setup):
    jmodel, jparams = jax_setup
    ref = JaxEngine(jmodel, jparams, slots=3, max_seq=64,
                    paged=False).generate(
        PROMPTS, max_new_tokens=MAX_NEW)
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    model = build_model(cfg, plan, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, plan,
                             "cpu")
    return model, params, ref


def _top2_margin(model, params, prompt, stream, at):
    """Top-2 logit margin of the port's model where ``stream`` has just
    produced its first ``at`` tokens (teacher-forced full forward)."""
    toks = torch.tensor([list(prompt) + list(stream[:at])])
    logits, _ = model.forward(params, toks, mode="train")
    top = logits[0, -1].topk(2).values
    return float(top[0] - top[1])


CONFIGS = {
    "dense": dict(paged=False),
    "paged16-stream": dict(paged=True, block_size=16, paged_kernel="stream"),
    "paged16-gather": dict(paged=True, block_size=16, paged_kernel="gather"),
    "preempt": dict(paged=True, block_size=8, num_blocks=5),
    "s4-window": dict(paged=True, block_size=16, steps_per_sync=4),
    "s4-no-pipeline": dict(paged=True, block_size=16, steps_per_sync=4,
                           pipeline=False),
    "host-sampling": dict(paged=True, block_size=16, sampling="host"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_streams_match_reference(setup, name):
    model, params, ref = setup
    eng = LPUEngine(model, params,
                    EngineConfig(slots=3, max_seq=64, **CONFIGS[name]),
                    device="cpu")
    got = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
    if name == "preempt":
        assert eng.stats.preemptions > 0
    eng.check_pool_balanced()
    for p, g, r in zip(PROMPTS, got, ref):
        if g != r:
            at = next(i for i, (a, b) in enumerate(zip(g, r)) if a != b)
            print(f"{name}: prompt {p} differs at token {at}; top-2 margin "
                  f"{_top2_margin(model, params, p, r, at)}")
    assert got == ref


def test_decode_launch_count_and_stats(setup):
    model, params, _ = setup
    eng = LPUEngine(model, params, EngineConfig(slots=3, max_seq=64,
                                                block_size=16), device="cpu")
    eng.generate(PROMPTS[:3], max_new_tokens=5)
    st = eng.stats
    # the first token of each stream comes from its prefill row
    assert st.tokens == 12 and st.device_decode_steps >= st.steps >= 4
    assert st.prefills == 3 and st.prefill_traces == 1
    assert 0 < st.peak_pool_blocks <= eng.num_blocks - 1
    assert eng.kv_bytes_moved_per_step() * 3 == LPUEngine(
        model, params, EngineConfig(slots=3, max_seq=64, block_size=16,
                                    paged_kernel="gather"),
        device="cpu").kv_bytes_moved_per_step()


@pytest.mark.parametrize("knob", [dict(prefill_chunk=16),
                                  dict(prefix_cache=True),
                                  dict(speculate="ngram"),
                                  dict(draft_k=2),
                                  dict(chaos="ring@3"),
                                  dict(max_migrations=1),
                                  dict(heartbeat_timeout_s=5.0),
                                  dict(ft_straggler_drain=True),
                                  dict(affinity="prefix"),
                                  dict(budget_ms=50.0),
                                  dict(max_pending=8),
                                  dict(kv_dtype="int8"),
                                  dict(kv_dtype="fp8")])
def test_later_slices_raise(setup, knob):
    model, params, _ = setup
    with pytest.raises(NotImplementedError):
        LPUEngine(model, params, EngineConfig(slots=2, max_seq=64, **knob),
                  device="cpu")


def test_w_dtype_int8_is_carried_and_decodes_with_fp_weights(jax_setup,
                                                             setup):
    """``w_dtype="int8"`` is carried as the reference carries it (the
    streamed-weight precision, for telemetry): the engine reports it and
    decodes with its fp weights, so its greedy streams equal the
    ``"auto"`` engine's and the reference engine's at ``"int8"``."""
    jmodel, jparams = jax_setup
    model, params, _ = setup
    streams = {}
    for w in ("auto", "int8"):
        eng = LPUEngine(model, params,
                        EngineConfig(slots=3, max_seq=64, block_size=16,
                                     w_dtype=w), device="cpu")
        assert eng.w_dtype == w
        streams[w] = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
    ref_eng = JaxEngine(jmodel, jparams, JaxEngineConfig(
        slots=3, max_seq=64, paged=False, w_dtype="int8"))
    assert ref_eng.w_dtype == "int8"
    ref = ref_eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
    assert streams["int8"] == streams["auto"] == ref


def test_mesh_raises(setup):
    model, params, _ = setup
    with pytest.raises(NotImplementedError):
        LPUEngine(model, params, EngineConfig(slots=2, max_seq=64),
                  mesh=object(), device="cpu")


def test_fp_kv_dtype_and_legacy_kwargs(setup):
    """A bfloat16 pool serves (plain path); the knobs go through
    ``EngineConfig`` only: loose kwargs are refused."""
    model, params, _ = setup
    with pytest.raises(TypeError):
        LPUEngine(model, params, device="cpu", slots=2, max_seq=64)
    eng = LPUEngine(model, params, EngineConfig(slots=2, max_seq=64,
                                                block_size=16,
                                                kv_dtype="bfloat16"),
                    device="cpu")
    out = eng.generate(PROMPTS[:2], max_new_tokens=4)
    assert eng.cache["l0"]["k"].dtype == torch.bfloat16
    assert [len(o) for o in out] == [4, 4]


def test_oversized_request_rejected_not_raised(setup):
    model, params, _ = setup
    eng = LPUEngine(model, params, EngineConfig(slots=2, max_seq=64,
                                                block_size=8, num_blocks=3),
                    device="cpu")
    with pytest.raises(ValueError):
        eng.submit(list(range(1, 30)), max_new_tokens=4)
    with pytest.raises(RuntimeError):
        eng.generate([[1, 2, 3]], max_new_tokens=30)


# ---------------------------------------------------------------------------
# host side: pool replay, buckets, budgets
# ---------------------------------------------------------------------------

def test_block_pool_replay_matches_reference():
    """One random alloc/free sequence on both copies of the pool: same
    block ids, refcounts, free counts, and the same refusals."""
    r = np.random.default_rng(0)
    pools = [kv_cache.BlockPool(12, 4), jax_kv.BlockPool(12, 4)]
    live = [[], []]
    for _ in range(300):
        op = int(r.integers(0, 3))
        n = int(r.integers(1, 5))
        pick = int(r.integers(1 << 30))
        res = []
        for k, pool in enumerate(pools):
            if op == 0:
                got = pool.alloc(n)
                if got:
                    live[k].append(got)
                res.append(got)
            elif op == 1 and live[k]:
                blocks = live[k].pop(pick % len(live[k]))
                pool.free(blocks)
                res.append(blocks)
            else:
                res.append(pool.num_free)
        assert res[0] == res[1]
        assert pools[0].ref == pools[1].ref
        assert pools[0].num_free == pools[1].num_free
    for k in range(2):
        for blocks in live[k]:
            pools[k].free(blocks)
    kv_cache.assert_pool_balanced(pools[0])
    jax_kv.assert_pool_balanced(pools[1])
    with pytest.raises(ValueError):
        pools[0].free([3])                          # double free


@pytest.mark.parametrize("n", [1, 3, 16, 17, 40, 64])
def test_host_helpers_match_reference(n):
    assert kv_cache.bucket_for(n, 64) == jax_kv.bucket_for(n, 64)
    assert kv_cache.bucket_for(n, 64, 8) == jax_kv.bucket_for(n, 64, 8)
    assert kv_cache.blocks_for(n, 16) == jax_kv.blocks_for(n, 16)
    b = kv_cache.per_rank_block_bytes(30, 3, 64, n, 4, 0)
    assert b == jax_kv.per_rank_block_bytes(30, 3, 64, n, 4, 0)
    assert kv_cache.pool_blocks_for_budget(1 << 24, b) == \
        jax_kv.pool_blocks_for_budget(1 << 24, b)


def test_cache_bytes_matches_reference(setup):
    model, _, _ = setup
    cache = model.init_cache(3, 64, paged=True, num_blocks=9, block_size=8)
    jcache = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                          {"l0": {k: v.numpy() for k, v in
                                  cache["l0"].items()}})
    assert kv_cache.cache_bytes(cache) == jax_kv.cache_bytes(jcache)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

def test_greedy_sampling_matches_reference():
    logits = np.random.default_rng(1).standard_normal((6, 300)) \
        .astype(np.float32)
    temps = np.array([0, 0, 0.7, 0, 1.0, 0], np.float32)
    ks = np.array([0, 5, 3, 0, 0, 1], np.int32)
    ps = np.array([1, 0.9, 0.8, 1, 0.5, 1], np.float32)
    g = torch.Generator().manual_seed(0)
    mine = sampler.sample_batched(
        torch.from_numpy(logits), g, torch.from_numpy(temps),
        torch.from_numpy(ks), torch.from_numpy(ps)).numpy()
    ref, _ = jax_sampler.sample_batched(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temps),
        jnp.asarray(ks), jnp.asarray(ps))
    greedy = temps <= 0
    np.testing.assert_array_equal(mine[greedy], np.asarray(ref)[greedy])
    before = g.get_state()
    sampler.sample_batched(torch.from_numpy(logits), g,
                           torch.zeros(6), torch.from_numpy(ks),
                           torch.from_numpy(ps), stochastic=False)
    assert torch.equal(before, g.get_state())      # greedy draws nothing
    assert (sampler.sample_local(
        torch.from_numpy(logits), g, sampler.SamplingParams(0.0)).numpy()
        == logits.argmax(-1)).all()


PARAM_SETS = [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.85), (1.0, 5, 0.85),
              (0.5, 3, 0.6)]


@pytest.mark.parametrize("temp,top_k,top_p", PARAM_SETS)
def test_filter_matches_reference(temp, top_k, top_p):
    rows = np.random.default_rng(2).standard_normal((4, 8)).astype(
        np.float32) * 2
    mine = sampler.filter_rows(
        torch.from_numpy(rows), torch.full((4,), temp),
        torch.full((4,), top_k, dtype=torch.int32),
        torch.full((4,), top_p)).numpy()
    ref = np.stack([np.asarray(jax_sampler._filter_row(
        jnp.asarray(r), jnp.float32(temp), jnp.int32(top_k),
        jnp.float32(top_p))) for r in rows])
    np.testing.assert_array_equal(np.isinf(mine), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(mine[fin], ref[fin], rtol=1e-6)


def _tv(counts_a, counts_b, n_a, n_b):
    keys = set(counts_a) | set(counts_b)
    return 0.5 * sum(abs(counts_a.get(k, 0) / n_a
                         - counts_b.get(k, 0) / n_b) for k in keys)


@pytest.mark.parametrize("temp,top_k,top_p", PARAM_SETS)
def test_stochastic_sampling_matches_target_distribution(temp, top_k,
                                                         top_p):
    """20k draws of the port's sampler against the reference's filtered
    target distribution softmax(_filter_row(row)): TV distance < 0.02."""
    V, n = 8, 20000
    row = np.random.default_rng(3).standard_normal(V).astype(np.float32) * 2
    p = np.asarray(jax.nn.softmax(jax_sampler._filter_row(
        jnp.asarray(row), jnp.float32(temp), jnp.int32(top_k),
        jnp.float32(top_p))))
    g = torch.Generator().manual_seed(4)
    toks = sampler.sample_batched(
        torch.from_numpy(np.repeat(row[None], n, 0)), g,
        torch.full((n,), temp), torch.full((n,), top_k, dtype=torch.int32),
        torch.full((n,), top_p)).numpy()
    counts = collections.Counter(int(t) for t in toks)
    target = {i: float(p[i]) * n for i in range(V) if p[i] > 0}
    assert set(counts) <= set(target)
    assert _tv(counts, target, n, n) < 0.02
