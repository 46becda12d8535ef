"""Speculative decoding on the model ring: gloo ranks on the CPU, each a
spawned process with its shards and its pool
(tests/torch_tp_spec_util.py), held to the reference at tp=1.

* The reference's own case (``tests/test_speculative.py``
  ``test_ring_speculative_matches_dense_tp1``: reduced smollm-135m,
  prompts of 7, 5 and 12 tokens from ``RandomState(11)``, 2 slots,
  max_seq 64, blocks of 16, the n-gram drafter at ``draft_k`` 4, 10 new
  tokens): the port's ring engine at tp 2 (ESL overlap and blocking)
  and tp 4 gives the reference's tp=1 engine's greedy streams, with
  verify rounds run.
* The same under a pool that preempts (both rings preempt), with a
  shared prefix in chunks of 8, with the model drafter (every rank
  proposes the same drafts) and with host sampling (the verify rows
  gathered whole; equal to the fused round); every rank proposes and
  accepts alike.
* ``speculative_verify_sharded``: greedy equal to the reference's
  ``speculative_verify_sharded`` on the same columns and to its tp=1
  ``speculative_verify_batched`` on the whole rows (ties across and
  inside ranks, drafts outside the candidates); stochastic identical on
  every rank, its first position's marginal within TV 0.03 of the
  reference's filtered distribution over the candidate set and its
  acceptance rate within 0.02 of the draft's mass there, over 20000
  windows.

Cost in one process ~45 s: two spawns of ranks (2 and 4, one torch
thread each) and the reference's tp=1 engine.
"""
import jax
import numpy as np
import pytest
import torch

from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro.serving.sampler import MAX_LOCAL_K, _filter_row
from repro.serving.sampler import \
    speculative_verify_batched as jax_verify_batched
from repro.serving.sampler import \
    speculative_verify_sharded as jax_verify_sharded
from repro_torch.core.dist import run_ranks
from tests.torch_dense_util import (one_torch_thread,  # noqa: F401
                                    reduced_pair, reference_compile_cache)
from tests.torch_tp_spec_util import counts, spec_rank

NAME = "smollm-135m"
VOCAB = 512
SPEC = dict(speculate="ngram", draft_k=4)
REF_CASE = dict(slots=2, max_seq=64, block_size=16)


def _prompts(seed, ns):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, VOCAB, size=n))) for n in ns]


def _shared_prompts():
    """A 20-token system prompt ahead of each tail: later requests hit
    its first block of 16."""
    rng = np.random.RandomState(3)
    sysp = list(map(int, rng.randint(1, VOCAB, size=20)))
    return [sysp + list(map(int, rng.randint(1, VOCAB, size=n)))
            for n in (6, 9, 3, 11)]


PROMPTS = {"ref": _prompts(11, (7, 5, 12)),
           "preempt": _prompts(7, (12, 9, 20)),
           "shared": _shared_prompts()}
# key: (engine config, prompts, new tokens)
SCENARIOS = {
    "ngram": (dict(REF_CASE, **SPEC), "ref", 10),
    "preempt": (dict(slots=3, max_seq=64, block_size=8, num_blocks=9,
                     **SPEC), "preempt", 16),
    "prefix_chunks": (dict(REF_CASE, prefill_chunk=8, prefix_cache=True,
                           **SPEC), "shared", 10),
    "model": (dict(REF_CASE, speculate="model", draft_k=4), "ref", 10),
    "host": (dict(REF_CASE, sampling="host", **SPEC), "ref", 10),
}
# the rings' runs: (tp, ESL overlap) -> scenarios
RUNS = {(2, True): list(SCENARIOS), (2, False): ["ngram", "preempt"],
        (4, True): ["ngram", "preempt", "host"]}


def _verify_cases():
    """Greedy and stochastic verify windows over (B, K+1, V) rows:
    greedy with ties across ranks and inside one rank's columns and
    drafts outside every rank's top-64; one stochastic row repeated
    over 20000 slots."""
    rng = np.random.default_rng(5)
    B, K, V = 6, 4, 384
    lg = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    lg[0, 0, [10, V // 2 + 3]] = 9.0         # a tie across ranks
    lg[2, 1, [7, 5]] = 9.0                   # ties inside rank 0
    lg[3, 2, [V - 5, V - 40]] = 9.0          # and inside the last rank
    draft = rng.integers(0, V, size=(B, K)).astype(np.int32)
    draft[1] = lg[1, :K].argmax(-1)          # accepted whole
    greedy = dict(logits=lg, draft=draft,
                  temps=np.zeros(B, np.float32),
                  top_ks=np.zeros(B, np.int32),
                  top_ps=np.ones(B, np.float32), seed=0, stochastic=False,
                  repeat=1)
    row = (2.0 * rng.standard_normal((1, K + 1, V))).astype(np.float32)
    d = np.argsort(-row[0, 0])[[1, 3, 0, 2]].astype(np.int32)
    stoch = dict(logits=row, draft=d[None],
                 temps=np.full(1, 0.9, np.float32),
                 top_ks=np.full(1, 8, np.int32),
                 top_ps=np.full(1, 0.95, np.float32), seed=3,
                 stochastic=True, repeat=20000)
    return [greedy, stoch]


@pytest.fixture(scope="module")
def tree():
    (_, _, jmodel, jparams), _ = reduced_pair(NAME)
    return jmodel, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def reference(tree):
    """{prompt set: the reference's tp=1 greedy streams} (16 new
    tokens, cut to each scenario's)."""
    jmodel, jparams, _ = tree
    eng = JaxEngine(jmodel, jparams, JaxEngineConfig(slots=3, max_seq=64,
                                                     paged=False))
    return {k: eng.generate(p, max_new_tokens=16)
            for k, p in PROMPTS.items()}


@pytest.fixture(scope="module")
def rings(tree):
    """{tp: every rank's results}: the served scenarios of RUNS and the
    sharded verify cases."""
    out = {}
    for tp in (2, 4):
        tasks = {}
        for (t, overlap), keys in RUNS.items():
            if t != tp:
                continue
            tasks[overlap] = ("serve_spec", dict(
                name=NAME, tree=tree[2], overlap=overlap, scenarios=[
                    dict(key=k, conf=SCENARIOS[k][0],
                         prompts=PROMPTS[SCENARIOS[k][1]],
                         max_new=SCENARIOS[k][2]) for k in keys]))
        tasks["verify"] = ("verify_sharded", dict(cases=_verify_cases()))
        out[tp] = run_ranks(spec_rank, tp, tasks, device="cpu", threads=1)
    return out


CASES = [(tp, ov, k) for (tp, ov), keys in RUNS.items() for k in keys]


@pytest.mark.parametrize("tp,overlap,key", CASES)
def test_ring_streams_equal_reference_tp1(rings, reference, tp, overlap,
                                          key):
    """Greedy streams of the ring's speculative engine equal the
    reference's tp=1 engine's, on every rank alike, with verify rounds
    run, the same drafts proposed and accepted on every rank."""
    per_rank = rings[tp][overlap]
    conf, pset, new = SCENARIOS[key]
    want = [s[:new] for s in reference[pset]]
    for r in per_rank:
        streams, st = r[key]
        assert streams == want, (tp, overlap, key, streams, want)
    st = [r[key][1] for r in per_rank]
    assert st[0]["spec_rounds"] > 0 and st[0]["draft_tokens"] > 0
    for s in st[1:]:
        for k in ("spec_rounds", "draft_tokens", "accepted_tokens",
                  "proposals", "preemptions", "prefix_hits",
                  "prefill_chunks", "device_decode_steps"):
            assert s[k] == st[0][k], (key, k)
    if key == "preempt":
        assert st[0]["preemptions"] > 0
    if key == "prefix_chunks":
        assert st[0]["prefix_hits"] > 0 and st[0]["prefill_chunks"] > 0


def test_host_round_equals_fused_round(rings):
    """The host-sampled verify round (the rows gathered whole on every
    rank, the oracle run on them) gives the fused round's streams, with
    verify rounds run and at least one host sync a round (its plain
    rounds are host decode steps, so its rounds fall at other steps)."""
    for tp, ov in ((2, True), (4, True)):
        fused, host = rings[tp][ov][0]["ngram"], rings[tp][ov][0]["host"]
        assert host[0] == fused[0]
        assert host[1]["spec_rounds"] > 0
        assert host[1]["host_syncs"] >= host[1]["spec_rounds"]


def test_model_drafter_proposes_alike_on_every_rank(rings):
    """The model drafter runs its draft model whole on each rank: every
    rank proposes the same drafts, and some are accepted."""
    per_rank = rings[2][True]
    props = [r["model"][1]["proposals"] for r in per_rank]
    assert props[0] and all(p == props[0] for p in props)
    assert sum(len(p) for p in props[0]) == \
        per_rank[0]["model"][1]["draft_tokens"]


def _reference_sharded(c, tp):
    """The reference's ``speculative_verify_sharded`` on the case's rows
    split into ``tp`` ranks' vocab columns (the ranks as a named vmap
    axis, its collectives as under ``shard_map``): rank 0's (out, n_acc),
    after checking that every rank's are the same."""
    B, K1, V = c["logits"].shape
    loc = np.moveaxis(c["logits"].reshape(B, K1, tp, V // tp), 2, 0)

    def rank(lg):
        out, n, _ = jax_verify_sharded(
            lg, c["draft"], jax.random.PRNGKey(c["seed"]), c["temps"],
            c["top_ks"], c["top_ps"], None, "model", tp)
        return out, n
    out, n = (np.asarray(t) for t in jax.vmap(rank, axis_name="model")(loc))
    assert (out == out[0]).all() and (n == n[0]).all()
    return out[0], n[0]


def _reference_candidate_marginal(row, tp, temp, top_k, top_p):
    """The reference's target distribution over the ring's candidate set
    of one (V,) row: each rank's top-``MAX_LOCAL_K`` of its columns in
    rank order, filtered by its ``_filter_row`` -> {global id: p}."""
    w = row.shape[-1] // tp
    vals, idx = jax.lax.top_k(jax.numpy.asarray(row).reshape(tp, w),
                              min(MAX_LOCAL_K, w))
    ids = np.asarray(idx) + np.arange(tp)[:, None] * w
    lg = _filter_row(vals.reshape(-1), jax.numpy.float32(temp),
                     jax.numpy.int32(top_k), jax.numpy.float32(top_p))
    p = np.asarray(jax.nn.softmax(lg))
    return {int(i): float(q) for i, q in zip(ids.reshape(-1), p) if q > 0}


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_verify_greedy_equals_tp1(rings, tp):
    """Greedy ``speculative_verify_sharded`` on each rank's columns
    equals the reference's on the same columns and the reference's tp=1
    ``speculative_verify_batched`` on the whole rows, on every rank: a
    tie across ranks and ties inside one rank's columns go to the lower
    id, as the tp=1 argmax."""
    c = _verify_cases()[0]
    want = jax_verify_batched(c["logits"], c["draft"],
                              jax.random.PRNGKey(0), c["temps"],
                              c["top_ks"], c["top_ps"])
    want = np.asarray(want[0]), np.asarray(want[1])
    assert want[0][0, 0] == 10 and want[0][2, 1] == 5
    assert want[0][3, 2] == c["logits"].shape[-1] - 40
    assert want[1][1] == c["draft"].shape[1]
    ref = _reference_sharded(c, tp)
    np.testing.assert_array_equal(ref[0], want[0])
    np.testing.assert_array_equal(ref[1], want[1])
    for r in rings[tp]["verify"]:
        out, n = r[0]
        np.testing.assert_array_equal(out, want[0])
        np.testing.assert_array_equal(n, want[1])


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_verify_stochastic_marginals(rings, tp):
    """Stochastic ``speculative_verify_sharded``: identical on every rank;
    position 0 of 20000 windows drawn within TV 0.03 of the reference's
    target over the ring's candidate set (its ``_filter_row`` at top_k 8
    there), and the first draft accepted at its mass within 0.02."""
    c = _verify_cases()[1]
    per_rank = [r[1] for r in rings[tp]["verify"]]
    for out, n in per_rank[1:]:
        np.testing.assert_array_equal(out, per_rank[0][0])
        np.testing.assert_array_equal(n, per_rank[0][1])
    out, n = per_rank[0]
    p = _reference_candidate_marginal(
        c["logits"][0, 0], tp, float(c["temps"][0]), int(c["top_ks"][0]),
        float(c["top_ps"][0]))
    N = out.shape[0]
    got = counts(out[:, 0])
    assert set(got) <= set(p)
    tv = 0.5 * sum(abs(got.get(t, 0) / N - q) for t, q in p.items())
    assert tv < 0.03, tv
    acc = float((n >= 1).mean())
    assert abs(acc - p.get(int(c["draft"][0, 0]), 0.0)) < 0.02
