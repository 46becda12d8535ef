"""The port's engine on the model ring: gloo ranks on the CPU, each a
spawned process with its shards and its pool (tests/torch_tp_util.py).

Greedy streams of the tp=2 engine on reduced smollm-135m and reduced
opt-1.3b (every bias and ``pos_embed`` redrawn non-zero) equal the
reference's tp=1 engine and the port's tp=1 engine, in both ESL modes
(overlap and blocking), under preemption (both runs preempt) and in
chunks of 8 with the prefix cache; smollm-135m at tp 4 (its 2 kv heads
duplicated) as well.  Also: logits of a prefill and 8 decode steps at
1e-4 against the tp=1 port; the stochastic window's draws on the ring
against the filtered target (TV < 0.02); the NaN guard tripping on every
rank when one rank's window is poisoned; ``per_rank_kv_bytes``; the
refusals; the CLI's ``--tp 2 --device cpu``; the serve driver's prior
point.

Cost in one process ~50 s: four spawns of ranks (one thread each) and
the reference's tp=1 engines.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampler as jax_sampler
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.core.dist import backend_for, run_ranks
from repro_torch.core.latency_model import LPU_FPGA
from repro_torch.launch import serve as serve_cli
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from tests.torch_dense_util import (one_torch_thread,  # noqa: F401
                                    reduced_pair, reference_compile_cache)
from tests.torch_tp_util import tp_rank

MAX_NEW = 12
MODES = {"overlap": True, "blocking": False}


def _prompts():
    r = np.random.default_rng(1)
    return [[int(t) for t in r.integers(1, 512, size=n)]
            for n in (3, 9, 17, 6, 25, 2)]


def _shared_prompts():
    """A 20-token system prompt ahead of each tail: the requests admitted
    after the first three hit its first block of 16."""
    r = np.random.default_rng(2)
    sys_prompt = [int(t) for t in r.integers(1, 512, size=20)]
    return [sys_prompt + [int(t) for t in r.integers(1, 512, size=n)]
            for n in (4, 11, 7, 9, 2)]


AXES = {
    "stream": (dict(block_size=16), _prompts),
    "preempt": (dict(block_size=8, num_blocks=9, steps_per_sync=4),
                _prompts),
    "chunk8-prefix": (dict(block_size=16, prefill_chunk=8,
                           prefix_cache=True), _shared_prompts),
    "dense": (dict(paged=False), _prompts),
    "host": (dict(block_size=16, sampling="host"), _prompts),
}
TP2_AXES = ("stream", "preempt", "chunk8-prefix")
TP4_RUNS = (("stream", "overlap"), ("chunk8-prefix", "overlap"),
            ("preempt", "blocking"))
FEED = np.random.default_rng(7).integers(1, 512, size=(3, 8))
TOKENS = np.random.default_rng(8).integers(1, 512, size=(3, 7))
ROW = (np.random.default_rng(3).standard_normal(8) * 2).astype(np.float32)
SAMPLERS = ((1.0, 5, 0.85), (0.7, 0, 1.0))
N_NEW = 2001


def _conf(axis):
    kw, prompts_fn = AXES[axis]
    return dict(slots=3, max_seq=64, **kw), prompts_fn()


def _tree(jparams):
    return jax.tree.map(np.asarray, jparams)


def _scenarios(axes):
    out = []
    for axis in axes:
        conf, prompts = _conf(axis)
        out.append(dict(key=axis, prompts=prompts, max_new=MAX_NEW,
                        conf=conf))
    return out


def _ring_runs(name, tree, runs):
    """engine_rank's runs: for each mode, the scenarios of its axes."""
    by_mode = collections.defaultdict(list)
    for axis, mode in runs:
        by_mode[mode].append(axis)
    return [dict(name=name, tree=tree, overlap=MODES[mode],
                 scenarios=[dict(s, key=(s["key"], mode))
                            for s in _scenarios(axes)])
            for mode, axes in by_mode.items()]


@pytest.fixture(scope="module")
def pairs():
    return {n: reduced_pair(n) for n in ("smollm-135m", "opt-1.3b")}


@pytest.fixture(scope="module")
def tp1(pairs):
    """{(name, axis): (reference tp=1 streams, its preemptions, the
    port's tp=1 streams)}."""
    out = {}
    for name, ((_, _, jmodel, jparams), (_, _, model, params)) in \
            pairs.items():
        for axis in (AXES if name == "smollm-135m" else TP2_AXES):
            conf, prompts = _conf(axis)
            jeng = JaxEngine(jmodel, jparams, JaxEngineConfig(**conf))
            ref = jeng.generate(prompts, max_new_tokens=MAX_NEW)
            mine = LPUEngine(model, params, EngineConfig(**conf),
                             device="cpu").generate(prompts,
                                                    max_new_tokens=MAX_NEW)
            out[name, axis] = (ref, jeng.stats.preemptions, mine)
    return out


@pytest.fixture(scope="module")
def ring2(pairs):
    """Every tp=2 task in two spawns (smollm, opt)."""
    out = {}
    for name in pairs:
        tree = _tree(pairs[name][0][3])
        runs = [(a, m) for m in MODES for a in TP2_AXES]
        if name == "smollm-135m":
            runs += [("dense", "overlap"), ("host", "overlap")]
        tasks = {"engine": ("engine_rank", dict(
            runs=_ring_runs(name, tree, runs)))}
        for mode, overlap in MODES.items():
            tasks["logits", mode] = ("logits_rank", dict(
                name=name, tree=tree, overlap=overlap, tokens=TOKENS,
                feed=FEED))
        if name == "smollm-135m":
            for i, (t, k, p) in enumerate(SAMPLERS):
                tasks["sampler", i] = ("sampler_rank", dict(
                    name=name, tree=tree, row=ROW, temp=t, top_k=k,
                    top_p=p, n_new=N_NEW))
            tasks["guard"] = ("guard_rank", dict(name=name, tree=tree))
            tasks["refusals"] = ("refusals_rank", dict(name=name,
                                                       tree=tree))
        out[name] = run_ranks(tp_rank, 2, tasks, device="cpu", threads=1)
    return out


@pytest.fixture(scope="module")
def ring4(pairs):
    tree = _tree(pairs["smollm-135m"][0][3])
    return run_ranks(tp_rank, 4, {
        "engine": ("engine_rank", dict(runs=_ring_runs(
            "smollm-135m", tree, TP4_RUNS))),
        "logits": ("logits_rank", dict(name="smollm-135m", tree=tree,
                                       overlap=True, tokens=TOKENS,
                                       feed=FEED))}, device="cpu", threads=1)


def _check_streams(per_rank, key, tp1_entry, tp):
    ref, ref_pre, mine = tp1_entry
    assert ref == mine
    for r, out in enumerate(per_rank):
        streams, st = out[key]
        assert streams == ref, (key, r)
        if key[0] == "preempt":
            assert ref_pre > 0 and st["preemptions"] > 0
        if key[0] == "chunk8-prefix":
            assert st["prefill_chunks"] > 0 and st["prefix_hits"] > 0
        assert st["per_rank_kv_bytes"] * tp == st["kv_cache_bytes"]
        assert st["per_rank_kv_bytes"] == st["rank_cache_bytes"]
        assert sum(st["launches"].values()) == 0   # the CPU runs the plain
        hops = st["ring"]["hops"]
        assert (hops > 0) == (key[1] == "overlap"), (key, st["ring"])
        assert st["ring"]["collectives"] > st["device_decode_steps"]


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["smollm-135m", "opt-1.3b"])
@pytest.mark.parametrize("axis", TP2_AXES)
@pytest.mark.parametrize("mode", list(MODES))
def test_tp2_streams_match_reference_tp1(ring2, tp1, name, axis, mode):
    _check_streams(ring2[name]["engine"], (axis, mode), tp1[name, axis], 2)


@pytest.mark.parametrize("axis", ["dense", "host"])
def test_tp2_dense_cache_and_host_sampling(ring2, tp1, axis):
    """The dense per-slot cache and host sampling (each rank gathers the
    logits row whole) on the ring."""
    _check_streams(ring2["smollm-135m"]["engine"], (axis, "overlap"),
                   tp1["smollm-135m", axis], 2)


@pytest.mark.parametrize("axis,mode", TP4_RUNS)
def test_tp4_duplicated_kv_streams(ring4, tp1, axis, mode):
    """Reduced smollm-135m's 2 kv heads on 4 ranks: each kv head on two
    adjacent ranks, the query heads split between them and padded."""
    _check_streams(ring4["engine"], (axis, mode), tp1["smollm-135m", axis],
                   4)


# ---------------------------------------------------------------------------
# logits, sampling, the guard
# ---------------------------------------------------------------------------

def _tp1_logits(pair):
    _, (_, _, model, params) = pair
    tok = torch.from_numpy(TOKENS).long()
    B, S = tok.shape
    cache = model.init_cache(B, S + FEED.shape[1])
    with torch.no_grad():
        lg, _ = model.forward(params, tok, mode="prefill", cache=cache,
                              positions=torch.arange(S).expand(B, S))
        rows = [lg]
        for i in range(FEED.shape[1]):
            lg, _ = model.forward(
                params, torch.from_numpy(FEED[:, i:i + 1]).long(),
                mode="decode", positions=torch.full((B,), S + i,
                                                    dtype=torch.int32),
                cache=cache)
            rows.append(lg)
    return torch.cat(rows, 1).numpy()


@pytest.mark.parametrize("case", ["smollm-135m/overlap",
                                  "smollm-135m/blocking",
                                  "opt-1.3b/overlap", "opt-1.3b/blocking",
                                  "smollm-135m/tp4"])
def test_ring_logits_match_tp1_port(pairs, ring2, ring4, case):
    name, mode = case.split("/")
    got = (ring4["logits"] if mode == "tp4"
           else ring2[name]["logits", mode])
    want = _tp1_logits(pairs[name])
    V = pairs[name][1][0].vocab_size
    assert got.shape[:2] == want.shape[:2]
    np.testing.assert_allclose(got[..., :V], want[..., :V], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("i", range(len(SAMPLERS)))
def test_stochastic_window_on_ring_matches_target(ring2, i):
    """The ring's window draws (each rank sampling the all-gathered
    candidates of its 4 of 8 columns) against the reference's filtered
    target softmax(_filter_row(row)): TV < 0.02, every rank the same."""
    temp, top_k, top_p = SAMPLERS[i]
    per_rank = ring2["smollm-135m"]["sampler", i]
    assert per_rank[0] == per_rank[1]
    draws = [t for o in per_rank[0] for t in o[1:]]   # o[0]: prefill row
    n = len(draws)
    assert n == 4 * (N_NEW - 1)
    p = np.asarray(jax.nn.softmax(jax_sampler._filter_row(
        jnp.asarray(ROW), jnp.float32(temp), jnp.int32(top_k),
        jnp.float32(top_p))))
    counts = collections.Counter(draws)
    assert set(counts) <= {j for j in range(len(ROW)) if p[j] > 0}
    tv = 0.5 * sum(abs(counts.get(j, 0) / n - p[j])
                   for j in range(len(ROW)))
    assert tv < 0.02


def test_nan_guard_trips_ring_wide(ring2):
    """Rank 1's window alone is poisoned: the psum'd verdict refuses it
    on both ranks at the same step; both serve on after reset()."""
    recs = ring2["smollm-135m"]["guard"]
    assert recs[0]["failed"] is not None
    assert recs[0]["failed"][0] == "nan_logits"
    assert recs[0]["failed"] == recs[1]["failed"]
    assert recs[0]["orphans"] == recs[1]["orphans"] == 1
    assert recs[0]["after_reset"] == recs[1]["after_reset"]
    assert len(recs[0]["after_reset"][0]) == 6


# ---------------------------------------------------------------------------
# refusals, the CLI, the prior
# ---------------------------------------------------------------------------

REFUSED = {
    "graphs": ("ValueError", "graphs=True on a gloo ring"),
    "full_tree": ("ValueError", "shard_params"),
    "no_ring": ("ValueError", "needs mesh"),
    "whisper-tiny": ("ValueError", "encoder-decoder"),
    "data_axis": ("NotImplementedError", "the engine on a data axis"),
}
# what the ring refused before it ran speculation, a vlm, the mesh fleet
# and the front end, each with what it gives now
# (tests/test_torch_tp_spec.py and tests/test_torch_tp_fleet.py hold
# them in full)
SERVED = {
    # a fleet of one sub-ring over the whole ring: the plain ring's
    "fleet": lambda r: r["equal"] and r["routed"] == [2],
    # rank 0's front end ordering both ranks: the plain ring's streams
    "frontend": lambda r: r["equal"] and r["crc"] != 0,
    # the n-gram drafter: the plain ring's streams, verify rounds run
    "speculate": lambda r: r["equal"] and r["rounds"] > 0,
    # llava's text decoder: the tp=1 engine's streams
    "llava-next-34b": lambda r: r["equal"],
    # a two-query verify window on an empty pool: the prefill's logits
    "verify": lambda r: r["shape"] == (1, 2, 512) and r["max_abs"] < 1e-5,
}


@pytest.mark.parametrize("kind", ["graphs", "speculate", "full_tree",
                                  "no_ring", "whisper-tiny",
                                  "llava-next-34b", "data_axis", "fleet",
                                  "frontend", "verify"])
def test_ring_refusals(ring2, kind):
    got = ring2["smollm-135m"]["refusals"][kind]
    if kind in SERVED:
        assert got[0] == "ok" and SERVED[kind](got[1]), got
        return
    typ, text = REFUSED[kind]
    assert got[0] == typ and text in got[1], got


def test_backend_rule():
    """gloo on the CPU or one shared card, NCCL for a card per rank,
    and a mix of the two refused."""
    assert backend_for(["cpu", "cpu"]) == "gloo"
    assert backend_for(["cuda:0"] * 2) == "gloo"
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"
    with pytest.raises(ValueError, match="a card per rank"):
        backend_for(["cuda:0", "cuda:0", "cuda:1"])


def test_cli_tp2_cpu(capfd):
    """``--tp 2 --device cpu`` serves the CLI's batch on two ranks, the
    same streams as the tp=1 run, and with ``--speculate ngram`` and
    through the front end (``--max-pending 2``) too; rank 0 prints the
    stats lines and the ring's."""
    argv = ["--reduced", "--device", "cpu", "--requests", "4",
            "--max-new", "6", "--max-seq", "64"]
    one = serve_cli.main(argv)
    capfd.readouterr()
    two = serve_cli.main(argv + ["--tp", "2"])
    out = capfd.readouterr().out
    assert two == one
    assert "tp=2 (ESL overlap, gloo ring, graphs off" in out
    assert "[serve] ring:" in out and out.count("[serve] kv=") == 1
    spec = serve_cli.main(argv + ["--tp", "2", "--speculate", "ngram"])
    out = capfd.readouterr().out
    assert spec == one
    assert "speculate=ngram draft_k=4:" in out and " 0 rounds" not in out
    # the front end on rank 0 ordering both ranks (the fleet's and the
    # other knobs' cases: tests/test_torch_tp_fleet.py)
    fe = serve_cli.main(argv + ["--tp", "2", "--max-pending", "2"])
    out = capfd.readouterr().out
    assert fe == one
    assert "[serve] frontend: 4 completed 0 failed 0 cancelled" in out
    assert " applied on each of 2 ranks" in out


def test_serve_prior_point():
    """The serve driver seeds the step-time prior at the LPU-FPGA point
    on the CPU and not at all on the card (no roofline point: the
    monitors' warm-up takes the first measured steps)."""
    assert serve_cli.prior_point(torch.device("cuda")) is None
    assert serve_cli.prior_point(torch.device("cpu")) is LPU_FPGA
