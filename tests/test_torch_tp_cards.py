"""The ring on its own cards, as far as the CPU can hold it: the backend
and placement rules, ranks that draw only their shards, and the NCCL
code paths run over gloo's transport.

* ``backend_for`` / ``rank_devices``: rank r on ``cuda:r`` over NCCL, a
  raise when asked for more cards than the machine has, never a silent
  switch to gloo or to one shared card; ``serve --tp N`` without N cards
  or ``--shared-card`` raises and names both counts.
* ``init_shard`` (+ ``redraw_shard`` for the biases and positions of
  OPT and GPT3) is bit-equal to ``shard_params(relayout(init_params))``
  (+ ``redraw``) at tp 2 and 4 on reduced smollm-135m, opt-1.3b and
  gpt3-20b, rank by rank.
* Engines on a gloo ring whose ranks drew only their shards serve the
  streams of the port's tp=1 engine and of the reference's engine on
  the same weights (reduced smollm-135m at tp 2 and 4, opt-1.3b at tp 2,
  f32, overlap and blocking).
* On a gloo ring standing in for NCCL (its backend read as ``"nccl"``),
  every collective's NCCL code gives the gloo code's bits and counts,
  and the engine with ``graphs=True`` serves the streams of its eager
  twin, its collectives counted per program run, the one-time
  parameter gathers of the blocking baseline made in the warm-ups
  (opt-1.3b at tp 2 also in blocking with a prefill in chunks of 8).
* ``graphs=True`` is refused on a gloo ring and taken on an NCCL one; a
  replay adds its capture's collectives, hops and bytes to
  ``Ring.counters`` (not its host seconds); a warm-up and a capture
  count nothing.

Cost in one process ~25 s: two spawns of ranks (2 and 4, one torch
thread each) and two reference engines.
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.core import dist
from repro_torch.core.dist import Ring, backend_for, rank_devices, run_ranks
from repro_torch.launch import serve as serve_cli
from repro_torch.models.common import init_params
from repro_torch.models.registry import build_model
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from repro_torch.serving.graphs import Program, Programs
from repro_torch.weights import (_leaves, init_shard, redraw, redraw_shard,
                                 relayout, shard_params, tp1_plan)
from tests.torch_dense_util import (one_torch_thread,  # noqa: F401
                                    reference_compile_cache)
from tests.torch_tp_cards_util import (SERVE_F32, assert_same, cards_rank,
                                       redraw_std, tp1_tree)

CONF = dict(slots=3, max_seq=64, block_size=16)
MAX_NEW = 12
PROMPTS = [[int(t) for t in np.random.default_rng(1).integers(
    1, 512, size=n)] for n in (3, 9, 17, 6, 25, 2)]
# mode: (ESL overlap, the engine's other knobs); blocking_chunks prefills
# in chunks of 8, the chunk program per C captured with the rest
MODES = {"overlap": (True, {}), "blocking": (False, {}),
         "blocking_chunks": (False, {"prefill_chunk": 8})}
SERVED = {2: (("smollm-135m", "overlap"), ("smollm-135m", "blocking"),
              ("opt-1.3b", "overlap"), ("opt-1.3b", "blocking")),
          4: (("smollm-135m", "overlap"), ("opt-1.3b", "blocking"))}
# the NCCL code with graphs on, beside its eager twin (both standing in
# for NCCL over gloo)
AS_NCCL = {2: (("opt-1.3b", "overlap"), ("opt-1.3b", "blocking"),
              ("opt-1.3b", "blocking_chunks")),
           4: (("smollm-135m", "blocking"),)}


# ---------------------------------------------------------------------------
# placement and backend
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _cards(monkeypatch, n):
    """A machine that reports ``n`` CUDA cards (none runs anything)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    yield


@pytest.mark.parametrize("tp", [2, 4])
def test_card_per_rank_places_rank_r_on_cuda_r(monkeypatch, tp):
    with _cards(monkeypatch, 4):
        devs = rank_devices(tp, "cuda", "card_per_rank")
    assert devs == [torch.device("cuda", r) for r in range(tp)]
    assert backend_for(devs) == "nccl"


@pytest.mark.parametrize("have,tp", [(0, 2), (1, 2), (3, 4), (4, 8)])
def test_card_per_rank_raises_without_enough_cards(monkeypatch, have, tp):
    """Never a silent switch to the shared card or to gloo."""
    with _cards(monkeypatch, have):
        with pytest.raises(RuntimeError,
                           match=f"needs {tp} cards; this machine has "
                                 f"{have}"):
            rank_devices(tp, "cuda", "card_per_rank")


def test_placement_is_explicit(monkeypatch):
    with _cards(monkeypatch, 4):
        with pytest.raises(ValueError, match="card_per_rank"):
            rank_devices(2, "cuda", None)
        shared = rank_devices(2, "cuda", "shared_card")
    assert shared == [torch.device("cuda", 0)] * 2
    assert backend_for(shared) == "gloo"
    assert rank_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="CPU take none"):
        rank_devices(2, "cpu", "card_per_rank")
    with pytest.raises(ValueError, match="a card per rank"):
        backend_for(["cuda:0", "cpu"])


@pytest.mark.parametrize("have", [0, 1])
def test_serve_tp_needs_cards_or_shared_card(monkeypatch, have):
    """``serve --tp 2`` on CUDA without 2 cards raises naming both
    counts; ``--shared-card`` asks for the shared card instead."""
    argv = ["--reduced", "--tp", "2"]
    with _cards(monkeypatch, have):
        with pytest.raises(RuntimeError,
                           match=f"needs 2 cards; this machine has {have}"):
            serve_cli.main(argv)
    parse = serve_cli._parser().parse_args
    assert serve_cli.placement_of(parse(argv)) == "card_per_rank"
    assert serve_cli.placement_of(parse(argv + ["--shared-card"])) == \
        "shared_card"
    assert serve_cli.placement_of(parse(argv + ["--device", "cpu"])) is None
    with pytest.raises(ValueError, match="--tp N > 1"):
        serve_cli.placement_of(parse(["--shared-card"]))


# ---------------------------------------------------------------------------
# ranks that draw only their shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["smollm-135m", "opt-1.3b", "gpt3-20b"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("overlap", [True, False])
def test_init_shard_bit_equal_to_sliced_tree(name, tp, overlap):
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, ("model",), (tp,), "serve", esl_overlap=overlap,
                      **SERVE_F32)
    plan1 = tp1_plan(cfg, plan)
    full = init_params(cfg, plan1, seed=3, device="cpu")
    std = redraw_std(cfg)
    if cfg.positional == "learned":
        redraw(full, std, 20)
    full = relayout(full, cfg, plan1, plan)
    for rank in range(tp):
        want = dict(_leaves(shard_params(full, plan, rank)))
        got = init_shard(cfg, plan, rank, seed=3, device="cpu")
        if cfg.positional == "learned":
            redraw_shard(got, cfg, plan, rank, std, 20)
        got = dict(_leaves(got))
        assert list(got) == list(want)
        for path, t in want.items():
            assert got[path].dtype == t.dtype, path
            assert torch.equal(got[path], t), (name, tp, rank, path)


def test_init_shard_refuses_other_families_and_tp1():
    """A vlm's and an encoder-decoder's shards are drawn alone too
    (llava's projector, whisper's encoder and decoder; every leaf:
    tests/test_torch_tp_multimodal.py), bit-equal to the sliced tp=1
    tree; a plan off the ring is refused."""
    for name in ("llava-next-34b", "whisper-tiny"):
        cfg = get_config(name).reduced()
        plan = plan_model(cfg, ("model",), (2,), "serve", **SERVE_F32)
        plan1 = tp1_plan(cfg, plan)
        full = relayout(init_params(cfg, plan1, seed=3, device="cpu"),
                        cfg, plan1, plan)
        for rank in range(2):
            want = dict(_leaves(shard_params(full, plan, rank)))
            got = dict(_leaves(init_shard(cfg, plan, rank, seed=3,
                                          device="cpu")))
            assert list(got) == list(want)
            assert all(torch.equal(got[k], want[k]) for k in want), name
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(ValueError, match="a plan for the ring"):
        init_shard(cfg, plan_model(cfg, None, (1,), "serve", **SERVE_F32),
                   0, device="cpu")


# ---------------------------------------------------------------------------
# engines on the ring's own shards, and the NCCL code over gloo
# ---------------------------------------------------------------------------

def _tasks(tp):
    tasks = {"gloo": ("collectives", {}),
             "nccl": ("collectives", {"nccl": True})}
    for name, mode in SERVED[tp]:
        overlap, knobs = MODES[mode]
        tasks[name, mode] = ("serve", dict(
            name=name, overlap=overlap, conf=dict(CONF, **knobs),
            prompts=PROMPTS, max_new=MAX_NEW, graphs=False))
    for name, mode in AS_NCCL[tp]:
        overlap, knobs = MODES[mode]
        for graphs in (False, True):
            tasks[name, mode, "nccl", graphs] = ("serve", dict(
                name=name, overlap=overlap, conf=dict(CONF, **knobs),
                prompts=PROMPTS, max_new=MAX_NEW, graphs=graphs, nccl=True))
    return tasks


@pytest.fixture(scope="module")
def rings():
    return {tp: run_ranks(cards_rank, tp, _tasks(tp), device="cpu",
                          threads=1) for tp in (2, 4)}


@pytest.fixture(scope="module")
def tp1():
    """{name: (the reference engine's streams, the port's tp=1 engine's)}
    on the same tp=1 tree."""
    out = {}
    for name in ("smollm-135m", "opt-1.3b"):
        cfg = get_config(name).reduced()
        plan, tree = tp1_tree(cfg)
        mine = LPUEngine(build_model(cfg, plan, "cpu"), tree,
                         EngineConfig(**CONF), device="cpu").generate(
            PROMPTS, max_new_tokens=MAX_NEW)
        jcfg = jax_get_config(name).reduced()
        jplan = jax_plan_model(jcfg, None, (1,), "serve", esl_overlap=False,
                               **SERVE_F32)
        jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
        ref = JaxEngine(jax_build_model(jcfg, jplan), jtree,
                        JaxEngineConfig(**CONF)).generate(
            PROMPTS, max_new_tokens=MAX_NEW)
        out[name] = (ref, mine)
    return out


@pytest.mark.parametrize("tp,name,mode",
                         [(tp, n, m) for tp in SERVED for n, m in SERVED[tp]])
def test_shard_engines_match_tp1_and_reference(rings, tp1, tp, name, mode):
    ref, mine = tp1[name]
    assert mine == ref
    for r, res in enumerate(rings[tp]):
        got = res[name, mode]
        assert got["streams"] == ref, (tp, name, mode, r)
        assert got["launches"] == 0                 # the CPU: plain
        assert got["counters"]["staged_bytes"] == 0
        assert (got["counters"]["hops"] > 0) == (mode == "overlap")


@pytest.mark.parametrize("tp", [2, 4])
def test_nccl_collectives_give_gloo_bits(rings, tp):
    for res in rings[tp]:
        assert_same(res["nccl"], res["gloo"], f"tp {tp}")
    n = tp
    # a psum is one collective; a ppermute a collective and a hop
    assert rings[tp][0]["gloo"]["counters"] == {
        "collectives": 9 + 2 * (n == 4), "hops": 3, "staged_bytes": 0}


@pytest.mark.parametrize(
    "tp,name,mode", [(tp, n, m) for tp in AS_NCCL for n, m in AS_NCCL[tp]])
def test_nccl_graphs_engine_matches_eager_twin(rings, tp1, tp, name, mode):
    """graphs=True on the stand-in NCCL ring: the eager twin's streams
    (and the reference's), the same collectives with the blocking
    baseline's parameter gathers made once in the warm-ups."""
    for res in rings[tp]:
        g = res[name, mode, "nccl", True]
        e = res[name, mode, "nccl", False]
        assert g["streams"] == e["streams"] == tp1[name][0]
        assert g["device_decode_steps"] == e["device_decode_steps"]
        assert g["counters"]["hops"] == e["counters"]["hops"]
        assert g["counters"]["collectives"] + g["gathered"] == \
            e["counters"]["collectives"]
        assert e["gathered"] == g["gathered"]
        assert (g["gathered"] > 0) == (not MODES[mode][0])
        chunks = g["prefill_chunks"]
        assert chunks == e["prefill_chunks"]
        assert (chunks > 0) == ("prefill_chunk" in MODES[mode][1])


# ---------------------------------------------------------------------------
# graphs on the ring, and its counters per replay
# ---------------------------------------------------------------------------

def _stand_in(backend, size=2):
    """A Ring of this process with no process group behind it."""
    ring = Ring.__new__(Ring)
    ring.group, ring.rank, ring.size = None, 0, size
    ring.backend, ring.device = backend, torch.device("cpu")
    ring._subgroups, ring._gathered = {}, {}
    ring.counters = dict(collectives=0, hops=0, staged_bytes=0, seconds=0.0)
    return ring


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_graphs_refused_on_gloo_taken_on_nccl(backend):
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, ("model",), (2,), "serve", **SERVE_F32)
    params = init_shard(cfg, plan, 0, device="cpu")
    make = lambda: LPUEngine(build_model(cfg, plan, "cpu"),  # noqa: E731
                             params, EngineConfig(**CONF),
                             mesh=_stand_in(backend), device="cpu")
    if backend == "gloo":
        with pytest.raises(ValueError, match="graphs=True on a gloo ring"):
            make()
    else:
        eng = make()
        assert eng.graphs and eng._programs.ring is eng.ring
        assert eng._admit.ring is eng.ring


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_ring_counters_add_per_replay():
    ring = _stand_in("nccl")
    progs = Programs("cpu", ring=ring)
    made = {"collectives": 7, "hops": 3, "staged_bytes": 0, "seconds": 0.5}
    prog = Program(_FakeGraph(), {}, collectives=made)
    for _ in range(3):
        progs.run(prog, lambda: pytest.fail("a replay ran the function"))
    assert ring.counters == {"collectives": 21, "hops": 9,
                             "staged_bytes": 0, "seconds": 0.0}
    with dist.held_counters(ring) as held:
        ring.counters["collectives"] += 5
    assert held["collectives"] == 5 and ring.counters["collectives"] == 21


def test_capture_counts_nothing_and_records_its_collectives(monkeypatch):
    """The CUDA calls of a capture stood in for on the CPU: the warm-up
    and the capture each make one psum and one hop, none counted; the
    program holds one of each, and every replay adds them."""
    ring = _stand_in("nccl")

    def fn():
        ring.counters["collectives"] += 2
        ring.counters["hops"] += 1
        ring.counters["seconds"] += 0.1

    class Stream:
        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass
    modes = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        modes.append(capture_error_mode)
        yield
    for name, value in dict(
            graph=graph, CUDAGraph=_FakeGraph, Stream=Stream,
            current_stream=lambda *a: Stream(), graph_pool_handle=tuple,
            stream=lambda s: contextlib.nullcontext()).items():
        monkeypatch.setattr(torch.cuda, name, value)
    progs = Programs("cpu", ring=ring)
    progs.device = types.SimpleNamespace(type="cuda")
    prog = progs.get(("probe",), fn, generator=None,
                     held=contextlib.nullcontext)
    assert modes == ["thread_local"]
    assert ring.counters == dict(collectives=0, hops=0, staged_bytes=0,
                                 seconds=0.0)
    assert prog.collectives["collectives"] == 2
    progs.run(prog, fn)
    progs.run(prog, fn)
    assert ring.counters["collectives"] == 4 and ring.counters["hops"] == 2
    assert ring.counters["seconds"] == 0.0
