"""The engine's decode window and fused verify round on their static
buffers (``repro_torch/serving/graphs.py``), as the card runs them under
a captured CUDA graph: on the CPU the same functions run eagerly on the
same buffers, after the same warm-up; only the capture call is skipped.

Greedy streams against the reference's ``LPUEngine`` and the port's
eager twin (``graphs=False``) at 1/4/8-step windows with the pipeline on
and off, under preemption, on the reduced smollm-135m, opt-1.3b and
rwkv6-7b; the verify round against its plain twin; the pipelined
window's token matrix; a warm-up mid-stream with a dense or recurrent
cache resident; stats and launch accounting; and stochastic windows
against the sampler's distribution gate.
"""
import collections
import contextlib
import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.serving import sampler as jax_sampler
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch import kernels
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from repro_torch.serving.graphs import Program, Programs
from repro_torch.serving.sampler import SamplingParams
from repro_torch.weights import params_from_jax
from tests.torch_dense_util import (SERVE_F32, one_torch_thread,  # noqa: F401
                                     reduced_pair)

# tests/test_kv_cache.py's trace
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11],
           [3, 1, 4, 1, 5, 9, 2, 6], [2, 7]]
MAX_NEW = 16
GEOM = dict(slots=3, max_seq=64)


def _pair(arch):
    """(reference model, params), (port model, params) of ``arch``'s
    reduced config on the reference's own init."""
    jcfg = jax_get_config(arch).reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jmodel = jax_build_model(jcfg, jplan)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    model = build_model(cfg, plan, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, plan,
                             "cpu")
    return (jmodel, jparams), (model, params)


@pytest.fixture(scope="module")
def models():
    """Per arch: the port's (model, params) and the reference engine's
    greedy streams of PROMPTS (paged pool of 16-row blocks, or the dense
    state cache of rwkv)."""
    out = {}
    for arch, kw in (("smollm-135m", dict(block_size=16)),
                     ("opt-1.3b", dict(block_size=16)),
                     ("rwkv6-7b", dict(paged=False))):
        if arch == "opt-1.3b":
            (_, _, jmodel, jparams), (_, _, model, params) = \
                reduced_pair(arch)
        else:
            (jmodel, jparams), (model, params) = _pair(arch)
        ref = JaxEngine(jmodel, jparams, JaxEngineConfig(**GEOM, **kw)
                        ).generate(PROMPTS, max_new_tokens=MAX_NEW)
        out[arch] = (model, params, kw, ref)
    return out


def _stats(eng):
    """Every counter but the wall clock and the graph counters."""
    d = dict(vars(eng.stats))
    for k in ("wall", "graph_captures", "graph_replays"):
        d.pop(k)
    return d


def _serve(model, params, kw, graphs, prompts=PROMPTS, **extra):
    eng = LPUEngine(model, params, EngineConfig(**GEOM, **kw, **extra),
                    device="cpu", graphs=graphs)
    kernels.reset_launches()
    out = eng.generate(prompts, max_new_tokens=MAX_NEW)
    return out, eng, kernels.read_launches()


AXES = {
    "smollm-s1": ("smollm-135m", dict(steps_per_sync=1)),
    "smollm-s4": ("smollm-135m", dict(steps_per_sync=4)),
    "smollm-s4-no-pipeline": ("smollm-135m", dict(steps_per_sync=4,
                                                  pipeline=False)),
    "smollm-s8": ("smollm-135m", dict(steps_per_sync=8)),
    "smollm-s8-no-pipeline": ("smollm-135m", dict(steps_per_sync=8,
                                                  pipeline=False)),
    "smollm-preempt-s4": ("smollm-135m", dict(block_size=8, num_blocks=5,
                                              steps_per_sync=4)),
    "opt-s4": ("opt-1.3b", dict(steps_per_sync=4)),
    "rwkv-s1": ("rwkv6-7b", dict(steps_per_sync=1)),
    "rwkv-s4": ("rwkv6-7b", dict(steps_per_sync=4)),
}


@pytest.mark.parametrize("axis", list(AXES))
def test_window_streams_match_reference_and_eager_twin(models, axis):
    arch, extra = AXES[axis]
    model, params, kw, ref = models[arch]
    kw = dict(kw, **extra)
    got, eng, launches = _serve(model, params, kw, graphs=True)
    eager, twin, twin_launches = _serve(model, params, kw, graphs=False)
    assert got == ref
    assert eager == ref
    assert _stats(eng) == _stats(twin)
    assert launches == twin_launches
    if "preempt" in axis:
        assert eng.stats.preemptions > 0
    eng.check_pool_balanced()
    # one program per (window length, stochastic), as the reference keys
    # its window traces; the twin builds none
    S = eng.steps_per_sync
    assert set(eng._programs._by_key) <= {("window", 1, False),
                                         ("window", S, False)}
    assert eng._programs._by_key and not twin._programs._by_key
    # nothing is captured on the CPU
    assert eng.stats.graph_captures == eng.stats.graph_replays == 0


def _motif_prompts():
    r = np.random.default_rng(7)
    out = []
    for n, reps in ((5, 4), (3, 6), (7, 3)):
        m = [int(t) for t in r.integers(1, 400, size=n)]
        out.append(m * reps + m[:2])
    return out


@pytest.mark.parametrize("draft_k", [2, 4])
def test_verify_round_matches_plain_twin(models, draft_k):
    model, params, kw, _ = models["smollm-135m"]
    prompts = _motif_prompts()
    plain, _, _ = _serve(model, params, kw, True, prompts)
    spec = dict(kw, speculate="ngram", draft_k=draft_k)
    got, eng, launches = _serve(model, params, spec, True, prompts)
    eager, twin, twin_launches = _serve(model, params, spec, False, prompts)
    assert got == plain == eager
    st = eng.stats
    assert st.spec_rounds > 0 and st.accepted_tokens > 0
    assert _stats(eng) == _stats(twin) and launches == twin_launches
    assert any(k[0] == "verify" for k in eng._programs._by_key)
    eng.check_pool_balanced()


def test_pipelined_window_keeps_its_token_matrix(models):
    """Window k's token matrix must survive the replay of window k+1,
    which is enqueued before window k is read back: the matrix the
    reconcile reads is the one its window wrote, never the static
    output both windows write into."""
    model, params, kw, ref = models["smollm-135m"]
    eng = LPUEngine(model, params,
                    EngineConfig(**GEOM, **kw, steps_per_sync=4),
                    device="cpu")
    written, read, rounds = [], [], []
    dispatch, reconcile = eng._dispatch_window, eng._reconcile

    def dispatch_spy(*a):
        h = dispatch(*a)
        written.append(h[1].clone())
        assert h[1].data_ptr() != eng._tok_out[h[0]].data_ptr()
        return h

    def reconcile_spy(h):
        read.append(h[1].clone())
        return reconcile(h)

    def round_spy(fn=eng._fused_decode_round):
        n = len(written)
        out = fn()
        rounds.append(len(written) - n)
        return out
    eng._dispatch_window, eng._reconcile = dispatch_spy, reconcile_spy
    eng._fused_decode_round = round_spy
    assert eng.generate(PROMPTS, max_new_tokens=MAX_NEW) == ref
    assert 2 in rounds                       # pipelined rounds happened
    assert all(torch.equal(a, b) for a, b in zip(written, read))
    assert any(not torch.equal(a, b) for a, b in zip(written, written[1:]))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "smollm-135m"])
def test_warm_up_mid_stream_leaves_resident_stream_unchanged(models, arch):
    """A program first needed mid-stream (here the stochastic window, when
    a sampled request joins a greedy one) warms up with a dead carry while
    the greedy stream is resident; its dense or recurrent cache, which
    the forward rewrites for every slot, and the generator are restored
    around it, so both streams equal the eager twin's."""
    model, params, _, _ = models[arch]
    runs = {}
    for graphs in (True, False):
        eng = LPUEngine(model, params, EngineConfig(
            **GEOM, paged=False, steps_per_sync=4), device="cpu",
            graphs=graphs, seed=3)
        greedy = eng.submit(PROMPTS[4], 40)
        for _ in range(3):
            eng.step()
        keys = set(eng._programs._by_key)
        sampled = eng.submit(PROMPTS[2], 12, SamplingParams(0.9, 0, 1.0))
        out = eng.drain()
        if graphs:
            assert keys == {("window", 4, False)}
            assert ("window", 4, True) in eng._programs._by_key
        runs[graphs] = (out[greedy], out[sampled])
    assert runs[True] == runs[False]


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_launch_registry_and_replay_accounting():
    """A capture's launches are held (the counters restored) and every
    replay adds them back; a replay never calls the eager function."""
    fns = kernels.counted()
    assert [f.__name__ for f in fns] == [
        "gemv", "paged_decode_attention", "decode_attention", "rwkv_scan",
        "mamba_scan", "mamba_scan_fused"]
    kernels.reset_launches()
    with kernels.held_launches() as made:
        fns[1].launches += 30
        fns[0].launches += 4
    assert made == {"gemv": 4, "paged_decode_attention": 30,
                    "decode_attention": 0, "rwkv_scan": 0, "mamba_scan": 0,
                    "mamba_scan_fused": 0}
    assert kernels.read_launches() == dict.fromkeys(made, 0)
    progs = Programs("cpu")
    prog = Program(_FakeGraph(), made)
    progs.run(prog, lambda: pytest.fail("a replay ran the function"))
    progs.run(prog, lambda: pytest.fail("a replay ran the function"))
    assert prog.graph.replays == 2 and progs.replays == 2
    assert kernels.read_launches()["paged_decode_attention"] == 60
    assert kernels.read_launches()["gemv"] == 8
    called = []
    progs.run(None, lambda: called.append(1))
    progs.run(Program(None), lambda: called.append(1))
    assert called == [1, 1] and progs.replays == 2
    kernels.reset_launches()


def test_no_cyclic_collection_inside_a_capture(models, monkeypatch):
    """An engine dropped in a reference cycle (here a callback closed
    over it, as a user's ``stream_cb`` may be) in the middle of another
    program's capture is not freed until the capture has ended: on the
    card a graph freed by the cyclic collector inside a capture
    invalidates it.  The CUDA calls of a capture are stood in for on the
    CPU; the captured function drops the cycle and allocates enough to
    set off the collector."""
    model, params, kw, _ = models["smollm-135m"]
    capturing, freed = [False], []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        capturing[0] = True
        try:
            yield
        finally:
            capturing[0] = False

    class Stream:
        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass
    for name, value in dict(
            graph=graph, CUDAGraph=_FakeGraph, Stream=Stream,
            current_stream=lambda *a: Stream(), graph_pool_handle=tuple,
            stream=lambda s: contextlib.nullcontext()).items():
        monkeypatch.setattr(torch.cuda, name, value)
    eng = LPUEngine(model, params, EngineConfig(**GEOM, **kw), device="cpu")
    weakref.finalize(eng, lambda: freed.append(capturing[0]))

    def cycle_to(engine):
        held = {"engine": engine}
        held["stream_cb"] = lambda rid, tok: held["engine"]
        return held
    box = [cycle_to(eng)]
    del eng

    def fn():
        if capturing[0]:
            box.clear()
            junk = [[] for _ in range(100_000)]
            del junk
    progs = Programs("cpu")
    progs.device = types.SimpleNamespace(type="cuda")
    assert gc.isenabled()
    progs.get(("probe",), fn, generator=None, held=contextlib.nullcontext)
    assert progs.captures == 1 and gc.isenabled() and freed == []
    gc.collect()
    assert freed == [False]


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 5, 0.85),
                                              (0.7, 0, 1.0)])
def test_stochastic_window_matches_target_distribution(models, temp, top_k,
                                                       top_p):
    """The stochastic window's draws from a fixed logits row (the decode
    forward stubbed) against the reference's filtered target
    softmax(_filter_row(row)): the sampler's gate, TV < 0.02."""
    model, params, kw, _ = models["smollm-135m"]
    V = 8
    eng = LPUEngine(model, params, EngineConfig(
        slots=4, max_seq=4096, steps_per_sync=8), device="cpu", seed=5)
    row = (np.random.default_rng(3).standard_normal(V) * 2).astype(
        np.float32)
    stub = torch.from_numpy(np.repeat(row[None], 4, 0))
    eng._decode_fn = lambda *a: stub
    n_new = 2001
    outs = eng.generate([[1, 2, 3]] * 4, n_new,
                        SamplingParams(temp, top_k, top_p))
    draws = [t for o in outs for t in o[1:]]        # o[0]: the prefill row
    n = len(draws)
    assert n == 4 * (n_new - 1)
    assert ("window", 8, True) in eng._programs._by_key
    p = np.asarray(jax.nn.softmax(jax_sampler._filter_row(
        jnp.asarray(row), jnp.float32(temp), jnp.int32(top_k),
        jnp.float32(top_p))))
    counts = collections.Counter(draws)
    assert set(counts) <= {i for i in range(V) if p[i] > 0}
    tv = 0.5 * sum(abs(counts.get(i, 0) / n - p[i]) for i in range(V))
    assert tv < 0.02
