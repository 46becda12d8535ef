"""The engine's admission side on its static buffers
(``repro_torch/serving/graphs.py``), as the card replays it: the
monolithic prefill per bucket, the chunk program per C (prefill chunks
and prefix tails), the first-token sampler, the copy-on-write block copy
and the host-sampled decode step.  On the CPU each program is the
function it was first built from, run after the same warm-up on dead
inputs, so a value baked into a program's closure shows here as it
would on the card.

Greedy streams of the reduced smollm-135m and opt-1.3b against the
reference's ``LPUEngine`` and the port's eager twin (``graphs=False``):
two prompt lengths in one bucket, chunks whose start and last length
differ, prefix tails of different lengths in one C, copy-on-write, an
int8 pool, the dense cache, host sampling; programs by key and
``prefill_traces``; a capture mid-stream; the sampled first token; the
replay of a program's first function; and an engine's programs freed
with it by reference count.
"""
import contextlib
import gc
import weakref

import numpy as np
import pytest

from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch import kernels
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from repro_torch.serving.graphs import Programs
from repro_torch.serving.sampler import SamplingParams
from tests.torch_dense_util import one_torch_thread, reduced_pair  # noqa: F401

VOCAB = 512                 # both reduced configs
MAX_NEW = 4
GEOM = dict(slots=3, max_seq=64)


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, VOCAB, size=n))) for n in lengths]


SYS = _prompts(5, [16])[0]                    # two blocks of 8
# a prefix hit's tail is prefilled by the chunk program at C =
# bucket(n - start) = 16 whatever its length; the bare system prompt
# hits 15 tokens and its 1-token tail writes into a shared block
PREFIX = [SYS + t for t in _prompts(6, [3, 5])] + [list(SYS)]

# name: (arch, engine knobs, prompts, warm-up prompt served first,
# the admission programs the run builds)
CASES = {
    # 9 and 13 tokens share bucket 16 (the dense case runs two buckets)
    "bucket": ("smollm-135m", dict(block_size=8), _prompts(1, [9, 13]),
               None, {("prefill", 16), ("sample", False)}),
    # chunks of 5: starts 0, 5, 10 and last lengths 2, 4 and 3
    "chunks": ("smollm-135m", dict(block_size=8, prefill_chunk=5),
               _prompts(2, [12, 14, 3]), None,
               {("chunk", 5), ("sample", False)}),
    "prefix-cow": ("smollm-135m", dict(block_size=8, prefix_cache=True),
                   PREFIX, SYS, {("prefill", 16), ("chunk", 16),
                                 ("sample", False), ("cow",)}),
    "int8": ("smollm-135m", dict(block_size=8, kv_dtype="int8"),
             _prompts(3, [7, 11]), None,
             {("prefill", 16), ("sample", False)}),
    "dense": ("smollm-135m", dict(paged=False), _prompts(4, [5, 18]), None,
              {("prefill", 16), ("prefill", 32), ("sample", False)}),
    "host-sampling": ("smollm-135m", dict(block_size=8, sampling="host"),
                      _prompts(7, [6, 10]), None,
                      {("prefill", 16), ("host_decode",)}),
    "opt-chunks-prefix": ("opt-1.3b", dict(block_size=8, prefill_chunk=8,
                                           prefix_cache=True),
                          PREFIX, SYS,
                          {("chunk", 8), ("sample", False), ("cow",)}),
}


@pytest.fixture(scope="module")
def pairs():
    """Per arch: the reference's (model, params) and the port's, on the
    same weights (every bias and the learned positions redrawn)."""
    out = {}
    for arch in ("smollm-135m", "opt-1.3b"):
        (_, _, jmodel, jparams), (_, _, model, params) = reduced_pair(arch)
        out[arch] = ((jmodel, jparams), (model, params))
    return out


def _serve(eng, prompts, warm):
    if warm is not None:
        eng.generate([warm], max_new_tokens=2)
    return eng.generate(prompts, max_new_tokens=MAX_NEW)


def _stats(eng):
    d = dict(vars(eng.stats))
    for k in ("wall", "graph_captures", "graph_replays"):
        d.pop(k)
    return d


@pytest.mark.parametrize("case", list(CASES))
def test_admission_streams_match_reference_and_eager_twin(pairs, case):
    arch, kw, prompts, warm, keys = CASES[case]
    (jmodel, jparams), (model, params) = pairs[arch]
    ref_eng = JaxEngine(jmodel, jparams, JaxEngineConfig(**GEOM, **kw))
    ref = _serve(ref_eng, prompts, warm)
    runs = {}
    for graphs in (True, False):
        eng = LPUEngine(model, params, EngineConfig(**GEOM, **kw),
                        device="cpu", graphs=graphs)
        kernels.reset_launches()
        runs[graphs] = (_serve(eng, prompts, warm), eng,
                        kernels.read_launches())
        eng.check_pool_balanced()
    (got, eng, launches), (eager, twin, twin_launches) = runs[True], \
        runs[False]
    assert got == ref
    assert eager == ref
    assert _stats(eng) == _stats(twin) and launches == twin_launches
    # one program per key, as the reference traces one program per
    # bucket and per C; the eager twin builds none
    assert set(eng._admit._by_key) == keys
    assert not twin._admit._by_key
    # prefill_traces keeps its meaning: the distinct monolithic buckets
    # and chunk sizes run (the reference's _buckets_traced)
    assert eng.stats.prefill_traces == len(
        {k[1] for k in keys if k[0] == "prefill"}
        | {k for k in keys if k[0] == "chunk"}) == ref_eng.stats.prefill_traces
    if "cow" in case:
        assert eng.stats.cow_blocks > 0 and eng.stats.prefix_hits >= 3
    if "chunk" in case:
        assert eng.stats.prefill_chunks > len(prompts)
    assert eng.stats.graph_captures == eng.stats.graph_replays == 0


@pytest.mark.parametrize("paged", [False, True])
def test_capture_mid_stream_leaves_resident_stream_unchanged(pairs, paged):
    """A greedy stream decodes in slot 0 while a sampled request arrives
    whose prefill needs a new program: a new bucket on the dense cache,
    a prefix hit's tail on the paged pool (its chunk program).  That
    program and the stochastic sampler are warmed up and captured
    mid-stream.  The dense prefill's warm-up writes slot 0, the chunk's
    the null block, and the sampler's draws from the generator; all is
    restored, so both streams equal the eager twin's."""
    _, (model, params) = pairs["smollm-135m"]
    if paged:
        kw, new_key = dict(block_size=8, prefix_cache=True), ("chunk", 16)
        first, second = SYS + [7], SYS + [9, 4, 2, 8]
    else:
        kw, new_key = dict(paged=False), ("prefill", 32)
        first, second = _prompts(8, [5, 20])
    runs = {}
    for graphs in (True, False):
        eng = LPUEngine(model, params, EngineConfig(**GEOM, **kw),
                        device="cpu", graphs=graphs, seed=3)
        greedy = eng.submit(first, 16)
        for _ in range(4):
            eng.step()
        before = set(eng._admit._by_key)
        sampled = eng.submit(second, 8, SamplingParams(0.9, 0, 1.0))
        out = eng.drain()
        if graphs:
            assert {new_key, ("sample", True)} <= \
                set(eng._admit._by_key) - before
        runs[graphs] = (out[greedy], out[sampled])
    assert runs[True] == runs[False]


def test_sampled_first_token_matches_eager_twin(pairs):
    """The stochastic sampler's program draws what the eager sampler
    draws under one seed: its warm-up's draws are undone."""
    _, (model, params) = pairs["smollm-135m"]
    toks = {}
    for graphs in (True, False):
        eng = LPUEngine(model, params, EngineConfig(**GEOM, block_size=8),
                        device="cpu", graphs=graphs, seed=11)
        toks[graphs] = eng.generate(_prompts(9, [4, 9, 4, 13]), 1,
                                    SamplingParams(1.0, 40, 0.95))
    assert toks[True] == toks[False]
    assert len({t[0] for t in toks[True]}) > 1


def test_program_replays_the_function_it_was_built_from():
    """On the CPU a program is the function of its first call, as a
    replay runs what the capture recorded: a later call's closure (here
    with another int baked in) is not run.  The eager twin (no program)
    runs the current function."""
    progs = Programs("cpu")
    seen = []
    for n in (1, 2, 3):
        fn = lambda n=n: seen.append(n)                     # noqa: E731
        prog = progs.get(("k",), fn, generator=None,
                         held=contextlib.nullcontext)
        progs.run(prog, fn)
    assert seen == [1, 1, 1, 1]          # the warm-up, then three runs
    progs.run(None, lambda: seen.append(4))
    assert seen[-1] == 4
    assert progs.captures == progs.replays == 0


def test_engine_and_programs_hold_no_reference_cycle(pairs):
    """On the card an engine's graphs are freed with it, by reference
    count.  An object in a reference cycle waits for the cyclic
    collector instead, which may run in the middle of another engine's
    capture, and a graph freed there invalidates that capture.  (On the
    CPU a program keeps its function, a closure over the engine; a
    card's program keeps only its graph, as this test makes them.)"""
    _, (model, params) = pairs["smollm-135m"]
    eng = LPUEngine(model, params, EngineConfig(**GEOM, block_size=8,
                                                prefix_cache=True),
                    device="cpu")
    eng.generate(PREFIX, 2)
    assert eng._admit._by_key and eng._programs._by_key
    for progs in (eng._programs, eng._admit):
        for prog in progs._by_key.values():
            prog.fn = None
    gc.disable()
    try:
        refs = [weakref.ref(o) for o in (eng, eng._programs, eng._admit)]
        del eng, progs, prog
        assert [r() for r in refs] == [None] * 3
    finally:
        gc.enable()
