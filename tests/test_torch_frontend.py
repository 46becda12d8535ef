"""The port's async serving front end (``repro_torch/serving/frontend.py``,
``budget.py``) against the reference's ``AsyncFrontend`` on the reduced
smollm-135m, f32, the reference's weights carried across
(``tests/torch_dense_util.py``).

Every scenario of ``tests/test_frontend.py`` — streaming parity on one
engine and on a two-ring fleet, budget scheduling, cancellation in the
middle of a stream and in the queue, structured backpressure,
``max_pending`` from the config, a failed request surfacing through its
stream, trace replay with telemetry — runs through both front ends on
the same prompts, and the port's streams, statuses and counters equal
the reference front end's exactly, and the port's blocking streams.
The reference engines are built once per configuration and reused
across scenarios (a drained engine serves the next front end as a fresh
one would, greedy).  Then the engine seam ``set_step_knobs``: S = 1..16
and C in {8, 16, 32, 64} between the steps of one engine, its streams
the fixed-knob engine's, every window output buffer keeping its address
across the run and a ``reset()``; and the serve CLI's front-end path.
"""
import asyncio
import contextlib
import io
import time
import types

import pytest

from repro.serving import budget as jax_budget
from repro.serving import engine as jax_engine
from repro.serving import frontend as jax_frontend
from repro.serving import tracker as jax_tracker
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro_torch.launch import serve
from repro_torch.serving import budget, engine, frontend, tracker
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.traces import TraceConfig, generate_trace
from tests.torch_dense_util import (one_torch_thread,  # noqa: F401
                                    reduced_pair, reference_compile_cache)

PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [1, 2, 3, 4, 5, 6]]
ECONF = dict(slots=2, max_seq=64, paged=True, block_size=16)
REF = types.SimpleNamespace(fe=jax_frontend, budget=jax_budget,
                            tracker=jax_tracker, engine=jax_engine)
PORT = types.SimpleNamespace(fe=frontend, budget=budget, tracker=tracker,
                             engine=engine)


@pytest.fixture(scope="module")
def pair():
    (_, _, jmodel, jparams), (_, _, model, params) = \
        reduced_pair("smollm-135m")
    return (jmodel, jparams), (model, params)


@pytest.fixture(scope="module")
def engines(pair):
    """``get(side, rings=0, **knobs)``: an engine (or a two-ring host
    fleet) of the reference (side ``REF``) or the port.  The reference's
    are built once per configuration and reused, the port's anew."""
    (jmodel, jparams), (model, params) = pair
    cache = {}

    def get(side, rings=0, **knobs):
        key = (rings, repr(sorted(knobs.items())))
        if side is REF and key in cache:
            return cache[key]
        kw = dict(ECONF, **knobs)
        if side is REF:
            conf = JaxEngineConfig(**kw)
            eng = (jax_engine.MultiRingEngine(jmodel, jparams, None,
                                              rings=rings, config=conf)
                   if rings else jax_engine.LPUEngine(jmodel, jparams, conf))
            cache[key] = eng
            return eng
        conf = EngineConfig(**kw)
        return (engine.MultiRingEngine(model, params, None, rings=rings,
                                       config=conf, device="cpu")
                if rings else engine.LPUEngine(model, params, conf,
                                               device="cpu"))
    return get


def _ledger_ok(fe):
    c = fe.counters
    assert c["completed"] + c["failed"] + c["cancelled"] == c["submitted"]


def _pools(eng):
    for e in getattr(eng, "engines", [eng]):
        e.check_pool_balanced()


async def _parity(kit, eng, fe_kw):
    async with kit.fe.AsyncFrontend(eng, **fe_kw) as fe:
        streams = [fe.submit(p, 8) for p in PROMPTS]
        outs = [await s.drain() for s in streams]
    _ledger_ok(fe)
    return outs, [s.status for s in streams], fe.counters


@pytest.mark.parametrize("rings", [0, 2], ids=["tp1", "2ring-fleet"])
def test_streaming_parity(engines, rings):
    """The front end is a facade: its greedy streams equal the blocking
    path's, on one engine and on a mesh-free two-ring fleet."""
    ref = asyncio.run(_parity(REF, engines(REF, rings), {}))
    eng = engines(PORT, rings)
    ours = asyncio.run(_parity(PORT, eng, {}))
    assert ours == ref
    outs, statuses, counters = ours
    assert statuses == ["completed"] * len(PROMPTS)
    assert counters["completed"] == len(PROMPTS)
    assert outs == engines(PORT, rings).generate(PROMPTS, 8)
    _pools(eng)


def test_budget_scheduling_keeps_parity(engines):
    """SLO retuning changes when tokens are read back, never which: the
    budget-driven front end streams what the fixed-knob blocking engine
    does, while the planner runs and measures real steps (its plans
    follow each package's own step times, so they are not compared)."""
    buds = {}

    def run(kit):
        bud = buds[kit is REF] = kit.budget.BudgetScheduler(
            5.0, prior_step_s=2e-3, max_chunk=32)
        eng = engines(kit, prefill_chunk=16)
        return asyncio.run(_parity(kit, eng, dict(budget=bud))), eng
    ref, _ = run(REF)
    ours, eng = run(PORT)
    assert ours == ref
    assert ours[0] == engines(PORT, prefill_chunk=16).generate(PROMPTS, 8)
    bud = buds[False]
    assert bud.planned and bud.observed_windows > 0
    assert all(c is None or 8 <= c <= 32 for c, _ in bud.planned)
    assert all(1 <= s <= budget.MAX_STEPS_PER_SYNC for _, s in bud.planned)
    assert eng.prefill_chunk in {8, 16, 32}
    _pools(eng)


async def _cancel_mid_stream(kit, eng):
    async with kit.fe.AsyncFrontend(eng) as fe:
        victim = fe.submit([1, 2, 3], 40)
        mate = fe.submit([4, 5], 6)
        got = 0
        async for _ in victim:
            got += 1
            if got == 3:
                assert await victim.cancel()
                break
        await fe.join()
    _ledger_ok(fe)
    again = (await victim.cancel(), await mate.cancel())
    return (victim.tokens, victim.status, mate.tokens, mate.status,
            fe.counters, again)


def test_cancel_mid_stream_frees_blocks(engines):
    ref = asyncio.run(_cancel_mid_stream(REF, engines(REF)))
    eng = engines(PORT)
    ours = asyncio.run(_cancel_mid_stream(PORT, eng))
    assert ours == ref
    vtoks, vstatus, _, mstatus, counters, again = ours
    assert vstatus == "cancelled" and len(vtoks) < 40
    assert mstatus == "completed" and counters["cancelled"] == 1
    assert again == (False, False)       # double cancel, cancel after end
    assert eng.stats.cancelled_requests == 1
    _pools(eng)                          # no pool block leaked


async def _cancel_queued(kit, eng):
    # slots=2 and 3 submits: the third waits in the scheduler's queue and
    # is removed before it ever owns a block
    async with kit.fe.AsyncFrontend(eng) as fe:
        a = fe.submit([1, 2, 3], 6)
        b = fe.submit([4, 5], 6)
        c = fe.submit([6, 7, 8], 6)
        assert await c.cancel()
        outs = [await s.drain() for s in (a, b)]
    return outs, c.status, c.tokens, fe.counters


def test_cancel_queued_request(engines):
    ref = asyncio.run(_cancel_queued(REF, engines(REF)))
    eng = engines(PORT)
    ours = asyncio.run(_cancel_queued(PORT, eng))
    assert ours == ref
    outs, status, toks, _ = ours
    assert status == "cancelled" and toks == []
    assert [len(o) for o in outs] == [6, 6]
    _pools(eng)


async def _backpressure(kit, eng):
    async with kit.fe.AsyncFrontend(eng, max_pending=2) as fe:
        s1 = fe.submit([1, 2, 3], 6)
        s2 = fe.submit([4, 5], 6)
        with pytest.raises(kit.fe.AdmissionRejected) as exc:
            fe.submit([6, 7], 6)
        fields = (exc.value.pending, exc.value.limit,
                  fe.counters["rejected"])
        outs = [await s1.drain(), await s2.drain()]
        s3 = fe.submit([6, 7], 6)        # capacity freed: admission opens
        outs.append(await s3.drain())
    return fields, outs, fe.counters


def test_backpressure_structured_rejection(engines):
    ref = asyncio.run(_backpressure(REF, engines(REF)))
    ours = asyncio.run(_backpressure(PORT, engines(PORT)))
    assert ours == ref
    fields, outs, counters = ours
    assert fields == (2, 2, 1) and all(outs)
    assert counters["submitted"] == 3


async def _max_pending_from_config(kit, eng):
    async with kit.fe.AsyncFrontend(eng) as fe:
        limit = fe.max_pending
        s = fe.submit([1, 2, 3], 4)
        with pytest.raises(kit.fe.AdmissionRejected):
            fe.submit([4, 5], 4)
        await fe.join()
    return limit, s.tokens, s.status, fe.counters


def test_max_pending_flows_from_config(engines):
    ref = asyncio.run(_max_pending_from_config(
        REF, engines(REF, max_pending=1)))
    ours = asyncio.run(_max_pending_from_config(
        PORT, engines(PORT, max_pending=1)))
    assert ours == ref
    assert ours[0] == 1 and ours[3]["rejected"] == 1


async def _failed_request(kit, eng):
    # a request whose resume state can never fit is rejected by the
    # scheduler in the middle of serving; its stream ends "failed" with
    # the error, and the consumer does not hang
    async with kit.fe.AsyncFrontend(eng) as fe:
        big = kit.engine.Request(7, list(range(1, 11)), 50)
        big.out = list(range(100, 145))    # resume needs 4 blocks
        rid = eng.submit(big)
        stream = kit.fe.TokenStream(rid, fe, kit.tracker.RequestTimeline(
            rid, time.perf_counter()))
        fe._streams[rid] = stream
        fe._inflight[rid] = stream
        fe.counters["submitted"] += 1
        fe._idle.clear()
        fe._wake.set()
        ok = fe.submit([1, 2, 3], 4)
        await stream.drain()
        await ok.drain()
    _ledger_ok(fe)
    return (stream.status, stream.error, stream.tokens, ok.status,
            ok.tokens, fe.counters)


def test_failed_request_surfaces_through_stream(engines):
    ref = asyncio.run(_failed_request(REF, engines(REF, num_blocks=3)))
    eng = engines(PORT, num_blocks=3)
    ours = asyncio.run(_failed_request(PORT, eng))
    assert ours == ref
    status, error, _, ok_status, _, counters = ours
    assert status == "failed" and "blocks" in error
    assert ok_status == "completed" and counters["failed"] == 1
    _pools(eng)


TRACE = TraceConfig(seed=3, requests=6, tenants=2, prefix_len=16,
                    tail_max=8, max_new_max=6, rate_rps=1000.0)


async def _trace_replay(kit, fleet, trace):
    sink = kit.tracker.RingBufferTracker(512)
    async with kit.fe.AsyncFrontend(fleet, tracker=sink) as fe:
        streams = await kit.fe.serve_trace(fe, trace, speed=100.0)
    return [(s.status, s.tokens) for s in streams], sink.records()


def test_serve_trace_replay_and_telemetry(engines):
    """The port's trace, replayed through both front ends on two-ring
    fleets with the prefix cache: the same streams, one ``request``
    record per request, and each ring's ``engine_window`` deltas
    summing to its cumulative counters."""
    trace = generate_trace(TRACE)
    ref, _ = asyncio.run(_trace_replay(
        REF, engines(REF, rings=2, prefix_cache=True), trace))
    fleet = engines(PORT, rings=2, prefix_cache=True)
    ours, records = asyncio.run(_trace_replay(PORT, fleet, trace))
    assert ours == ref
    assert all(status == "completed" for status, _ in ours)
    blocking = engines(PORT, rings=2, prefix_cache=True)
    rids = [blocking.submit(r.prompt, r.max_new_tokens) for r in trace]
    res = blocking.drain()
    assert [t for _, t in ours] == [res[r] for r in rids]
    kinds = {r["kind"] for r in records}
    assert kinds == {"engine_window", "request"}
    reqs = [r for r in records if r["kind"] == "request"]
    assert sorted(r["rid"] for r in reqs) == list(range(len(trace)))
    assert all(r["ttft_ms"] >= 0 for r in reqs)
    for i, eng in enumerate(fleet.engines):
        sums = dict.fromkeys(tracker.counter_fields(eng.stats), 0)
        for r in records:
            if r["kind"] == "engine_window" and r["ring"] == i:
                for k, v in r["delta"].items():
                    sums[k] += v
        assert sums == tracker.snapshot_stats(eng.stats)
    _pools(fleet)


async def _mixed_run(fe):
    """A completed, a cancelled and (on a fleet with no migrations left)
    failed streams."""
    async with fe:
        streams = [fe.submit(p, 8) for p in PROMPTS]
        async for _ in streams[1]:
            await streams[1].cancel()
            break
        await fe.join()
    return streams


@pytest.mark.parametrize("rings", [0, 2], ids=["engine", "2ring-fleet"])
def test_engine_behind_a_front_end_is_freed_by_reference_count(pair, rings):
    """Dropping the front end, its streams and the engine frees the
    engine and its programs by reference count: the front end holds no
    reference cycle through its streams or through the ``stream_cb`` of
    a request that ended (completed, cancelled or failed on a fleet).
    An engine left to the cyclic collector may be freed in the middle of
    another engine's capture, and a graph freed there invalidates that
    capture.  (On the CPU a program keeps its function, a closure over
    the engine; a card's program keeps only its graph, as this test
    makes them.)"""
    import gc
    import weakref
    _, (model, params) = pair
    if rings:
        eng = engine.MultiRingEngine(
            model, params, None, rings=rings, device="cpu",
            config=EngineConfig(**ECONF, chaos="ring@2", max_migrations=0))
    else:
        eng = engine.LPUEngine(model, params, EngineConfig(**ECONF),
                               device="cpu")
    fe = frontend.AsyncFrontend(eng)
    streams = asyncio.run(_mixed_run(fe))
    statuses = {s.status for s in streams}
    assert statuses >= {"completed", "cancelled"}
    assert ("failed" in statuses) == bool(rings)
    parts = getattr(eng, "engines", [eng])
    for e in parts:
        for progs in (e._programs, e._admit):
            for prog in progs._by_key.values():
                prog.fn = None
    gc.collect()
    gc.disable()
    try:
        refs = [weakref.ref(o) for o in [eng, fe] + [
            p for e in parts for p in (e, e._programs, e._admit)]]
        del eng, fe, streams, parts, e, progs, prog
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


def test_set_step_knobs_sweep_keeps_streams_and_buffers(pair):
    """``set_step_knobs`` between the steps of one chunked engine, S
    through 1..16 and C through 8, 16, 32, 64: the streams equal a
    fixed-knob engine's, every S's window output buffer is made once, by
    the first window of that length (before its program is built), and
    keeps its address through the run, a ``reset()`` and a second run."""
    import numpy as np
    _, (model, params) = pair
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(1, 500, size=n)]
               for n in (21, 9, 40, 3, 30, 17, 12, 5)]
    conf = EngineConfig(slots=2, max_seq=128, paged=True, block_size=16,
                        prefill_chunk=8)
    base = engine.LPUEngine(model, params, conf,
                            device="cpu").generate(prompts, 56)
    eng = engine.LPUEngine(model, params, conf, device="cpu")
    ptrs, wins = {}, []
    dispatch = eng._dispatch_window

    def spy(win, *a):
        wins.append(win)
        return dispatch(win, *a)
    eng._dispatch_window = spy

    def sweep():
        rids = [eng.submit(p, 56) for p in prompts]
        k = 0
        while eng.has_work():
            eng.set_step_knobs(prefill_chunk=(8, 16, 32, 64)[k % 4],
                               steps_per_sync=k % 16 + 1)
            k += 1
            eng.step()
            for s, buf in eng._win_out.items():
                assert ptrs.setdefault(s, buf.data_ptr()) == buf.data_ptr()
                assert eng._tok_out[s].data_ptr() == buf.data_ptr()
        res = eng.drain()
        return [res[r] for r in rids]
    assert sweep() == base
    assert set(wins) >= set(range(2, 17))
    assert set(eng._win_out) == set(wins)     # made by the windows run
    eng.reset()
    assert {s: b.data_ptr() for s, b in eng._win_out.items()} == ptrs
    assert sweep() == base
    eng.check_pool_balanced()


@pytest.mark.parametrize("knobs,match", [
    (dict(steps_per_sync=0), "steps_per_sync"),
    (dict(prefill_chunk=-1), "prefill_chunk"),
    (dict(prefill_chunk=0), "mid-serve")])
def test_set_step_knobs_refusals(pair, knobs, match):
    """The constructor's checks, and no way back from chunked mode."""
    _, (model, params) = pair
    eng = engine.LPUEngine(model, params, EngineConfig(
        **ECONF, prefill_chunk=8), device="cpu")
    with pytest.raises(ValueError, match=match):
        eng.set_step_knobs(**knobs)


def test_serve_cli_front_end(tmp_path, capsys):
    """``--budget-ms 5 --max-pending 2 --tracker PATH`` serves the batch
    through the front end: the reference's summary lines, the jsonl read
    back and validated, the streams the blocking run's."""
    path = tmp_path / "t.jsonl"
    outs = serve.main(["--device", "cpu", "--reduced", "--budget-ms", "5",
                       "--max-pending", "2", "--tracker", str(path)])
    out = capsys.readouterr().out
    assert "[serve] frontend: 8 completed 0 failed 0 cancelled " \
        "(3 backpressure rejections, 3 retried)" in out
    assert "[serve] ttft p50/max " in out and "ms/token p50/max" in out
    assert "[serve] budget=5.0ms: " in out
    recs = tracker.read_jsonl(str(path))
    assert f"[serve] tracker: {len(recs)} records -> {path}" in out
    kinds = [r["kind"] for r in recs]
    assert kinds.count("request") == 8 and kinds.count("event") == 3
    assert kinds.count("engine_window") > 0
    with contextlib.redirect_stdout(io.StringIO()):
        plain = serve.main(["--device", "cpu", "--reduced"])
    assert outs == plain
