"""The port's serving telemetry (``repro_torch/serving/tracker.py``) and
trace generator (``traces.py``) against the reference's
(``src/repro/serving/tracker.py``, ``benchmarks/traces.py``), on the
reduced smollm-135m, f32, the reference's weights carried across.

The cases of ``tests/test_tracker.py`` on the port: the record schema
and the sinks (fed the same records as the reference's, with the same
verdicts), the request timeline, the ``stats_delta`` contract, and the
``EngineStats`` delta accounting on the port's engine and fleet —
deltas summing to the cumulative counters on one engine (its per-window
deltas equal to the reference engine's on every counter both keep),
across a ring failure with a migration, across ``reset()``, and quiet
windows skipped — plus the same sums through the async front end on a
chaotic fleet.  Then ``generate_trace`` equal to the reference's for
three configurations.
"""
import json
import math
import sys
from pathlib import Path

import pytest

from repro.serving import tracker as jax_tracker
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import EngineStats, LPUEngine, MultiRingEngine
from repro_torch.serving.traces import TraceConfig, generate_trace
from repro_torch.serving.tracker import (CompositeTracker, EngineTap,
                                         JsonlTracker, NullTracker,
                                         RequestTimeline, RingBufferTracker,
                                         counter_fields, read_jsonl,
                                         snapshot_stats, stats_delta,
                                         validate_record)
from tests.torch_dense_util import (one_torch_thread,  # noqa: F401
                                    reduced_pair, reference_compile_cache)

ECONF = dict(slots=2, max_seq=64, paged=True, block_size=16)


@pytest.fixture(scope="module")
def pair():
    (_, _, jmodel, jparams), (_, _, model, params) = \
        reduced_pair("smollm-135m")
    return (jmodel, jparams), (model, params)


# -- schema / sinks (no model) -------------------------------------------


WINDOW_REC = {"kind": "engine_window", "t": 1.0, "ring": 0, "step": 3,
              "dt_ms": 2.5, "delta": {"steps": 1, "tokens": 2}}
REQ_REC = {"kind": "request", "t": 2.0, "rid": 7, "status": "completed",
           "tokens": 5, "ttft_ms": 12.0, "ms_per_token": 3.0}
BAD_RECS = (
    {"kind": "nope", "t": 0.0},
    {"kind": "engine_window", "t": float("nan"), "ring": 0, "step": 0,
     "dt_ms": 0.0, "delta": {}},
    {**WINDOW_REC, "delta": {"steps": -1}},      # a counter fell
    {**WINDOW_REC, "dt_ms": -1.0},
    {**WINDOW_REC, "delta": [1]},
    {k: v for k, v in REQ_REC.items() if k != "ttft_ms"},
    {**REQ_REC, "status": "exploded"},
    {**REQ_REC, "tokens": -1},
    {"kind": "event", "t": 0.0},
    "not a dict",
)


def _verdict(validate, rec):
    try:
        validate(rec)
    except ValueError as e:
        return str(e)
    return None


def test_validate_record_rejects_malformed():
    """The reference's verdict, message and all, on every record."""
    good = (WINDOW_REC, REQ_REC, {"kind": "event", "t": 0.0, "name": "x"})
    for rec in good + BAD_RECS:
        assert _verdict(validate_record, rec) == \
            _verdict(jax_tracker.validate_record, rec)
    assert all(_verdict(validate_record, r) is None for r in good)
    assert all(_verdict(validate_record, r) for r in BAD_RECS)


def test_jsonl_sink_round_trips(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with JsonlTracker(path) as tr:
        tr.log(WINDOW_REC)
        tr.log(REQ_REC)
        with pytest.raises(ValueError):
            tr.log({"kind": "request", "t": 0.0})   # invalid: not written
    assert tr.written == 2
    assert read_jsonl(path) == [WINDOW_REC, REQ_REC]
    with open(path) as fh:
        for line in fh:                 # every line is standalone JSON
            json.loads(line)
    # the reference's sink writes the same bytes
    ref_path = str(tmp_path / "r.jsonl")
    with jax_tracker.JsonlTracker(ref_path) as tr:
        tr.log(WINDOW_REC)
        tr.log(REQ_REC)
    assert Path(ref_path).read_bytes() == Path(path).read_bytes()


def test_ring_buffer_windows_correctly():
    tr = RingBufferTracker(capacity=3)
    for i in range(5):
        tr.log({"kind": "event", "t": float(i), "name": f"e{i}"})
    assert tr.seen == 5
    assert [r["name"] for r in tr.records()] == ["e2", "e3", "e4"]
    assert [r["name"] for r in tr.window(2)] == ["e3", "e4"]
    assert [r["name"] for r in tr.window(99)] == ["e2", "e3", "e4"]
    assert tr.window(0) == []
    with pytest.raises(ValueError):
        tr.window(-1)
    with pytest.raises(ValueError):
        RingBufferTracker(0)


def test_composite_fans_out():
    a, b = RingBufferTracker(8), RingBufferTracker(8)
    CompositeTracker([a, b]).log(WINDOW_REC)
    assert a.records() == b.records() == [WINDOW_REC]
    NullTracker().log(WINDOW_REC)                   # silently fine


def test_request_timeline_ttft_monotone():
    ts = [10.4, 10.5, 10.7, 11.0]
    tl, ref = (RequestTimeline(1, t_submit=10.0, tenant="a"),
               jax_tracker.RequestTimeline(1, t_submit=10.0, tenant="a"))
    for t in ts:
        tl.on_token(t)
        ref.on_token(t)
    assert tl.ttft_ms == pytest.approx(400.0)
    # ms/token averages the gaps after the first token only
    assert tl.ms_per_token == pytest.approx((11.0 - 10.4) * 1e3 / 3)
    rec = tl.record("completed", 11.0)
    validate_record(rec)
    assert rec == ref.record("completed", 11.0)
    assert rec["tenant"] == "a" and rec["tokens"] == 4
    assert rec["ttft_ms"] <= (11.0 - 10.0) * 1e3
    # a tokenless (cancelled before prefill) timeline stays valid
    empty = RequestTimeline(2, 0.0).record("cancelled", 1.0)
    validate_record(empty)
    assert empty["ttft_ms"] == -1.0 and empty["tokens"] == 0
    assert math.isnan(RequestTimeline(3, 0.0).ttft_ms)


def test_stats_delta_monotone_contract():
    a = {"steps": 1, "tokens": 4}
    b = {"steps": 3, "tokens": 9}
    assert stats_delta(a, b) == {"steps": 2, "tokens": 5}
    with pytest.raises(ValueError):
        stats_delta(b, a)                           # a fall must raise
    names = counter_fields(EngineStats())
    assert "peak_pool_blocks" not in names and "wall" not in names
    assert "tokens" in names and "preemptions" in names
    # the reference's counters, and the port's own: the decode forwards
    # dispatched and the CUDA graphs captured and replayed
    from repro.serving.engine import EngineStats as JaxStats
    assert set(names) - set(jax_tracker.counter_fields(JaxStats())) == {
        "device_decode_steps", "graph_captures", "graph_replays"}


# -- delta accounting against the port's engine ---------------------------


def _run_with_tap(engine_or_fleet, engines, prompts, max_new):
    """Step to the drain, emitting per-window deltas; returns the
    per-engine delta sums keyed like the snapshots, and the sink."""
    sink = RingBufferTracker(4096)
    taps = [EngineTap(e, ring=i) for i, e in enumerate(engines)]
    sums = [dict.fromkeys(counter_fields(e.stats), 0) for e in engines]

    def emit():
        for tap, acc in zip(taps, sums):
            rec = tap.emit(sink, t=0.0)
            if rec is not None:
                for k, v in rec["delta"].items():
                    acc[k] += v
    for p in prompts:
        engine_or_fleet.submit(list(p), max_new)
    while engine_or_fleet.has_work():
        engine_or_fleet.step()
        emit()
    engine_or_fleet.drain()
    emit()            # one final emit catches what drain() itself touched
    return sums, sink


def test_deltas_sum_to_cumulative_single_engine(pair):
    """The sums equal the final counters, and every window's delta
    equals the reference engine's on each counter both packages keep."""
    (jmodel, jparams), (model, params) = pair
    prompts = [[1, 2, 3], [4, 5], [1, 2, 3, 9]]
    conf = dict(ECONF, prefix_cache=True)
    eng = LPUEngine(model, params, EngineConfig(**conf), device="cpu")
    sums, sink = _run_with_tap(eng, [eng], prompts, 6)
    assert sums[0] == snapshot_stats(eng.stats)
    assert eng.stats.tokens > 0
    assert all(r["dt_ms"] >= 0 for r in sink.records())
    jeng = JaxEngine(jmodel, jparams, JaxEngineConfig(**conf))
    _, jsink = _run_with_tap(jeng, [jeng], prompts, 6)
    shared = set(jax_tracker.counter_fields(jeng.stats)) - {"decode_stalls"}

    def windows(records):
        return [(r["step"], {k: v for k, v in r["delta"].items()
                             if k in shared}) for r in records]
    assert windows(sink.records()) == windows(jsink.records())


def test_deltas_survive_reset_regression(pair):
    """Chaos kills ring 0 in flight; the rebuilt scheduler, pool and
    prefix index restart their counters at zero, but the banked bases
    keep the cumulative counters monotone: every delta >= 0 (the tap
    raises otherwise) and the sums equal the final counters."""
    _, (model, params) = pair
    shared = list(range(1, 33))
    prompts = [shared + [50], shared + [51], [4, 5, 6], shared + [52]]
    fleet = MultiRingEngine(model, params, None, rings=2, device="cpu",
                            config=EngineConfig(**ECONF, prefix_cache=True,
                                                chaos="ring@2"))
    for mon in fleet.monitors:          # no wall-clock straggler verdicts
        mon.warmup = 10 ** 9
    sums, _ = _run_with_tap(fleet, fleet.engines, prompts, 8)
    assert sum(e.stats.ring_failures for e in fleet.engines) >= 1
    assert fleet.fleet_counters()["migrated_requests"] >= 1
    for eng, acc in zip(fleet.engines, sums):
        assert acc == snapshot_stats(eng.stats)
    hit = [e for e in fleet.engines if e.stats.ring_failures]
    assert hit and all(e.stats.prefix_lookups > 0 for e in hit)


def test_cumulative_counters_never_regress_across_reset(pair):
    """Preemption, eviction and prefix traffic, a snapshot, ``reset()``,
    then more traffic: no counter went backwards."""
    _, (model, params) = pair
    eng = LPUEngine(model, params, EngineConfig(**ECONF, prefix_cache=True),
                    device="cpu")
    eng.generate([[1, 2, 3, 4] * 4, [1, 2, 3, 4] * 4 + [9]], 8)
    before = snapshot_stats(eng.stats)
    assert before["prefix_lookups"] > 0
    eng.reset()                                     # rebuild mid-life
    eng.generate([[7, 8, 9]], 4)
    after = snapshot_stats(eng.stats)
    stats_delta(before, after)                      # raises on a fall
    assert after["prefix_lookups"] >= before["prefix_lookups"]
    assert after["preemptions"] >= before["preemptions"]
    assert after["evicted_blocks"] >= before["evicted_blocks"]


def test_engine_tap_skips_quiet_windows(pair):
    _, (model, params) = pair
    eng = LPUEngine(model, params, EngineConfig(**ECONF), device="cpu")
    sink = RingBufferTracker(64)
    tap = EngineTap(eng)
    assert tap.emit(sink, t=0.0) is None            # nothing happened
    assert sink.seen == 0
    eng.generate([[1, 2, 3]], 4)
    rec = tap.emit(sink, t=1.0)
    # the first token comes out of the prefill, the other three out of
    # decode steps: the delta mirrors the cumulative counter
    assert rec is not None and rec["delta"]["tokens"] == eng.stats.tokens
    assert rec["delta"]["graph_captures"] == eng.stats.graph_captures
    assert math.isfinite(rec["dt_ms"])
    assert tap.emit(sink, t=2.0) is None and tap.windows == 1


def test_front_end_deltas_sum_across_migration(pair):
    """The front end's own taps over a chaotic two-ring fleet: every
    stream completes, and each ring's ``engine_window`` deltas sum to
    its cumulative counters across the ring failure and the migration."""
    import asyncio

    from repro_torch.serving.frontend import AsyncFrontend
    _, (model, params) = pair
    fleet = MultiRingEngine(model, params, None, rings=2, device="cpu",
                            config=EngineConfig(**ECONF, chaos="ring@2"))
    for mon in fleet.monitors:
        mon.warmup = 10 ** 9
    sink = RingBufferTracker(4096)

    async def go():
        async with AsyncFrontend(fleet, tracker=sink) as fe:
            streams = [fe.submit(p, 8) for p in ([1, 2, 3], [4, 5],
                                                 [6, 7, 8, 9], [10, 11])]
            return [await s.drain() for s in streams], streams
    outs, streams = asyncio.run(go())
    assert all(s.status == "completed" for s in streams)
    assert all(len(o) == 8 for o in outs)
    assert fleet.fleet_counters()["migrated_requests"] >= 1
    for i, eng in enumerate(fleet.engines):
        sums = dict.fromkeys(counter_fields(eng.stats), 0)
        for r in sink.records():
            if r["kind"] == "engine_window" and r["ring"] == i:
                for k, v in r["delta"].items():
                    sums[k] += v
        assert sums == snapshot_stats(eng.stats)


# -- traces ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(seed=3, requests=6, tenants=2, prefix_len=16, tail_max=8,
         max_new_max=6, rate_rps=1000.0),
    dict(seed=7, requests=32, tenants=2, arrival="poisson", rate_rps=200.0,
         prefix_len=256, tail_min=4, tail_max=64, max_new_min=4,
         max_new_max=32, vocab=49152, tenant_names=("a", "b"))],
    ids=["default", "frontend-test", "poisson-named"])
def test_generate_trace_matches_reference(kw):
    """The port's copy of ``benchmarks/traces.py`` gives the reference's
    trace, request for request."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]
                           / "benchmarks"))
    try:
        import traces as ref
    finally:
        sys.path.pop(0)
    ours = generate_trace(TraceConfig(**kw))
    theirs = ref.generate_trace(ref.TraceConfig(**kw))
    assert [vars(r) for r in ours] == [vars(r) for r in theirs]
    assert len(ours) == kw.get("requests", 16)
