"""The port's serving fault tolerance and host fleet against the
reference's (``src/repro/serving/ft.py``, ``core/latency_model.py``,
``scheduler.RingRouter`` and ``engine.MultiRingEngine``) on the reduced
smollm-135m, f32, the reference's weights carried across
(``tests/torch_dense_util.py``).

Policy units fed the same seeded sequences: chaos specs, the straggler
monitor, the heartbeat tracker on a ManualClock, the failure injector,
the latency model's step-time prior, the router and the scheduler's
load.  Fleets of two rings under the reference test's chaos scenarios
(``tests/test_fault_tolerance.py``): results, failures, counters, routes
and event sequences equal the reference fleet's, every pool balanced and
finite after the drain, and every survivor's greedy stream the port's
fault-free fleet's.  Then the engine's seams: ``reset()`` in place
(storage, programs, counters), the poison flag read from the window's
static buffer by a program built before the fault, the refusals,
``cancel`` against the reference's, and the serve CLI.

The straggler monitor times real steps, so its verdicts depend on the
host's load: in the fleet comparisons both fleets' monitors are kept in
warm-up (they never flag), and the monitor itself is held to the
reference's on seeded step times.  Torch runs one thread here
(``one_torch_thread``): its pool and XLA's fight over a shared CPU, and
the port's fleets ran some forty times slower on eight.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import latency_model as jax_lm
from repro.serving import ft as jax_ft
from repro.serving import scheduler as jax_sched
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import EngineStats as JaxStats
from repro.serving.engine import LPUEngine as JaxEngine
from repro.serving.engine import MultiRingEngine as JaxFleet
from repro.serving.engine import Request as JaxRequest
from repro.serving.sampler import SamplingParams as JaxSamplingParams
from repro_torch.configs import get_config
from repro_torch.core import latency_model as lm
from repro_torch.launch import serve
from repro_torch.serving import ft
from repro_torch.serving import scheduler as sched
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import (EngineStats, LPUEngine,
                                        MultiRingEngine, Request)
from repro_torch.serving.sampler import SamplingParams
from tests.torch_dense_util import (one_torch_thread,  # noqa: F401
                                    reduced_pair, reference_compile_cache)

CHAOS_ALL = "ring@2,stall@3:1,nan@5,corrupt@8"
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11], [12, 13, 14],
           [15, 16]]
FLEET = dict(slots=2, max_seq=64, paged=True, block_size=16,
             heartbeat_timeout_s=4.0)
# name: (config knobs, prompts, new tokens) — the reference test's
# scenarios, and nan@3 inside 4-step windows
SCENARIOS = {
    "chaos-all": (dict(chaos=CHAOS_ALL), PROMPTS, 8),
    "corrupt": (dict(chaos="corrupt@4"), PROMPTS[:2], 8),
    "retries-exhausted": (dict(chaos="ring@2", max_migrations=0),
                          PROMPTS[:2], 6),
    "stall-one-request": (dict(chaos="stall@2"), [[1, 2, 3, 4]], 6),
    "nan-window4": (dict(chaos="nan@3", steps_per_sync=4), PROMPTS, 8),
}


@pytest.fixture(scope="module")
def pair():
    (_, _, jmodel, jparams), (_, _, model, params) = \
        reduced_pair("smollm-135m")
    return (jmodel, jparams), (model, params)


def _quiet(fleet):
    """Keep the fleet's wall-clock straggler monitors in warm-up."""
    for mon in fleet.monitors:
        mon.warmup = 10 ** 9
    return fleet


def _serve(fleet, prompts, max_new):
    rids = [fleet.submit(p, max_new) for p in prompts]
    return rids, fleet.drain()


def _events(events):
    return [(e.kind, e.step, e.detail) for e in events]


# EngineStats fields both packages keep, but the wall time and
# decode_stalls, which the port counts only for a prefill that froze
# another decode-ready stream (a deliberate correction, ROADMAP §3)
COUNTERS = sorted(set(JaxStats.__dataclass_fields__)
                  & set(EngineStats.__dataclass_fields__)
                  - {"wall", "decode_stalls"})


def _record(fleet, rids, results):
    return {
        "results": results,
        "order": rids,
        "failed": {rid: (r.out, r.error, r.failed)
                   for rid, r in fleet.failed.items()},
        "fleet_counters": fleet.fleet_counters(),
        "per_ring": [{k: getattr(s, k) for k in COUNTERS}
                     for s in fleet.per_ring_stats()],
        "routed": list(fleet.router.routed),
        "ring_of": dict(fleet.ring_of),
        "events": _events(fleet.events),
        "ring_events": [_events(e.events) for e in fleet.engines],
    }


def _check_pools(fleet):
    """Every pool balanced, every floating pool tensor finite."""
    for eng in fleet.engines:
        eng.check_pool_balanced()
        for c in eng.cache.values():
            for t in c.values():
                if t.is_floating_point():
                    assert torch.isfinite(t.float()).all()


@pytest.fixture(scope="module")
def base(pair):
    """The port's fault-free fleet's streams per (prompts, new tokens,
    knobs), each fleet run once.  (In "chaos-all" every request
    survives, so there the port's fault-free streams are also held to
    the reference fleet's.)"""
    _, (model, params) = pair
    cache = {}

    def get(prompts, max_new, **kw):
        key = (repr(prompts), max_new, repr(sorted(kw.items())))
        if key not in cache:
            fleet = _quiet(MultiRingEngine(
                model, params, None, rings=2,
                config=EngineConfig(**dict(FLEET, **kw)), device="cpu"))
            rids, res = _serve(fleet, prompts, max_new)
            cache[key] = [res[r] for r in rids]
        return cache[key]
    return get


# -- policy units --------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "ring@3,stall@5:1, nan@7 ,corrupt@9:0", "", "ring@1", CHAOS_ALL,
    "explode@3", "ring@0", "ring@3:-1", "ring", "@3", "nan@x", "stall@2:y"])
def test_parse_chaos_matches_reference(spec):
    def parsed(parse):
        try:
            return [(e.kind, e.step, e.ring) for e in parse(spec)]
        except ValueError as e:
            return str(e)
    want = parsed(jax_ft.parse_chaos)
    assert parsed(ft.parse_chaos) == want
    if isinstance(want, str):
        with pytest.raises(ValueError):
            EngineConfig(chaos=spec)
    else:
        assert EngineConfig(chaos=spec).chaos == spec


@pytest.mark.parametrize("kw", [dict(), dict(mu0=0.01),
                                dict(warmup=0, cooldown=0, mu0=0.02),
                                dict(alpha=0.3, k_sigma=2.0, min_slack=0.1)])
def test_straggler_monitor_matches_reference(kw):
    rng = np.random.default_rng(7)
    dts = rng.lognormal(np.log(0.01), 0.2, size=300)
    dts[rng.integers(0, 300, size=12)] *= rng.uniform(2, 20, size=12)
    ours, ref = ft.StragglerMonitor(**kw), jax_ft.StragglerMonitor(**kw)
    flags = 0
    for step, dt in enumerate(dts.tolist(), 1):
        a, b = ours.record(step, dt), ref.record(step, dt)
        assert (a is None) == (b is None)
        if a is not None:
            flags += 1
            assert (a.kind, a.step, a.detail) == (b.kind, b.step, b.detail)
        assert (ours.mu, ours.var, ours.n) == (ref.mu, ref.var, ref.n)
    assert flags > 0
    assert _events(ours.events) == _events(ref.events)


def test_heartbeat_tracker_matches_reference():
    rng = np.random.default_rng(3)
    clocks = ft.ManualClock(), jax_ft.ManualClock()
    ours = ft.HeartbeatTracker(3, timeout_s=5.0, clock=clocks[0])
    ref = jax_ft.HeartbeatTracker(3, timeout_s=5.0, clock=clocks[1])
    seen = []
    for _ in range(400):
        op, w = int(rng.integers(0, 4)), int(rng.integers(0, 3))
        if op == 0:
            dt = float(rng.uniform(0, 3))
            assert clocks[0].advance(dt) == clocks[1].advance(dt)
        elif op == 1:
            ours.beat(w)
            ref.beat(w)
        elif op == 2:
            got = ours.check()
            assert got == ref.check()
            seen += got
        else:
            ours.revive(w)
            ref.revive(w)
        assert (ours.last, ours.failed) == (ref.last, ref.failed)
    assert seen


def test_failure_injector_matches_reference():
    rng = np.random.default_rng(5)
    kinds = ft.CHAOS_KINDS
    spec = ",".join(f"{kinds[rng.integers(0, 4)]}@{rng.integers(1, 9)}:"
                    f"{rng.integers(0, 3)}" for _ in range(12))
    ours = ft.FailureInjector(fail_at_steps=[2, 5],
                              chaos=ft.parse_chaos(spec))
    ref = jax_ft.FailureInjector(fail_at_steps=[2, 5],
                                 chaos=jax_ft.parse_chaos(spec))
    fired = 0
    for _ in range(3):                   # a replayed step never re-fires
        for step in range(1, 10):
            for ring in range(3):
                got = [(e.kind, e.step, e.ring)
                       for e in ours.fire(step, ring)]
                assert got == [(e.kind, e.step, e.ring)
                               for e in ref.fire(step, ring)]
                fired += len(got)
            raised = []
            for inj in (ours, ref):
                try:
                    inj.maybe_fail(step)
                    raised.append(None)
                except RuntimeError as e:
                    raised.append(str(e))
            assert raised[0] == raised[1]
    assert fired == 12


@pytest.mark.parametrize("name,reduced", [("smollm-135m", False),
                                          ("smollm-135m", True),
                                          ("opt-1.3b", False),
                                          ("opt-6.7b", False)])
def test_latency_model_matches_reference(name, reduced):
    cfg, jcfg = get_config(name), jax_get_config(name)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for hw in ("LPU_FPGA", "LPU_ASIC", "H100"):
        ours, ref = getattr(lm, hw), getattr(jax_lm, hw)
        assert ours == ft_hw(ref)
        for n in (1, 2):
            assert lm.token_latency(cfg, n, ours, kv_len=512) == \
                jax_lm.token_latency(jcfg, n, ref, kv_len=512)
        for window in (1, 4, 8):
            assert lm.step_time_prior(cfg, 1, ours, kv_len=512,
                                      steps_per_sync=window) == \
                jax_lm.step_time_prior(jcfg, 1, ref, kv_len=512,
                                       steps_per_sync=window)
    with pytest.raises(ValueError):
        lm.step_time_prior(cfg, 1, lm.LPU_FPGA, steps_per_sync=0)


def ft_hw(ref):
    """The reference's HWConfig as the port's (field for field)."""
    return lm.HWConfig(ref.name, ref.mem_bw, ref.link_bw,
                       ref.system_power_w, ref.peak_flops)


def test_ring_router_and_pending_tokens_match_reference():
    rng = np.random.default_rng(11)
    for n in (1, 2, 3, 4):
        ours, ref = sched.RingRouter(n), jax_sched.RingRouter(n)
        for _ in range(500):
            loads = [int(x) for x in rng.integers(0, 40, size=n)]
            aff = None if rng.random() < 0.4 else \
                [int(x) * int(rng.random() < 0.3)
                 for x in rng.integers(0, 64, size=n)]
            assert ours.route(loads, aff) == ref.route(loads, aff)
        assert (ours.routed, ours.affinity_routed) == \
            (ref.routed, ref.affinity_routed)
    for trial in range(20):
        ours, ref = sched.Scheduler(3, 64, None), \
            jax_sched.Scheduler(3, 64, None)
        for rid in range(int(rng.integers(1, 7))):
            prompt = [int(x) for x in rng.integers(1, 50,
                                                   size=rng.integers(1, 9))]
            out = [int(x) for x in rng.integers(1, 50,
                                                size=rng.integers(0, 4))]
            new = int(rng.integers(1, 12))
            for s, cls in ((ours, Request), (ref, JaxRequest)):
                req = cls(rid, list(prompt), new)
                req.out = list(out)
                s.submit(req)
        for _ in range(int(rng.integers(0, 4))):
            a, b = ours.admit_next(), ref.admit_next()
            assert (a is None) == (b is None)
        assert ours.pending_tokens() == ref.pending_tokens()


# -- fleets against the reference's ---------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_matches_reference(pair, base, name):
    (jmodel, jparams), (model, params) = pair
    kw, prompts, max_new = SCENARIOS[name]
    conf = dict(FLEET, **kw)
    ref = _quiet(JaxFleet(jmodel, jparams, None, rings=2,
                          config=JaxEngineConfig(**conf)))
    want = _record(ref, *_serve(ref, prompts, max_new))
    fleet = _quiet(MultiRingEngine(model, params, None, rings=2,
                                   config=EngineConfig(**conf),
                                   device="cpu"))
    assert isinstance(fleet._clock, ft.ManualClock)
    rids, results = _serve(fleet, prompts, max_new)
    assert _record(fleet, rids, results) == want
    _check_pools(fleet)
    # every fired kind is logged, every failure is structured and keeps
    # its partial stream, every survivor is the fault-free stream
    fired = {e.detail["kind"] for eng in fleet.engines for e in eng.events
             if e.kind == "chaos"}
    assert fired and fleet.fleet_counters()["ring_failures"] >= 1
    clean = base(prompts, max_new, **{k: v for k, v in kw.items()
                                      if k == "steps_per_sync"})
    for i, rid in enumerate(rids):
        if rid in fleet.failed:
            req = fleet.failed[rid]
            assert req.failed and "retries exhausted" in req.error
            assert results[rid] == req.out == clean[i][:len(req.out)]
        else:
            assert results[rid] == clean[i]
    if name == "corrupt":
        failed = [e for e in fleet.events if e.kind == "ring_failed"]
        assert failed[0].detail["reason"] == "nan_logits"
    if name == "retries-exhausted":
        assert fleet.failed and \
            fleet.fleet_counters()["migrated_requests"] == 0
    if name == "stall-one-request":
        assert {e.detail["ring"] for e in fleet.events
                if e.kind == "ring_failed"} == {0}
        assert fleet.events[0].detail["reason"] == "heartbeat_timeout"
    if name == "nan-window4":
        failed = [e for e in fleet.events if e.kind == "ring_failed"]
        assert failed[0].detail["reason"] == "nan_logits"
        assert failed[0].detail["window_step"] == 0
        assert ("window", 4, False) in fleet.engines[0]._programs._by_key


@pytest.mark.parametrize("kw", [dict(chaos="nan@3", sampling="host"),
                                dict(chaos="ring@2", paged=False)],
                         ids=["host-sampled-nan", "dense-ring"])
def test_fleet_recovers_to_fault_free_streams(pair, base, kw):
    """The host-sampled decode step's guard, and a ring failure on the
    dense cache, against the port's own fault-free fleet."""
    _, (model, params) = pair
    fleet = _quiet(MultiRingEngine(model, params, None, rings=2,
                                   config=EngineConfig(**dict(FLEET, **kw)),
                                   device="cpu"))
    rids, results = _serve(fleet, PROMPTS, 8)
    clean = base(PROMPTS, 8, **{k: v for k, v in kw.items()
                                if k != "chaos"})
    assert [results[r] for r in rids] == clean == base(PROMPTS, 8)
    assert fleet.fleet_counters()["ring_failures"] == 1
    assert not fleet.failed
    reason = [e.detail["reason"] for e in fleet.events
              if e.kind == "ring_failed"]
    assert reason == ["nan_logits" if "sampling" in kw
                      else "injected_ring_failure"]
    _check_pools(fleet)


# -- the engine's seams ---------------------------------------------------


def _ptrs(eng):
    """data_ptr of every cache tensor and static buffer."""
    out = [t.data_ptr() for c in eng.cache.values() for t in c.values()]
    bufs = [eng._win, eng._tables, *eng._bufs.values(), *eng._ver.values()]
    out += [b.dev.data_ptr() for b in bufs if b is not None]
    out += [t.data_ptr() for t in (*eng._win_out.values(), eng._row,
                                   eng._first)]
    return out


def test_reset_keeps_storage_and_programs(pair):
    """reset() zeroes the cache in place (a corrupted block included),
    keeps every static buffer and program, and a reset engine serves
    fresh prompts exactly like a fresh engine."""
    _, (model, params) = pair
    conf = EngineConfig(**dict(FLEET, steps_per_sync=4, prefix_cache=True))
    eng = LPUEngine(model, params, conf, device="cpu")
    eng.generate(PROMPTS[:3], max_new_tokens=8)
    for p in PROMPTS[3:]:
        eng.submit(p, 30)
    for _ in range(3):
        eng.step()
    eng._corrupt_pool_block()
    ptrs, keys = _ptrs(eng), (set(eng._programs._by_key),
                              set(eng._admit._by_key))
    captures = eng.stats.graph_captures
    orphans = eng.reset()
    assert [r.rid for r in orphans] == [3, 4, 5]
    assert _ptrs(eng) == ptrs
    assert (set(eng._programs._by_key), set(eng._admit._by_key)) == keys
    assert all(not t.any() for c in eng.cache.values() for t in c.values())
    assert eng._win.mirror is None and eng._tables.mirror is None
    assert not eng.sched.has_work() and eng.sched.pool.num_used == 0
    fresh = LPUEngine(model, params, conf, device="cpu")
    new = [[7, 7, 1, 9], [20, 21, 22], [5, 4, 3, 2, 1]]
    assert eng.generate(new, 8) == fresh.generate(new, 8)
    assert _ptrs(eng) == ptrs and eng.stats.graph_captures == captures
    eng.check_pool_balanced()


def test_poison_rides_the_window_buffer(pair, base):
    """The chaos flag is an input of the window's program, not a value
    baked into it: a window built before the fault (pipelined, 4 steps)
    trips the guard when run after ``_poison_next`` is set, and the
    flag is consumed, so the orphan resumes to its fault-free stream."""
    _, (model, params) = pair
    conf = EngineConfig(**dict(FLEET, steps_per_sync=4))
    eng = LPUEngine(model, params, conf, device="cpu")
    rid = eng.submit(PROMPTS[0], 40)
    rounds = []
    dispatch = eng._dispatch_window

    def spy(*a):
        rounds[-1] += 1
        return dispatch(*a)
    eng._dispatch_window = spy
    for _ in range(2):
        rounds.append(0)
        eng.step()
    assert ("window", 4, False) in eng._programs._by_key
    eng._poison_next = True
    rounds.append(0)
    with pytest.raises(ft.RingFailure) as fault:
        eng.step()
    assert rounds[-1] == 2               # a second window was in flight
    assert fault.value.reason == "nan_logits"
    assert fault.value.detail == {"window_step": 0, "slots": [0]}
    [req] = eng.reset()
    assert eng._win.view["poison"].item() == 0   # consumed on the device
    eng.submit(req)
    assert eng.drain()[rid] == base([PROMPTS[0]], 40)[0]


@pytest.mark.parametrize("case", ["chaos+speculate", "corrupt+dense",
                                  "rings=0", "mesh"])
def test_refusals(pair, case):
    _, (model, params) = pair
    if case == "chaos+speculate":
        with pytest.raises(ValueError, match="speculative"):
            LPUEngine(model, params, EngineConfig(
                **FLEET, chaos="nan@2", speculate="ngram"), device="cpu")
    elif case == "corrupt+dense":
        with pytest.raises(ValueError, match="paged"):
            LPUEngine(model, params, EngineConfig(
                **dict(FLEET, paged=False), chaos="corrupt@2"),
                device="cpu")
    elif case == "rings=0":
        with pytest.raises(ValueError, match="rings"):
            MultiRingEngine(model, params, None, rings=0,
                            config=EngineConfig(**FLEET), device="cpu")
    else:
        # a mesh fleet takes the rank's world ring (run_ranks), nothing
        # else (tests/test_torch_tp_fleet.py serves it)
        with pytest.raises(TypeError, match="world ring"):
            MultiRingEngine(model, params, object(), ring_size=2,
                            config=EngineConfig(**FLEET), device="cpu")


def test_fault_tolerance_knobs_build_engine_and_fleet(pair):
    _, (model, params) = pair
    conf = EngineConfig(**dict(FLEET, heartbeat_timeout_s=5.0),
                        chaos="ring@3", max_migrations=1,
                        ft_straggler_drain=True, affinity="prefix",
                        prefix_cache=True)
    eng = LPUEngine(model, params, conf, device="cpu")
    assert eng.injector is not None
    fleet = MultiRingEngine(model, params, None, rings=2, config=conf,
                            device="cpu")
    assert (fleet.max_migrations, fleet.affinity, fleet.hb.timeout,
            fleet.ft_straggler_drain) == (1, "prefix", 5.0, True)
    assert fleet.engines[0].params is fleet.engines[1].params is params


SYS = list(range(30, 47))                 # a full block of 16 and one


def _cancel_run(eng, make):
    """Cancel a queued and an active request, drain, run two requests
    sharing a cached block on a pool small enough to preempt, reset with
    both in flight, then serve three more; ``make(rid, prompt, new)``
    builds a greedy request.  Returns what each step gave, the banked
    counter bases, the stats and the events."""
    for rid in range(3):
        eng.submit(make(rid, SYS + [rid + 1], 16))
    eng.step()
    eng.step()
    got = []
    for rid in (2, 0):                   # queued, then active
        r = eng.cancel(rid)
        got.append((r.rid, list(r.out), r.done, r.cancelled, r.failed))
    got.append(eng.cancel(99))
    got.append(eng.drain())
    for rid in (3, 4):
        eng.submit(make(rid, SYS + [rid + 1], 24))
    for _ in range(16):
        eng.step()
    got.append([(r.rid, list(r.out)) for r in eng.reset()])
    banked = dict(eng._ctr_base)
    got.append(eng.generate([SYS + [9, 8], SYS + [7], SYS + [6, 5]], 6))
    eng.check_pool_balanced()
    stats = {k: getattr(eng.stats, k) for k in COUNTERS}
    return got, banked, stats, _events(eng.events)


def test_cancel_and_reset_counters_match_reference(pair):
    """cancel() of a queued and an active request, and the counters a
    reset banks (prefix index, preemptions), against the reference
    engine on the same sequence."""
    (jmodel, jparams), (model, params) = pair
    conf = dict(FLEET, prefix_cache=True, num_blocks=5)
    ours = _cancel_run(
        LPUEngine(model, params, EngineConfig(**conf), device="cpu"),
        lambda *a: Request(*a, SamplingParams(0.0, 0, 1.0)))
    ref = _cancel_run(
        JaxEngine(jmodel, jparams, JaxEngineConfig(**conf)),
        lambda *a: JaxRequest(*a, JaxSamplingParams(0.0, 0, 1.0)))
    assert ours == ref
    _, banked, stats, _ = ours
    assert banked["preemptions"] > 0 and banked["prefix_hits"] > 0
    assert stats["prefix_hits"] > banked["prefix_hits"]
    assert stats["cancelled_requests"] == 2


def test_fleet_cancel_follows_migration(pair):
    _, (model, params) = pair
    fleet = _quiet(MultiRingEngine(
        model, params, None, rings=2,
        config=EngineConfig(**FLEET, chaos="ring@2"), device="cpu"))
    rids = [fleet.submit(p, 8) for p in PROMPTS[:4]]
    while not fleet.events:
        fleet.step()
    moved = [r for r in rids if fleet.ring_of[r] == 1 and r % 2 == 0]
    assert moved                         # ring 0's requests went to ring 1
    got = fleet.cancel(moved[0])
    assert got is not None and got.cancelled
    assert fleet.engines[1].stats.cancelled_requests == 1
    results = fleet.drain()
    assert results[moved[0]] == got.out
    assert fleet.cancel(moved[0]) is None
    _check_pools(fleet)


def test_prefix_affinity_routes_to_the_owning_ring(pair):
    _, (model, params) = pair
    fleet = MultiRingEngine(
        model, params, None, rings=2, device="cpu",
        config=EngineConfig(**FLEET, prefix_cache=True, affinity="prefix"))
    sys_p = list(range(100, 133))        # two full blocks of 16
    fleet.generate([[1, 2], sys_p + [1]], 4)
    owner = fleet.ring_of[1]
    rids = [fleet.submit(sys_p + [k], 4) for k in range(3, 6)]
    fleet.drain()
    assert [fleet.ring_of[r] for r in rids] == [owner] * 3
    assert fleet.router.affinity_routed[owner] == 3
    assert fleet.engines[owner].stats.prefix_hits == 3


def test_serve_cli_fleet(capsys):
    outs = serve.main(["--reduced", "--device", "cpu", "--rings", "2",
                       "--chaos", "ring@2", "--requests", "4",
                       "--max-new", "6", "--max-seq", "64"])
    out = capsys.readouterr().out
    assert "4 requests over 2 sub-rings (tp=1 each), routed [2, 2]" in out
    assert "[serve] ft: chaos=ring@2 ring_failures=1 migrated=2 " \
        "retries=2 rejected=0 failed=0 events=3" in out
    assert [len(o) for o in outs] == [6] * 4
    with contextlib.redirect_stdout(io.StringIO()):
        plain = serve.main(["--reduced", "--device", "cpu", "--requests",
                            "4", "--max-new", "6", "--max-seq", "64"])
    assert outs == plain
