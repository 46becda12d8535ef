"""Rank functions of the port's mesh-fleet and ring front-end tests, and
the front-end scenarios both packages run.

:func:`repro_torch.core.dist.run_ranks` spawns each rank as a fresh
process that imports the function it runs, so the functions live here,
at module level, and take only picklable arguments (numpy trees, dicts
of knobs).  :func:`fleet_rank` runs every task of one world size in one
spawn and returns every rank's results.  The scenario coroutines take
the front-end module (the port's or the reference's), so the test runs
the same scenario through both.
"""
from __future__ import annotations

import asyncio
import gc
import os
import weakref

import numpy as np

SERVE_F32 = dict(remat="none", compute_dtype="float32",
                 param_dtype="float32")


# ---------------------------------------------------------------------------
# front-end scenarios (either package)
# ---------------------------------------------------------------------------

def ledger_ok(fe) -> None:
    c = fe.counters
    assert c["completed"] + c["failed"] + c["cancelled"] == c["submitted"]


async def parity(fe_mod, eng, prompts, new, **fe_kw):
    """Every prompt submitted at once, every stream drained."""
    async with fe_mod.AsyncFrontend(eng, **fe_kw) as fe:
        streams = [fe.submit(p, new) for p in prompts]
        outs = [await s.drain() for s in streams]
    ledger_ok(fe)
    return (outs, [s.status for s in streams], fe.counters), fe


async def cancel_mid_stream(fe_mod, eng):
    """Cancel one stream after its third token; a second one runs on."""
    async with fe_mod.AsyncFrontend(eng) as fe:
        victim = fe.submit([1, 2, 3], 40)
        mate = fe.submit([4, 5], 6)
        got = 0
        async for _ in victim:
            got += 1
            if got == 3:
                assert await victim.cancel()
                break
        await fe.join()
    ledger_ok(fe)
    again = (await victim.cancel(), await mate.cancel())
    return (victim.tokens, victim.status, mate.tokens, mate.status,
            fe.counters, again), fe


async def backpressure(fe_mod, eng):
    """``max_pending=2``: the third submit is rejected until the first
    two end."""
    async with fe_mod.AsyncFrontend(eng, max_pending=2) as fe:
        s1 = fe.submit([1, 2, 3], 6)
        s2 = fe.submit([4, 5], 6)
        try:
            fe.submit([6, 7], 6)
            fields = None
        except fe_mod.AdmissionRejected as exc:
            fields = (exc.pending, exc.limit, fe.counters["rejected"])
        outs = [await s1.drain(), await s2.drain()]
        s3 = fe.submit([6, 7], 6)
        outs.append(await s3.drain())
    return (fields, outs, fe.counters), fe


def run_scenario(fe_mod, eng, name, kw, **fe_kw):
    """One scenario by name on world rank 0 (or in one process):
    (its result, the front end)."""
    if name == "parity":
        return asyncio.run(parity(fe_mod, eng, **kw, **fe_kw))
    if name == "cancel":
        return asyncio.run(cancel_mid_stream(fe_mod, eng))
    return asyncio.run(backpressure(fe_mod, eng))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_setup(ring, name, tree, tp):
    """(cfg, plan, model, this rank's shards at its place in its
    sub-ring of ``tp``, that sub-ring's handle) of reduced ``name`` on
    the weights ``tree`` (numpy, the tp=1 layout)."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.core.rings import sub_ring
    from repro_torch.models.registry import build_model
    from repro_torch.weights import params_from_jax, relayout, shard_params
    cfg = get_config(name).reduced()
    plan1 = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                       **SERVE_F32)
    plan = plan_model(cfg, ("model",), (tp,), "serve", esl_overlap=True,
                      **SERVE_F32)
    sub = sub_ring(ring, tp)[1] if tp < ring.size else ring
    full = relayout(params_from_jax(tree, cfg, plan1, "cpu"), cfg, plan1,
                    plan)
    return cfg, plan, build_model(cfg, plan, "cpu"), \
        shard_params(full, plan, sub.rank), sub


def _fleet(ring, model, params, tp, conf, quiet=True):
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import MultiRingEngine
    fleet = MultiRingEngine(model, params, ring, ring_size=tp,
                            config=EngineConfig(**conf), device="cpu",
                            graphs=False)
    if quiet:
        for mon in fleet.monitors:
            mon.warmup = 10 ** 9
    return fleet


def fleet_state(fleet, rids, results):
    """What every rank of a mesh fleet must hold alike."""
    return {
        "results": [results[r] for r in rids],
        "failed": {rid: (r.out, r.error, r.failed)
                   for rid, r in fleet.failed.items()},
        "fleet_counters": fleet.fleet_counters(),
        "per_ring": [dict(vars(s)) for s in fleet.per_ring_stats()],
        "routed": list(fleet.router.routed),
        "ring_of": dict(fleet.ring_of),
        "events": [(e.kind, e.step, e.detail) for e in fleet.events],
        "ring_events": [[(e.kind, e.step, e.detail) for e in v.events]
                        for v in fleet.engines],
        "has_work": fleet.has_work(),
    }


def _serve_fleet(ring, run):
    """One mesh-fleet run: the fleet's agreed state, this rank's own
    counters, and for a fault-free run the same requests of this rank's
    ring served by a lone engine on the same sub-ring (its collectives
    and decode steps)."""
    from repro_torch.kernels import read_launches, reset_launches
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    tp = run["tp"]
    _, _, model, params, sub = _rank_setup(ring, run["name"], run["tree"],
                                           tp)
    fleet = _fleet(ring, model, params, tp, run["conf"])
    sub.reset_counters()
    ring.reset_counters()
    reset_launches()
    rids = [fleet.submit(p, run["max_new"]) for p in run["prompts"]]
    results = fleet.drain()
    out = {"state": fleet_state(fleet, rids, results),
           "ring": fleet.ring_index, "sub_ranks": list(fleet.sub.ranks),
           "world": dict(ring.counters), "sub": dict(sub.counters),
           "launches": read_launches(),
           "decode_steps": fleet.local.stats.device_decode_steps,
           "agreement": dict(fleet.agreement.counters),
           "round": fleet._round}
    fleet.local.check_pool_balanced()
    if run.get("lone"):
        mine = [p for rid, p in zip(rids, run["prompts"])
                if fleet.ring_of[rid] == fleet.ring_index]
        lone = LPUEngine(model, params, EngineConfig(**run["conf"]),
                         mesh=sub, device="cpu", graphs=False)
        sub.reset_counters()
        got = lone.generate(mine, max_new_tokens=run["max_new"])
        out["lone"] = {"streams": got, "sub": dict(sub.counters),
                       "decode_steps": lone.stats.device_decode_steps,
                       "fleet_streams": [
                           results[r] for r in rids
                           if fleet.ring_of[r] == fleet.ring_index]}
    # dropped, the fleet and its engine go by reference count (on the
    # card their graphs hold NCCL work: the cyclic collector would free
    # them at any later point)
    gc.disable()
    try:
        refs = (weakref.ref(fleet), weakref.ref(fleet.local))
        del fleet
        out["freed"] = [r() is None for r in refs]
    finally:
        gc.enable()
    return out


def _frontends(ring, fe_runs):
    """The front-end scenarios on one engine or fleet per config: world
    rank 0 runs each through the port's ``AsyncFrontend``, the others
    follow.  Returns this rank's (result, orders crc, orders applied) per
    scenario, and the knobs each engine ended with."""
    from repro_torch.serving import frontend as fe_mod
    from repro_torch.serving.budget import BudgetScheduler
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    from repro_torch.serving.tracker import JsonlTracker
    out = {}
    for run in fe_runs:
        tp = run["tp"]
        _, _, model, params, _ = _rank_setup(ring, run["name"], run["tree"],
                                             tp)
        if tp < ring.size:
            eng = _fleet(ring, model, params, tp, run["conf"])
        else:
            eng = LPUEngine(model, params, EngineConfig(**run["conf"]),
                            mesh=ring, device="cpu", graphs=False)
        for key, name, kw in run["scenarios"]:
            fe_kw = {}
            if name == "parity" and kw.get("budget_ms"):
                fe_kw["budget"] = BudgetScheduler(kw["budget_ms"],
                                                  prior_step_s=2e-3,
                                                  max_chunk=32)
            if name == "parity" and kw.get("tracker"):
                fe_kw["tracker"] = JsonlTracker(os.path.join(
                    kw["tracker"], f"rank{ring.rank}.jsonl"))
            sk = {k: v for k, v in kw.items()
                  if k in ("prompts", "new")}
            if ring.rank == 0:
                got, fe = run_scenario(fe_mod, eng, name, sk, **fe_kw)
            else:
                fe = fe_mod.AsyncFrontend(eng, **fe_kw)
                fe.follow()
                got = None
            knobs = [(e.prefill_chunk, e.steps_per_sync)
                     for e in getattr(eng, "engines", [eng])]
            plans = (list(fe_kw["budget"].planned)
                     if "budget" in fe_kw and ring.rank == 0 else None)
            out[key] = (got, fe.orders_crc, fe.orders_applied, knobs, plans)
    return out


def _shards(ring, name, tp):
    """A digest of this rank's shards at its place in its sub-ring:
    every sub-ring draws the same replica."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.core.rings import sub_ring
    from repro_torch.weights import init_shard
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, ("model",), (tp,), "serve", esl_overlap=True,
                      **SERVE_F32)
    sub = sub_ring(ring, tp)[1]
    mine = init_shard(cfg, plan, sub, seed=0, device="cpu")
    by_int = init_shard(cfg, plan, sub.rank, seed=0, device="cpu")

    def leaves(t, pre=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{pre}/{k}")
        else:
            yield pre, t
    a = dict(leaves(mine))
    b = dict(leaves(by_int))
    return {"equal_int": all(np.array_equal(a[k].numpy(), b[k].numpy())
                             for k in a),
            "digest": {k: float(v.double().sum()) for k, v in a.items()}}


def _refusals(ring, name, tp):
    """What a world of sub-rings refuses, each as (exception type,
    message), raised alike on every rank before any collective."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.core.rings import sub_ring
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine, MultiRingEngine
    from repro_torch.serving.frontend import AsyncFrontend
    from repro_torch.weights import init_shard
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, ("model",), (tp,), "serve", esl_overlap=True,
                      **SERVE_F32)
    sub = sub_ring(ring, tp)[1]
    params = init_shard(cfg, plan, sub, seed=0, device="cpu")
    model = build_model(cfg, plan, "cpu")
    kw = dict(device="cpu", graphs=False)
    out = {}

    def rec(key, fn):
        try:
            fn()
            out[key] = ("ok", "")
        except Exception as e:                      # noqa: BLE001
            out[key] = (type(e).__name__, str(e))
    rec("fleet_on_a_sub_ring",
        lambda: MultiRingEngine(model, params, sub, ring_size=tp, **kw))
    rec("ring_size_not_a_divisor",
        lambda: MultiRingEngine(model, params, ring, ring_size=3, **kw))
    rec("ring_size_not_the_plan",
        lambda: MultiRingEngine(model, params, ring, ring_size=ring.size,
                                **kw))
    eng = LPUEngine(model, params, EngineConfig(slots=2, max_seq=64),
                    mesh=sub, **kw)
    rec("frontend_on_a_sub_ring", lambda: AsyncFrontend(eng))
    rec("split_a_sub_ring", lambda: sub.split([[0], [1]]))
    rec("groups_in_a_sub_ring", lambda: sub.make_groups([[0], [1]]))
    rec("split_not_covering", lambda: ring.split([[0, 1]]))
    return out


def fleet_rank(ring, tasks):
    """Every task of one world size in one spawn: {key: (kind, kwargs)}
    with kinds ``fleet`` (a list of runs of :func:`_serve_fleet`),
    ``frontends`` (:func:`_frontends`), ``refusals`` and ``shards``;
    returns every rank's {key: result}."""
    out = {}
    for key, (kind, kw) in tasks.items():
        if kind == "fleet":
            out[key] = {r["key"]: _serve_fleet(ring, r) for r in kw["runs"]}
        elif kind == "frontends":
            out[key] = _frontends(ring, kw["runs"])
        elif kind == "refusals":
            out[key] = _refusals(ring, **kw)
        else:
            out[key] = _shards(ring, **kw)
    return ring.gather_object(out)


def card_fleet_rank(ring, spec):
    """A mesh fleet of reduced ``spec["name"]`` at tp 2 on cards of its
    own (rank r on ``cuda:r``, NCCL), each rank drawing its shard at
    its place in its sub-ring: served with ``graphs=True`` and as the
    eager twin, then through the front end on rank 0 over the first
    run's fleet (``spec["modes"]``, default (True, False); a gloo
    rehearsal on the CPU passes ``(False,)``).  Returns every rank's
    record."""
    import torch
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.core.rings import sub_ring
    from repro_torch.kernels import read_launches, reset_launches
    from repro_torch.models.registry import build_model
    from repro_torch.serving import frontend as fe_mod
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import MultiRingEngine
    from repro_torch.weights import init_shard
    dev = ring.device
    cfg = get_config(spec["name"]).reduced()
    plan = plan_model(cfg, ("model",), (2,), "serve", esl_overlap=True,
                      **SERVE_F32)
    sub = sub_ring(ring, 2)[1]
    params = init_shard(cfg, plan, sub, seed=0, device=dev)
    model = build_model(cfg, plan, dev)
    out = {}
    modes = spec.get("modes", (True, False))
    for graphs in modes:
        fleet = MultiRingEngine(model, params, ring, ring_size=2,
                                config=EngineConfig(**spec["conf"]),
                                device=dev, graphs=graphs)
        reset_launches()
        ring.reset_counters()
        sub.reset_counters()
        got = fleet.generate(spec["prompts"], max_new_tokens=spec["new"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        st = fleet.local.stats
        out[graphs] = {
            "streams": got, "fleet_counters": fleet.fleet_counters(),
            "routed": list(fleet.router.routed),
            "launches": read_launches().get("paged_decode_attention", 0),
            "want": cfg.n_layers * (st.device_decode_steps
                                    + st.prefill_chunks),
            "replays": st.graph_replays,
            "world": ring.counters["collectives"],
            "staged": sub.counters["staged_bytes"],
            "collectives": sub.counters["collectives"]}
        if graphs == modes[0]:
            if ring.rank == 0:
                res, fe = run_scenario(fe_mod, fleet, "parity",
                                       dict(prompts=spec["prompts"],
                                            new=spec["new"]))
                out["frontend"] = res
            else:
                fe = fe_mod.AsyncFrontend(fleet)
                fe.follow()
            out["orders"] = (fe.orders_crc, fe.orders_applied)
        del fleet
    return ring.agreement().gather(out)
