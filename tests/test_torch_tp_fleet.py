"""The port's mesh fleet and its front end over the ESL ring: gloo ranks
on the CPU, each a spawned process (rank functions in
``tests/torch_tp_fleet_util.py``), against the reference's host fleet
and front end on the reduced smollm-135m (and opt-1.3b) in f32, the
reference's weights carried across (``tests/torch_dense_util.py``).

A world of 4 ranks serves as 2 sub-rings of tp 2
(``MultiRingEngine(model, shards, ring, ring_size=2)``): its streams,
routes and per-ring tokens are the reference's
``tests/test_serving.py::test_multi_ring_engine_isolated_and_balanced``
and its tp=1 engine's; under every chaos scenario of
``tests/test_torch_fault_tolerance.py`` its results, failures,
``fleet_counters()``, routes, events and rounds are the reference host
fleet's (``MultiRingEngine(..., None, rings=2)``, whose supervision is
the same code; an orphan an earlier ring sends to a later one steps in
the same round through the later ring's admission pass, whose windows
its counters show, ``PASS_COUNTERS``).  Every
rank holds the same fleet state; no model collective runs on the world
group; each sub-ring's collectives are a lone engine's on the same
requests; both sub-rings draw the same shards.  The async front end
over a lone tp 2 ring (2 ranks) and over the mesh fleet (4 ranks)
streams the reference front end's tokens (parity, cancel in the middle
of a stream, ``max_pending`` backpressure, the budget's knobs) with
every rank's orders equal, and its tracker is written on rank 0 alone.
Then the CLI's ``--tp 2 --rings 2``, ``--tp 2 --chaos ring@2`` and
``--tp 2 --budget-ms 5 --max-pending 2 --tracker PATH``, and the step
time prior on the card: a healthy fleet with ``ft_straggler_drain`` and
steps ~30x the roofline prior drains nothing.

The wall-clock straggler monitors are kept in warm-up on both sides in
the chaos comparisons, as in ``tests/test_torch_fault_tolerance.py``.
Cost in one process ~145 s: three spawns of ranks (one thread each;
the 4-rank ones ~23 s each), the CLI's three (~21 s) and the
reference's fleets and front ends.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.serving import frontend as jax_frontend
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro.serving.engine import MultiRingEngine as JaxFleet
from repro_torch.core.dist import run_ranks
from repro_torch.launch import serve
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import MultiRingEngine
from repro_torch.serving.tracker import read_jsonl
from tests.test_torch_fault_tolerance import FLEET, SCENARIOS
from tests.torch_dense_util import (one_torch_thread,  # noqa: F401
                                    reduced_pair, reference_compile_cache)
from tests.torch_tp_fleet_util import fleet_rank, run_scenario

# tests/test_serving.py::test_multi_ring_engine_isolated_and_balanced
RING_CONF = dict(slots=2, max_seq=64, paged=True, block_size=16)
RING_PROMPTS = [[5, 17, 9, 33], [2, 8], [41, 7, 7, 19, 3], [11, 12, 13]]
RING_NEW = 10
# the front end's scenarios (tests/test_torch_frontend.py)
FE_PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [1, 2, 3, 4, 5, 6]]
FE_PARITY = dict(prompts=FE_PROMPTS, new=8)
FE_SCENARIOS = [("parity", "parity", FE_PARITY),
                ("cancel", "cancel", {}),
                ("backpressure", "backpressure", {})]
BUDGET_MS = 5.0


def _tree(jparams):
    return jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def pairs():
    return {n: reduced_pair(n) for n in ("smollm-135m", "opt-1.3b")}


def _fe_runs(tree, tp, tracker_dir):
    track = dict(FE_PARITY, tracker=str(tracker_dir))
    budget = dict(FE_PARITY, budget_ms=BUDGET_MS)
    return [dict(name="smollm-135m", tree=tree, tp=tp, conf=RING_CONF,
                 scenarios=FE_SCENARIOS + [("tracker", "parity", track)]),
            dict(name="smollm-135m", tree=tree, tp=tp,
                 conf=dict(RING_CONF, prefill_chunk=16),
                 scenarios=[("budget", "parity", budget)])]


@pytest.fixture(scope="module")
def world4(pairs, tmp_path_factory):
    """Every 4-rank task in one spawn: the mesh fleet's runs, its front
    ends and the shards of each sub-ring."""
    tree = _tree(pairs["smollm-135m"][0][3])
    runs = [dict(key="isolated", name="smollm-135m", tree=tree, tp=2,
                 conf=RING_CONF, prompts=RING_PROMPTS, max_new=RING_NEW,
                 lone=True),
            dict(key="opt", name="opt-1.3b",
                 tree=_tree(pairs["opt-1.3b"][0][3]), tp=2, conf=RING_CONF,
                 prompts=RING_PROMPTS, max_new=RING_NEW)]
    for name, (kw, prompts, new) in SCENARIOS.items():
        runs.append(dict(key=name, name="smollm-135m", tree=tree, tp=2,
                         conf=dict(FLEET, **kw), prompts=prompts,
                         max_new=new))
    track = tmp_path_factory.mktemp("fleet-tracker")
    per_rank = run_ranks(fleet_rank, 4, {
        "fleet": ("fleet", dict(runs=runs)),
        "frontends": ("frontends", dict(runs=_fe_runs(tree, 2, track))),
        "shards": ("shards", dict(name="smollm-135m", tp=2)),
        "refusals": ("refusals", dict(name="smollm-135m", tp=2)),
    }, device="cpu", threads=1)
    return per_rank, track


@pytest.fixture(scope="module")
def world2(pairs, tmp_path_factory):
    """The front end over a lone tp 2 ring (2 ranks)."""
    tree = _tree(pairs["smollm-135m"][0][3])
    track = tmp_path_factory.mktemp("ring-tracker")
    per_rank = run_ranks(fleet_rank, 2, {
        "frontends": ("frontends", dict(runs=_fe_runs(tree, 2, track)))},
        device="cpu", threads=1)
    return per_rank, track


def _quiet(fleet):
    for mon in fleet.monitors:
        mon.warmup = 10 ** 9
    return fleet


def _reference_fleet(pair, conf, prompts, new):
    (_, _, jmodel, jparams), _ = pair
    ref = _quiet(JaxFleet(jmodel, jparams, None, rings=2,
                          config=JaxEngineConfig(**conf)))
    rids = [ref.submit(p, new) for p in prompts]
    res = ref.drain()
    return ref, rids, res


def _by_kind(events):
    """Events as (kind, ring, reason), rounds dropped."""
    return [(k, d.get("ring"), d.get("reason")) for k, _, d in events]


# -- the mesh fleet against the reference's ---------------------------------


def test_mesh_fleet_isolated_and_balanced(pairs, world4):
    """2 x tp 2 sub-rings: disjoint ranks, least-loaded routing, the
    merged streams equal to the reference's tp=1 engine's and its host
    fleet's, the decode tokens of every request counted once."""
    per_rank, _ = world4
    (_, _, jmodel, jparams), _ = pairs["smollm-135m"]
    want = JaxEngine(jmodel, jparams, JaxEngineConfig(**RING_CONF)).generate(
        RING_PROMPTS, max_new_tokens=RING_NEW)
    ref, rids, res = _reference_fleet(pairs["smollm-135m"], RING_CONF,
                                      RING_PROMPTS, RING_NEW)
    assert [res[r] for r in rids] == want
    runs = [r["fleet"]["isolated"] for r in per_rank]
    st = runs[0]["state"]
    assert st["results"] == want
    assert sorted(st["routed"]) == [2, 2] == sorted(ref.router.routed)
    assert st["routed"] == list(ref.router.routed)
    assert sum(s["tokens"] for s in st["per_ring"]) == 4 * (RING_NEW - 1)
    subs = [set(r["sub_ranks"]) for r in runs]
    assert subs == [{0, 1}, {0, 1}, {2, 3}, {2, 3}]
    assert [r["ring"] for r in runs] == [0, 0, 1, 1]


def test_mesh_fleet_opt_matches_reference(pairs, world4):
    """Reduced opt-1.3b (biases and positions redrawn) on the mesh
    fleet: the reference tp=1 engine's streams."""
    per_rank, _ = world4
    (_, _, jmodel, jparams), _ = pairs["opt-1.3b"]
    want = JaxEngine(jmodel, jparams, JaxEngineConfig(**RING_CONF)).generate(
        RING_PROMPTS, max_new_tokens=RING_NEW)
    assert per_rank[0]["fleet"]["opt"]["state"]["results"] == want


# Where an earlier ring's orphans reach a later ring within a round, the
# mesh fleet's admission pass decodes them in windows of their own: the
# later ring's window counters then stand above the reference's by
# those windows ({scenario: {ring: {counter: (mesh fleet, reference)}}}),
# and with a block freed by its step before the pass admits the orphans
# its pool's peak below.  Every other counter is the reference's but the
# wall times and ``decode_stalls`` (the port counts only the prefills
# that froze another stream, ROADMAP §3).
PASS_COUNTERS = {
    "corrupt": {1: dict(steps=(8, 7), slot_steps=(16, 14),
                        host_syncs=(9, 8), bytes_to_host=(84, 74),
                        peak_pool_blocks=(1, 2))},
    "nan-window4": {1: dict(steps=(21, 14), slot_steps=(42, 28),
                            host_syncs=(9, 7), bytes_to_host=(252, 172))},
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_fleet_chaos_matches_reference(pairs, world4, name):
    """Results, structured failures, fleet counters, routes, events and
    the rounds equal the reference host fleet's under each chaos
    scenario (an orphan an earlier ring sends to a later one steps in
    the same round, through the later ring's admission pass); per-ring
    counters too, but the pass's windows (``PASS_COUNTERS``)."""
    per_rank, _ = world4
    kw, prompts, new = SCENARIOS[name]
    ref, rids, res = _reference_fleet(pairs["smollm-135m"],
                                      dict(FLEET, **kw), prompts, new)
    st = per_rank[0]["fleet"][name]["state"]
    assert st["results"] == [res[r] for r in rids]
    assert st["failed"] == {rid: (r.out, r.error, r.failed)
                            for rid, r in ref.failed.items()}
    assert st["fleet_counters"] == ref.fleet_counters()
    assert st["routed"] == list(ref.router.routed)
    assert st["ring_of"] == dict(ref.ring_of)
    want = [(e.kind, e.step, e.detail) for e in ref.events]
    assert _by_kind(st["events"]) == _by_kind(want)
    # the same rounds, and every event in the reference's round
    assert per_rank[0]["fleet"][name]["round"] == ref._round
    assert [e[1] for e in st["events"]] == [e[1] for e in want]
    for j, (mine, theirs) in enumerate(zip(st["per_ring"],
                                           ref.per_ring_stats())):
        apart = {k: (v, getattr(theirs, k)) for k, v in mine.items()
                 if k not in ("wall", "decode_stalls")
                 and hasattr(theirs, k) and getattr(theirs, k) != v}
        assert apart == PASS_COUNTERS.get(name, {}).get(j, {}), (name, j)
    assert st["fleet_counters"]["ring_failures"] >= 1
    assert not st["has_work"]


def test_mesh_fleet_state_same_on_every_rank(world4):
    """Every rank holds the same fleet: streams, failures, counters,
    per-ring stats, routes and events, run after run; and each dropped
    fleet is freed with its engine by reference count on every rank."""
    per_rank, _ = world4
    for key in per_rank[0]["fleet"]:
        states = [r["fleet"][key]["state"] for r in per_rank]
        assert all(s == states[0] for s in states[1:]), key
        rounds = {r["fleet"][key]["round"] for r in per_rank}
        assert len(rounds) == 1, key
        assert all(r["fleet"][key]["freed"] == [True, True]
                   for r in per_rank), key


def test_no_model_collective_crosses_sub_rings(world4):
    """The world group carries no collective; each sub-ring's are a
    lone engine's on the same requests on the same sub-ring (the same
    streams), and the agreement is rank 0's clock at the start, then one
    gather a round."""
    per_rank, _ = world4
    for r in per_rank:
        for key, run in r["fleet"].items():
            assert run["world"]["collectives"] == 0, key
            assert run["sub"]["collectives"] > 0, key
        run = r["fleet"]["isolated"]
        lone = run["lone"]
        assert lone["streams"] == lone["fleet_streams"]
        assert lone["decode_steps"] == run["decode_steps"]
        for k in ("collectives", "hops"):
            assert lone["sub"][k] == run["sub"][k], k
        # the start's clock from rank 0, then one gather of 4 a round
        a = run["agreement"]
        assert a["rounds"] == 1 + run["round"]
        assert a["objects"] == 1 + 4 * run["round"]


def test_every_sub_ring_draws_the_same_shards(world4):
    """``init_shard`` at a rank's place in its sub-ring (the handle or
    its int): rank r and r + 2 hold the same shard."""
    per_rank, _ = world4
    got = [r["shards"] for r in per_rank]
    assert all(g["equal_int"] for g in got)
    assert got[0]["digest"] == got[2]["digest"]
    assert got[1]["digest"] == got[3]["digest"]
    assert got[0]["digest"] != got[1]["digest"]


MESH_REFUSED = {
    "fleet_on_a_sub_ring": ("TypeError", "world ring"),
    "ring_size_not_a_divisor": ("ValueError", "does not split"),
    "ring_size_not_the_plan": ("ValueError", "planned for tp=2"),
    "frontend_on_a_sub_ring": ("ValueError", "one sub-ring's engine"),
    "split_a_sub_ring": ("ValueError", "does not split again"),
    "groups_in_a_sub_ring": ("ValueError", "inside a sub-ring"),
    "split_not_covering": ("ValueError", "disjoint groups"),
}


@pytest.mark.parametrize("case", list(MESH_REFUSED))
def test_mesh_refusals(world4, case):
    """What a world of sub-rings refuses, alike on every rank and before
    any collective (the spawn goes on to its other tasks)."""
    per_rank, _ = world4
    got = {r["refusals"][case] for r in per_rank}
    typ, text = MESH_REFUSED[case]
    assert len(got) == 1
    (g_typ, g_text), = got
    assert g_typ == typ and text in g_text, got


# -- the front end over a ring and over the fleet -----------------------------


def _reference_frontend(pairs, rings, name, kw, conf=RING_CONF):
    (_, _, jmodel, jparams), _ = pairs["smollm-135m"]
    jconf = JaxEngineConfig(**conf)
    eng = (JaxFleet(jmodel, jparams, None, rings=rings, config=jconf)
           if rings else JaxEngine(jmodel, jparams, jconf))
    fe_kw = {}
    if kw.get("budget_ms"):
        from repro.serving.budget import BudgetScheduler
        fe_kw["budget"] = BudgetScheduler(kw["budget_ms"],
                                          prior_step_s=2e-3, max_chunk=32)
    sk = {k: v for k, v in kw.items() if k in ("prompts", "new")}
    return run_scenario(jax_frontend, eng, name, sk, **fe_kw)[0]


WORLDS = {"ring": ("world2", 0), "fleet": ("world4", 2)}


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("key,name,kw", FE_SCENARIOS,
                         ids=[k for k, _, _ in FE_SCENARIOS])
def test_frontend_matches_reference(pairs, request, world, key, name, kw):
    """Parity, a cancel in the middle of a stream and ``max_pending``
    backpressure through the port's front end on rank 0 over a lone tp 2
    ring and over the mesh fleet: the reference front end's streams,
    statuses and counters (over its tp=1 engine and its two-ring host
    fleet), every rank's orders equal."""
    fixture, rings = WORLDS[world]
    per_rank, _ = request.getfixturevalue(fixture)
    want = _reference_frontend(pairs, rings, name, kw)
    got = [r["frontends"][key] for r in per_rank]
    assert got[0][0] == want
    assert all(g[0] is None for g in got[1:])
    assert len({(g[1], g[2]) for g in got}) == 1 and got[0][2] > 0


@pytest.mark.parametrize("world", list(WORLDS))
def test_frontend_budget_knobs_and_tracker(pairs, request, world):
    """The budget plans on rank 0 and every rank applies its knobs (the
    same ones, its last plan's); the streams are the reference budget
    front end's.  The tracker is written on rank 0 alone, one request
    record per request."""
    fixture, rings = WORLDS[world]
    per_rank, track = request.getfixturevalue(fixture)
    want = _reference_frontend(pairs, rings, "parity",
                               dict(FE_PARITY, budget_ms=BUDGET_MS),
                               conf=dict(RING_CONF, prefill_chunk=16))
    got = [r["frontends"]["budget"] for r in per_rank]
    assert got[0][0] == want
    plans = got[0][4]
    assert plans and all(c is None or 8 <= c <= 32 for c, _ in plans)
    assert len({(g[1], g[2], repr(g[3])) for g in got}) == 1
    last = plans[-(rings or 1):]
    assert got[0][3] == [(c, s) for c, s in last]
    recs = read_jsonl(str(track / "rank0.jsonl"))
    reqs = [r for r in recs if r["kind"] == "request"]
    assert sorted(r["rid"] for r in reqs) == sorted(
        set(r["rid"] for r in reqs))
    assert len(reqs) == len(FE_PROMPTS)
    for rank in range(1, len(per_rank)):
        assert read_jsonl(str(track / f"rank{rank}.jsonl")) == []


# -- the CLI ------------------------------------------------------------------

CLI = ["--reduced", "--device", "cpu", "--requests", "4", "--max-new", "6",
       "--max-seq", "64"]


@pytest.fixture(scope="module")
def cli_plain():
    with contextlib.redirect_stdout(io.StringIO()):
        return serve.main(CLI)


def test_cli_mesh_fleet(cli_plain, capfd):
    outs = serve.main(CLI + ["--tp", "2", "--rings", "2"])
    out = capfd.readouterr().out
    assert outs == cli_plain
    assert "4 requests over 2 sub-rings (tp=2 each), routed [2, 2]" in out
    assert "[serve] ft: chaos=off ring_failures=0 migrated=0 " in out
    assert "[serve] mesh fleet: 4 ranks" in out
    assert "world-ring collectives 0" in out


def test_cli_chaos_on_a_ring(cli_plain, capfd):
    outs = serve.main(CLI + ["--tp", "2", "--chaos", "ring@2"])
    out = capfd.readouterr().out
    assert outs == cli_plain
    assert "4 requests over 1 sub-rings (tp=2 each), routed [4]" in out
    assert "[serve] ft: chaos=ring@2 ring_failures=1 migrated=0 " \
        "retries=4 rejected=0 failed=0 events=3" in out


def test_cli_front_end_on_a_ring(cli_plain, capfd, tmp_path):
    path = tmp_path / "t.jsonl"
    outs = serve.main(CLI + ["--tp", "2", "--budget-ms", "5",
                             "--max-pending", "2", "--tracker", str(path)])
    out = capfd.readouterr().out
    assert outs == cli_plain
    assert "[serve] frontend: 4 completed 0 failed 0 cancelled " \
        "(1 backpressure rejections, 1 retried)" in out
    assert "[serve] frontend orders: " in out and " on each of 2 ranks" in out
    assert "[serve] budget=5.0ms: " in out
    recs = read_jsonl(str(path))
    assert f"[serve] tracker: {len(recs)} records -> {path}" in out
    assert [r["kind"] for r in recs].count("request") == 4


def test_cli_refuses_too_few_cards(monkeypatch):
    """On CUDA a card per rank: a machine with fewer cards than tp x
    rings raises and names both counts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError,
                       match="2 ring.*needs 4 cards; this machine has 2"):
        serve.main(["--tp", "2", "--rings", "2"])


# -- the step-time prior on the card -----------------------------------------


class _Clock:
    """``time`` of the engine module on a virtual clock that only a
    ring's step moves: the card's step times, read by the fleet's
    straggler monitors."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def time(self):
        return self.t


def test_healthy_card_fleet_flags_no_straggler(pairs, monkeypatch):
    """A healthy host fleet with ``ft_straggler_drain`` whose steps take
    ~30x the H100 roofline prior of smollm-135m (0.333 ms; the first
    step, with its prefills and captures, 10x that again, the others
    within 5% of each other), seeded as the serve driver seeds it on the
    card (no prior: the monitors' warm-up takes the first measured
    steps): no straggler event, nothing drained, the streams the
    blocking fleet's."""
    from repro_torch.core.latency_model import H100, step_time_prior
    _, (cfg, _, model, params) = pairs["smollm-135m"]
    args = serve._parser().parse_args(["--max-seq", "64"])
    prior = serve.step_prior(cfg, 1, torch.device("cuda"), args)
    assert prior == 0.0
    assert serve.step_prior(cfg, 1, torch.device("cpu"), args) > 0
    base = 30 * step_time_prior(serve.get_config("smollm-135m"), 1, H100,
                                kv_len=64)
    conf = EngineConfig(**RING_CONF, ft_straggler_drain=True)
    prompts = [[i + 1, i + 2, i + 3] for i in range(8)]
    clock = _Clock()
    monkeypatch.setattr(engine_mod, "time", clock)
    fleet = MultiRingEngine(model, params, None, rings=2, config=conf,
                            step_prior_s=prior, device="cpu")
    for eng in fleet.engines:
        steps = iter(range(10 ** 6))

        def timed(step=eng.step, steps=steps):
            k = next(steps)
            clock.t += base * (10.0 if k == 0 else 1 + 0.05 * (k % 3 - 1))
            return step()
        eng.step = timed
    outs = fleet.generate(prompts, 24)
    monkeypatch.undo()
    assert [e for e in fleet.events if e.kind == "straggler"] == []
    assert fleet.fleet_counters()["ring_failures"] == 0
    assert sum(m.n for m in fleet.monitors) > 2 * 20
    plain = MultiRingEngine(model, params, None, rings=2,
                            config=EngineConfig(**RING_CONF), device="cpu")
    assert outs == plain.generate(prompts, 24)


# tests/test_torch_tp_fleet_cuda.py's traffic
CARD_CONF = dict(slots=2, max_seq=64, block_size=16, prefill_chunk=8)
CARD_PROMPTS = [[int(t) for t in np.random.RandomState(13).randint(
    1, 512, size=n)] for n in (7, 19, 12, 9, 3, 25)]
CARD_NEW = 10


def test_card_fleet_rank_rehearsed_on_gloo():
    """The card test's rank function (``card_fleet_rank``) on 4 gloo
    ranks, its eager fleet alone: the front end's record on rank 0 is
    (streams, statuses, counters) as the card test unpacks it (its run
    on four cards found it holding the streams alone), the streams
    tp=1's, every rank's orders equal."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import LPUEngine
    from tests.torch_tp_fleet_util import card_fleet_rank
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    tp1 = LPUEngine(build_model(cfg, plan, "cpu"),
                    init_params(cfg, plan, seed=0, device="cpu"),
                    EngineConfig(**CARD_CONF), device="cpu").generate(
                        CARD_PROMPTS, max_new_tokens=CARD_NEW)
    per_rank = run_ranks(card_fleet_rank, 4, dict(
        name="smollm-135m", conf=CARD_CONF, prompts=CARD_PROMPTS,
        new=CARD_NEW, modes=(False,)), device="cpu", threads=1)
    outs, statuses, counters = per_rank[0]["frontend"]
    assert outs == tp1 and set(statuses) == {"completed"}
    assert counters["completed"] == len(CARD_PROMPTS)
    assert len({r["orders"] for r in per_rank}) == 1
    assert all(r[False]["streams"] == tp1 for r in per_rank)
