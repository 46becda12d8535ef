"""Rank functions of the port's tensor-parallel tests.

:func:`repro_torch.core.dist.run_ranks` spawns each rank as a fresh
process that imports the function it runs, so the functions live here,
at module level, and take only picklable arguments (numpy trees, dicts
of knobs).  Each one runs several scenarios per spawn and returns what
the test compares (rank 0's view, or every rank's via
``ring.gather_object``).
"""
from __future__ import annotations

import numpy as np
import torch

SERVE_F32 = dict(remat="none", compute_dtype="float32",
                 param_dtype="float32")


# ---------------------------------------------------------------------------
# ESL collective matmuls
# ---------------------------------------------------------------------------

def esl_rank(ring, cases):
    """Every case of ``cases`` (per-rank numpy locals ``x``, ``w``,
    ``b`` stacked on a leading rank axis, and the call's knobs) through
    the port's ``ag_matmul`` / ``rs_matmul`` on this rank's locals, then
    the helpers of scattered mode; returns every rank's outputs."""
    from repro_torch.core import dist, esl
    from repro_torch.core.rings import RingConfig
    r = ring.rank
    out = []
    for c in cases:
        x = torch.from_numpy(c["x"][r])
        w = torch.from_numpy(c["w"][r])
        b = torch.from_numpy(c["b"][r]) if c["b"] is not None else None
        sub = RingConfig(*c["ring"]) if c["ring"] else None
        kw = dict(axis=ring, tp=c["tp"], overlap=c["overlap"], b=b, ring=sub)
        if c["op"] == "ag":
            y = esl.ag_matmul(x, w, scattered_in=c["scattered_in"], **kw)
        else:
            y = esl.rs_matmul(x, w, scatter_out=c["scatter_out"], **kw)
        out.append(y.numpy())
    v = torch.arange(8, dtype=torch.float32) + 10 * r
    helpers = {
        "gather": esl.gather_scattered(v, axis=ring, tp=ring.size).numpy(),
        "scatter": esl.scatter_full(v, axis=ring, tp=ring.size).numpy(),
        "full_vec": esl.full_vec(v, axis=ring, tp=ring.size,
                                 scattered_activations=False).numpy(),
        "psum": dist.psum(v, ring).numpy(),
        "pmax": dist.pmax(v, ring).numpy(),
        "pmean": dist.pmean(v, ring).numpy(),
        "psum_scatter": dist.psum_scatter(v, ring).numpy(),
        "ppermute": dist.ppermute(v, ring, [(0, 1)]).numpy(),
        "counters": dict(ring.counters),
    }
    # the single-call ring sampler: greedy is the global argmax
    from repro_torch.serving.sampler import SamplingParams, sample_sharded
    row = torch.tensor([[0.1, 3.0, -1.0, 2.0, 0.5, 4.0, 1.0, -2.0]])
    c = 8 // ring.size
    helpers["sample_sharded"] = int(sample_sharded(
        row[:, r * c:(r + 1) * c], torch.Generator(), SamplingParams(0.0),
        ring, ring.size)[0])
    # a parameter is gathered once, again after an in-place change
    p = torch.arange(4, dtype=torch.float32) + 10 * r
    made = []
    for change in (False, False, True, False):
        if change:
            p.add_(1)
        full = dist.all_gather_param(p, ring)
        made.append((ring.counters["collectives"], full.numpy().copy()))
    helpers["param_gathers"] = made
    return ring.gather_object((out, helpers))


# ---------------------------------------------------------------------------
# the engine on the ring
# ---------------------------------------------------------------------------

def _rank_model(ring, name, tree, overlap):
    """(cfg, tp plan, model, this rank's shards) of reduced ``name`` on
    the weights ``tree`` (numpy, the tp=1 layout), stored again at the
    ring's layout."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.weights import params_from_jax, relayout, shard_params
    cfg = get_config(name).reduced()
    plan1 = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                       **SERVE_F32)
    plan = plan_model(cfg, ("model",), (ring.size,), "serve",
                      esl_overlap=overlap, **SERVE_F32)
    full = relayout(params_from_jax(tree, cfg, plan1, "cpu"), cfg, plan1,
                    plan)
    return cfg, plan, build_model(cfg, plan, "cpu"), \
        shard_params(full, plan, ring.rank)


def _serve(ring, model, params, prompts, max_new, conf, warm=None, sp=None):
    from repro_torch.kernels import read_launches, reset_launches
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    eng = LPUEngine(model, params, EngineConfig(**conf), mesh=ring,
                    device="cpu", graphs=False)
    reset_launches()
    ring.reset_counters()
    if warm is not None:
        eng.generate([warm], max_new_tokens=4)
    outs = eng.generate(prompts, max_new_tokens=max_new, params=sp)
    eng.check_pool_balanced()
    st = eng.stats
    return outs, {"preemptions": st.preemptions,
                  "prefill_chunks": st.prefill_chunks,
                  "prefix_hits": st.prefix_hits,
                  "device_decode_steps": st.device_decode_steps,
                  "kv_cache_bytes": eng.kv_cache_bytes(),
                  "per_rank_kv_bytes": eng.per_rank_kv_bytes(),
                  "rank_cache_bytes": sum(
                      t.numel() * t.element_size()
                      for c in eng.cache.values() for t in c.values()),
                  "launches": read_launches(),
                  "ring": dict(ring.counters)}


def engine_rank(ring, runs):
    """Each run of ``runs`` ({name, tree, overlap, scenarios: [{key,
    prompts, max_new, conf, warm}]}) served by this rank's engine on the
    ring; returns every rank's {key: (streams, stats)}."""
    out = {}
    for run in runs:
        _, _, model, params = _rank_model(ring, run["name"], run["tree"],
                                          run["overlap"])
        for sc in run["scenarios"]:
            out[sc["key"]] = _serve(ring, model, params, sc["prompts"],
                                    sc["max_new"], sc["conf"],
                                    warm=sc.get("warm"))
    return ring.gather_object(out)


def tp_rank(ring, tasks):
    """Several tasks in one spawn: {key: (function name, kwargs)} with
    the functions of this module (engine_rank, logits_rank,
    sampler_rank, guard_rank, refusals_rank); returns {key: result}."""
    fns = {f.__name__: f for f in (engine_rank, logits_rank, sampler_rank,
                                   guard_rank, refusals_rank)}
    return {key: fns[fn](ring, **kw) for key, (fn, kw) in tasks.items()}


def logits_rank(ring, name, tree, overlap, tokens, feed):
    """Logits (gathered whole) of a prefill of ``tokens`` (B, S) and one
    decode step per column of ``feed`` (B, steps), the tokens fed, on the
    rank's dense cache, through the model's forward on the ring."""
    from repro_torch.core import esl
    from repro_torch.core.dist import make_axis_env
    cfg, plan, model, params = _rank_model(ring, name, tree, overlap)
    env = make_axis_env(plan, ring=ring)
    tok = torch.from_numpy(tokens).long()
    B, S = tok.shape
    cache = model.init_cache(B, S + feed.shape[1])
    with torch.no_grad():
        lg, _ = model.forward(params, tok, mode="prefill", cache=cache,
                              positions=torch.arange(S).expand(B, S),
                              env=env)
        rows = [esl.gather_scattered(lg, axis=ring, tp=ring.size)]
        for i in range(feed.shape[1]):
            pos = torch.full((B,), S + i, dtype=torch.int32)
            lg, _ = model.forward(
                params, torch.from_numpy(feed[:, i:i + 1]).long(),
                mode="decode", positions=pos, cache=cache, env=env)
            rows.append(esl.gather_scattered(lg, axis=ring, tp=ring.size))
    return torch.cat(rows, 1).numpy()


def sampler_rank(ring, name, tree, row, temp, top_k, top_p, n_new):
    """The stochastic window's draws on the ring from a fixed logits
    row (the decode forward stubbed with this rank's columns of
    ``row``), every rank's."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    from repro_torch.serving.sampler import SamplingParams
    _, _, model, params = _rank_model(ring, name, tree, True)
    eng = LPUEngine(model, params, EngineConfig(
        slots=4, max_seq=4096, steps_per_sync=8), mesh=ring, device="cpu",
        seed=5, graphs=False)
    c = len(row) // ring.size
    stub = torch.from_numpy(np.repeat(
        row[None, ring.rank * c:(ring.rank + 1) * c], 4, 0))
    eng._decode_fn = lambda *a: stub
    outs = eng.generate([[1, 2, 3]] * 4, n_new,
                        SamplingParams(temp, top_k, top_p))
    return ring.gather_object(outs)


def guard_rank(ring, name, tree):
    """The NaN guard with only rank 1's window poisoned: every rank
    must refuse the window (RingFailure "nan_logits") at the same step,
    and serve on after a ``reset()``.  Returns every rank's record."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    from repro_torch.serving.ft import RingFailure
    _, _, model, params = _rank_model(ring, name, tree, True)
    eng = LPUEngine(model, params, EngineConfig(slots=2, max_seq=64,
                                                steps_per_sync=4),
                    mesh=ring, device="cpu", graphs=False)
    eng.submit([1, 2, 3, 4], max_new_tokens=12)
    eng.step()
    if ring.rank == 1:
        eng._poison_next = True
    rec = {"failed": None}
    try:
        while eng.has_work():
            eng.step()
    except RingFailure as e:
        rec["failed"] = (e.reason, e.step)
    orphans = eng.reset()
    rec["orphans"] = len(orphans)
    rec["after_reset"] = eng.generate([[5, 6, 7]], max_new_tokens=6)
    return ring.gather_object(rec)


def refusals_rank(ring, name, tree):
    """What the ring refuses, each as (exception type, message), and
    what it now serves in their place, each as ("ok", its result)."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.core import esl
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine, MultiRingEngine
    from repro_torch.serving.frontend import AsyncFrontend
    from repro_torch.weights import init_shard
    cfg, plan, model, params = _rank_model(ring, name, tree, True)
    conf = EngineConfig(slots=2, max_seq=64)
    out = {}
    prompts = [[5, 9, 5, 9, 5, 9, 5], [3, 1, 4, 1, 5]]

    def rec(key, fn):
        try:
            out[key] = ("ok", fn())
        except Exception as e:                      # noqa: BLE001
            out[key] = (type(e).__name__, str(e))

    def speculate():
        # the n-gram drafter on the ring: the plain ring's streams
        spec = LPUEngine(model, params, EngineConfig(
            slots=2, max_seq=64, speculate="ngram"), mesh=ring,
            device="cpu", graphs=False)
        got = spec.generate(prompts, max_new_tokens=8)
        plain = LPUEngine(model, params, conf, mesh=ring, device="cpu",
                          graphs=False).generate(prompts, max_new_tokens=8)
        return {"equal": got == plain, "rounds": spec.stats.spec_rounds}

    def llava():
        # llava's text decoder on the ring, its shard drawn alone: the
        # tp=1 engine's streams on the same weights
        c = get_config("llava-next-34b").reduced()
        p = plan_model(c, ("model",), (ring.size,), "serve", **SERVE_F32)
        p1 = plan_model(c, None, (1,), "serve", esl_overlap=False,
                        **SERVE_F32)
        m1 = build_model(c, p1, "cpu")
        want = LPUEngine(m1, m1.init(seed=0), conf, device="cpu").generate(
            prompts, max_new_tokens=8)
        got = LPUEngine(build_model(c, p, "cpu"), init_shard(
            c, p, ring.rank, seed=0, device="cpu"), conf, mesh=ring,
            device="cpu", graphs=False).generate(prompts, max_new_tokens=8)
        return {"equal": got == want}

    def verify():
        # a verify window of two queries on an empty pool: the prefill
        # logits of the same two tokens (both gathered whole)
        env = eng.env
        tok = torch.tensor([[7, 11]])
        cache = model.init_cache(1, 64, paged=True, num_blocks=3,
                                 block_size=16)
        v, _ = model.forward(
            params, tok, mode="verify", positions=torch.tensor([[0, 1]]),
            cache=cache, block_tables=torch.tensor([[1], [1]],
                                                   dtype=torch.int32),
            kv_valid_len=torch.tensor([1, 2], dtype=torch.int32), env=env)
        pre, _ = model.forward(params, tok, mode="prefill", env=env,
                               cache=model.init_cache(1, 2))
        v, pre = (esl.gather_scattered(x, axis=ring, tp=ring.size)
                  for x in (v, pre))
        return {"shape": tuple(v.shape),
                "max_abs": float((v - pre).abs().max())}

    rec("graphs", lambda: LPUEngine(model, params, conf, mesh=ring,
                                    device="cpu"))
    rec("speculate", speculate)
    rec("full_tree", lambda: LPUEngine(
        model, {"embed": torch.zeros(plan.vocab_padded, 4)}, conf,
        mesh=ring, device="cpu", graphs=False))
    rec("no_ring", lambda: LPUEngine(model, params, conf, device="cpu"))
    c = get_config("whisper-tiny").reduced()
    p = plan_model(c, ("model",), (ring.size,), "serve", **SERVE_F32)
    rec("whisper-tiny", lambda: LPUEngine(build_model(c, p, "cpu"), params,
                                          conf, mesh=ring, device="cpu",
                                          graphs=False))
    rec("llava-next-34b", llava)
    def data_axis():
        # the grid's plan is served; the engine on it is not ported
        c = get_config("llama4").reduced()
        p = plan_model(c, ("data", "model"), (1, ring.size), "serve",
                       **SERVE_F32)
        return LPUEngine(build_model(c, p, "cpu"),
                         init_shard(c, p, ring.rank, device="cpu"), conf,
                         mesh=ring, device="cpu", graphs=False)
    rec("data_axis", data_axis)
    plain = LPUEngine(model, params, conf, mesh=ring, device="cpu",
                      graphs=False).generate(prompts, max_new_tokens=8)

    def fleet():
        # one sub-ring of the whole ring: the plain ring's streams
        f = MultiRingEngine(model, params, ring, ring_size=2, config=conf,
                            device="cpu", graphs=False)
        got = f.generate(prompts, max_new_tokens=8)
        return {"equal": got == plain, "routed": list(f.router.routed)}

    def frontend():
        # rank 0's front end orders both ranks: the plain ring's streams
        import asyncio
        fe = AsyncFrontend(eng)
        if ring.rank:
            fe.follow()
            return {"equal": True, "crc": fe.orders_crc}

        async def go():
            async with fe:
                streams = [fe.submit(p, 8) for p in prompts]
                return [await s.drain() for s in streams]
        return {"equal": asyncio.run(go()) == plain, "crc": fe.orders_crc}
    rec("fleet", fleet)
    eng = LPUEngine(model, params, conf, mesh=ring, device="cpu",
                    graphs=False)
    rec("frontend", frontend)
    rec("verify", verify)
    return out
