"""Rank functions of the tests of the serving steps on a ``("data",
"model")`` grid of ranks (``tests/test_torch_data_axis.py`` on the CPU,
``tests/test_torch_data_axis_cuda.py`` on 4 cards).

:func:`repro_torch.core.dist.run_ranks` spawns each rank as a fresh
process that imports the function it runs, so the functions live here,
at module level, import nothing of JAX or of ``tests.`` (the card
machine's copy imports this file by path) and take only picklable
arguments: numpy trees in the tp=1 layout and dicts of knobs.  Each
returns every rank's record (``Ring.gather_object``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SERVE_F32 = dict(remat="none", compute_dtype="float32",
                 param_dtype="float32")


def force_data_model(plan, d_ff_expert: int):
    """``plan`` (either package's, on a ``("data", "model")`` mesh) with
    its MoE's experts spread over data x model as the giant-MoE rule
    spreads them (``ep = gcd(E, dwidth * tp)``), whatever the model's
    size: the reduced configs are far below the rule's 12e9 x tp."""
    sizes = dict(zip(plan.mesh_axes, plan.mesh_shape))
    w = sizes["data"] * sizes["model"]
    m = plan.moe
    ep = math.gcd(m.n_experts, w)
    split = w // ep
    dffe = -(-d_ff_expert // max(split * 8, 8)) * max(split * 8, 8)
    moe = dataclasses.replace(
        m, ep=ep, ffn_split=split, experts_per_rank=m.n_experts // ep,
        d_ff_expert_shard=dffe // split, expert_axes=("data", "model"))
    rules = dict(plan.rules)
    rules["experts"] = ("data", "model")
    return dataclasses.replace(plan, moe=moe, rules=rules)


def grid_cfg(name, capacity_factor=None, depth=None):
    """The port's reduced ``name``, its MoE's capacity factor replaced;
    with ``depth`` its full-width config cut to that many layers."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, n_layers=depth) if depth else \
        cfg.reduced()
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def grid_plan(cfg, shape, overlap=True, kv_seq=False, force=False):
    """The port's serving plan of ``cfg`` on the grid ``shape`` (dwidth,
    tp), or on one device (``shape`` None)."""
    from repro_torch.compiler.mapper import plan_model
    if shape is None:
        return plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                          **SERVE_F32)
    plan = plan_model(cfg, ("data", "model"), shape, "serve",
                      esl_overlap=overlap,
                      kv_seq_axis="data" if kv_seq else None, **SERVE_F32)
    return force_data_model(plan, cfg.moe.d_ff_expert) if force else plan


def rank_params(ring, cfg, plan, tree):
    """This rank's shards of the tp=1 numpy ``tree`` (the reference's
    layout), stored at ``plan``'s layout; drawn alone from seed 0
    (``weights.init_shard``) without a tree."""
    from repro_torch.weights import (init_shard, params_from_jax, relayout,
                                     shard_params)
    if tree is None:
        return init_shard(cfg, plan, ring, seed=0, device=ring.device)
    plan1 = grid_plan(cfg, None)
    return shard_params(relayout(params_from_jax(tree, cfg, plan1,
                                                 ring.device),
                                 cfg, plan1, plan), plan, ring.rank)


def moe_rank(ring, spec):
    """Each case {key, overlap, cf, x (B,S,D) numpy} through the port's
    ``moe_fwd`` on this rank: its data row's rows of ``x`` (scattered
    over the model ring under ESL overlap), its expert cell of reduced
    ``spec["name"]`` forced onto data x model.  Returns every rank's
    {key: {"y", "aux"}} (the rank's block of the output, numpy) and the
    data ring's collectives per call."""
    from repro_torch.core.dist import make_axis_env
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import layer_params
    out = {}
    for c in spec["cases"]:
        cfg = grid_cfg(spec["name"], c["cf"])
        plan = grid_plan(cfg, spec["shape"], c["overlap"], force=True)
        params = rank_params(ring, cfg, plan, spec["tree"])
        x = torch.from_numpy(c["x"])
        env = make_axis_env(plan, batch=x.shape[0], ring=ring)
        per = x.shape[0] // env.dp_width
        d, m = env.data.rank, env.model.rank
        x = x[d * per:(d + 1) * per]
        if c["overlap"] and env.tp > 1:
            w = x.shape[-1] // env.tp
            x = x[..., m * w:(m + 1) * w].contiguous()
        p = layer_params(params, 0)[spec["block"]]["moe"]
        before = env.data.counters["collectives"]
        with torch.no_grad():
            y, aux = moe_mod.moe_fwd(p, x, cfg=cfg, plan=plan, env=env)
        out[c["key"]] = {"y": y.numpy(), "aux": float(aux),
                         "data_collectives":
                             env.data.counters["collectives"] - before}
    return ring.gather_object({"rank": ring.rank, "out": out})


def _full_logits(env, logits):
    """The rank's vocab columns gathered over its model ring."""
    from repro_torch.core import dist
    if env.tp == 1:
        return logits
    return dist.all_gather(logits.contiguous(), env.model, dim=-1)


def seq_rank(ring, spec):
    """Reduced ``spec["name"]`` (a hybrid) on the grid ``spec["shape"]``
    with its KV sequence sharded over ``data``: the prompt (1, P) through
    the forward in prefill, then ``spec["feed"]`` tokens one decode step
    each at positions P, P+1, ..; the full logits of every step and the
    rank's attention caches after prefill and at the end.  Returns
    every rank's record (numpy)."""
    from repro_torch.core.dist import make_axis_env
    from repro_torch.models.registry import build_model
    cfg = grid_cfg(spec["name"])
    plan = grid_plan(cfg, spec["shape"], spec["overlap"], kv_seq=True,
                     force=spec.get("force", False))
    params = rank_params(ring, cfg, plan, spec["tree"])
    model = build_model(cfg, plan, ring.device)
    prompt = torch.from_numpy(spec["prompt"])
    env = make_axis_env(plan, batch=prompt.shape[0], ring=ring)
    cache = model.init_cache(prompt.shape[0], spec["max_seq"], env=env)

    def attn_cache():
        return {lj: {k: v.clone().numpy() for k, v in c.items()}
                for lj, c in cache.items() if "k" in c}
    logits = []
    with torch.no_grad():
        lg, cache = model.forward(params, prompt, mode="prefill",
                                  cache=cache, env=env)
        logits.append(_full_logits(env, lg[:, -1]).numpy())
        after_prefill = attn_cache()
        P = prompt.shape[1]
        for i, tok in enumerate(spec["feed"]):
            t = torch.full((prompt.shape[0], 1), int(tok), dtype=torch.long)
            pos = torch.full((prompt.shape[0],), P + i, dtype=torch.int32)
            lg, cache = model.forward(params, t, mode="decode",
                                      positions=pos, cache=cache, env=env)
            logits.append(_full_logits(env, lg[:, -1]).numpy())
    return ring.gather_object({
        "rank": ring.rank, "d": env.data.rank, "m": env.model.rank,
        "logits": np.stack(logits), "after_prefill": after_prefill,
        "final": attn_cache(), "dp": env.dp,
        "kv_seq_width": env.kv_seq_width})


def serve_grid(ring, model, params, tokens, new, max_seq, extra=None):
    """The grid's prefill step on ``tokens`` (B, P), then ``new`` serve
    steps of the greedy tokens (``core/steps.py`` on the rank's world
    ``ring``).  Returns ([the prefill's tokens, each step's] (B,) lists,
    the data ring's collectives per serve step, the env)."""
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    from repro_torch.kernels import reset_launches
    B, P = tokens.shape
    reset_launches()
    pre, meta = build_prefill_step(model, ring, B, max_seq)
    serve, _ = build_serve_step(model, ring, B, max_seq)
    env = meta["env"]
    cache = model.init_cache(B, max_seq, env=env)
    with torch.no_grad():
        tok, cache = pre(params, cache, tokens, **(extra or {}))
        got = [tok.tolist()]
        per_step = []
        for i in range(new):
            before = env.data.counters["collectives"]
            pos = torch.full((B,), P + i, dtype=torch.int32,
                             device=tokens.device)
            tok, cache = serve(params, cache, tok[:, None].long(), pos)
            per_step.append(env.data.counters["collectives"] - before)
            got.append(tok.tolist())
    return got, per_step, env


def steps_rank(ring, spec):
    """Each case {key, name, shape, kv_seq, force, tree, tokens (B, P)
    numpy, new, max_seq} through the grid's prefill and serve steps.
    Returns every rank's {key: {"tokens", "data_per_step", "dp"}}."""
    from repro_torch.models.registry import build_model
    out = {}
    for c in spec["cases"]:
        cfg = grid_cfg(c["name"], depth=c.get("depth"))
        plan = grid_plan(cfg, c["shape"], c.get("overlap", True),
                         kv_seq=c.get("kv_seq", False),
                         force=c.get("force", False))
        params = rank_params(ring, cfg, plan, c["tree"])
        model = build_model(cfg, plan, ring.device)
        got, per_step, env = serve_grid(
            ring, model, params,
            torch.from_numpy(c["tokens"]).long().to(ring.device),
            c["new"], c["max_seq"])
        out[c["key"]] = {"tokens": got, "data_per_step": per_step,
                         "dp": env.dp}
        if ring.device.type == "cuda":
            from repro_torch.kernels import read_launches
            out[c["key"]]["kernel5_launches"] = \
                read_launches()["mamba_scan_fused"]
        del model, params
    return ring.gather_object({"rank": ring.rank, "out": out})


def grid_rank(ring, spec):
    """Every task of one grid in one spawn: the MoE cases per name
    (:func:`moe_rank`), the steps (:func:`steps_rank`) and the
    sequence-sharded decode (:func:`seq_rank`)."""
    return {"moe": {n: moe_rank(ring, s) for n, s in spec["moe"].items()},
            "steps": steps_rank(ring, spec["steps"]),
            "seq": seq_rank(ring, spec["seq"])}
