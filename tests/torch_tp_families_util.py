"""Rank functions of the tests of the rwkv, hybrid and MoE families on
the model ring (``tests/test_torch_tp_families.py`` on the CPU,
``tests/test_torch_tp_families_cuda.py`` on 2 or more cards).

:func:`repro_torch.core.dist.run_ranks` spawns each rank as a fresh
process that imports the function it runs, so the functions live here,
at module level, import nothing of JAX and take only picklable
arguments (numpy trees in the tp=1 layout, dicts of knobs).
:func:`families_rank` runs several tasks per spawn.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

SERVE_F32 = dict(remat="none", compute_dtype="float32",
                 param_dtype="float32")


def reduced_cfg(name, n_experts=None):
    """The port's reduced ``name``, its MoE cut to ``n_experts``."""
    from repro_torch.configs import get_config
    cfg = get_config(name).reduced()
    if n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=n_experts))
    return cfg


def ring_model(ring, cfg, overlap, tree=None):
    """(plan, model, this rank's shards) of ``cfg`` on the ring: the
    tp=1 ``tree`` (numpy, the reference's layout) stored at the ring's
    layout and sliced, or (no tree) the shard drawn alone from seed 0
    (``weights.init_shard``)."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.models.registry import build_model
    from repro_torch.weights import (init_shard, params_from_jax, relayout,
                                     shard_params)
    plan = plan_model(cfg, ("model",), (ring.size,), "serve",
                      esl_overlap=overlap, **SERVE_F32)
    if tree is None:
        params = init_shard(cfg, plan, ring.rank, device=ring.device)
    else:
        plan1 = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                           **SERVE_F32)
        params = shard_params(relayout(params_from_jax(
            tree, cfg, plan1, ring.device), cfg, plan1, plan), plan,
            ring.rank)
    return plan, build_model(cfg, plan, ring.device), params


def _block(ring, x, dim, whole):
    """This rank's block of ``x`` along ``dim`` (all of it if whole)."""
    if whole:
        return x
    c = x.shape[dim] // ring.size
    return x.narrow(dim, ring.rank * c, c).contiguous()


def _whole(ring, t, dim, whole):
    """``t`` gathered along ``dim`` from every rank (itself if whole)."""
    from repro_torch.core import dist
    return t if whole else dist.all_gather(t.contiguous(), ring, dim=dim)


def layers(ring, name, tree, cases, n_experts=None):
    """Each case {key, layer (mamba|tmix|cmix|moe), block ("l{j}"),
    overlap, x (B,S,D) numpy, state (numpy dict or None)} through the
    port's layer on this rank's shards and slices (x scattered under
    overlap), the output and the new state gathered whole.  Returns
    rank 0's {key: {"y", "state", "aux"?}} as numpy."""
    from repro_torch.core.dist import make_axis_env
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.models.transformer import layer_params
    cfg = reduced_cfg(name, n_experts)
    out, built = {}, {}
    for c in cases:
        ov = c["overlap"]
        if ov not in built:
            built[ov] = ring_model(ring, cfg, ov, tree)
        plan, _, params = built[ov]
        env = make_axis_env(plan, ring=ring)
        p = layer_params(params, 0)[c["block"]][c["layer"]]
        x = _block(ring, torch.from_numpy(c["x"]), -1, not ov)
        st = {k: torch.from_numpy(v) for k, v in (c["state"] or {}).items()}
        rec = {}
        with torch.no_grad():
            if c["layer"] == "mamba":
                state = ({"conv": _block(ring, st["conv"], -1, False),
                          "ssm": _block(ring, st["ssm"], 1, False)}
                         if st else None)
                y, new = mamba_mod.mamba_fwd(p, x, cfg=cfg, plan=plan,
                                             state=state, env=env)
                rec["state"] = {"conv": _whole(ring, new["conv"], -1, False),
                                "ssm": _whole(ring, new["ssm"], 1, False)}
            elif c["layer"] == "tmix":
                state = ({"shift": _block(ring, st["shift"], -1, not ov),
                          "wkv": _block(ring, st["wkv"], 1, False)}
                         if st else None)
                y, new = rwkv_mod.time_mix_fwd(p, x, cfg=cfg, plan=plan,
                                               state=state, env=env)
                if new is not None:
                    rec["state"] = {
                        "shift": _whole(ring, new["shift"], -1, not ov),
                        "wkv": _whole(ring, new["wkv"], 1, False)}
            elif c["layer"] == "cmix":
                state = (_block(ring, st["shift"], -1, not ov) if st
                         else None)
                y, new = rwkv_mod.channel_mix_fwd(p, x, cfg=cfg, plan=plan,
                                                  state=state, env=env)
                if new is not None:
                    rec["state"] = {"shift": _whole(ring, new, -1, not ov)}
            else:
                y, aux = moe_mod.moe_fwd(p, x, cfg=cfg, plan=plan, env=env)
                rec["aux"] = float(aux)
        rec["y"] = _whole(ring, y, -1, not ov)
        out[c["key"]] = {k: ({n: t.numpy() for n, t in v.items()}
                             if isinstance(v, dict) else
                             v.numpy() if torch.is_tensor(v) else v)
                         for k, v in rec.items()}
    return out


def serve(ring, name, overlap, conf, prompts, max_new, tree=None,
          graphs=False, nccl=False):
    """This rank's engine of reduced ``name`` on the ring (its shards
    from ``tree``, or drawn alone), serving ``prompts`` greedily after a
    warm-up request; returns this rank's streams and counts (the family
    kernel's launches and the ring's counters from zero over the served
    run)."""
    from repro_torch.launch.serve import family_kernel
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    cfg = reduced_cfg(name)
    _, model, params = ring_model(ring, cfg, overlap, tree)
    kernel = family_kernel(cfg)
    # the NCCL stand-in runs on the CPU only, where tests/ is a package
    stand_in = contextlib.nullcontext()
    if nccl:
        from tests.torch_tp_cards_util import as_nccl
        stand_in = as_nccl(ring, True)
    with stand_in:
        eng = LPUEngine(model, params, EngineConfig(**conf), mesh=ring,
                        device=ring.device, graphs=graphs)
        eng.generate(prompts[:1], max_new_tokens=2)
        st0 = dataclasses.replace(eng.stats)
        kernel.launches = 0
        ring.reset_counters()
        streams = eng.generate(prompts, max_new_tokens=max_new)
        if ring.device.type == "cuda":
            torch.cuda.synchronize(ring.device)
        st = eng.stats
        steps = st.device_decode_steps - st0.device_decode_steps
        per = (steps + st.prefills - st0.prefills
               if cfg.family == "hybrid" else steps)
        n = (sum(not cfg.is_attention_layer(i) for i in range(cfg.n_layers))
             if cfg.family == "hybrid" else cfg.n_layers)
        rec = {"streams": streams, "kernel": kernel.__name__,
               "launches": kernel.launches, "launches_want": n * per,
               "device_decode_steps": st.device_decode_steps
               - st0.device_decode_steps,
               "prefills": st.prefills - st0.prefills,
               "preemptions": st.preemptions - st0.preemptions,
               "replays": st.graph_replays - st0.graph_replays,
               "captures": st.graph_captures,
               "counters": dict(ring.counters),
               "cache_shapes": {lj: {k: tuple(v.shape) for k, v in c.items()}
                                for lj, c in eng.cache.items()}}
        if eng.paged:
            eng.check_pool_balanced()
    return rec


def families_rank(ring, tasks):
    """Several tasks in one spawn: {key: (function name, kwargs)} with
    :func:`layers` and :func:`serve`; returns every rank's {key:
    result}."""
    fns = {"layers": layers, "serve": serve, "kernels": kernels_at_ranks}
    return ring.gather_object({key: fns[fn](ring, **kw)
                               for key, (fn, kw) in tasks.items()})


def kernels_at_ranks(ring, shapes, seed=0):
    """Kernels 4 and 5 on this rank's card at the ranks' shapes
    (``shapes``: {"rwkv": [(B, S, H, dh)], "mamba": [(B, S, C, N)]})
    against their plain versions, outside any counted run: {call: max
    abs error, bit-equal, finite}."""
    from repro_torch.kernels import held_launches
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_fused_ref
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
    from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref
    dev = ring.device
    g = torch.Generator(device=dev).manual_seed(seed + ring.rank)

    def rnd(*sh, scale=1.0):
        return torch.randn(sh, generator=g, device=dev) * scale
    out = {}
    for B, S, H, dh in shapes["rwkv"]:
        r, k, v = rnd(B, S, H, dh), rnd(B, S, H, dh), rnd(B, S, H, dh)
        w = torch.rand((B, S, H, dh), generator=g, device=dev) * 0.5 + 0.45
        u, s0 = rnd(H, dh, scale=0.5), rnd(B, H, dh, dh, scale=0.1)
        with held_launches():
            got = rwkv_scan(r, k, v, w, u, s0)
        want = rwkv_scan_ref(r, k, v, w, u, s0)
        out[f"rwkv_scan {(B, S, H, dh)}"] = _err(got, want)
    for B, S, C, N in shapes["mamba"]:
        dt = torch.nn.functional.softplus(rnd(B, S, C))
        x, a = rnd(B, S, C), -torch.exp(rnd(C, N, scale=0.5))
        b, c, h0 = rnd(B, S, N), rnd(B, S, N), rnd(B, C, N, scale=0.1)
        with held_launches():
            got = mamba_scan_fused(dt, x, a, b, c, h0)
        want = mamba_scan_fused_ref(dt, x, a, b, c, h0)
        out[f"mamba_scan_fused {(B, S, C, N)}"] = _err(got, want)
    return out


def _err(got, want):
    return {"max_abs_err": max((a - b).abs().max().item()
                               for a, b in zip(got, want)),
            "bit_equal": all(torch.equal(a, b) for a, b in zip(got, want)),
            "finite": all(bool(torch.isfinite(a).all()) for a in got)}
