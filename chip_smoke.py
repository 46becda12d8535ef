#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line when any phase fails or when no CUDA device is present):

1. device — the card's name and power limit (nvidia-smi);
2. build  — compile every hand-written kernel from ``src/repro_torch``
   (one nvcc per source, started together) and print the build time;
3. kernel — hold each kernel against its plain PyTorch version on the
   card at the main path's shapes, then time kernel, plain version and
   a PyTorch library call of the same function, beside the bound the
   card's data sheet gives for the same work;
4. engine — serve full-width smollm-135m (random weights from seed 0)
   through ``LPUEngine``: the streamed paged kernel, the gather oracle,
   and a run that preempts with 4-step windows; the greedy streams must
   agree and the kernel must have launched once per layer per decode
   step.

The last lines are a ``{"kernels": [...]}`` line, an ``{"engine": ...}``
line, the nvidia-smi line and ``{"ok": true, "device": {...}}``.
Imports nothing of JAX: the port stands alone.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# data-sheet HBM bandwidth (bytes/s) by the name nvidia-smi reports
BANDWIDTH = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
             ("H200", 4.8e12), ("H100", 3.35e12))
# data-sheet peak rates (op/s): f32 off the tensor cores, bf16/f16 dense
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 3e-2, "float16": 3e-2}

# main-path shapes of the paged kernel: smollm-135m at slots=4,
# max_seq=512, block_size=128 (T=4, dense-equivalent pool N=17)
B, H, G, DH, BS, T, N = 4, 9, 3, 64, 128, 4, 17
LENGTHS = (0, 77, 300, 511)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def bandwidth_for(name: str) -> float:
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    raise RuntimeError(f"no data-sheet bandwidth known for {name!r}")


def kernel_inputs(torch, dev, q_dtype, kv_dtype, seed=0, fill=None):
    """Paged-attention inputs at the main path's shapes: ragged lengths
    (one row empty), table tails on the null block 0, block 0 filled
    with ``fill`` when given."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    q = rnd(B, H, DH, dtype=q_dtype)
    kp = rnd(N, BS, G, DH, dtype=kv_dtype)
    vp = rnd(N, BS, G, DH, dtype=kv_dtype)
    kn = rnd(B, G, DH, dtype=q_dtype)
    vn = rnd(B, G, DH, dtype=q_dtype)
    tables = torch.zeros((B, T), dtype=torch.int32)
    for b, n in enumerate(LENGTHS):
        used = -(-n // BS)
        tables[b, :used] = torch.arange(1 + T * b, 1 + T * b + used)
    if fill is not None:
        kp[0] = fill
        vp[0] = fill
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    return q, kp, vp, tables.to(dev), lengths.to(dev), kn, vn


def check_paged_kernel(torch, dev):
    """Kernel vs plain version on the card: f32/bf16/f16 pools, with and
    without the fold; block 0 scribbled must change nothing.  Returns
    the largest error per dtype pair."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref
    errs = {}
    cases = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float16, torch.float16), (torch.float32, torch.bfloat16))
    for q_dt, kv_dt in cases:
        name = str(kv_dt).split(".")[-1]
        tol = TOL[name]
        key = f"q={str(q_dt).split('.')[-1]},pool={name}"
        errs[key] = 0.0
        for fold in (False, True):
            base = None
            for fill in (None, 1e30, -1e30):
                if fill is not None:
                    fill = min(fill, torch.finfo(kv_dt).max) if fill > 0 \
                        else max(fill, -torch.finfo(kv_dt).max)
                q, kp, vp, tb, ln, kn, vn = kernel_inputs(
                    torch, dev, q_dt, kv_dt, fill=fill)
                extra = dict(k_new=kn, v_new=vn) if fold else {}
                got = paged_decode_attention(q, kp, vp, tb, ln, **extra)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{key} fold={fold} fill={fill}: "
                                         "non-finite kernel output")
                if fill is None:
                    base = got
                    want = paged_decode_attention_ref(q, kp, vp, tb, ln,
                                                      **extra)
                    err = (got.float() - want.float()).abs().max().item()
                    if not torch.allclose(got.float(), want.float(),
                                          rtol=tol, atol=tol):
                        raise AssertionError(
                            f"{key} fold={fold}: kernel vs plain beyond "
                            f"rtol=atol={tol} (max abs error {err})")
                    errs[key] = max(errs[key], err)
                    if not fold and got[0].abs().max().item() != 0.0:
                        raise AssertionError("length-0 row without a fold "
                                             "must be zeros")
                elif not torch.equal(got, base):
                    raise AssertionError(
                        f"{key} fold={fold}: null block filled with {fill} "
                        "changed the output")
    return errs


def time_ms(torch, fn, n_sets, iters=200, warmup=20):
    """(device ms, host ms) of one call, cycling over ``n_sets`` input
    sets so the caches stay cold like the main path's per-layer pools.

    Host ms is the wall time per call launched back to back (Python
    dispatch included).  Device ms comes from CUDA events around the
    same calls queued behind a device-side sleep that outlasts their
    launching, so they run back to back on the card and the host's
    dispatch cost is hidden."""
    for i in range(warmup):
        fn(i % n_sets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i % n_sets)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)   # cycles, >= 2 GHz
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, host_s / iters * 1e3


def time_paged_kernel(torch, dev, card_name):
    """Kernel, plain and library times at the main path's shapes (f32,
    with the fold, as decode calls it) and the data-sheet bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
    q, kp, vp, tb, ln, kn, vn = kernel_inputs(torch, dev, torch.float32,
                                              torch.float32)
    pool_bytes = 2 * kp.numel() * kp.element_size()
    n_sets = max(1, math.ceil(2 * 50e6 / pool_bytes))   # > 2x the 50 MB L2
    pools = [(kp.clone(), vp.clone()) for _ in range(n_sets)]

    def kernel(i):
        paged_decode_attention(q, pools[i][0], pools[i][1], tb, ln,
                               k_new=kn, v_new=vn)

    def plain(i):
        paged_decode_attention_ref(q, pools[i][0], pools[i][1], tb, ln,
                                   k_new=kn, v_new=vn)

    S = T * BS
    valid = torch.arange(S, device=dev)[None, :] < ln[:, None]
    mask = torch.cat([valid, torch.ones((B, 1), dtype=torch.bool,
                                        device=dev)], 1)[:, None, None, :]

    def library(i):
        k = gather_kv_pages(pools[i][0], tb)
        v = gather_kv_pages(pools[i][1], tb)
        k = torch.cat([k, kn[:, None]], 1).transpose(1, 2)
        v = torch.cat([v, vn[:, None]], 1).transpose(1, 2)
        F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                       enable_gqa=True)

    times = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        times[key], times[key.replace("ms", "host_ms")] = \
            time_ms(torch, fn, n_sets)
    # least work: q, the valid K/V rows, the new token, tables, lengths
    # read once and the output written once; 4*dh flops per q head per
    # attended position (score dot + P.V)
    item = 4
    rows = sum(LENGTHS)
    nbytes = item * (B * H * DH + 2 * rows * G * DH + 2 * B * G * DH
                     + B * H * DH) + 4 * (B * T + B)
    ops = 4 * DH * H * (rows + B)
    t_bytes = nbytes / bandwidth_for(card_name) * 1e3
    t_ops = ops / PEAK_OPS["float32"] * 1e3
    times["bound_ms"] = max(t_bytes, t_ops)
    times["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return times


def serve(torch, dev, model, params, prompts, **kw):
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    eng = LPUEngine(model, params, EngineConfig(slots=4, max_seq=512, **kw),
                    device=dev)
    paged_decode_attention.launches = 0
    outs = eng.generate(prompts, max_new_tokens=32)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return outs, eng, paged_decode_attention.launches


def profile_engine(torch, dev, model, params, prompts, wall_s):
    """Device time by kernel over the same streamed run under
    torch.profiler; the busy share divides it by that run's unprofiled
    wall time.  None where the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(torch, dev, model, params, prompts, paged_kernel="stream")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    paged_us = sum(e.self_device_time_total for e in kernels
                   if "paged_decode_kernel" in e.key)
    return {"device_busy_ms": busy_us / 1e3,
            "unprofiled_wall_ms": wall_s * 1e3,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "paged_kernel_ms": paged_us / 1e3,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def run_engine(torch, dev):
    import numpy as np
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build_model
    cfg = get_config("smollm-135m")
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, dev)
    params = init_params(cfg, plan, seed=0, device=dev)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                            size=rng.randint(2, 65))]
               for _ in range(8)]
    serve(torch, dev, model, params, prompts[:2], paged_kernel="stream")
    stream, eng, launches = serve(torch, dev, model, params, prompts,
                                  paged_kernel="stream")
    st = eng.stats
    if st.device_decode_steps == 0 or \
            launches != cfg.n_layers * st.device_decode_steps:
        raise AssertionError(
            f"kernel launches {launches} != n_layers {cfg.n_layers} x "
            f"decode steps {st.device_decode_steps}")
    for o in stream:
        if len(o) != 32 or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"bad stream {o}")
    profile = profile_engine(torch, dev, model, params, prompts, st.wall)
    gather, geng, glaunch = serve(torch, dev, model, params, prompts,
                                  paged_kernel="gather")
    if gather != stream:
        raise AssertionError("stream and gather greedy streams differ")
    if glaunch != 0:
        raise AssertionError("the gather oracle launched the kernel")
    pre, peng, plaunch = serve(torch, dev, model, params, prompts,
                               paged_kernel="stream", block_size=32,
                               num_blocks=7, steps_per_sync=4)
    if peng.stats.preemptions == 0:
        raise AssertionError("the small pool did not force a preemption")
    if pre != stream:
        raise AssertionError("streams under preemption and 4-step "
                             "windows differ")
    if plaunch != cfg.n_layers * peng.stats.device_decode_steps:
        raise AssertionError("launch count under preemption")
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": "float32", "slots": 4,
            "max_seq": 512, "requests": len(prompts), "max_new": 32,
            "tokens": st.tokens, "tokens_per_s": st.tokens_per_s,
            "wall_s": st.wall, "decode_steps": st.steps,
            "device_decode_steps": st.device_decode_steps,
            "kernel_launches": launches,
            "gather_tokens_per_s": geng.stats.tokens_per_s,
            "preempt_run": {"block_size": 32, "num_blocks": 7,
                            "steps_per_sync": 4,
                            "preemptions": peng.stats.preemptions,
                            "device_decode_steps":
                                peng.stats.device_decode_steps,
                            "kernel_launches": plaunch},
            "streams_equal_gather": True,
            "streams_equal_preempt": True,
            "profile": profile}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    took = build.build()
    print(f"[build] {len(took)} kernel(s) built in "
          f"{time.perf_counter() - t0:.1f} s: {took}")
    for name in build.SOURCES:
        print(f"[build] {name} ptxas: "
              + " | ".join(ln.strip() for ln in build.build_log(name)
                           .splitlines() if "registers" in ln or
                           "spill" in ln)[:600])

    errs = check_paged_kernel(torch, dev)
    print(f"[kernel] paged_decode_attention vs plain: {errs}")
    times = time_paged_kernel(torch, dev, smi)
    print(f"[kernel] paged_decode_attention timing: {times}")

    engine = run_engine(torch, dev)
    print(f"[engine] {engine['tokens']} tokens, "
          f"{engine['tokens_per_s']:.1f} tok/s, "
          f"{engine['decode_steps']} decode steps, "
          f"{engine['preempt_run']['preemptions']} preemptions in the "
          "small-pool run")

    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": os.path.relpath(
            build.source_path("paged_decode_attention"), HERE),
        "replaces": "src/repro/kernels/decode_attention/"
                    "decode_attention.py:142",
        "ok": True, "launches": engine["kernel_launches"],
        "max_abs_err": errs["q=float32,pool=float32"],
        "max_abs_err_by_dtype": errs,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
        "host_ms": times["host_ms"], "plain_host_ms": times["plain_host_ms"],
        "library_host_ms": times["library_host_ms"],
        "shapes": {"B": B, "H": H, "G": G, "dh": DH, "bs": BS, "T": T,
                   "N": N, "lengths": list(LENGTHS), "dtype": "float32",
                   "fold": True},
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"engine": engine}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
