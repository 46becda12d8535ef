#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line when any phase fails or when no CUDA device is present):

1. device — the card's name and power limit (nvidia-smi);
2. build  — compile every hand-written kernel from ``src/repro_torch``
   (one nvcc per source, started together) and print the build time;
3. kernel — hold each kernel against its plain PyTorch version on the
   card at the main paths' shapes, then time kernel, plain version and
   a PyTorch library call of the same function, beside the bound the
   card's data sheet gives for the same work: the paged decode attention
   (f32/bf16/f16 pools, and int8/fp8 pools with their scales; and at the
   edges of its split over 16 blocks, for all five pool types with and
   without the fold: lengths 0, 1, 15, 16, 17, bs - 1, bs, bs + 1, 300,
   511 and T*bs over tables out of order, each row alone bit-identical
   to its row in the batch, the null block inert, the length-0 row the
   mean of its table's V rows), the dense
   decode attention (each row alone bit-identical to its row in the
   batch; the chunked prefill's stride-0 cache at C = 64), and the decode
   GEMV at the four shapes of one full-width layer (f32, bf16 and int8
   weights; B = 4 bit-identical to four B = 1 calls); first, the timing
   floor: a one-element ``add_`` timed the same way;
4. engine — serve full-width smollm-135m (random weights from seed 0)
   through ``LPUEngine``: the streamed paged kernel, the gather oracle,
   and a run that preempts with 4-step windows; the greedy streams must
   agree and the kernel must have launched once per layer per decode
   step;
5. chain — the C1 streamlined chain (``core/streamline.py``) at full
   width: 4 prompts prefilled by the model, then 32 teacher-forced decode
   steps of ``decode_layer`` stacked over the 30 layers, in six variants
   (paged stream, paged gather, dense, int8 pool, fp8 pool, int8
   weights), each with kernels and with the plain versions; logits are
   held against each other and (fp variants) against the model's own
   decode, launches per step must be exact; plus one full-width
   ``chunk_prefill_layer`` (C = 64) against 64 sequential decode steps,
   through kernel 1 and through kernel 2's broadcast cache, and
   a torch.profiler pass of the stream and the dense variants (device ms
   per step of each port kernel);
6. rwkv — kernel 4 (the WKV recurrence) bit-identical to its plain
   version at the reference test's shapes, the decode shape
   (4, 1, 64, 64), a prefill length (1, 512, 64, 64), dh 32, 64, 100
   and 128 and B*H = 1, timed at the decode and prefill shapes (at the
   prefill length
   beside the port's chunked form too); then full-width rwkv6-7b (32
   layers, f32, random weights from seed 0, ~30 GB) served through
   ``LPUEngine``: 8 prompts x 32 new tokens on 4 slots, exactly 32 kernel
   launches per device decode step and none in prefill, a torch.profiler
   pass, and a teacher-forced replay of the streams with the kernel and
   with its plain version (logits within 1e-4, greedy tokens equal to the
   plain oracle's argmax wherever its top-2 gap exceeds 1e-4);
7. jamba — after the rwkv phase's model is freed: kernel 5 (the
   selective scan), both entries (a: da, bx given; b: fused, da and bx
   formed in registers from dt, x, a, b) bit-identical to their plain
   versions at the reference test's shapes, the decode shape
   (4, 1, 8192, 16) and the prefill shapes (1, 64, 8192, 16) and
   (1, 512, 8192, 16), timed at the last three, entry (b) beside the
   path it replaced (PyTorch's producers of da and bx, then entry a);
   then jamba-v0.1-52b at full width, its depth cut from 32 layers to one
   super-block of 8 (attention at index 4, mamba at the other seven, MoE
   on the odd layers; 13.3e9 parameters, 53 GB in f32: the full depth
   does not fit the card), random weights from seed 0, served through
   ``LPUEngine`` from the dense cache: 8 prompts x 32 new tokens on 4
   slots, exactly 7 launches of entry (b) per device decode step and per
   prefill, a torch.profiler pass, and a teacher-forced replay of the
   streams in the engine's batching with the kernel and with its plain
   version (logits within 1e-4, greedy tokens equal to the plain
   oracle's argmax wherever its top-2 gap exceeds 1e-4).

A ``[time]`` line closes each phase and one gives the total.  The last
lines are a ``{"kernels": [...], "floor_ms": ...}`` line, an
``{"engine": ...}`` line, a ``{"chain": ...}`` line, an ``{"rwkv": ...}``
line, a ``{"jamba": ...}`` line, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX: the port
stands alone.
"""
from __future__ import annotations

import gc
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
    without the fold; the length-0 row without the fold is the mean of
    its table's V rows; block 0 scribbled must change no row that
    attends something.  Returns the largest error per dtype pair."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
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
                    if not fold:
                        # length-0 row: the mean of the V rows of its
                        # whole table (all on the null block here)
                        mean = gather_kv_pages(vp, tb)[0].float().mean(0)
                        got0 = got[0].float().reshape(G, H // G, DH)
                        if not torch.allclose(got0, mean[:, None].expand(
                                -1, H // G, -1), rtol=tol, atol=tol):
                            raise AssertionError(
                                f"{key}: length-0 row without a fold is "
                                "not the mean of its table's V rows")
                else:
                    # the null block is inert for rows that attend
                    # something (length > 0, or the fold)
                    keep = (ln > 0) | fold
                    if not torch.equal(got[keep], base[keep]):
                        raise AssertionError(
                            f"{key} fold={fold}: null block filled with "
                            f"{fill} changed the output")
    return errs


def time_ms(torch, fn, n_sets, iters=200, warmup=20):
    """(device ms, host ms) of one call, cycling over ``n_sets`` input
    sets so the caches stay cold like the main path's per-layer pools.

    Host ms is the wall time per call launched back to back (Python
    dispatch included).  Device ms comes from CUDA events around the
    same calls queued behind a device-side sleep that outlasts their
    launching, so they run back to back on the card and the host's
    dispatch cost is hidden.  When the launching took longer than the
    sleep can have lasted (the host slowed down between the two loops),
    the calls may have been paced by the host, and the run is repeated
    behind a 4x longer sleep, up to twice.  That holds while the queued
    launches fit the driver's queue: for a function of many small
    launches (a plain version) the device ms may be paced by the host,
    and is then an upper bound."""
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
    cycles = int(4e9 * host_s) + 1_000_000
    for _ in range(3):
        torch.cuda._sleep(cycles)
        t1 = time.perf_counter()
        start.record()
        for i in range(iters):
            fn(i % n_sets)
        stop.record()
        queued_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        if queued_s < 0.9 * cycles / 2.0e9:   # the sleep's least length
            break
        cycles *= 4
    return start.elapsed_time(stop) / iters, host_s / iters * 1e3


def time_floor(torch, dev):
    """(device ms, host ms) of a call of known-trivial device work, a
    one-element ``add_`` on a tensor already on the card, through the
    same time_ms: the floor under every single-launch kernel's time."""
    t = torch.zeros(1, device=dev)
    return time_ms(torch, lambda i: t.add_(1.0), 1)


def time_paged_kernel(torch, dev, card_name):
    """Kernel, plain and library times at the main path's shapes (f32,
    with the fold, as decode calls it) and the data-sheet bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        SPLIT, dense_plan, paged_decode_attention)
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
    q, kp, vp, tb, ln, kn, vn = kernel_inputs(torch, dev, torch.float32,
                                              torch.float32)
    pool_bytes = 2 * kp.numel() * kp.element_size()
    n_sets = sets_for(pool_bytes)
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

    times = timed(torch, {"ms": kernel, "plain_ms": plain,
                          "library_ms": library}, n_sets)
    # least work: q, the valid K/V rows, the new token, tables, lengths
    # read once and the output written once; 4*dh flops per q head per
    # attended position (score dot + P.V)
    item = 4
    rows = sum(LENGTHS)
    nbytes = item * (B * H * DH + 2 * rows * G * DH + 2 * B * G * DH
                     + B * H * DH) + 4 * (B * T + B)
    times["bound_ms"], times["bound_by"] = bound_for(
        nbytes, 4 * DH * H * (rows + B), "float32", card_name)
    L, stages = dense_plan(T * BS, DH, 4)
    times["plan"] = {"grid": [SPLIT, G, B], "cluster": [SPLIT, 1, 1],
                     "blocks": SPLIT * G * B, "tile_rows": L,
                     "stages": stages}
    return times


def bound_for(nbytes, ops, op_dtype, card_name):
    """(bound ms, what bounds it): the larger of the bytes over the
    data-sheet bandwidth and the operations over the data-sheet peak."""
    t_bytes = nbytes / bandwidth_for(card_name) * 1e3
    t_ops = ops / PEAK_OPS[op_dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def timed(torch, fns, n_sets, iters=None):
    """{"ms", "host_ms", ...} for each named function, as time_ms gives
    them; ``iters`` ({name: (iters, warmup)}) shortens the slow ones."""
    out = {}
    for key, fn in fns.items():
        it, warm = (iters or {}).get(key, (200, 20))
        out[key], out[key.replace("ms", "host_ms")] = time_ms(
            torch, fn, n_sets, iters=it, warmup=warm)
    return out


def sets_for(nbytes):
    """Input sets to cycle so the working set exceeds twice the L2."""
    return max(1, math.ceil(2 * 50e6 / nbytes))


def check_time_quantized_pool(torch, dev, card_name):
    """Kernel 1 with int8 and fp8 pools (f16 scales per row and kv head)
    against its plain version at the main path's shapes, with and without
    the fold; timed without the fold, as the chain calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
    from repro_torch.serving.kv_cache import quantize_kv_rows
    out = {}
    for name, qdt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        q, kp, vp, tb, ln, kn, vn = kernel_inputs(torch, dev, torch.float32,
                                                  torch.float32, seed=3)
        kq, ks = quantize_kv_rows(kp, qdt, torch.float16)
        vq, vs = quantize_kv_rows(vp, qdt, torch.float16)
        err = 0.0
        for fold in (False, True):
            extra = dict(k_new=kn, v_new=vn) if fold else {}
            got = paged_decode_attention(q, kq, vq, tb, ln, k_scale=ks,
                                         v_scale=vs, **extra)
            want = paged_decode_attention_ref(q, kq, vq, tb, ln, k_scale=ks,
                                              v_scale=vs, **extra)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            if not torch.isfinite(got).all() or not torch.allclose(
                    got, want, rtol=TOL["float32"], atol=TOL["float32"]):
                raise AssertionError(f"{name} pool fold={fold}: kernel vs "
                                     f"plain beyond 1e-4 (max abs {e})")
            err = max(err, e)
        n_sets = sets_for(2 * (kq.numel() + 2 * ks.numel()))
        pools = [(kq.clone(), vq.clone(), ks.clone(), vs.clone())
                 for _ in range(n_sets)]
        S = T * BS
        mask = (torch.arange(S, device=dev)[None, :] <
                ln[:, None])[:, None, None, :]

        def kernel(i, pools=pools, q=q, tb=tb, ln=ln):
            k, v, a, b = pools[i]
            paged_decode_attention(q, k, v, tb, ln, k_scale=a, v_scale=b)

        def plain(i, pools=pools, q=q, tb=tb, ln=ln):
            k, v, a, b = pools[i]
            paged_decode_attention_ref(q, k, v, tb, ln, k_scale=a,
                                       v_scale=b)

        def library(i, pools=pools, q=q, tb=tb, mask=mask):
            k, v, a, b = pools[i]
            kf = gather_kv_pages(k, tb).float() * gather_kv_pages(
                a, tb).float()[..., None]
            vf = gather_kv_pages(v, tb).float() * gather_kv_pages(
                b, tb).float()[..., None]
            F.scaled_dot_product_attention(
                q[:, :, None], kf.transpose(1, 2), vf.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        t = timed(torch, {"ms": kernel, "plain_ms": plain,
                          "library_ms": library}, n_sets)
        rows = sum(LENGTHS)
        nbytes = (4 * 2 * B * H * DH + 2 * rows * G * (DH + 2)
                  + 4 * (B * T + B))
        t["bound_ms"], t["bound_by"] = bound_for(
            nbytes, 4 * DH * H * rows, "float32", card_name)
        t["max_abs_err"] = err
        out[name] = t
    return out


# kernel 1's split at its edges, at the main path's pool (bs 128, T 4):
# lengths on share and pool-block boundaries (300 and 511: shares of 19
# and 32 rows, the first crossing blocks), each row's blocks out of order
SPLIT_LENGTHS = (0, 1, 15, 16, 17, BS - 1, BS, BS + 1, 300, 511, T * BS)


def split_inputs(torch, dev, pool_dtype, seed=5):
    """(q, kp, vp, tables, lengths, kn, vn, scales) at SPLIT_LENGTHS, the
    rows' blocks drawn from a shuffled pool, table tails on the null
    block 0; an int8 / fp8 pool is quantized from an f32 one with f16
    scales (q stays f32)."""
    from repro_torch.serving.kv_cache import quantize_kv_rows
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = len(SPLIT_LENGTHS)
    n_blocks = nb * T + 1
    quant = pool_dtype in (torch.int8, torch.float8_e4m3fn)
    q_dtype = torch.float32 if quant else pool_dtype

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    perm = torch.randperm(n_blocks - 1, generator=g, device=dev) + 1
    tables = torch.zeros((nb, T), dtype=torch.int32, device=dev)
    for b, n in enumerate(SPLIT_LENGTHS):
        used = -(-n // BS)
        tables[b, :used] = perm[b * T:b * T + used]
    kp, vp = rnd(n_blocks, BS, G, DH), rnd(n_blocks, BS, G, DH)
    scales = {}
    if quant:
        kp, ks = quantize_kv_rows(kp, pool_dtype, torch.float16)
        vp, vs = quantize_kv_rows(vp, pool_dtype, torch.float16)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=dev)
    return (rnd(nb, H, DH).to(q_dtype), kp, vp, tables, lengths,
            rnd(nb, G, DH).to(q_dtype), rnd(nb, G, DH).to(q_dtype), scales)


def check_paged_split(torch, dev):
    """Kernel 1 at its split's edges, for f32, bf16, f16, int8 and fp8
    pools, with and without the fold: within tolerance of its plain
    version; each row alone bit-equal to its row in the batch; the
    length-0 row the mean of its table's V rows (v_new with the fold);
    the null block inert under +-1e30 fills (the largest stored values
    and f16 scales for a quantized pool).  Returns the largest error per
    case."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref
    errs = {}
    for pool_dtype in (torch.float32, torch.bfloat16, torch.float16,
                       torch.int8, torch.float8_e4m3fn):
        name = str(pool_dtype).split(".")[-1]
        tol = TOL.get(name, TOL["float32"])
        for fold in (False, True):
            key = f"{name},fold={fold}"
            q, kp, vp, tb, ln, kn, vn, sc = split_inputs(torch, dev,
                                                         pool_dtype)
            extra = dict(k_new=kn, v_new=vn) if fold else {}
            got = paged_decode_attention(q, kp, vp, tb, ln, **sc, **extra)
            want = paged_decode_attention_ref(q, kp, vp, tb, ln, **sc,
                                              **extra)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.isfinite(got).all() or not torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol):
                raise AssertionError(f"split {key}: kernel vs plain beyond "
                                     f"rtol=atol={tol} (max abs {err})")
            errs[key] = err
            for b in range(len(SPLIT_LENGTHS)):
                one = {k: v[b:b + 1] for k, v in extra.items()}
                alone = paged_decode_attention(q[b:b + 1], kp, vp,
                                               tb[b:b + 1], ln[b:b + 1],
                                               **sc, **one)
                if not torch.equal(alone[0], got[b]):
                    raise AssertionError(f"split {key}: row {b} alone "
                                         "differs from its row in the batch")
            if fold:
                row0 = vn[0].float()[:, None].expand(-1, H // G, -1)
            else:
                v0 = vp[tb[0].long()].float()             # (T, BS, G, DH)
                if sc:
                    v0 = v0 * sc["v_scale"][tb[0].long()].float()[..., None]
                row0 = v0.reshape(-1, G, DH).mean(0)[:, None].expand(
                    -1, H // G, -1)
            if not torch.allclose(got[0].float().reshape(G, H // G, DH),
                                  row0, rtol=tol, atol=tol):
                raise AssertionError(f"split {key}: the length-0 row is not "
                                     + ("v_new" if fold else
                                        "the mean of its table's V rows"))
            for fill in (1e30, -1e30):
                kz, vz = kp.clone(), vp.clone()
                scz = {k: v.clone() for k, v in sc.items()}
                if sc:
                    big = 127.0 if pool_dtype == torch.int8 else 448.0
                    for v in scz.values():
                        v[0] = 65504.0 if fill > 0 else -65504.0
                else:
                    big = min(abs(fill), torch.finfo(pool_dtype).max)
                for t, val in ((kz, big if fill > 0 else -big), (vz, -big)):
                    t[0] = torch.full(t.shape[1:], val,
                                      device=dev).to(pool_dtype)
                out = paged_decode_attention(q, kz, vz, tb, ln, **scz,
                                             **extra)
                keep = (ln > 0) | fold
                if not torch.isfinite(out).all() or \
                        not torch.equal(out[keep], got[keep]):
                    raise AssertionError(f"split {key}: null block filled "
                                         f"with {fill} changed the output")
    return errs


# dense decode attention (kernel 2) at the chain's dense shapes, and the
# chunked prefill's call (C queries over one request's cache broadcast
# over the batch, lengths start + i + 1)
DENSE_S = 512
DENSE_LENGTHS = (0, 78, 301, 512)
CHUNK_START = 300


def check_time_dense(torch, dev, card_name):
    """Kernel 2 against its plain version on the card, f32/bf16/f16,
    lengths with an empty row (the mean of its S V rows), each row alone
    bit-equal to its row in the batch, and the chunked prefill's stride-0
    cache at C = 64 queries; timed in f32 beside gather-free SDPA on the
    same cache."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (SPLIT,
                                                          decode_attention,
                                                          dense_plan)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    g = torch.Generator(device=dev).manual_seed(1)
    ln = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device=dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dt).split(".")[-1]
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for shape in ((B, H, DH), (B, DENSE_S, G, DH),
                                 (B, DENSE_S, G, DH)))
        got = decode_attention(q, k, v, ln)
        want = decode_attention_ref(q, k, v, ln)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[name]
        if not torch.isfinite(got).all() or not torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"dense {name}: kernel vs plain beyond "
                                 f"rtol=atol={tol} (max abs {err})")
        mean = v[0].float().mean(0)                        # (G, DH)
        if not torch.allclose(got[0].float().reshape(G, H // G, DH),
                              mean[:, None].expand(-1, H // G, -1),
                              rtol=tol, atol=tol):
            raise AssertionError(f"dense {name}: length-0 row is not the "
                                 "mean of its V rows")
        for b in range(B):
            if not torch.equal(decode_attention(q[b:b + 1], k[b:b + 1],
                                                v[b:b + 1], ln[b:b + 1])[0],
                               got[b]):
                raise AssertionError(f"dense {name}: row {b} alone differs "
                                     "from its row in the batch")
        errs[name] = err
    # the chunked prefill's call: one cache read in place by C queries
    qc = torch.randn((CHUNK_C, H, DH), generator=g, device=dev)
    kc, vc = (torch.randn((1, DENSE_S, G, DH), generator=g, device=dev)
              .expand(CHUNK_C, -1, -1, -1) for _ in range(2))
    lc = torch.arange(CHUNK_START + 1, CHUNK_START + CHUNK_C + 1,
                      dtype=torch.int32, device=dev)
    got = decode_attention(qc, kc, vc, lc)
    err = (got - decode_attention_ref(qc, kc, vc, lc)).abs().max().item()
    if not torch.isfinite(got).all() or err > TOL["float32"]:
        raise AssertionError(f"dense stride-0 cache, C={CHUNK_C}: kernel vs "
                             f"plain max abs {err}")
    errs["float32,stride0,C=64"] = err
    q = torch.randn((B, H, DH), generator=g, device=dev)
    k = torch.randn((B, DENSE_S, G, DH), generator=g, device=dev)
    n_sets = sets_for(2 * k.numel() * 4)
    caches = [(k.clone(), k.clone() * 0.5) for _ in range(n_sets)]
    mask = (torch.arange(DENSE_S, device=dev)[None, :] <
            ln[:, None])[:, None, None, :]
    t = timed(torch, {
        "ms": lambda i: decode_attention(q, *caches[i], ln),
        "plain_ms": lambda i: decode_attention_ref(q, *caches[i], ln),
        "library_ms": lambda i: F.scaled_dot_product_attention(
            q[:, :, None], caches[i][0].transpose(1, 2),
            caches[i][1].transpose(1, 2), attn_mask=mask,
            enable_gqa=True)}, n_sets)
    # least work: q, the valid K rows, the valid V rows (all S for an
    # empty row, which averages them), the output, lengths
    k_rows = sum(DENSE_LENGTHS)
    v_rows = k_rows + DENSE_S * sum(n == 0 for n in DENSE_LENGTHS)
    nbytes = 4 * (2 * B * H * DH + (k_rows + v_rows) * G * DH + B)
    ops = 4 * DH * H * k_rows + v_rows * G * DH
    t["bound_ms"], t["bound_by"] = bound_for(nbytes, ops, "float32",
                                             card_name)
    L, stages = dense_plan(DENSE_S, DH, 4)
    t["plan"] = {"grid": [SPLIT, G, B], "cluster": [SPLIT, 1, 1],
                 "blocks": SPLIT * G * B, "tile_rows": L, "stages": stages}
    return errs, t


# the four gemvs of one full-width smollm-135m layer at B = 4 decode rows
GEMV_SHAPES = (("qkv", 576, 960), ("o", 576, 576), ("gate_up", 576, 3072),
               ("down", 1536, 576))


def check_time_gemv(torch, dev, card_name):
    """Kernel 3 against its plain version at the chain's four shapes, f32,
    bf16 and int8 weights, with and without bias; the B = 4 result must
    equal four B = 1 calls bit for bit.  Timed without bias, beside
    torch.matmul on the fp weight."""
    from repro_torch.kernels.gemv.ops import gemv, gemv_plan, quantize_weight
    from repro_torch.kernels.gemv.ref import gemv_ref
    g = torch.Generator(device=dev).manual_seed(2)
    errs, per_call = {}, []
    for shape_name, K, N in GEMV_SHAPES:
        for wname in ("float32", "bfloat16", "int8"):
            xdt = torch.bfloat16 if wname == "bfloat16" else torch.float32
            x = torch.randn((B, K), generator=g, device=dev).to(xdt)
            wf = torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)
            if wname == "int8":
                w, sc = quantize_weight(wf)
                wlib = wf
            else:
                w, sc = wf.to(xdt), None
                wlib = w
            tol = TOL["float32"] if wname == "float32" else 3e-2
            for bias in (False, True):
                b = torch.randn((N,), generator=g, device=dev).to(xdt) \
                    if bias else None
                got = gemv(x, w, b, w_scale=sc)
                want = gemv_ref(x, w, b, w_scale=sc)
                rows = torch.cat([gemv(x[i:i + 1], w, b, w_scale=sc)
                                  for i in range(B)])
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                key = f"{shape_name},{wname},bias={bias}"
                if not torch.isfinite(got).all() or not torch.allclose(
                        got.float(), want.float(), rtol=tol, atol=tol):
                    raise AssertionError(f"gemv {key}: kernel vs plain "
                                         f"beyond {tol} (max abs {err})")
                if not torch.equal(rows, got):
                    raise AssertionError(f"gemv {key}: B=4 differs from "
                                         "four B=1 calls")
                errs[key] = err
            n_sets = sets_for(w.numel() * w.element_size())
            ws = [w.clone() for _ in range(n_sets)]
            wls = [wlib.clone() for _ in range(n_sets)] \
                if wname == "int8" else ws
            t = timed(torch, {
                "ms": lambda i: gemv(x, ws[i], w_scale=sc),
                "plain_ms": lambda i: gemv_ref(x, ws[i], w_scale=sc),
                "library_ms": lambda i: torch.matmul(x.to(wls[i].dtype),
                                                     wls[i])}, n_sets)
            nbytes = (B * K * x.element_size() + K * N * w.element_size()
                      + B * N * x.element_size() + (4 * N if sc is not None
                                                    else 0))
            t["bound_ms"], t["bound_by"] = bound_for(
                nbytes, 2 * B * K * N, str(xdt).split(".")[-1], card_name)
            ksplit, n_tiles = gemv_plan(K, N)
            t.update(shape=shape_name, K=K, N=N, B=B, w_dtype=wname,
                     ksplit=ksplit, blocks=ksplit * n_tiles)
            per_call.append(t)
            del ws, wls
    return errs, per_call


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


# the C1 chain: 32 teacher-forced decode steps in six variants, named
# (cache, paged dataflow, w_dtype)
CHAIN_STEPS = 32
CHAIN_VARIANTS = (("stream", "pool", "stream", "auto"),
                  ("gather", "pool", "gather", "auto"),
                  ("dense", "dense", "auto", "auto"),
                  ("int8_pool", "int8", "stream", "auto"),
                  ("fp8_pool", "fp8", "stream", "auto"),
                  ("int8_weights", "pool", "stream", "int8"))
# largest |logit| difference allowed, kernels vs plain and (fp variants)
# chain vs the model's decode: f32 end to end, only the order of sums
# differs.  Quantized pools: kernels and plain quantize new rows from K/V
# that differ in the last bits, so a row may round one step apart.
CHAIN_TOL = 1e-4
CHAIN_TOL_QUANT = 1e-2
CHUNK_C = 64


def _counts():
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.gemv.ops import gemv
    from repro_torch.kernels.mamba_scan.ops import (mamba_scan,
                                                    mamba_scan_fused)
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
    return gemv, paged_decode_attention, decode_attention, rwkv_scan, \
        mamba_scan, mamba_scan_fused


def _reset_counts():
    for fn in _counts():
        fn.launches = 0


def _read_counts():
    return {fn.__name__: fn.launches for fn in _counts()}


def run_chain(torch, ctx, cache0, tables, use_kernels, paged_kernel,
              w_dtype):
    """32 teacher-forced steps of decode_layer stacked over the layers,
    from a copy of ``cache0``; -> (logits (steps, B, V_pad), wall s)."""
    from repro_torch.core import streamline as sl
    from repro_torch.models.common import apply_norm
    from repro_torch.models.transformer import lm_logits
    cfg, plan, params = ctx["cfg"], ctx["plan"], ctx["params"]
    cache = {k: v.clone() for k, v in cache0.items()}
    layers = [{k: v[i] for k, v in cache.items()}
              for i in range(cfg.n_layers)]
    pos = ctx["lens"].clone()
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(CHAIN_STEPS):
        x = params["embed"][ctx["tokens"][step]]
        for i, lp in enumerate(ctx["layers"]):
            x, _ = sl.decode_layer(lp, x, layers[i], pos, cfg=cfg, plan=plan,
                                   use_kernels=use_kernels,
                                   block_table=tables,
                                   paged_kernel=paged_kernel,
                                   w_dtype=w_dtype)
        out.append(lm_logits(params, apply_norm(params["ln_f"], x,
                                                cfg.norm), cfg, plan))
        pos = pos + 1
    torch.cuda.synchronize()
    return torch.stack(out), time.perf_counter() - t0


def chain_context(torch, dev):
    """Full-width smollm-135m (f32, random weights from seed 0), the
    engine phase's first 4 prompts prefilled by the model into a paged
    pool (block 128, max_seq 512) and a dense cache, and the model's own
    greedy decode: its tokens drive every variant (teacher forcing), its
    logits are the reference."""
    import numpy as np
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import layer_params
    from repro_torch.serving.kv_cache import (scatter_prefill_dense,
                                              scatter_prefill_pages)
    cfg = get_config("smollm-135m")
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, dev)
    params = init_params(cfg, plan, seed=0, device=dev)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                            size=rng.randint(2, 65))]
               for _ in range(8)][:4]
    max_seq, bs = 512, 128
    T = max_seq // bs
    nb = 1 + len(prompts) * T
    tables = (1 + torch.arange(len(prompts) * T, dtype=torch.int32,
                               device=dev)).reshape(len(prompts), T)
    pool = model.init_cache(len(prompts), max_seq, paged=True,
                            num_blocks=nb, block_size=bs)
    dense = model.init_cache(len(prompts), max_seq)
    first = []
    for b, pr in enumerate(prompts):
        buf = torch.zeros((1, bs), dtype=torch.long, device=dev)
        buf[0, :len(pr)] = torch.tensor(pr, device=dev)
        logits, pc = model.forward(params, buf, mode="prefill",
                                   cache=model.init_cache(1, bs),
                                   positions=torch.arange(bs,
                                                          device=dev)[None])
        first.append(int(logits[0, len(pr) - 1].argmax()))
        scatter_prefill_pages(pool, pc, tables[b, :1])
        scatter_prefill_dense(dense, pc, b)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    caches = {"pool": {k: v.clone() for k, v in pool["l0"].items()},
              "dense": {k: v.clone() for k, v in dense["l0"].items()}}
    # the model's own greedy decode (paged, streamed through kernel 1)
    tok = torch.tensor(first, device=dev)
    tokens, ref = [], []
    pos = lens.clone()
    for _ in range(CHAIN_STEPS):
        tokens.append(tok)
        logits, _ = model.forward(params, tok[:, None], mode="decode",
                                  positions=pos, cache=pool,
                                  block_tables=tables,
                                  paged_kernel="stream")
        ref.append(logits[:, -1])
        tok = logits[:, -1].argmax(-1)
        pos = pos + 1
    return {"cfg": cfg, "plan": plan, "params": params, "tables": tables,
            "lens": lens, "tokens": tokens, "ref": torch.stack(ref),
            "caches": caches, "prompt_lens": [len(p) for p in prompts],
            "layers": [layer_params(params, i)["l0"]
                       for i in range(cfg.n_layers)]}


def quantized_cache(torch, cache, qdt):
    from repro_torch.serving.kv_cache import quantize_kv_rows
    out = {}
    for key in ("k", "v"):
        out[key], out[key + "_scale"] = quantize_kv_rows(cache[key], qdt,
                                                         torch.float16)
    return out


def top2_gap(logits):
    top = logits.topk(2, -1).values
    return top[..., 0] - top[..., 1]


def run_chain_phase(torch, dev):
    """The six variants, kernels and plain; launch counts, tolerances and
    argmax checks; times per step.  Returns the ``chain`` record."""
    ctx = chain_context(torch, dev)
    n_steps, L = CHAIN_STEPS, ctx["cfg"].n_layers
    B_ = len(ctx["prompt_lens"])
    caches = dict(ctx["caches"])
    caches["int8"] = quantized_cache(torch, caches["pool"], torch.int8)
    caches["fp8"] = quantized_cache(torch, caches["pool"],
                                    torch.float8_e4m3fn)
    ref, ref_gap = ctx["ref"], top2_gap(ctx["ref"])
    ref_arg = ref.argmax(-1)
    variants, logits_of, walls = {}, {}, {}
    total = dict.fromkeys(_read_counts(), 0)
    for name, kind, mode, w_dtype in CHAIN_VARIANTS:
        tables = None if kind == "dense" else ctx["tables"]
        cache0 = caches[kind]
        _reset_counts()
        got, _ = run_chain(torch, ctx, cache0, tables, True, mode, w_dtype)
        counts = _read_counts()
        for k in total:
            total[k] += counts[k]
        attn = "decode_attention" if kind == "dense" or mode == "gather" \
            else "paged_decode_attention"
        want_counts = dict.fromkeys(counts, 0)
        want_counts["gemv"] = 4 * L * n_steps
        want_counts[attn] = L * n_steps
        if counts != want_counts:
            raise AssertionError(f"chain {name}: launches {counts}, "
                                 f"expected {want_counts}")
        _, wall = run_chain(torch, ctx, cache0, tables, True, mode, w_dtype)
        plain, plain_wall = run_chain(torch, ctx, cache0, tables, False,
                                      mode, w_dtype)
        if not torch.isfinite(got).all():
            raise AssertionError(f"chain {name}: non-finite logits")
        quant = kind in ("int8", "fp8")
        tol = CHAIN_TOL_QUANT if quant else CHAIN_TOL
        err = (got - plain).abs().max().item()
        if err > tol:
            raise AssertionError(f"chain {name}: kernels vs plain max abs "
                                 f"{err} > {tol}")
        rec = {"ms_per_step": wall / n_steps * 1e3,
               "tokens_per_s": B_ * n_steps / wall,
               "plain_ms_per_step": plain_wall / n_steps * 1e3,
               "max_abs_err_vs_plain": err, "tol_vs_plain": tol,
               "launches_per_step": {k: v / n_steps
                                     for k, v in counts.items()}}
        arg = got.argmax(-1)
        if not quant and w_dtype == "auto":
            err_m = (got - ref).abs().max().item()
            if err_m > CHAIN_TOL:
                raise AssertionError(f"chain {name}: vs model decode max "
                                     f"abs {err_m} > {CHAIN_TOL}")
            decided = ref_gap > CHAIN_TOL
            if not torch.equal(arg[decided], ref_arg[decided]):
                raise AssertionError(f"chain {name}: greedy argmax differs "
                                     "from the model's where its top-2 "
                                     f"gap exceeds {CHAIN_TOL}")
            rec.update(max_abs_err_vs_model=err_m, tol_vs_model=CHAIN_TOL,
                       argmax_checked=int(decided.sum()),
                       argmax_total=int(decided.numel()))
        else:
            rec["argmax_agree_with_fp_stream"] = float(
                (arg == logits_of["stream"].argmax(-1)).float().mean())
            rec["max_abs_diff_vs_model"] = (got - ref).abs().max().item()
        variants[name] = rec
        logits_of[name] = got
        walls[name] = wall
    return ctx, {"arch": ctx["cfg"].name, "n_layers": L,
                 "d_model": ctx["cfg"].d_model, "dtype": "float32",
                 "batch": B_, "prompt_lens": ctx["prompt_lens"],
                 "steps": n_steps, "block_size": 128, "max_seq": 512,
                 "ref_logit_std": ref.std().item(),
                 "ref_top2_gap_min": ref_gap.min().item(),
                 "variants": variants}, total, walls


def chunk_vs_sequential(torch, dev, ctx, mode):
    """chunk_prefill_layer on one full-width layer (C = 64 rows) against
    64 sequential decode_layer calls on a fresh pool, attending through
    the paged kernel ("stream") or the dense kernel over the gathered,
    broadcast view ("gather").  Also whether the layer's first steps,
    the norm and the QKV gemv, give each row the same bits in the chunk
    as alone: where they do not, the chunk and the sequential run start
    from different inputs."""
    from repro_torch.core import streamline as sl
    from repro_torch.kernels.gemv.ops import gemv
    from repro_torch.models.common import apply_norm
    cfg, plan = ctx["cfg"], ctx["plan"]
    a = plan.attn
    p = ctx["layers"][0]
    g = torch.Generator(device=dev).manual_seed(5)
    xs = torch.randn((CHUNK_C, cfg.d_model), generator=g, device=dev)
    table = torch.arange(1, 5, dtype=torch.int32, device=dev)

    def fresh():
        return {k: torch.zeros((5, 128, a.gp, a.d_head), device=dev)
                for k in "kv"}
    y_c, pool_c = sl.chunk_prefill_layer(p, xs, fresh(), table, 0, CHUNK_C,
                                         cfg=cfg, plan=plan,
                                         paged_kernel=mode)
    pool_s, ys = fresh(), []
    for i in range(CHUNK_C):
        y, _ = sl.decode_layer(p, xs[i:i + 1], pool_s,
                               torch.tensor([i], dtype=torch.int32,
                                            device=dev),
                               cfg=cfg, plan=plan, block_table=table[None],
                               paged_kernel=mode)
        ys.append(y)
    y_s = torch.cat(ys)
    h = apply_norm(p["ln1"], xs, cfg.norm)
    h_rows = torch.cat([apply_norm(p["ln1"], xs[i:i + 1], cfg.norm)
                        for i in range(CHUNK_C)])
    wq = p["attn"]["wq"].reshape(cfg.d_model, -1)
    torch.cuda.synchronize()
    if not torch.isfinite(y_c).all():
        raise AssertionError(f"chunk_prefill_layer {mode}: non-finite output")
    err_y = (y_c - y_s).abs().max().item()
    err_kv = max((pool_c[k] - pool_s[k]).abs().max().item() for k in "kv")
    if err_y > CHAIN_TOL or err_kv > CHAIN_TOL:
        raise AssertionError(f"chunk vs sequential ({mode}): {err_y}, "
                             f"{err_kv} > {CHAIN_TOL}")
    gemv_rows_equal = torch.equal(
        gemv(h_rows, wq), torch.cat([gemv(h_rows[i:i + 1], wq)
                                     for i in range(CHUNK_C)]))
    if not gemv_rows_equal:
        raise AssertionError("gemv: a row of the chunk differs from the "
                             "same row alone")
    return {"C": CHUNK_C, "mode": mode, "max_abs_diff_y": err_y,
            "max_abs_diff_pool": err_kv, "tol": CHAIN_TOL,
            "exact": bool(torch.equal(y_c, y_s) and all(
                torch.equal(pool_c[k], pool_s[k]) for k in "kv")),
            "norm_rows_bit_equal": bool(torch.equal(h, h_rows)),
            "norm_rows_max_abs_diff": (h - h_rows).abs().max().item(),
            "gemv_rows_bit_equal": gemv_rows_equal}


# the port's kernels on the chain, by the names the profiler shows
CHAIN_KERNELS = ("gemv_kernel", "dense_decode_kernel", "paged_decode_kernel")


def profile_chain(torch, ctx, tables, mode, wall):
    """torch.profiler over one kernel run of a chain variant: device busy
    share against the unprofiled wall time, the concatenations' and each
    port kernel's device ms per step, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cache = ctx["caches"]["pool" if tables is not None else "dense"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_chain(torch, ctx, cache, tables, True, mode, "auto")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    cat_us = sum(e.self_device_time_total for e in kernels
                 if "CatArray" in e.key or "cat" in e.key.lower())
    per_kernel = {}
    for name in CHAIN_KERNELS:
        hits = [e for e in kernels if name in e.key]
        if hits:
            us = sum(e.self_device_time_total for e in hits)
            n = sum(e.count for e in hits)
            per_kernel[name] = {"launches": n,
                                "device_ms_per_step": us / 1e3 / CHAIN_STEPS,
                                "us_per_launch": us / n}
    return {"device_busy_ms": busy_us / 1e3,
            "unprofiled_wall_ms": wall * 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_ms_per_step": busy_us / 1e3 / CHAIN_STEPS,
            "cat_device_ms_per_step": cat_us / 1e3 / CHAIN_STEPS,
            "port_kernels": per_kernel,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def chain_costs(torch, ctx, walls):
    """torch.profiler over the stream and the dense variants, and the
    wall time of one decode step's per-call weight work run on its own:
    the wq|wk|wv and wg|wu concatenations, and the int8 quantization of
    every weight (w_dtype="int8")."""
    from repro_torch.kernels.gemv.ops import quantize_weight
    D = ctx["cfg"].d_model
    a = ctx["plan"].attn

    def concat(_):
        for lp in ctx["layers"]:
            torch.cat([lp["attn"]["wq"].reshape(D, -1),
                       lp["attn"]["wk"].reshape(D, -1),
                       lp["attn"]["wv"].reshape(D, -1)], -1)
            torch.cat([lp["mlp"]["wg"], lp["mlp"]["wu"]], -1)

    def quantize(_):
        for lp in ctx["layers"]:
            quantize_weight(torch.cat([lp["attn"]["wq"].reshape(D, -1),
                                       lp["attn"]["wk"].reshape(D, -1),
                                       lp["attn"]["wv"].reshape(D, -1)], -1))
            quantize_weight(lp["attn"]["wo"].reshape(a.hp * a.d_head, D))
            quantize_weight(torch.cat([lp["mlp"]["wg"], lp["mlp"]["wu"]],
                                      -1))
            quantize_weight(lp["mlp"]["wd"])
    def wall_ms(fn, n=10):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    return {"profile_stream": profile_chain(torch, ctx, ctx["tables"],
                                            "stream", walls["stream"]),
            "profile_dense": profile_chain(torch, ctx, None, "auto",
                                           walls["dense"]),
            "per_step_weight_concat_wall_ms": wall_ms(concat),
            "per_step_weight_quantize_wall_ms": wall_ms(quantize)}


# ---------------------------------------------------------------------------
# rwkv6-7b at full width on kernel 4 (the WKV recurrence)
# ---------------------------------------------------------------------------

# kernel 4 against its plain version: the shapes of tests/test_kernels.py
# (:71-72), the engine's decode shape (4 slots, 64 heads x 64) and a
# prefill length
RWKV_DECODE = (4, 1, 64, 64)
RWKV_PREFILL = (1, 512, 64, 64)
RWKV_CHECK_SHAPES = ((1, 16, 1, 8), (2, 64, 2, 16), (2, 32, 4, 32),
                     RWKV_DECODE, RWKV_PREFILL, (1, 5, 1, 64),
                     (1, 3, 1, 32), (2, 3, 3, 100), (1, 4, 2, 128),
                     (4, 1, 64, 128))
# f32 throughout; only the order of the sums differs from the plain version
RWKV_TOL = 1e-4
RWKV_SLOTS, RWKV_REQUESTS, RWKV_NEW = 4, 8, 32


def rwkv_inputs(torch, dev, shape, seed):
    """r, k, v, w, u, s0 with the distributions of the reference's kernel
    test, and a nonzero s0."""
    B, S, H, dh = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*sh):
        return torch.randn(sh, generator=g, device=dev)
    w = 0.8 + 0.199 * torch.rand((B, S, H, dh), generator=g, device=dev)
    return (rnd(B, S, H, dh), 0.3 * rnd(B, S, H, dh), rnd(B, S, H, dh), w,
            0.2 * rnd(H, dh), 0.1 * rnd(B, H, dh, dh))


def rwkv_bound(shape, card_name):
    """Least work of one call: r, k, v, w, u and s0 read once, y and the
    final state written once; 7 f32 operations per state element per
    step (the k.v outer product 1, the output 4, the update 2)."""
    B, S, H, dh = shape
    nbytes = 4 * (5 * B * S * H * dh + H * dh + 2 * B * H * dh * dh)
    return bound_for(nbytes, 7 * B * S * H * dh * dh, "float32", card_name)


def check_time_rwkv_scan(torch, dev, card_name):
    """Kernel 4 against its plain version at every listed shape, then
    timed at the decode and the prefill shape beside the plain version;
    at the prefill shape also beside the port's chunked form
    (``wkv_chunked``, the prefill path of ``time_mix_fwd``): no single
    PyTorch call computes the recurrence, so that is the comparator."""
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
    from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref
    from repro_torch.models.rwkv import wkv_chunked
    errs, exact = {}, {}
    for i, shape in enumerate(RWKV_CHECK_SHAPES):
        args = rwkv_inputs(torch, dev, shape, seed=10 + i)
        y, s = rwkv_scan(*args)
        yr, sr = rwkv_scan_ref(*args)
        torch.cuda.synchronize()
        err = max((y - yr).abs().max().item(), (s - sr).abs().max().item())
        ok = all(torch.isfinite(t).all() for t in (y, s)) and \
            torch.allclose(y, yr, rtol=RWKV_TOL, atol=RWKV_TOL) and \
            torch.allclose(s, sr, rtol=RWKV_TOL, atol=RWKV_TOL)
        if not ok:
            raise AssertionError(f"rwkv_scan {shape}: kernel vs plain beyond "
                                 f"{RWKV_TOL} (max abs {err})")
        key = "x".join(map(str, shape))
        errs[key] = err
        # the plain version repeats the kernel's order of rounding
        exact[key] = bool(torch.equal(y, yr) and torch.equal(s, sr))
        if not exact[key]:
            raise AssertionError(f"rwkv_scan {shape}: kernel not bit-equal "
                                 f"to its plain version (max abs {err})")
    times = {}
    for name, shape in (("decode", RWKV_DECODE), ("prefill", RWKV_PREFILL)):
        args = rwkv_inputs(torch, dev, shape, seed=20)
        per_set = 4 * sum(a.numel() for a in args)
        sets = [tuple(a.clone() for a in args)
                for _ in range(sets_for(per_set))]
        fns = {"ms": lambda i: rwkv_scan(*sets[i]),
               "plain_ms": lambda i: rwkv_scan_ref(*sets[i])}
        slow = None
        if name == "prefill":
            fns["chunked_ms"] = lambda i: wkv_chunked(*sets[i])
            slow = {"plain_ms": (3, 1), "chunked_ms": (50, 5)}
        t = timed(torch, fns, len(sets), iters=slow)
        t["bound_ms"], t["bound_by"] = rwkv_bound(shape, card_name)
        t["shape"] = list(shape)
        times[name] = t
        del sets
    return errs, exact, times


def rwkv_model(torch, dev):
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.weights import _expected_shapes
    cfg = get_config("rwkv6-7b")
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    nbytes = 4 * sum(math.prod(s) for s in _expected_shapes(cfg, plan)
                     .values())
    print(f"[rwkv] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.rwkv.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}: f32 weights {nbytes / 1e9:.2f} GB",
          flush=True)
    model = build_model(cfg, plan, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    got = sum(t.numel() * t.element_size() for t in _leaves(params))
    if got != nbytes:
        raise AssertionError(f"weights hold {got} bytes, reckoned {nbytes}")
    return cfg, model, params, nbytes, time.perf_counter() - t0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def serve_dense(torch, dev, model, params, prompts, max_new, slots=4,
                max_seq=512):
    """The engine on the dense per-slot cache (a recurrent family's
    default), greedy; -> (streams, engine)."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    eng = LPUEngine(model, params, EngineConfig(slots=slots,
                                                max_seq=max_seq), device=dev)
    outs = eng.generate(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    return outs, eng


def rwkv_replay(torch, dev, model, params, prompts, outs, use_kernels):
    """Teacher-forced replay of the engine's streams, all rows in one
    batch (an rwkv state has no positions): each prompt prefilled at its
    exact length into its row, then the stream's tokens fed one decode
    step at a time.  -> (logits (new, rows, V_pad), prefill launches,
    decode launches, decode ms per step)."""
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
    from repro_torch.serving.kv_cache import scatter_prefill_dense
    n = len(prompts)
    cache = model.init_cache(n, 1)
    rows = []
    rwkv_scan.launches = 0
    for b, p in enumerate(prompts):
        logits, pc = model.forward(
            params, torch.tensor([p], device=dev), mode="prefill",
            cache=model.init_cache(1, len(p)))
        rows.append(logits[0, -1])
        scatter_prefill_dense(cache, pc, b)
    first = [torch.stack(rows)]
    prefill_launches = rwkv_scan.launches
    toks = torch.tensor(outs, device=dev).t()            # (new, rows)
    pos = torch.zeros((n,), dtype=torch.int32, device=dev)
    rwkv_scan.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(toks.shape[0] - 1):
        logits, _ = model.forward(params, toks[t][:, None], mode="decode",
                                  positions=pos, cache=cache,
                                  use_kernels=use_kernels)
        first.append(logits[:, -1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (toks.shape[0] - 1) * 1e3
    return torch.stack(first), prefill_launches, rwkv_scan.launches, ms


def profile_serve(torch, dev, model, params, prompts, max_new, wall_s,
                  kernel, **serve_kw):
    """Device time by kernel over the same engine run (``serve_dense``
    with ``serve_kw``) under torch.profiler; busy share against the
    unprofiled run's wall; the time and launches of the kernels whose
    name holds ``kernel``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve_dense(torch, dev, model, params, prompts, max_new, **serve_kw)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    mine = [e for e in kernels if kernel in e.key]
    return {"device_busy_ms": busy_us / 1e3,
            "unprofiled_wall_ms": wall_s * 1e3,
            "device_busy_share": busy_us / 1e6 / wall_s,
            f"{kernel}_ms": sum(e.self_device_time_total
                                for e in mine) / 1e3,
            f"{kernel}_launches": sum(e.count for e in mine),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def run_rwkv(torch, dev):
    """Full-width rwkv6-7b (f32, random weights from seed 0) served by
    ``LPUEngine``: 8 prompts of 2-64 tokens x 32 new tokens, 4 slots,
    greedy.  Kernel 4 must launch exactly once per layer per device
    decode step and never in prefill; the streams are replayed
    teacher-forced with the kernel and with its plain version (the
    oracle): logits within RWKV_TOL, and the engine's tokens equal the
    oracle's argmax wherever its top-2 gap exceeds RWKV_TOL."""
    import numpy as np
    cfg, model, params, nbytes, init_s = rwkv_model(torch, dev)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                            size=rng.randint(2, 65))]
               for _ in range(RWKV_REQUESTS)]
    serve_dense(torch, dev, model, params, prompts[:2], 4,
                RWKV_SLOTS)                                   # warm-up
    _reset_counts()
    outs, eng = serve_dense(torch, dev, model, params, prompts, RWKV_NEW,
                            RWKV_SLOTS)
    counts = _read_counts()
    st = eng.stats
    want = {name: 0 for name in counts}
    want["rwkv_scan"] = cfg.n_layers * st.device_decode_steps
    if st.device_decode_steps == 0 or counts != want:
        raise AssertionError(f"rwkv engine launches {counts}, expected "
                             f"{want} ({cfg.n_layers} per device decode "
                             "step, none in prefill)")
    for o in outs:
        if len(o) != RWKV_NEW or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"bad rwkv stream {o}")
    profile = profile_serve(torch, dev, model, params, prompts, RWKV_NEW,
                            st.wall, "wkv_kernel", slots=RWKV_SLOTS)

    got, pre_k, dec_k, ms_k = rwkv_replay(torch, dev, model, params, prompts,
                                          outs, True)
    ref, pre_p, dec_p, ms_p = rwkv_replay(torch, dev, model, params, prompts,
                                          outs, False)
    steps = RWKV_NEW - 1
    if pre_k or pre_p or dec_p or dec_k != cfg.n_layers * steps:
        raise AssertionError(f"replay launches: prefill {pre_k}/{pre_p}, "
                             f"decode {dec_k} (want {cfg.n_layers * steps})"
                             f"/{dec_p} (want 0)")
    if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
        raise AssertionError("rwkv replay: non-finite logits")
    err = (got - ref).abs().max().item()
    if err > RWKV_TOL:
        raise AssertionError(f"rwkv replay: kernel vs plain max abs {err} "
                             f"> {RWKV_TOL}")
    # the model's own f32 noise floor at full depth, for the record: the
    # same plain replay in two batches of 4 rows, where cuBLAS picks other
    # f32 product kernels; the kernel and its plain version round alike
    # (bit for bit), so the replay check above holds below this floor
    halves = torch.cat([rwkv_replay(torch, dev, model, params, prompts[:4],
                                    outs[:4], False)[0],
                        rwkv_replay(torch, dev, model, params, prompts[4:],
                                    outs[4:], False)[0]], 1)
    floor_by_step = (halves - ref).abs().amax(dim=(1, 2)).tolist()
    gap = top2_gap(ref)
    decided = gap > RWKV_TOL
    toks = torch.tensor(outs, device=dev).t()
    ref_arg = ref.argmax(-1)
    if not torch.equal(toks[decided], ref_arg[decided]) or \
            not torch.equal(got.argmax(-1)[decided], ref_arg[decided]):
        raise AssertionError("rwkv: greedy tokens differ from the plain "
                             "oracle's argmax where its top-2 gap exceeds "
                             f"{RWKV_TOL}")

    # the model's decode step at the engine's batch, on its own
    cache = model.init_cache(RWKV_SLOTS, 1)
    tok = torch.ones((RWKV_SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.zeros((RWKV_SLOTS,), dtype=torch.int32, device=dev)
    model.forward(params, tok, mode="decode", positions=pos, cache=cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        model.forward(params, tok, mode="decode", positions=pos, cache=cache)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 16 * 1e3
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": cfg.n_heads,
            "head_dim": cfg.rwkv.head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "dtype": "float32",
            "weight_bytes": nbytes, "init_s": init_s,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "slots": RWKV_SLOTS, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "max_new": RWKV_NEW,
            "tokens": st.tokens, "tokens_per_s": st.tokens_per_s,
            "wall_s": st.wall, "decode_steps": st.steps,
            "device_decode_steps": st.device_decode_steps,
            "prefills": st.prefills, "state_bytes": eng.kv_cache_bytes(),
            "launches": counts,
            "launches_per_device_decode_step":
                counts["rwkv_scan"] / st.device_decode_steps,
            "decode_step_ms_b4": step_ms,
            "replay": {"rows": len(prompts), "steps": steps,
                       "kernel_ms_per_step": ms_k,
                       "plain_ms_per_step": ms_p,
                       "decode_launches_kernel": dec_k,
                       "max_abs_err_vs_plain": err, "tol": RWKV_TOL,
                       "bit_equal": bool(torch.equal(got, ref)),
                       "plain_b8_vs_2xb4_max_abs": max(floor_by_step),
                       "plain_b8_vs_2xb4_by_step": floor_by_step,
                       "argmax_checked": int(decided.sum()),
                       "argmax_total": int(decided.numel()),
                       "ref_logit_std": ref.std().item(),
                       "ref_top2_gap_min": gap.min().item()},
            "profile": profile}


# kernel 5 against its plain version: the shapes of tests/test_kernels.py
# (:56-57), the jamba engine's decode shape (4 slots, d_inner 8192,
# d_state 16), its longest prefill (64 tokens) and a longer prefill
MAMBA_DECODE = (4, 1, 8192, 16)
MAMBA_PREFILL = (1, 64, 8192, 16)
MAMBA_LONG = (1, 512, 8192, 16)
MAMBA_CHECK_SHAPES = ((1, 32, 8, 8), (2, 128, 16, 16), (2, 64, 32, 8),
                      MAMBA_DECODE, MAMBA_PREFILL, MAMBA_LONG)
# f32 throughout; the plain version repeats the kernel's rounding order
MAMBA_TOL = 1e-4
# jamba-v0.1-52b at full width, cut from 32 layers to one super-block of
# 8 (52B parameters do not fit one 80 GB card, even in bf16; depth 8 is
# 13.3e9 parameters, 53 GB in f32)
JAMBA_DEPTH = 8
JAMBA_SLOTS, JAMBA_REQUESTS, JAMBA_NEW, JAMBA_MAX_SEQ = 4, 8, 32, 512
JAMBA_TOL = 1e-4


def mamba_inputs(torch, dev, shape, seed):
    """da, bx, c, h0 with the distributions of the reference's kernel
    test (da in [0.5, 0.99)), and a nonzero h0."""
    B, S, C, N = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return (0.5 + 0.49 * torch.rand((B, S, C, N), generator=g, device=dev),
            0.1 * torch.randn((B, S, C, N), generator=g, device=dev),
            torch.randn((B, S, N), generator=g, device=dev),
            0.1 * torch.randn((B, C, N), generator=g, device=dev))


def mamba_fused_inputs(torch, dev, shape, seed):
    """dt (softplus of a normal, shifted as jamba's dt_bias leaves it), x,
    a = -exp(a_log) with jamba's a_log = log(1..N) plus noise, b, c and a
    nonzero h0."""
    B, S, C, N = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, C), generator=g, device=dev) - 2.0)
    a = -torch.exp(torch.log(torch.arange(1, N + 1, device=dev).float())
                   + 0.1 * torch.randn((C, N), generator=g, device=dev))
    return (dt, torch.randn((B, S, C), generator=g, device=dev), a,
            torch.randn((B, S, N), generator=g, device=dev),
            torch.randn((B, S, N), generator=g, device=dev),
            0.1 * torch.randn((B, C, N), generator=g, device=dev))


def mamba_bound(shape, card_name):
    """Least work of one call: da, bx, c and h0 read once, y and the
    final state written once; 4 f32 operations per (b, t, c, n) element
    (the update's product and sum, the output's product and sum)."""
    B, S, C, N = shape
    nbytes = 4 * (2 * B * S * C * N + B * S * N + 2 * B * C * N + B * S * C)
    return bound_for(nbytes, 4 * B * S * C * N, "float32", card_name)


# the SFUs' exp2 rate: 16 a clock per SM (NVIDIA's CUDA programming
# guide, compute capability 9.0) x 132 SMs x the H100 SXM's 1.98 GHz boost
SFU_PER_S = 16 * 132 * 1.98e9


def mamba_fused_bound(shape, card_name):
    """Least work of one fused call: dt, x, a, b, c and h0 read once, y
    and the final state written once; per (b, t, c, n) element one
    exponential on the SFUs and 6 f32 operations (dt*a, (dt*x)*b, the
    update's product and sum, the output's product and sum).  The larger
    of the bytes' time and the exponentials' time on the SFUs (the f32
    operations take less than either)."""
    B, S, C, N = shape
    nbytes = 4 * (3 * B * S * C + C * N + 2 * B * S * N + 2 * B * C * N)
    t_bytes, _ = bound_for(nbytes, 0, "float32", card_name)
    elems = B * S * C * N
    t_ops = max(elems / SFU_PER_S, 6 * elems / PEAK_OPS["float32"]) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def mamba_producers(torch, dt, x, a, b):
    """The jamba layer's PyTorch producers of da and bx, as
    ``models/mamba.py`` ran them before the fused entry: the
    comparator's first half."""
    da = torch.exp(dt[..., None] * a)
    bx = (dt * x)[..., None] * b[:, :, None, :]
    return da.contiguous(), bx.contiguous()


def check_mamba_entry(torch, entry, kernel, plain, inputs, errs, exact):
    """One entry of kernel 5 against its plain version at every listed
    shape: finite, within MAMBA_TOL, and whether bit-equal."""
    for i, shape in enumerate(MAMBA_CHECK_SHAPES):
        args = inputs(shape, 30 + i)
        y, h = kernel(*args)
        yr, hr = plain(*args)
        torch.cuda.synchronize()
        err = max((y - yr).abs().max().item(), (h - hr).abs().max().item())
        ok = all(torch.isfinite(t).all() for t in (y, h)) and \
            torch.allclose(y, yr, rtol=MAMBA_TOL, atol=MAMBA_TOL) and \
            torch.allclose(h, hr, rtol=MAMBA_TOL, atol=MAMBA_TOL)
        if not ok:
            raise AssertionError(f"{entry} {shape}: kernel vs plain "
                                 f"beyond {MAMBA_TOL} (max abs {err})")
        key = "x".join(map(str, shape))
        errs[key] = err
        exact[key] = bool(torch.equal(y, yr) and torch.equal(h, hr))
        del args, y, h, yr, hr


def check_time_mamba_scan(torch, dev, card_name):
    """Kernel 5's two entries against their plain versions at every
    listed shape, then timed at the decode, the engine's longest prefill
    and a 512-token prefill: entry (a) beside its plain version, entry
    (b) (fused) beside its plain version and the path it replaced, the
    PyTorch producers of da and bx followed by entry (a).  No single
    PyTorch call computes the recurrence, so there is no library time.
    -> ({entry: {shape: err}}, {entry: {shape: bit-equal}}, times)."""
    from repro_torch.kernels.mamba_scan.ops import (mamba_plan, mamba_scan,
                                                    mamba_scan_fused)
    from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                    mamba_scan_ref)
    errs, exact = {"a": {}, "fused": {}}, {"a": {}, "fused": {}}
    check_mamba_entry(torch, "mamba_scan", mamba_scan, mamba_scan_ref,
                      lambda sh, sd: mamba_inputs(torch, dev, sh, sd),
                      errs["a"], exact["a"])
    check_mamba_entry(torch, "mamba_scan_fused", mamba_scan_fused,
                      mamba_scan_fused_ref,
                      lambda sh, sd: mamba_fused_inputs(torch, dev, sh, sd),
                      errs["fused"], exact["fused"])
    times = {}
    for name, shape, slow in (("decode", MAMBA_DECODE, None),
                              ("prefill64", MAMBA_PREFILL, (20, 2)),
                              ("prefill512", MAMBA_LONG, (3, 1))):
        args = mamba_inputs(torch, dev, shape, seed=40)
        per_set = 4 * sum(a.numel() for a in args)
        sets = [tuple(a.clone() for a in args)
                for _ in range(sets_for(per_set))]
        del args
        fns = {"ms": lambda i: mamba_scan(*sets[i]),
               "plain_ms": lambda i: mamba_scan_ref(*sets[i])}
        t = timed(torch, fns, len(sets),
                  iters={"plain_ms": slow} if slow else None)
        t["bound_ms"], t["bound_by"] = mamba_bound(shape, card_name)
        del sets, fns
        torch.cuda.empty_cache()
        args = mamba_fused_inputs(torch, dev, shape, seed=41)
        per_set = 4 * sum(a.numel() for a in args)
        fsets = [tuple(a.clone() for a in args)
                 for _ in range(sets_for(per_set))]
        del args

        def old_path(i):
            dt, x, a, b, c, h0 = fsets[i]
            return mamba_scan(*mamba_producers(torch, dt, x, a, b), c, h0)
        ft = timed(torch, {"ms": lambda i: mamba_scan_fused(*fsets[i]),
                           "plain_ms":
                               lambda i: mamba_scan_fused_ref(*fsets[i]),
                           "old_path_ms": old_path}, len(fsets),
                   iters={"plain_ms": slow} if slow else None)
        t.update({("" if k.startswith("old_path") else "fused_") + k: v
                  for k, v in ft.items()})
        t["fused_bound_ms"], t["fused_bound_by"] = mamba_fused_bound(
            shape, card_name)
        t["shape"] = list(shape)
        t["plan_a"] = mamba_plan(*shape, fused=False)
        t["plan_fused"] = mamba_plan(*shape, fused=True)
        times[name] = t
        del fsets
        torch.cuda.empty_cache()
    return errs, exact, times


def jamba_schedule(cfg):
    return ["/".join(("attn" if cfg.is_attention_layer(j) else "mamba",
                      "moe" if cfg.is_moe_layer(j) else "mlp"))
            for j in range(cfg.n_layers)]


def jamba_model(torch, dev):
    import dataclasses
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.weights import _expected_shapes
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_DEPTH)
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    nbytes = 4 * sum(math.prod(s) for s in _expected_shapes(cfg, plan)
                     .values())
    print(f"[jamba] {cfg.name}: depth cut from {full.n_layers} to "
          f"{cfg.n_layers} layers (one super-block; the card's memory), "
          f"full width: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads x {cfg.d_head}, d_inner {cfg.mamba.expand * cfg.d_model}, "
          f"d_state {cfg.mamba.d_state}, dt_rank {cfg.mamba.dt_rank}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} x "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab_size}; schedule "
          f"{jamba_schedule(cfg)}; f32 weights {nbytes / 1e9:.2f} GB",
          flush=True)
    model = build_model(cfg, plan, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    got = sum(t.numel() * t.element_size() for t in _leaves(params))
    if got != nbytes:
        raise AssertionError(f"weights hold {got} bytes, reckoned {nbytes}")
    return cfg, model, params, nbytes, time.perf_counter() - t0


def jamba_replay(torch, dev, model, params, prompts, outs, use_kernels):
    """Teacher-forced replay of the engine's streams in the engine's own
    batching: the 8 requests ran as two batches of 4 slots (all streams
    have the same length, so a batch finishes together and the next is
    admitted into the same slots), so each batch of 4 rows gets a dense
    cache of the engine's shape; each prompt is prefilled at its exact
    length into its row, then the stream's tokens are fed one decode step
    at a time at their positions.  -> (logits (new, rows, V_pad), prefill
    launches, decode launches, decode ms per step)."""
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused
    from repro_torch.serving.kv_cache import scatter_prefill_dense
    out, pre_l, dec_l, dec_s, steps = [], 0, 0, 0.0, 0
    for lo in range(0, len(prompts), JAMBA_SLOTS):
        ps, os_ = prompts[lo:lo + JAMBA_SLOTS], outs[lo:lo + JAMBA_SLOTS]
        cache = model.init_cache(len(ps), JAMBA_MAX_SEQ)
        rows = []
        mamba_scan_fused.launches = 0
        for b, p in enumerate(ps):
            logits, pc = model.forward(
                params, torch.tensor([p], device=dev), mode="prefill",
                cache=model.init_cache(1, len(p)), use_kernels=use_kernels)
            rows.append(logits[0, -1])
            scatter_prefill_dense(cache, pc, b)
        pre_l += mamba_scan_fused.launches
        got = [torch.stack(rows)]
        toks = torch.tensor(os_, device=dev).t()          # (new, rows)
        pos = torch.tensor([len(p) for p in ps], dtype=torch.int32,
                           device=dev)
        mamba_scan_fused.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(toks.shape[0] - 1):
            logits, _ = model.forward(params, toks[t][:, None],
                                      mode="decode", positions=pos + t,
                                      cache=cache, use_kernels=use_kernels)
            got.append(logits[:, -1])
        torch.cuda.synchronize()
        dec_s += time.perf_counter() - t0
        steps += toks.shape[0] - 1
        dec_l += mamba_scan_fused.launches
        out.append(torch.stack(got))
        del cache
    return torch.cat(out, 1), pre_l, dec_l, dec_s / steps * 1e3


def run_jamba(torch, dev):
    """Full-width jamba-v0.1-52b at depth 8 (f32, random weights from
    seed 0) served by ``LPUEngine``: 8 prompts of 2-64 tokens x 32 new
    tokens, 4 slots, greedy, dense cache.  Kernel 5's fused entry must
    launch exactly once per mamba layer (7) per device decode step and
    per prefill, and no other kernel (nor entry (a)) may launch; the
    streams are replayed teacher-forced with the kernel and with its
    plain version (the oracle): logits within JAMBA_TOL, and the engine's
    tokens equal the oracle's argmax wherever its top-2 gap exceeds
    JAMBA_TOL."""
    import numpy as np
    cfg, model, params, nbytes, init_s = jamba_model(torch, dev)
    peak_init = torch.cuda.max_memory_allocated()
    print(f"[jamba] weights on the card: {nbytes} bytes, init "
          f"{init_s:.1f} s, peak device memory {peak_init / 1e9:.2f} GB",
          flush=True)
    n_mamba = sum(not cfg.is_attention_layer(i) for i in range(cfg.n_layers))
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                            size=rng.randint(2, 65))]
               for _ in range(JAMBA_REQUESTS)]
    serve_dense(torch, dev, model, params, prompts[:2], 4, JAMBA_SLOTS,
                JAMBA_MAX_SEQ)                                # warm-up
    _reset_counts()
    outs, eng = serve_dense(torch, dev, model, params, prompts, JAMBA_NEW,
                            JAMBA_SLOTS, JAMBA_MAX_SEQ)
    counts = _read_counts()
    st = eng.stats
    want = {name: 0 for name in counts}
    want["mamba_scan_fused"] = n_mamba * (st.device_decode_steps
                                          + st.prefills)
    if st.device_decode_steps == 0 or st.prefills != len(prompts) or \
            counts != want:
        raise AssertionError(
            f"jamba engine launches {counts}, expected {want} ({n_mamba} per "
            f"device decode step and per prefill; {st.prefills} prefills)")
    for o in outs:
        if len(o) != JAMBA_NEW or not all(0 <= t < cfg.vocab_size
                                          for t in o):
            raise AssertionError(f"bad jamba stream {o}")
    profile = profile_serve(torch, dev, model, params, prompts, JAMBA_NEW,
                            st.wall, "scan_kernel", slots=JAMBA_SLOTS,
                            max_seq=JAMBA_MAX_SEQ)

    torch.backends.cuda.matmul.allow_tf32 = False     # as the engine sets
    torch.backends.cudnn.allow_tf32 = False
    got, pre_k, dec_k, ms_k = jamba_replay(torch, dev, model, params,
                                           prompts, outs, True)
    ref, pre_p, dec_p, ms_p = jamba_replay(torch, dev, model, params,
                                           prompts, outs, False)
    steps = JAMBA_NEW - 1
    want_dec = n_mamba * steps * math.ceil(len(prompts) / JAMBA_SLOTS)
    if pre_p or dec_p or pre_k != n_mamba * len(prompts) or \
            dec_k != want_dec:
        raise AssertionError(
            f"replay launches: prefill {pre_k} (want "
            f"{n_mamba * len(prompts)})/{pre_p} (want 0), decode {dec_k} "
            f"(want {want_dec})/{dec_p} (want 0)")
    if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
        raise AssertionError("jamba replay: non-finite logits")
    err = (got - ref).abs().max().item()
    if err > JAMBA_TOL:
        raise AssertionError(f"jamba replay: kernel vs plain max abs {err} "
                             f"> {JAMBA_TOL}")
    gap = top2_gap(ref)
    decided = gap > JAMBA_TOL
    toks = torch.tensor(outs, device=dev).t()
    ref_arg = ref.argmax(-1)
    if not torch.equal(toks[decided], ref_arg[decided]) or \
            not torch.equal(got.argmax(-1)[decided], ref_arg[decided]):
        raise AssertionError("jamba: greedy tokens differ from the plain "
                             "oracle's argmax where its top-2 gap exceeds "
                             f"{JAMBA_TOL}")

    # the model's decode step at the engine's batch, on its own
    cache = model.init_cache(JAMBA_SLOTS, JAMBA_MAX_SEQ)
    tok = torch.ones((JAMBA_SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((JAMBA_SLOTS,), 64, dtype=torch.int32, device=dev)
    model.forward(params, tok, mode="decode", positions=pos, cache=cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        model.forward(params, tok, mode="decode", positions=pos, cache=cache)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "n_layers_published": 32, "schedule": jamba_schedule(cfg),
            "d_model": cfg.d_model, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "d_inner":
                cfg.mamba.expand * cfg.d_model, "d_state": cfg.mamba.d_state,
            "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
            "d_ff_expert": cfg.moe.d_ff_expert, "vocab": cfg.vocab_size,
            "dtype": "float32", "weight_bytes": nbytes, "init_s": init_s,
            "peak_memory_after_init_bytes": peak_init,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "slots": JAMBA_SLOTS, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "max_new": JAMBA_NEW,
            "tokens": st.tokens, "tokens_per_s": st.tokens_per_s,
            "wall_s": st.wall, "decode_steps": st.steps,
            "device_decode_steps": st.device_decode_steps,
            "prefills": st.prefills, "cache_bytes": eng.kv_cache_bytes(),
            "kv_bytes_moved_per_step": eng.kv_bytes_moved_per_step(),
            "launches": counts,
            "mamba_scan_per_device_decode_step_and_prefill": n_mamba,
            "decode_step_ms_b4": step_ms,
            "replay": {"rows": len(prompts), "batches_of": JAMBA_SLOTS,
                       "steps": steps,
                       "kernel_ms_per_step": ms_k,
                       "plain_ms_per_step": ms_p,
                       "prefill_launches_kernel": pre_k,
                       "decode_launches_kernel": dec_k,
                       "max_abs_err_vs_plain": err, "tol": JAMBA_TOL,
                       "bit_equal": bool(torch.equal(got, ref)),
                       "engine_tokens_equal_kernel_argmax": bool(
                           torch.equal(toks, got.argmax(-1))),
                       "argmax_checked": int(decided.sum()),
                       "argmax_total": int(decided.numel()),
                       "ref_logit_std": ref.std().item(),
                       "ref_top2_gap_min": gap.min().item()},
            "profile": profile}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def lap(phase):
        print(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
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

    # f32 matmuls in full f32 (the chain's plain version and the model)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    lap("build")
    floor_ms, floor_host_ms = time_floor(torch, dev)
    print(f"[kernel] timing floor (one-element add_): {floor_ms} ms device, "
          f"{floor_host_ms} ms host")
    errs = check_paged_kernel(torch, dev)
    print(f"[kernel] paged_decode_attention vs plain: {errs}")
    times = time_paged_kernel(torch, dev, smi)
    print(f"[kernel] paged_decode_attention timing: {times}")
    quant = check_time_quantized_pool(torch, dev, smi)
    print(f"[kernel] paged_decode_attention int8/fp8 pools: {quant}")
    split_errs = check_paged_split(torch, dev)
    print(f"[kernel] paged_decode_attention split edges (lengths "
          f"{list(SPLIT_LENGTHS)}, tables out of order; rows alone equal "
          f"rows in the batch; null block inert): {split_errs}")
    dense_errs, dense_t = check_time_dense(torch, dev, smi)
    print(f"[kernel] decode_attention vs plain: {dense_errs}; timing: "
          f"{dense_t}")
    gemv_errs, gemv_calls = check_time_gemv(torch, dev, smi)
    print(f"[kernel] gemv vs plain: max abs "
          f"{max(gemv_errs.values())}; B=4 equals 4 x B=1 at every shape")
    for c in gemv_calls:
        print(f"[kernel] gemv {c}")

    lap("kernels 1-3")
    engine = run_engine(torch, dev)
    print(f"[engine] {engine['tokens']} tokens, "
          f"{engine['tokens_per_s']:.1f} tok/s, "
          f"{engine['decode_steps']} decode steps, "
          f"{engine['preempt_run']['preemptions']} preemptions in the "
          "small-pool run")

    lap("engine")
    ctx, chain, chain_launches, walls = run_chain_phase(torch, dev)
    chain["chunk_prefill"] = chunk_vs_sequential(torch, dev, ctx, "stream")
    chain["chunk_prefill_gather"] = chunk_vs_sequential(torch, dev, ctx,
                                                        "gather")
    chain.update(chain_costs(torch, ctx, walls))
    for name, rec in chain["variants"].items():
        print(f"[chain] {name}: {rec['ms_per_step']:.2f} ms/step, "
              f"{rec['tokens_per_s']:.1f} tok/s, kernels vs plain "
              f"{rec['max_abs_err_vs_plain']:.3g}")

    # the rwkv phase needs ~31 GB: free what the earlier phases hold
    del ctx
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rwkv_errs, rwkv_exact, rwkv_t = check_time_rwkv_scan(torch, dev, smi)
    print(f"[kernel] rwkv_scan vs plain: {rwkv_errs}; bit-equal: "
          f"{rwkv_exact}")
    for name, t in rwkv_t.items():
        print(f"[kernel] rwkv_scan {name} timing: {t}")
    lap("chain, kernel 4")
    rwkv = run_rwkv(torch, dev)
    print(f"[rwkv] {rwkv['tokens']} tokens, {rwkv['tokens_per_s']:.1f} "
          f"tok/s, {rwkv['device_decode_steps']} device decode steps, "
          f"{rwkv['launches_per_device_decode_step']:.0f} rwkv_scan launches "
          f"per step, decode step {rwkv['decode_step_ms_b4']:.2f} ms at "
          f"{RWKV_SLOTS} rows, replay kernel vs plain max abs "
          f"{rwkv['replay']['max_abs_err_vs_plain']:.3g}")

    # the jamba phase holds ~54 GB: free everything the rwkv phase held
    # first, so two full-width models never share the card
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    print(f"[jamba] device memory allocated before the phase: {held} bytes",
          flush=True)
    if held > 2e9:
        raise AssertionError(f"{held} bytes still allocated after the rwkv "
                             "phase")
    mamba_errs, mamba_exact, mamba_t = check_time_mamba_scan(torch, dev, smi)
    print(f"[kernel] mamba_scan (a) and mamba_scan_fused vs plain: "
          f"{mamba_errs}; bit-equal: {mamba_exact}")
    for name, t in mamba_t.items():
        print(f"[kernel] mamba_scan {name} timing: {t}")
    lap("rwkv, kernel 5")
    jamba = run_jamba(torch, dev)
    lap("jamba")
    print(f"[jamba] {jamba['tokens']} tokens, {jamba['tokens_per_s']:.1f} "
          f"tok/s, {jamba['device_decode_steps']} device decode steps + "
          f"{jamba['prefills']} prefills, "
          f"{jamba['mamba_scan_per_device_decode_step_and_prefill']} "
          f"mamba_scan_fused launches per decode step and per prefill, decode "
          f"step {jamba['decode_step_ms_b4']:.2f} ms at {JAMBA_SLOTS} rows, "
          f"peak memory {jamba['peak_memory_bytes'] / 1e9:.2f} GB, replay "
          f"kernel vs plain max abs "
          f"{jamba['replay']['max_abs_err_vs_plain']:.3g}")

    def src(name):
        return os.path.relpath(build.source_path(name), HERE)

    f32_calls = [c for c in gemv_calls if c["w_dtype"] == "float32"]
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": src("paged_decode_attention"),
        "replaces": "src/repro/kernels/decode_attention/"
                    "decode_attention.py:142",
        "ok": True,
        "launches": engine["kernel_launches"]
        + chain_launches["paged_decode_attention"],
        "launches_by_path": {
            "engine_stream": engine["kernel_launches"],
            "chain_kernel_runs": chain_launches["paged_decode_attention"]},
        "max_abs_err": errs["q=float32,pool=float32"],
        "max_abs_err_by_dtype": errs,
        "max_abs_err_split_edges": split_errs,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
        "host_ms": times["host_ms"], "plain_host_ms": times["plain_host_ms"],
        "library_host_ms": times["library_host_ms"],
        "shapes": {"B": B, "H": H, "G": G, "dh": DH, "bs": BS, "T": T,
                   "N": N, "lengths": list(LENGTHS), "dtype": "float32",
                   "fold": True},
        "plan": times["plan"],
        "quantized_pools": quant,
    }, {
        "name": "decode_attention", "route": "cuda",
        "source": src("decode_attention"),
        "replaces": "src/repro/kernels/decode_attention/"
                    "decode_attention.py:218",
        "ok": True, "launches": chain_launches["decode_attention"],
        "launches_by_path": {
            "chain_kernel_runs": chain_launches["decode_attention"]},
        "max_abs_err": dense_errs["float32"],
        "max_abs_err_by_dtype": dense_errs,
        "ms": dense_t["ms"], "plain_ms": dense_t["plain_ms"],
        "bound_ms": dense_t["bound_ms"], "bound_by": dense_t["bound_by"],
        "library_ms": dense_t["library_ms"],
        "host_ms": dense_t["host_ms"],
        "plain_host_ms": dense_t["plain_host_ms"],
        "library_host_ms": dense_t["library_host_ms"],
        "shapes": {"B": B, "H": H, "G": G, "dh": DH, "S": DENSE_S,
                   "lengths": list(DENSE_LENGTHS), "dtype": "float32"},
        "plan": dense_t["plan"],
    }, {
        "name": "gemv", "route": "cuda", "source": src("gemv"),
        "replaces": "src/repro/kernels/gemv/gemv.py:55",
        "ok": True, "launches": chain_launches["gemv"],
        "launches_by_path": {"chain_kernel_runs": chain_launches["gemv"]},
        "max_abs_err": max(v for k, v in gemv_errs.items()
                           if ",float32," in k),
        "max_abs_err_by_case": gemv_errs,
        # the four gemvs of one decoder layer (f32, B = 4), summed
        "ms": sum(c["ms"] for c in f32_calls),
        "plain_ms": sum(c["plain_ms"] for c in f32_calls),
        "bound_ms": sum(c["bound_ms"] for c in f32_calls),
        "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                   for c in f32_calls) else "operations",
        "library_ms": sum(c["library_ms"] for c in f32_calls),
        "unit": "sum of the 4 gemvs of one layer, float32, B=4",
        "per_call": gemv_calls,
    }, {
        "name": "rwkv_scan", "route": "cuda", "source": src("rwkv_scan"),
        "replaces": "src/repro/kernels/rwkv_scan/rwkv_scan.py:50",
        "ok": True, "launches": rwkv["launches"]["rwkv_scan"],
        "launches_by_path": {"rwkv_engine": rwkv["launches"]["rwkv_scan"],
                             "rwkv_replay_kernel":
                                 rwkv["replay"]["decode_launches_kernel"]},
        "max_abs_err": max(rwkv_errs.values()),
        "max_abs_err_by_shape": rwkv_errs,
        "bit_equal_by_shape": rwkv_exact,
        # at the engine's decode shape; no PyTorch call computes the
        # recurrence, so library_ms is null
        "ms": rwkv_t["decode"]["ms"], "plain_ms": rwkv_t["decode"]["plain_ms"],
        "bound_ms": rwkv_t["decode"]["bound_ms"],
        "bound_by": rwkv_t["decode"]["bound_by"], "library_ms": None,
        "host_ms": rwkv_t["decode"]["host_ms"],
        "plain_host_ms": rwkv_t["decode"]["plain_host_ms"],
        "shapes": {"B": RWKV_DECODE[0], "S": RWKV_DECODE[1],
                   "H": RWKV_DECODE[2], "dh": RWKV_DECODE[3],
                   "dtype": "float32"},
        "prefill": dict(rwkv_t["prefill"],
                        comparator="chunked_ms: the port's wkv_chunked "
                                   "(plain PyTorch), time_mix_fwd's "
                                   "prefill path"),
    }, {
        "name": "mamba_scan", "route": "cuda", "source": src("mamba_scan"),
        "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:52",
        # the jamba engine runs entry (b), mamba_scan_fused, only
        "ok": True, "launches": jamba["launches"]["mamba_scan_fused"],
        "main_path_entry": "mamba_scan_fused",
        "launches_by_path": {
            "jamba_engine": jamba["launches"]["mamba_scan_fused"],
            "jamba_replay_kernel":
                jamba["replay"]["prefill_launches_kernel"]
                + jamba["replay"]["decode_launches_kernel"]},
        "max_abs_err": max(max(e.values()) for e in mamba_errs.values()),
        "max_abs_err_by_entry_and_shape": mamba_errs,
        "bit_equal_by_entry_and_shape": mamba_exact,
        # at the engine's decode shape: ms, plain_ms and bound_ms are
        # entry (a)'s, fused_* entry (b)'s, old_path_ms the producers of
        # da and bx + entry (a); no PyTorch call computes the recurrence,
        # so library_ms is null
        "ms": mamba_t["decode"]["ms"],
        "plain_ms": mamba_t["decode"]["plain_ms"],
        "bound_ms": mamba_t["decode"]["bound_ms"],
        "bound_by": mamba_t["decode"]["bound_by"], "library_ms": None,
        "host_ms": mamba_t["decode"]["host_ms"],
        "plain_host_ms": mamba_t["decode"]["plain_host_ms"],
        "fused_ms": mamba_t["decode"]["fused_ms"],
        "fused_plain_ms": mamba_t["decode"]["fused_plain_ms"],
        "fused_bound_ms": mamba_t["decode"]["fused_bound_ms"],
        "fused_bound_by": mamba_t["decode"]["fused_bound_by"],
        "old_path_ms": mamba_t["decode"]["old_path_ms"],
        "shapes": {"B": MAMBA_DECODE[0], "S": MAMBA_DECODE[1],
                   "C": MAMBA_DECODE[2], "N": MAMBA_DECODE[3],
                   "dtype": "float32"},
        "decode": mamba_t["decode"],
        "prefill64": mamba_t["prefill64"],
        "prefill512": mamba_t["prefill512"],
    }]
    print(json.dumps({"kernels": kernels, "floor_ms": floor_ms,
                      "floor_host_ms": floor_host_ms}))
    print(json.dumps({"engine": engine}))
    print(json.dumps({"chain": chain}))
    print(json.dumps({"rwkv": rwkv}))
    print(json.dumps({"jamba": jamba}))
    print(f"[time] total {time.perf_counter() - t_start:.1f} s (limit "
          "1200 s)")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
