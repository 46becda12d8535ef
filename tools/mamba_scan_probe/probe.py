"""Where the first design of kernel 5 (the selective scan) spent its time.

    python3 tools/mamba_scan_probe/probe.py

Needs one CUDA card and ``nvcc``.  Builds ``probe.cu`` (the first
design's kernel with its pieces switched off one at a time) into
``build/mamba_scan_probe/`` and times each variant with ``chip_smoke``'s
``time_ms`` at the jamba decode shape (4, 1, 8192, 16) and at a prefill
length (1, 512, 8192, 16), beside the port's current ``mamba_scan``
and ``mamba_scan_fused`` (the latter also at 2 and 4 rows of 512
steps), PyTorch's copy of as many bytes as the kernel moves, the
timing floor, and the PyTorch producers of da and bx as the jamba
model ran them before the fused entry.  Then holds the
CUDA math library's ``expf`` against ``torch.exp`` on the card over every
float32 bit pattern.  Prints the card and one JSON line of device ms.
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mamba_scan import ops  # noqa: E402

VARIANTS = ("first_design", "no_state", "no_da_bx_loads", "no_c_staging",
            "empty")


def load_probe():
    out_dir = os.path.join(ROOT, "build", "mamba_scan_probe")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "probe.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so,
                    os.path.join(HERE, "probe.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.probe.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    lib.probe.restype = ctypes.c_int
    lib.probe_expf.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_long, ctypes.c_void_p]
    lib.probe_expf.restype = ctypes.c_int
    return lib


def model_inputs(dev, shape, seed):
    """dt (softplus of a normal), x, a = -exp(a_log) with a_log = log(1..N)
    as jamba initialises it, b, c and h0."""
    B, S, C, N = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, C), generator=g, device=dev) - 2.0)
    x = torch.randn((B, S, C), generator=g, device=dev)
    a = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(
        C, N).contiguous()
    b = torch.randn((B, S, N), generator=g, device=dev)
    c = torch.randn((B, S, N), generator=g, device=dev)
    h0 = 0.1 * torch.randn((B, C, N), generator=g, device=dev)
    return dt, x, a, b, c, h0


def producers(dt, x, a, b):
    """``models/mamba.py``'s da and bx before the fused entry."""
    da = torch.exp(dt[..., None] * a)
    bx = (dt * x)[..., None] * b[:, :, None, :]
    return da.contiguous(), bx.contiguous()


def expf_check(lib, dev):
    """expf of probe.cu against torch.exp over all 2^32 bit patterns:
    mismatches among non-NaN outputs, the largest ulp gap, NaN agreement."""
    stream = torch.cuda.current_stream().cuda_stream
    step = 1 << 28
    bad, worst, nan_bad = 0, 0, 0
    for lo in range(-(1 << 31), 1 << 31, step):
        bits = torch.arange(lo, lo + step, dtype=torch.int64, device=dev
                            ).to(torch.int32)
        x = bits.view(torch.float32)
        got = torch.empty_like(x)
        if lib.probe_expf(x.data_ptr(), got.data_ptr(), x.numel(), stream):
            raise RuntimeError("probe_expf launch failed")
        want = torch.exp(x)
        gn, wn = torch.isnan(got), torch.isnan(want)
        nan_bad += int((gn != wn).sum())
        both = ~gn & ~wn
        gi = got.view(torch.int32)[both].to(torch.int64)
        wi = want.view(torch.int32)[both].to(torch.int64)
        diff = (gi - wi).abs()
        bad += int((diff != 0).sum())
        if diff.numel():
            worst = max(worst, int(diff.max()))
        del bits, x, got, want, gn, wn, both, gi, wi, diff
    return {"patterns": 1 << 32, "mismatches": bad, "max_ulps": worst,
            "nan_mismatches": nan_bad}


def main():
    if not torch.cuda.is_available():
        print("mamba_scan_probe: no CUDA device", file=sys.stderr)
        return 1
    lib = load_probe()
    dev = torch.device("cuda")
    out = {"card": cs.nvidia_smi(), "floor_ms": cs.time_floor(torch, dev)[0]}
    stream = torch.cuda.current_stream().cuda_stream
    for shape in (cs.MAMBA_DECODE, cs.MAMBA_LONG):
        B, S, C, N = shape
        dt, x, a, b, c, h0 = model_inputs(dev, shape, seed=50)
        da, bx = producers(dt, x, a, b)
        per_set = 4 * (2 * da.numel() + 3 * dt.numel() + a.numel()
                       + 2 * b.numel() + 2 * h0.numel())
        n = cs.sets_for(per_set)
        sets = [dict(dt=dt.clone(), x=x.clone(), a=a.clone(), b=b.clone(),
                     c=c.clone(), h0=h0.clone(), da=da.clone(),
                     bx=bx.clone(), y=torch.empty_like(dt),
                     h=torch.empty_like(h0)) for _ in range(n)]
        del dt, x, a, b, c, h0, da, bx
        iters, warm = (200, 20) if S == 1 else (20, 3)

        def variant(mode):
            def call(i):
                s = sets[i]
                err = lib.probe(*[s[k].data_ptr() for k in
                                  ("da", "bx", "c", "h0", "y", "h")],
                                B, S, C, N, mode, stream)
                if err:
                    raise RuntimeError(f"probe launch failed: {err}")
            return call
        res = {name: cs.time_ms(torch, variant(mode), n, iters, warm)[0]
               for mode, name in enumerate(VARIANTS)}
        res["current_kernel"] = cs.time_ms(
            torch, lambda i: ops.mamba_scan(*(sets[i][k] for k in
                                              ("da", "bx", "c", "h0"))),
            n, iters, warm)[0]
        res["current_fused_kernel"] = cs.time_ms(
            torch, lambda i: ops.mamba_scan_fused(
                *(sets[i][k] for k in ("dt", "x", "a", "b", "c", "h0"))),
            n, iters, warm)[0]
        res["torch_producers"] = cs.time_ms(
            torch, lambda i: producers(*(sets[i][k] for k in
                                         ("dt", "x", "a", "b"))),
            n, iters, warm)[0]
        # a copy that moves as many bytes as the first design does
        moved = 4 * (2 * B * S * C * N + B * S * N + 2 * B * C * N
                     + B * S * C)
        src = [torch.empty(moved // 8, device=dev) for _ in range(n)]
        dst = [torch.empty_like(t) for t in src]
        res["torch_copy_same_bytes"] = cs.time_ms(
            torch, lambda i: dst[i].copy_(src[i]), n)[0]
        res["bytes_moved"] = moved
        out["x".join(map(str, shape))] = res
        del sets, src, dst
        torch.cuda.empty_cache()
    # the current fused entry as the rows (and so the warps an SM) grow:
    # a time per row that falls says the kernel waits on latency at B = 1
    for B in (1, 2, 4):
        args = model_inputs(dev, (B, 512, 8192, 16), seed=51)
        n = cs.sets_for(4 * sum(a.numel() for a in args))
        sets = [tuple(a.clone() for a in args) for _ in range(n)]
        out[f"fused_{B}x512x8192x16"] = cs.time_ms(
            torch, lambda i: ops.mamba_scan_fused(*sets[i]), n, 20, 3)[0]
        del args, sets
    out["expf_vs_torch_exp"] = expf_check(lib, dev)
    print(out["card"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
