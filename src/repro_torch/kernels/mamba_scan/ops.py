"""Dispatch for the selective scan: the Hopper kernel or its plain version.

Two entries of one kernel (``csrc/mamba_scan.cu``):

* :func:`mamba_scan` takes da and bx as (B,S,C,N) tensors, the TPU
  kernel's arguments;
* :func:`mamba_scan_fused` takes dt, x (B,S,C), a (C,N) and b (B,S,N)
  and forms da = exp(dt*a) and bx = (dt*x)*b inside the kernel, so the
  (B,S,C,N) tensors are never written; the jamba model's path.

Each launches the kernel for tensors on the card, at any sequence length
S >= 1 and any channel count C, and takes its plain PyTorch version
(:mod:`.ref`) only for tensors on the CPU.  On the card it launches or
raises: there is no fallback, and none of the reference's TPU rules (S
and C multiples of 8, the VMEM tiles ``block_s``/``block_c``) applies.
Each launch adds one to its entry's ``launches``.  :func:`mamba_plan`
repeats the kernel's plan (lanes per channel, chunk, stages, blocks,
shared memory).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                mamba_scan_ref)

MAX_N = 64      # the kernel keeps a lane's states in registers
MAX_B = 65535   # batch rows ride the grid's y dimension
# the kernel's plan constants (csrc/mamba_scan.cu, kThreads ...)
THREADS = 128       # threads per block
MAX_CHUNK = 32      # sequence steps per stage, at most
# a stage's floats, unless one step needs more: the fused entry's, and
# entry (a)'s, whose rows are (C, N)
STAGE_FLOATS = 4096
ROW_STAGE_FLOATS = 6400
STAGES = 4          # stages in the ring, at most
BARRIER_BYTES = 64  # the ring's full and empty mbarriers


def mamba_plan(B: int, S: int, C: int, N: int, fused: bool = True) -> dict:
    """The kernel's launch plan (``make_plan`` in csrc/mamba_scan.cu):
    ``lanes`` per channel holding ``npl`` states each, ``channels`` per
    block of ``threads``, ``chunk`` steps per stage, ``stages`` in the
    ring, ``blocks`` in the grid and ``smem_bytes`` of shared memory."""
    lanes = 1
    while lanes < -(-N // 4) and lanes < 8:
        lanes *= 2
    npl = 8 if N > 32 else 4
    cb = THREADS // lanes
    np_ = lanes * npl
    per_step = 2 * cb + 2 * np_ if fused else 2 * cb * np_ + np_
    budget = STAGE_FLOATS if fused else ROW_STAGE_FLOATS
    chunk = min(S, max(1, min(MAX_CHUNK, budget // per_step)))
    nchunks = -(-S // chunk)
    stages = min(STAGES, nchunks)
    return {"lanes": lanes, "npl": npl, "channels": cb, "threads": THREADS,
            "chunk": chunk, "stages": stages, "chunks": nchunks,
            "blocks": -(-C // cb) * B,
            "smem_bytes": BARRIER_BYTES + stages * chunk * per_step * 4}


def _bind(lib: ctypes.CDLL, name: str, n_ptrs: int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_fn = None        # entry (a), bound at its first launch
_fused_fn = None  # entry (b)


def _launch_fn():
    global _fn
    if _fn is None:
        _fn = _bind(build.load("mamba_scan"), "mamba_scan", 6)
    return _fn


def _fused_launch_fn():
    global _fused_fn
    if _fused_fn is None:
        _fused_fn = _bind(build.load("mamba_scan"), "mamba_scan_fused", 8)
    return _fused_fn


def _check(entry: str, shapes: dict, dims: Tuple[int, int, int, int]
           ) -> Tuple[int, int, int, int]:
    first = next(iter(shapes.values()))[0]
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{entry}: {name} {tuple(t.shape)}, "
                             f"expected {want}")
        if t.dtype != torch.float32:
            raise TypeError(f"{entry} kernel takes float32, {name} is "
                            f"{t.dtype}")
        if t.device != first.device or not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous on "
                             f"{first.device}")
    B, S, C, N = dims
    if not 1 <= N <= MAX_N:
        raise ValueError(f"{entry}: d_state N={N} must be in "
                         f"[1, {MAX_N}] (the kernel holds a channel's N "
                         "states in registers)")
    if S < 1 or C < 1 or not 1 <= B <= MAX_B:
        raise ValueError(f"{entry}: B={B}, S={S}, C={C} must be >= 1 "
                         f"(B <= {MAX_B})")
    return B, S, C, N


def check_args(da: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
               h0: torch.Tensor) -> Tuple[int, int, int, int]:
    """Raise unless the kernel takes these arguments: shapes, float32,
    one device, contiguous, 1 <= N <= 64.  Returns (B, S, C, N)."""
    if da.dim() != 4:
        raise ValueError(f"mamba_scan: da {tuple(da.shape)} is not "
                         "(B,S,C,N)")
    B, S, C, N = da.shape
    return _check("mamba_scan", {
        "da": (da, (B, S, C, N)), "bx": (bx, (B, S, C, N)),
        "c": (c, (B, S, N)), "h0": (h0, (B, C, N))}, (B, S, C, N))


def check_fused_args(dt: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, h0: torch.Tensor
                     ) -> Tuple[int, int, int, int]:
    """:func:`check_args` for the fused entry.  Returns (B, S, C, N)."""
    if dt.dim() != 3 or a.dim() != 2:
        raise ValueError(f"mamba_scan_fused: dt {tuple(dt.shape)} is not "
                         f"(B,S,C) or a {tuple(a.shape)} is not (C,N)")
    (B, S, C), N = dt.shape, a.shape[1]
    return _check("mamba_scan_fused", {
        "dt": (dt, (B, S, C)), "x": (x, (B, S, C)), "a": (a, (C, N)),
        "b": (b, (B, S, N)), "c": (c, (B, S, N)), "h0": (h0, (B, C, N))},
        (B, S, C, N))


def mamba_scan(da: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
               h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan.  da, bx: (B,S,C,N) f32; c: (B,S,N) f32; h0:
    (B,C,N) f32, all contiguous on one device.  Returns (y (B,S,C),
    h_final (B,C,N)), both new tensors."""
    refuse_autograd("mamba_scan", da, bx, c, h0)
    if da.device.type == "cpu":
        return mamba_scan_ref(da, bx, c, h0)
    if da.device.type != "cuda":
        raise ValueError(f"mamba_scan: no kernel for {da.device}")
    B, S, C, N = check_args(da, bx, c, h0)
    y = torch.empty((B, S, C), dtype=torch.float32, device=da.device)
    h_fin = torch.empty_like(h0)
    err = _launch_fn()(
        da.data_ptr(), bx.data_ptr(), c.data_ptr(), h0.data_ptr(),
        y.data_ptr(), h_fin.data_ptr(), B, S, C, N,
        torch.cuda.current_stream(da.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: cudaError "
                           f"{err}")
    mamba_scan.launches += 1
    return y, h_fin


mamba_scan.launches = 0


def mamba_scan_fused(dt: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, h0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan with the discretization fused in.  dt (after
    softplus), x: (B,S,C) f32; a = -exp(a_log): (C,N) f32; b, c: (B,S,N)
    f32; h0: (B,C,N) f32, all contiguous on one device.  The same as
    ``mamba_scan(exp(dt[..., None] * a), (dt * x)[..., None] * b[:, :,
    None], c, h0)``.  Returns (y (B,S,C), h_final (B,C,N)), both new
    tensors."""
    refuse_autograd("mamba_scan_fused", dt, x, a, b, c, h0)
    if dt.device.type == "cpu":
        return mamba_scan_fused_ref(dt, x, a, b, c, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"mamba_scan_fused: no kernel for {dt.device}")
    B, S, C, N = check_fused_args(dt, x, a, b, c, h0)
    y = torch.empty((B, S, C), dtype=torch.float32, device=dt.device)
    h_fin = torch.empty_like(h0)
    err = _fused_launch_fn()(
        dt.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), h0.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
        B, S, C, N, torch.cuda.current_stream(dt.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_fused kernel launch failed: "
                           f"cudaError {err}")
    mamba_scan_fused.launches += 1
    return y, h_fin


mamba_scan_fused.launches = 0
