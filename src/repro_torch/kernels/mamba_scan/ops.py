"""Dispatch for the selective scan: the Hopper kernel or its plain version.

:func:`mamba_scan` launches the CUDA kernel (``csrc/mamba_scan.cu``) for
tensors on the card, at any sequence length S >= 1 and any channel count
C, and takes the plain PyTorch version (:mod:`.ref`) only for tensors on
the CPU.  On the card it launches or raises: there is no fallback, and
none of the reference's TPU rules (S and C multiples of 8, the VMEM
tiles ``block_s``/``block_c``) applies.  Each launch adds one to
``mamba_scan.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

MAX_N = 64      # the kernel keeps a thread's N states in registers
MAX_B = 65535   # batch rows ride the grid's y dimension


def _bind(lib: ctypes.CDLL):
    fn = lib.mamba_scan
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_fn = None


def _launch_fn():
    global _fn
    if _fn is None:
        _fn = _bind(build.load("mamba_scan"))
    return _fn


def check_args(da: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
               h0: torch.Tensor) -> Tuple[int, int, int, int]:
    """Raise unless the kernel takes these arguments: shapes, float32,
    one device, contiguous, 1 <= N <= 64.  Returns (B, S, C, N)."""
    if da.dim() != 4:
        raise ValueError(f"mamba_scan: da {tuple(da.shape)} is not "
                         "(B,S,C,N)")
    B, S, C, N = da.shape
    shapes = {"da": (da, (B, S, C, N)), "bx": (bx, (B, S, C, N)),
              "c": (c, (B, S, N)), "h0": (h0, (B, C, N))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"mamba_scan: {name} {tuple(t.shape)}, "
                             f"expected {want}")
        if t.dtype != torch.float32:
            raise TypeError(f"mamba_scan kernel takes float32, {name} is "
                            f"{t.dtype}")
        if t.device != da.device or not t.is_contiguous():
            raise ValueError(f"mamba_scan: {name} must be contiguous on "
                             f"{da.device}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"mamba_scan: d_state N={N} must be in "
                         f"[1, {MAX_N}] (the kernel holds a channel's N "
                         "states in registers)")
    if S < 1 or C < 1 or not 1 <= B <= MAX_B:
        raise ValueError(f"mamba_scan: B={B}, S={S}, C={C} must be >= 1 "
                         f"(B <= {MAX_B})")
    return B, S, C, N


def mamba_scan(da: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
               h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan.  da, bx: (B,S,C,N) f32; c: (B,S,N) f32; h0:
    (B,C,N) f32, all contiguous on one device.  Returns (y (B,S,C),
    h_final (B,C,N)), both new tensors."""
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
