"""Dispatch for the WKV recurrence: the Hopper kernel or its plain version.

:func:`rwkv_scan` launches the CUDA kernel (``csrc/rwkv_scan.cu``) for
tensors on the card, at any sequence length S >= 1, and takes the plain
PyTorch version (:mod:`.ref`) only for tensors on the CPU.  On the card
it launches or raises: there is no fallback, and none of the reference's
TPU rules (S a multiple of 8, the VMEM tile ``block_s``) applies.  Each
launch adds one to ``rwkv_scan.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref

MAX_DH = 128    # the kernel keeps a state column of dh floats per thread


def _bind(lib: ctypes.CDLL):
    fn = lib.rwkv_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_fn = None


def _launch_fn():
    global _fn
    if _fn is None:
        _fn = _bind(build.load("rwkv_scan"))
    return _fn


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV recurrence.  r,k,v,w: (B,S,H,dh) f32; u: (H,dh) f32;
    s0: (B,H,dh,dh) f32, all contiguous on one device.  Returns
    (y (B,S,H,dh), s_final (B,H,dh,dh)), both new tensors."""
    refuse_autograd("rwkv_scan", r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return rwkv_scan_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv_scan: no kernel for {r.device}")
    if r.dim() != 4:
        raise ValueError(f"rwkv_scan: r {tuple(r.shape)} is not (B,S,H,dh)")
    B, S, H, dh = r.shape
    shapes = {"r": (r, (B, S, H, dh)), "k": (k, (B, S, H, dh)),
              "v": (v, (B, S, H, dh)), "w": (w, (B, S, H, dh)),
              "u": (u, (H, dh)), "s0": (s0, (B, H, dh, dh))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"rwkv_scan: {name} {tuple(t.shape)}, "
                             f"expected {want}")
        if t.dtype != torch.float32:
            raise TypeError(f"rwkv_scan kernel takes float32, {name} is "
                            f"{t.dtype}")
        if t.device != r.device or not t.is_contiguous():
            raise ValueError(f"rwkv_scan: {name} must be contiguous on "
                             f"{r.device}")
    if S < 1 or not 1 <= dh <= MAX_DH:
        raise ValueError(f"rwkv_scan: S={S} must be >= 1 and dh={dh} in "
                         f"[1, {MAX_DH}]")
    y = torch.empty_like(r)
    s_fin = torch.empty_like(s0)
    err = _launch_fn()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
        B, S, H, dh, torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv_scan kernel launch failed: cudaError {err}")
    rwkv_scan.launches += 1
    return y, s_fin


rwkv_scan.launches = 0
