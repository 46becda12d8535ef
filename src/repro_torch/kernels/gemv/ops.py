"""Dispatch for the decode GEMV: the Hopper kernel or its plain version,
and the int8 weight quantizer.

:func:`gemv` launches the CUDA kernel (``csrc/gemv.cu``) for tensors on
the card, at every shape it accepts, and takes the plain PyTorch version
(:mod:`.ref`) only for tensors on the CPU.  On the card it launches or
raises: there is no fallback, and none of the reference's TPU rules
(K and N multiples of 128, ``plan_blocks``' VMEM budget) applies — the
kernel picks its own tile.  Each launch adds one to ``gemv.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.gemv.ref import gemv_ref

# the kernel's tile and its cluster limit (csrc/gemv.cu)
TILE_N = 32          # output columns per block
STAGE_K = 32         # weight rows per stage of the shared-memory ring
MAX_CLUSTER = 8      # K splits per cluster (the portable cluster size)
TARGET_BLOCKS = 384  # about three blocks per SM of an H100's 132

_X_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_W_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
           torch.int8: 3}


def gemv_plan(K: int, N: int) -> Tuple[int, int]:
    """(ksplit, column tiles): the K split that puts about TARGET_BLOCKS
    blocks of one row group on the card, within one cluster and with at
    least one stage of weight rows per split.  A function of (K, N) only,
    so row b's result never depends on the number of rows."""
    n_tiles = -(-N // TILE_N)
    ksplit = max(1, min(MAX_CLUSTER, -(-TARGET_BLOCKS // n_tiles),
                        -(-K // STAGE_K)))
    return ksplit, n_tiles


def quantize_weight(w: torch.Tensor, store_dtype: torch.dtype = torch.int8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absmax-quantize a (K, N) weight per OUTPUT column.

    Returns ``(q, scale)``: ``q`` (K, N) in ``store_dtype`` and ``scale``
    (N,) f32, applied at the kernel's f32 flush.  All-zero columns get
    scale 0."""
    qmax = 127.0
    x = w.float()
    scale = x.abs().amax(0) / qmax
    y = x / torch.where(scale > 0, scale, torch.ones_like(scale))[None, :]
    q = torch.clamp(torch.round(y), -qmax, qmax).to(store_dtype)
    return q, scale


def _bind(lib: ctypes.CDLL):
    fn = lib.gemv
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_fn = None


def _launch_fn():
    global _fn
    if _fn is None:
        _fn = _bind(build.load("gemv"))
    return _fn


def gemv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
         *, w_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode GEMV: x (B,K) · w (K,N) [* w_scale (N,)] [+ b (N,)] ->
    (B,N) in x's dtype, f32 accumulation.  ``w_scale`` marks ``w`` as
    int8 quantized per output column (:func:`quantize_weight`)."""
    refuse_autograd("gemv", x, w, b, w_scale)
    if x.device.type == "cpu":
        return gemv_ref(x, w, b, w_scale=w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"gemv: no kernel for {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemv: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "are not (B,K) and (K,N)")
    B, K = x.shape
    N = w.shape[1]
    if x.dtype not in _X_CODE or w.dtype not in _W_CODE:
        raise TypeError(f"gemv kernel takes x in float32/bfloat16/float16 "
                        f"and w in those or int8, got {x.dtype}, {w.dtype}")
    if (w.dtype == torch.int8) != (w_scale is not None):
        raise ValueError("gemv: an int8 weight needs w_scale, and only an "
                         "int8 weight takes one")
    dev = x.device
    for name, t in (("x", x), ("w", w)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"gemv: {name} must be contiguous on {dev}")
    if w_scale is not None and (w_scale.dtype != torch.float32 or
                                tuple(w_scale.shape) != (N,) or
                                w_scale.device != dev or
                                not w_scale.is_contiguous()):
        raise ValueError("gemv: w_scale must be a contiguous float32 (N,) "
                         f"tensor on {dev}")
    if b is not None and (b.dtype not in _X_CODE or tuple(b.shape) != (N,)
                          or b.device != dev or not b.is_contiguous()):
        raise ValueError("gemv: b must be a contiguous float (N,) tensor "
                         f"on {dev}")
    out = torch.empty((B, N), dtype=x.dtype, device=dev)
    if B == 0 or N == 0:
        return out
    if K == 0:
        raise ValueError("gemv: K = 0")
    ksplit, _ = gemv_plan(K, N)
    err = _launch_fn()(
        x.data_ptr(), w.data_ptr(),
        b.data_ptr() if b is not None else None,
        w_scale.data_ptr() if w_scale is not None else None,
        out.data_ptr(), B, K, N, ksplit, _X_CODE[x.dtype], _W_CODE[w.dtype],
        _X_CODE[b.dtype] if b is not None else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemv kernel launch failed: cudaError {err}")
    gemv.launches += 1
    return out


gemv.launches = 0

