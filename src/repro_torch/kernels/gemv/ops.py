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
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gemv.ref import gemv_ref

# the kernel's tile (csrc/gemv.cu)
TILE_N = 128        # output columns per block
TILE_ROWS = 4       # rows of x per block
CHUNK_K = 16        # weight rows per warp chunk
WARPS = 4
TARGET_BLOCKS = 264  # two blocks per SM of an H100's 132

_X_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_W_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
           torch.int8: 3}


def split_k(K: int, N: int) -> int:
    """Blocks along K per column tile: enough to put ~TARGET_BLOCKS on
    the card, at most one chunk per warp.  A function of (K, N) only,
    so row b's result never depends on the number of rows."""
    n_tiles = -(-N // TILE_N)
    chunks = -(-K // CHUNK_K)
    return max(1, min(-(-TARGET_BLOCKS // n_tiles), -(-chunks // WARPS)))


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
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_fn = None
# per device: split-K tickets, zero between launches (the kernel's last
# block of a tile resets its own)
_counters: Dict[torch.device, torch.Tensor] = {}


def _launch_fn():
    global _fn
    if _fn is None:
        _fn = _bind(build.load("gemv"))
    return _fn


def _counter_buffer(dev: torch.device, n: int) -> torch.Tensor:
    buf = _counters.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _counters[dev] = buf
    return buf


def gemv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
         *, w_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode GEMV: x (B,K) · w (K,N) [* w_scale (N,)] [+ b (N,)] ->
    (B,N) in x's dtype, f32 accumulation.  ``w_scale`` marks ``w`` as
    int8 quantized per output column (:func:`quantize_weight`)."""
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
    ksplit = split_k(K, N)
    ws = counters = None
    if ksplit > 1:
        ws = torch.empty((ksplit, B, N), dtype=torch.float32, device=dev)
        counters = _counter_buffer(dev, -(-N // TILE_N) * -(-B // TILE_ROWS))
    vec_ok = int(N % 4 == 0 and w.data_ptr() % (4 * w.element_size()) == 0)
    err = _launch_fn()(
        x.data_ptr(), w.data_ptr(),
        b.data_ptr() if b is not None else None,
        w_scale.data_ptr() if w_scale is not None else None,
        out.data_ptr(), ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        B, K, N, ksplit, _X_CODE[x.dtype], _W_CODE[w.dtype],
        _X_CODE[b.dtype] if b is not None else 0, vec_ok,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemv kernel launch failed: cudaError {err}")
    gemv.launches += 1
    return out


gemv.launches = 0

