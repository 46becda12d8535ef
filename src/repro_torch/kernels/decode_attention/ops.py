"""Dispatch for decode attention: the Hopper kernels or their plain
versions, and the paged eligibility rule every caller resolves through.

:func:`paged_decode_attention` (``csrc/paged_decode_attention.cu``) and
:func:`decode_attention` (the dense cache, ``csrc/decode_attention.cu``)
launch their CUDA kernel for tensors on the card and take the plain
PyTorch version (:mod:`.ref`) only for tensors on the CPU.  On the card
they launch or raise: there is no fallback, and none of the reference's
TPU rules (S, block size and d_head multiples of 128, ``plan_block_s``'
VMEM budget) applies.  Each launch adds one to the wrapper's
``launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)

# the paged kernel's limits (csrc/paged_decode_attention.cu)
MAX_GROUP = 8          # query heads per kv head
MAX_D_HEAD = 256
MAX_BLOCK_SIZE = 256   # rows per pool block

# both kernels' split over the cache (csrc/decode_split.cuh): a cluster
# of SPLIT blocks per (b, kv head), tiles of at most MAX_TILE_ROWS rows
# and TILE_BYTES bytes of K (and as many of V)
SPLIT = 16
MAX_TILE_ROWS = 64
TILE_BYTES = 16384

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# a pool may also be int8 / fp8, with f16 scales per (row, kv head)
_POOL_CODE = {**_DTYPE_CODE, torch.int8: 3, torch.float8_e4m3fn: 4}
SCALE_DTYPE = torch.float16


def dense_plan(S: int, d_head: int, item: int) -> Tuple[int, int]:
    """(tile rows L, stages) of the dense kernel for a cache of S rows of
    ``d_head`` values of ``item`` bytes: L covers one block's share of S
    in one tile where the tile's bytes allow, and a second stage
    double-buffers the tiles only when a share can exceed one.  A
    function of S and the row's bytes only: never of B or a length.  The
    paged kernel computes the same plan itself (``tile_plan`` in
    csrc/decode_split.cuh) for S = T * block_size and the pool's item
    size."""
    per = -(-S // SPLIT)
    L = max(1, min(per, MAX_TILE_ROWS, TILE_BYTES // (d_head * item)))
    return L, 1 if per <= L else 2


def kernel_supports(gs: int, d_head: int, block_size: int) -> bool:
    return (1 <= gs <= MAX_GROUP and 1 <= d_head <= MAX_D_HEAD
            and 1 <= block_size <= MAX_BLOCK_SIZE)


def paged_stream_supported(plan, block_size: Optional[int] = None) -> bool:
    """True when paged decode can stream through the kernel: the plan's
    stored GQA layout is block-regular (q head ``h`` reads kv head
    ``h // gs`` with no per-head gather) and the shapes are within the
    kernel's limits.  The reference's TPU rule (block_size and d_head
    multiples of 128) does not apply to this kernel."""
    a = plan.attn
    if a is None or not a.block_regular:
        return False
    gs = a.q_per_rank // max(a.kv_per_rank, 1)
    return kernel_supports(gs, a.d_head,
                           block_size if block_size is not None else 1)


def resolve_paged_kernel(plan, block_size: int, requested: str) -> str:
    """Resolve a ``paged_kernel`` request to the dataflow that will run.

    ``"auto"`` becomes ``"stream"`` when :func:`paged_stream_supported`
    allows it, else ``"gather"``; an explicit ``"stream"`` on an
    ineligible plan raises instead of silently degrading."""
    if requested not in ("auto", "stream", "gather"):
        raise ValueError(f"paged_kernel={requested!r} not in "
                         "('auto', 'stream', 'gather')")
    ok = paged_stream_supported(plan, block_size)
    if requested == "auto":
        return "stream" if ok else "gather"
    if requested == "stream" and not ok:
        raise ValueError(
            "paged_kernel='stream' needs a block-regular stored GQA layout "
            f"with at most {MAX_GROUP} query heads per kv head, d_head <= "
            f"{MAX_D_HEAD} and block_size <= {MAX_BLOCK_SIZE}; plan for "
            f"{plan.arch} with block_size={block_size} cannot stream "
            "(use 'gather' or 'auto')")
    return requested


def _bind_paged(lib: ctypes.CDLL):
    fn = lib.paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bind_dense(lib: ctypes.CDLL):
    fn = lib.decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_fn = None
_dense_fn = None


def _launch_fn():
    global _fn
    if _fn is None:
        _fn = _bind_paged(build.load("paged_decode_attention"))
    return _fn


def _dense_launch_fn():
    global _dense_fn
    if _dense_fn is None:
        _dense_fn = _bind_dense(build.load("decode_attention"))
    return _dense_fn


def _check(name, t, dtype=None, shape=None, device=None):
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           k_new: Optional[torch.Tensor] = None,
                           v_new: Optional[torch.Tensor] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Paged decode attention over a shared block pool.

    q: (B,H,dh); k_pages, v_pages: (N,bs,G,dh) with H = G*gs;
    block_tables: (B,T) int32 physical block ids (each < N); lengths:
    (B,) int32 resident tokens per row; k_new/v_new: (B,G,dh) in q's
    dtype, the current token attended in addition (the pool is read
    before the caller scatters it); k_scale/v_scale: (N,bs,G) f16 scales
    of an int8/fp8 pool.  A row with length 0 returns v_new with the
    fold, else the mean of the V rows of its whole table, as the
    reference does.  -> (B,H,dh) in q's dtype."""
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new go together")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, lengths, k_new=k_new,
            v_new=v_new, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    B, H, dh = q.shape
    N, bs, G, _ = k_pages.shape
    T = block_tables.shape[1]
    if H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    if not kernel_supports(H // G, dh, bs):
        raise ValueError(
            f"kernel limits: H/G={H // G} (<= {MAX_GROUP}), dh={dh} "
            f"(<= {MAX_D_HEAD}), block_size={bs} (<= {MAX_BLOCK_SIZE})")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype not in _POOL_CODE:
        raise TypeError(f"kernel takes q in float32/bfloat16/float16 and a "
                        f"pool in those or int8/float8_e4m3fn, got q "
                        f"{q.dtype}, pool {k_pages.dtype}")
    quantized = k_pages.dtype not in _DTYPE_CODE
    if quantized != (k_scale is not None):
        raise ValueError("an int8/fp8 pool needs k_scale/v_scale, and only "
                         "such a pool takes them")
    dev = q.device
    _check("q", q)
    _check("k_pages", k_pages, shape=(N, bs, G, dh), device=dev)
    _check("v_pages", v_pages, dtype=k_pages.dtype, shape=(N, bs, G, dh),
           device=dev)
    _check("block_tables", block_tables, dtype=torch.int32, shape=(B, T),
           device=dev)
    _check("lengths", lengths, dtype=torch.int32, shape=(B,), device=dev)
    if k_new is not None:
        _check("k_new", k_new, dtype=q.dtype, shape=(B, G, dh), device=dev)
        _check("v_new", v_new, dtype=q.dtype, shape=(B, G, dh), device=dev)
    if quantized:
        _check("k_scale", k_scale, dtype=SCALE_DTYPE, shape=(N, bs, G),
               device=dev)
        _check("v_scale", v_scale, dtype=SCALE_DTYPE, shape=(N, bs, G),
               device=dev)
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = _launch_fn()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), lengths.data_ptr(),
        k_new.data_ptr() if k_new is not None else None,
        v_new.data_ptr() if v_new is not None else None,
        out.data_ptr(), B, H, G, dh, bs, T, _DTYPE_CODE[q.dtype],
        _POOL_CODE[k_pages.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over a dense cache.

    q: (B,H,dh); k, v: (B,S,G,dh) with H = G*gs (q head ``h`` reads kv
    head ``h // gs``), each row contiguous; the batch stride may be 0 (a
    cache broadcast over the batch, read in place); lengths: (B,) int32
    valid cache length.  A row with length 0 returns the mean of its S
    V rows, as the reference does.  -> (B,H,dh) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    B, H, dh = q.shape
    _, S, G, _ = k.shape
    if H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    if not (1 <= H // G <= MAX_GROUP and 1 <= dh <= MAX_D_HEAD and S >= 1):
        raise ValueError(f"kernel limits: H/G={H // G} (<= {MAX_GROUP}), "
                         f"dh={dh} (<= {MAX_D_HEAD}), S={S} (>= 1)")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32/bfloat16/float16, got q "
                        f"{q.dtype}, cache {k.dtype}")
    dev = q.device
    _check("q", q)
    _check("lengths", lengths, dtype=torch.int32, shape=(B,), device=dev)
    for name, t in (("k", k), ("v", v)):
        if t.dtype != k.dtype or tuple(t.shape) != (B, S, G, dh) or \
                t.device != dev:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {k.dtype} "
                             f"{(B, S, G, dh)} on {dev}")
        if t.stride()[1:] != (G * dh, dh, 1):
            raise ValueError(f"{name}: rows must be contiguous (strides "
                             f"{t.stride()})")
    out = torch.empty_like(q)
    if B == 0:
        return out
    L, stages = dense_plan(S, dh, k.element_size())
    err = _dense_launch_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, G, dh, S, k.stride(0), v.stride(0), L, stages,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
