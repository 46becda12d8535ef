"""Dispatch for paged decode attention: the Hopper kernel or its plain
version, and the eligibility rule every caller resolves through.

:func:`paged_decode_attention` launches the CUDA kernel
(``csrc/paged_decode_attention.cu``) for tensors on the card and takes
the plain PyTorch version (:mod:`.ref`) only for tensors on the CPU.  On
the card it launches or raises: there is no fallback.  Each launch adds
one to ``paged_decode_attention.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref

# the kernel's own limits (csrc/paged_decode_attention.cu)
MAX_GROUP = 8          # query heads per kv head
MAX_D_HEAD = 256
MAX_BLOCK_SIZE = 256   # pool rows per tile (scores live in shared memory)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def _bind(lib: ctypes.CDLL):
    fn = lib.paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_fn = None


def _launch_fn():
    global _fn
    if _fn is None:
        _fn = _bind(build.load("paged_decode_attention"))
    return _fn


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
    before the caller scatters it); k_scale/v_scale: (N,bs,G) scales of
    a quantized pool (plain version only for now).  -> (B,H,dh) in q's
    dtype."""
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
    if k_scale is not None:
        raise NotImplementedError(
            "the int8/fp8 pool (k_scale/v_scale) is not in the CUDA kernel "
            "yet; it arrives with the quantized-KV slice")
    B, H, dh = q.shape
    N, bs, G, _ = k_pages.shape
    T = block_tables.shape[1]
    if H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    if not kernel_supports(H // G, dh, bs):
        raise ValueError(
            f"kernel limits: H/G={H // G} (<= {MAX_GROUP}), dh={dh} "
            f"(<= {MAX_D_HEAD}), block_size={bs} (<= {MAX_BLOCK_SIZE})")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32/bfloat16/float16, got q "
                        f"{q.dtype}, pool {k_pages.dtype}")
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
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = _launch_fn()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(),
        k_new.data_ptr() if k_new is not None else None,
        v_new.data_ptr() if v_new is not None else None,
        out.data_ptr(), B, H, G, dh, bs, T,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
