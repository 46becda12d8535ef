"""Paged KV-cache: a shared pool of fixed-size blocks + per-request tables.

Host side: a plain-Python copy of the reference's accounting
(``serving/kv_cache.py`` there) — pow2 prefill buckets and the
refcounting :class:`BlockPool`, without the prefix-cache index and its
LRU of parked blocks, which come back with the prefix-cache slice.
Device side: the port's in-place copies of a prefilled
batch-1 cache into the pool (:func:`scatter_prefill_pages`) or a dense
slot (:func:`scatter_prefill_dense`), the positionwise scatter of a
prefill chunk (:func:`scatter_chunk_rows`), and the absmax quantization
of an int8/fp8 pool's rows (:func:`quantize_kv_rows`).

Block id 0 is reserved as the **null block**: table entries past a
request's used length point at it, padded prefill tokens are written to
it, and idle decode slots scatter into it — reads are masked by the
valid length, so it absorbs all don't-care traffic.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch

LANE = 128  # default block size cap (kept from the reference)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# host-side accounting
# ---------------------------------------------------------------------------

def bucket_for(n: int, max_seq: int, min_bucket: int = 16) -> int:
    """Pad a prompt length to its power-of-two prefill bucket."""
    if n > max_seq:
        raise ValueError(f"prompt length {n} exceeds max_seq {max_seq}")
    b = max(min_bucket, 1)
    while b < n:
        b *= 2
    return min(b, max_seq)


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Number of KV blocks needed to hold ``n_tokens``."""
    return max(1, math.ceil(n_tokens / block_size))


def per_rank_block_bytes(n_layers: int, kv_heads_per_rank: int,
                         d_head: int, block_size: int,
                         dtype_bytes: int = 2,
                         scale_bytes: int = 0) -> int:
    """Bytes ONE pool block occupies on ONE rank (K and V, all layers)."""
    return 2 * n_layers * block_size * kv_heads_per_rank \
        * (d_head * dtype_bytes + scale_bytes)


def pool_blocks_for_budget(budget_bytes: int, block_bytes: int) -> int:
    """Largest pool (incl. the null block) fitting a per-rank budget."""
    n = int(budget_bytes // max(block_bytes, 1))
    if n < 2:
        raise ValueError(
            f"KV budget {budget_bytes}B holds {n} blocks of "
            f"{block_bytes}B/rank; need >= 2 (null block + 1)")
    return n


class BlockPool:
    """Refcounting allocator over the shared block pool.

    Block 0 is reserved (null block) and never handed out.  ``alloc``
    returns None when the request cannot be satisfied — the scheduler
    turns that into queueing or preemption, never a partial grant."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (one is the null block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.ref: List[int] = [0] * num_blocks

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return (self.num_blocks - 1) - self.num_free

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > self.num_free:
            return None
        out: List[int] = []
        for _ in range(n):
            b = self._free.pop()
            self.ref[b] = 1
            out.append(b)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per listed block; raises on ids outside the
        pool, the null block, and blocks already at refcount zero."""
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"bad block id {b}")
            if self.ref[b] <= 0:
                raise ValueError(
                    f"double free (or free of never-allocated) block {b}")
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._free.append(b)


def assert_pool_balanced(pool: BlockPool) -> None:
    """Refcount-balance invariant after a full drain: every block at
    refcount zero and every non-null block on the free list."""
    leaked = [b for b in range(1, pool.num_blocks) if pool.ref[b] != 0]
    if leaked:
        raise AssertionError(
            f"leaked blocks (nonzero refcount after drain): {leaked}")
    if pool.num_used != 0:
        raise AssertionError(
            f"pool accounting imbalance: {pool.num_used} blocks used "
            "after drain (the free list lost track of them)")


# ---------------------------------------------------------------------------
# device-side pool plumbing (in place)
# ---------------------------------------------------------------------------

def cache_bytes(cache: Params) -> int:
    """Total bytes of a cache tree (dense slot cache, block pool, or the
    recurrent state of an rwkv or hybrid stack)."""
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    return cache.numel() * cache.element_size()


def scatter_prefill_pages(cache: Params, prefill_cache: Params,
                          table: torch.Tensor) -> None:
    """Copy a batch=1 prefill cache into the shared block pool, in place.

    cache:         {lj: {"k": (n_sb, N, bs, gp, dh), "v": ...}}
    prefill_cache: {lj: {"k": (n_sb, 1, S, gp, dh), "v": ...}}, S a
                   multiple of bs
    table:         (S // bs,) physical block ids; pad entries point at
                   the null block 0, which absorbs the padded tokens."""
    idx = table.long()
    for lj, c in cache.items():
        for key in ("k", "v"):
            pg, dn = c[key], prefill_cache[lj][key]
            n_sb, bs = pg.shape[0], pg.shape[2]
            nb = dn.shape[2] // bs
            chunks = dn[:, 0].reshape((n_sb, nb, bs) + tuple(dn.shape[3:]))
            pg[:, idx] = chunks.to(pg.dtype)


def scatter_prefill_dense(cache: Params, prefill_cache: Params,
                          slot: int) -> None:
    """Copy a batch=1 prefill cache into one slot of the dense cache, in
    place.  KV leaves ("k"/"v") fill the sequence prefix of the slot;
    recurrent-state leaves (rwkv shift/wkv, mamba conv/ssm) replace the
    slot's state wholesale."""
    for lj, c in cache.items():
        for key, tgt in c.items():
            dn = prefill_cache[lj][key]
            if key in ("k", "v"):
                tgt[:, slot, :dn.shape[2]] = dn[:, 0].to(tgt.dtype)
            else:
                tgt[:, slot] = dn[:, 0].to(tgt.dtype)


def scatter_chunk_rows(pages: torch.Tensor, rows: torch.Tensor,
                       block_table: torch.Tensor, positions: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Positionwise scatter of ONE prefill chunk into the block pool, in
    place; returns ``pages``.

    pages:       (N, bs, ...) one layer of the shared pool (values, or a
                 quantized pool's (N, bs, G) scales)
    rows:        (C, ...) the chunk's K (or V, or scale) rows
    block_table: (T,) the request's physical block ids
    positions:   (C,) absolute token positions of the chunk rows
    valid:       (C,) bool; padded rows go to the null block 0."""
    bs = pages.shape[1]
    T = block_table.shape[0]
    pos = positions.long()
    idx = torch.clamp(pos // bs, 0, T - 1)
    blk = torch.where(valid, block_table.long()[idx],
                      torch.zeros((), dtype=torch.long, device=pages.device))
    pages[blk, pos % bs] = rows.to(pages.dtype)
    return pages


# ---------------------------------------------------------------------------
# quantized storage: absmax row quantization + the pool's scale side-arrays
# ---------------------------------------------------------------------------

def qmax_for_dtype(dtype: torch.dtype) -> float:
    """Symmetric clip bound of a quantized pool leaf dtype."""
    if dtype == torch.int8:
        return 127.0
    if dtype == torch.float8_e4m3fn:
        return 448.0
    raise ValueError(f"not a quantized KV storage dtype: {dtype}")


def quantize_kv_rows(rows: torch.Tensor, store_dtype: torch.dtype,
                     scale_dtype: torch.dtype):
    """Symmetric absmax quantization of KV rows along the head dim.

    rows: (..., dh) float K (or V) rows.  Returns ``(q, scales)``: ``q``
    shaped like ``rows`` in ``store_dtype`` (int8 or float8_e4m3fn) and
    ``scales`` shaped ``rows.shape[:-1]`` in ``scale_dtype`` (the plan's
    ``resolve_kv_precision`` gives float16) — one scale per stored token
    row per kv head.  All-zero rows get scale 0 (they dequantize to exact
    zeros, the null block's contract) and never NaN."""
    qmax = qmax_for_dtype(store_dtype)
    x = rows.float()
    scale = x.abs().amax(-1) / qmax
    y = x / torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    y = torch.clamp(y, -qmax, qmax)
    if store_dtype == torch.int8:
        y = torch.round(y)
    return y.to(store_dtype), scale.to(scale_dtype)


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows` (f32 out)."""
    return q.float() * scales.float()[..., None]
