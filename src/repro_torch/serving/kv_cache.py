"""Paged KV-cache: a shared pool of fixed-size blocks + per-request tables.

Host side: a plain-Python copy of the reference's accounting
(``serving/kv_cache.py`` there) — pow2 prefill buckets, the refcounting
:class:`BlockPool` with its LRU of parked cached blocks, and the
block-aligned prefix index :class:`PrefixCache`.  Device side: the
port's in-place copies of a prefilled batch-1 cache into the pool
(:func:`scatter_prefill_pages`) or a dense slot
(:func:`scatter_prefill_dense`), the positionwise scatter of a prefill
chunk (:func:`scatter_chunk_rows`) and of a speculative verify window
with one table per query (:func:`scatter_spec_rows`), the copy-on-write
copy of one pool block (:func:`copy_pool_block`), and the absmax
quantization of an int8/fp8 pool's rows (:func:`quantize_kv_rows`).

Block id 0 is reserved as the **null block**: table entries past a
request's used length point at it, padded prefill tokens are written to
it, and idle decode slots scatter into it — reads are masked by the
valid length, so it absorbs all don't-care traffic.
"""
from __future__ import annotations

import math
import zlib
from collections import OrderedDict
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

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
    turns that into queueing or preemption, never a partial grant.

    A prefix-cache hit maps one physical block into several tables
    (:meth:`share`); ``free`` drops one reference and returns the block
    to circulation at zero.  A block registered in the prefix index
    (:meth:`mark_cached`) parks in an LRU at refcount zero, its KV still
    valid for later hits; ``alloc`` drains the plain free list first and
    only then evicts LRU-oldest cached blocks, calling ``on_evict`` so
    the index drops them (counted in ``evicted_blocks``)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (one is the null block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.ref: List[int] = [0] * num_blocks
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._cached: set = set()
        self.on_evict: Optional[Callable[[int], None]] = None
        self.evicted_blocks = 0

    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._lru)

    @property
    def num_used(self) -> int:
        return (self.num_blocks - 1) - self.num_free

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > self.num_free:
            return None
        out: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, _ = self._lru.popitem(last=False)
                self._cached.discard(b)
                self.evicted_blocks += 1
                if self.on_evict is not None:
                    self.on_evict(b)
            self.ref[b] = 1
            out.append(b)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per listed block; raises on ids outside the
        pool, the null block, and blocks already at refcount zero (once
        blocks are shared, a silent bad free corrupts another request's
        KV)."""
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"bad block id {b}")
            if self.ref[b] <= 0:
                raise ValueError(
                    f"double free (or free of never-allocated) block {b}")
            self.ref[b] -= 1
            if self.ref[b] == 0:
                if b in self._cached:
                    self._lru[b] = None       # most-recently-used end
                else:
                    self._free.append(b)

    def share(self, blocks: Sequence[int]) -> None:
        """Take one more reference on each block (a prefix hit mapping
        cached blocks into a new table); a block parked in the LRU is
        revived."""
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"bad block id {b}")
            if self.ref[b] == 0:
                if b not in self._lru:
                    raise ValueError(f"share of free, un-cached block {b}")
                del self._lru[b]
            self.ref[b] += 1

    def mark_cached(self, block: int) -> None:
        """Flag a live block as registered in the prefix index: at
        refcount zero it parks in the LRU instead of the free list."""
        if self.ref[block] <= 0:
            raise ValueError(f"mark_cached of free block {block}")
        self._cached.add(block)

    def touch(self, blocks: Sequence[int]) -> None:
        """Refresh the LRU recency of parked cached blocks."""
        for b in blocks:
            if b in self._lru:
                self._lru.move_to_end(b)


def assert_pool_balanced(pool: BlockPool,
                         prefix: Optional["PrefixCache"] = None) -> None:
    """Refcount-balance invariant after a full drain: every block at
    refcount zero (cached blocks park at zero too), the free list and
    the LRU accounting for every non-null block, and — with a prefix
    index — every index entry pointing at a parked block."""
    leaked = [b for b in range(1, pool.num_blocks) if pool.ref[b] != 0]
    if leaked:
        raise AssertionError(
            f"leaked blocks (nonzero refcount after drain): {leaked}")
    if pool.num_used != 0:
        raise AssertionError(
            f"pool accounting imbalance: {pool.num_used} blocks used "
            "after drain (free + LRU lists lost track of them)")
    if prefix is not None:
        stray = [b for b in prefix._by_block if b not in pool._lru]
        if stray:
            raise AssertionError(
                f"prefix index entries for non-parked blocks: {stray}")


# ---------------------------------------------------------------------------
# prefix cache: block-aligned hash index over token prefixes
# ---------------------------------------------------------------------------

def _chain_hash(prev: int, tokens: Sequence[int]) -> int:
    """crc32 of one block's tokens chained on the hash of everything
    before it (crc32, not ``hash``: the same in every process)."""
    data = prev.to_bytes(4, "little") + \
        b"".join(int(t).to_bytes(4, "little", signed=True) for t in tokens)
    return zlib.crc32(data)


class PrefixCache:
    """Block-aligned prefix index over the pool.

    Maps the chained hash of each *full* block of prompt tokens to the
    physical block holding its KV.  At admission the longest chain of
    hits is mapped (refcounted) into the new table and only the tail is
    prefilled.  One entry per physical block; eviction from the pool's
    LRU drops the entry through ``pool.on_evict``.  A registered block's
    contents never change: a write into a block with refcount > 1 is
    copied first (the engine's copy-on-write), and a sole owner only
    appends past the hashed span."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.block_size = pool.block_size
        self._by_hash: Dict[int, int] = {}
        self._by_block: Dict[int, int] = {}
        self.lookups = 0
        self.hits = 0
        self.hit_blocks = 0
        self.tokens_saved = 0
        pool.on_evict = self._evict

    def _evict(self, block: int) -> None:
        h = self._by_block.pop(block, None)
        if h is not None and self._by_hash.get(h) == block:
            del self._by_hash[h]

    def _hit_blocks(self, tokens: Sequence[int]) -> List[int]:
        bs = self.block_size
        hit: List[int] = []
        h = 0
        for i in range(len(tokens) // bs):
            h = _chain_hash(h, tokens[i * bs:(i + 1) * bs])
            b = self._by_hash.get(h)
            if b is None:
                break
            hit.append(b)
        return hit

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: ``(shared_blocks,
        cached_tokens)``.  ``cached_tokens`` is capped at ``len(tokens)
        - 1`` so at least one tail token is prefilled (its logits row
        gives the first sampled token); when the cap lands mid-block,
        the last shared block is the one a tail write copies on write."""
        self.lookups += 1
        hit = self._hit_blocks(tokens)
        cached = min(len(hit) * self.block_size, len(tokens) - 1)
        if cached <= 0:
            return [], 0
        shared = hit[:blocks_for(cached, self.block_size)]
        self.pool.touch(shared)
        return shared, cached

    def peek(self, tokens: Sequence[int]) -> int:
        """Prefix tokens :meth:`match` would map now, with its cap, but
        counting no lookup and touching no LRU entry."""
        hit = self._hit_blocks(tokens)
        return max(min(len(hit) * self.block_size, len(tokens) - 1), 0)

    def note_hit(self, shared: Sequence[int], cached: int) -> None:
        """Count a hit that admitted (called once the tail's blocks were
        granted, so a request that waits is not counted twice)."""
        self.hits += 1
        self.hit_blocks += len(shared)
        self.tokens_saved += cached

    def register(self, tokens: Sequence[int], blocks: Sequence[int]) -> None:
        """Index every full block of a fully prefilled prompt; the first
        entry wins a hash or a block, so each block keeps one entry."""
        bs = self.block_size
        h = 0
        for i in range(len(tokens) // bs):
            h = _chain_hash(h, tokens[i * bs:(i + 1) * bs])
            if i >= len(blocks):
                break
            b = blocks[i]
            if self._by_hash.get(h) == b:
                continue
            if h in self._by_hash or b in self._by_block:
                continue
            self._by_hash[h] = b
            self._by_block[b] = h
            self.pool.mark_cached(b)


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

    cache:         {lj: {"k": (n_sb, N, bs, gp, dh), "v": ...}}, plus
                   ``k_scale``/``v_scale`` (n_sb, N, bs, gp) leaves for
                   an int8/fp8 pool
    prefill_cache: {lj: {"k": (n_sb, 1, S, gp, dh), "v": ...}}, S a
                   multiple of bs
    table:         (S // bs,) physical block ids; pad entries point at
                   the null block 0, which absorbs the padded tokens.

    The prefill cache stays full precision; a quantized pool's rows are
    quantized HERE, at pool-write time, as every other row scatter
    does."""
    idx = table.long()
    for lj, c in cache.items():
        for key in ("k", "v"):
            pg, dn = c[key], prefill_cache[lj][key]
            n_sb, bs = pg.shape[0], pg.shape[2]
            nb = dn.shape[2] // bs
            chunks = dn[:, 0].reshape((n_sb, nb, bs) + tuple(dn.shape[3:]))
            spg = c.get(key + "_scale")
            if spg is not None:
                q, s = quantize_kv_rows(chunks, pg.dtype, spg.dtype)
                pg[:, idx] = q
                spg[:, idx] = s
            else:
                pg[:, idx] = chunks.to(pg.dtype)


def _block_index(i: Union[int, torch.Tensor],
                 device: torch.device) -> torch.Tensor:
    """(1,) long index of a slot or block: a device int read in place
    (what a captured program passes, so no value is baked into it), or
    a host int."""
    if torch.is_tensor(i):
        return i.reshape(1).long()
    return torch.tensor([int(i)], dtype=torch.long, device=device)


def scatter_prefill_dense(cache: Params, prefill_cache: Params,
                          slot: Union[int, torch.Tensor]) -> None:
    """Copy a batch=1 prefill cache into one slot of the dense cache, in
    place.  KV leaves ("k"/"v") fill the sequence prefix of the slot;
    recurrent-state leaves (rwkv shift/wkv, mamba conv/ssm) replace the
    slot's state wholesale.  ``slot``: an int, or a (1,) device int."""
    for lj, c in cache.items():
        for key, tgt in c.items():
            dn = prefill_cache[lj][key].to(tgt.dtype)
            idx = _block_index(slot, tgt.device)
            if key in ("k", "v"):
                tgt[:, :, :dn.shape[2]].index_copy_(1, idx, dn)
            else:
                tgt.index_copy_(1, idx, dn)


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


def scatter_spec_rows(pages: torch.Tensor, rows: torch.Tensor,
                      block_tables: torch.Tensor, positions: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Per-query scatter of a speculative verify window into the block
    pool, in place; returns ``pages``.  The per-query form of
    :func:`scatter_chunk_rows`: each row resolves its (block, offset)
    through its OWN table.  Rejected drafts are never un-written: their
    rows lie past the slot's resident length, masked on every later read
    and overwritten by the next window (logical rollback).

    pages:        (N, bs, ...) one layer of the shared pool (values, or
                  a quantized pool's (N, bs, G) scales)
    rows:         (Q, ...) the verify queries' K (or V, or scale) rows
    block_tables: (Q, T) each query's physical block ids
    positions:    (Q,) absolute token positions
    valid:        (Q,) bool; invalid rows go to the null block 0."""
    bs = pages.shape[1]
    T = block_tables.shape[1]
    pos = positions.long()
    idx = torch.clamp(pos // bs, 0, T - 1)
    blk = block_tables.long().gather(1, idx[:, None])[:, 0]
    blk = torch.where(valid, blk,
                      torch.zeros((), dtype=torch.long, device=pages.device))
    pages[blk, pos % bs] = rows.to(pages.dtype)
    return pages


def copy_pool_block(cache: Params, src: Union[int, torch.Tensor],
                    dst: Union[int, torch.Tensor]) -> None:
    """Copy physical block ``src`` over ``dst`` in every leaf of the
    pool, in place, on the current stream (copy-on-write: a shared block
    is duplicated before its writer's next scatter).  ``src``/``dst``:
    ints, or (1,) device ints.

    cache: {lj: {"k", "v", ...: (n_sb, N, bs, ...)}}"""
    for c in cache.values():
        for pg in c.values():
            pg.index_copy_(1, _block_index(dst, pg.device),
                           pg.index_select(1, _block_index(src, pg.device)))


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
