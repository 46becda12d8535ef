"""GQA attention under the mapper's stored head layout.

Weights live in the stored layout of ``plan.attn``: wq (D, Hp, dh),
wk/wv (D, Gp, dh), wo (Hp, dh, D).  At tp=1 the projections are plain
matmuls.  On the ring (``env`` from :mod:`repro_torch.core.dist`) each
rank holds its q_per_rank query heads and kv_per_rank kv heads (padded,
or duplicated when there are fewer kv heads than ranks), projects them
with ONE streamed ESL ``ag_matmul`` of its concatenated q/k/v tiles,
attends on its local heads only (every local q head finds its kv head
on its own rank, ``local_kmap``), and reduces the output projection
around the ring with ``rs_matmul``.  The cache holds the rank's
kv_per_rank heads, with the same block ids on every rank.

Decode reads the cache *before* this step's update and folds the new
token into the online softmax; the caller then scatters (k_new, v_new)
into the cache.  In the port the scatter happens in place, right after
the layer's attention, so the per-layer pool is never copied.  A chunk
of prefill and a speculative verify window scatter their rows first and
then read them back through one length mask.

An int8/fp8 pool carries ``k_scale``/``v_scale`` leaves (one f16 absmax
scale per stored row and kv head): every row is quantized at pool-write
time, and every reader (the paged kernel, the gather oracle, decode's
fold of the new token) sees the dequantized stored value.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import dist, esl
from repro_torch.core.dist import AxisEnv, model_rank, on_ring, ring_axis
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.models.common import apply_rope, big_neg
from repro_torch.serving.kv_cache import (dequantize_kv, quantize_kv_rows,
                                          scatter_chunk_rows,
                                          scatter_spec_rows)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def qkv_proj(p: Params, x: torch.Tensor, plan,
             env: Optional[AxisEnv] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D) (or (B,S,D/tp) scattered on the ring) -> the rank's
    q (B,S,qpr,dh), k, v (B,S,kpr,dh)."""
    a = plan.attn
    D = p["wq"].shape[0]
    B, S = x.shape[0], x.shape[1]
    qpr, kpr, dh = a.q_per_rank, a.kv_per_rank, a.d_head
    if on_ring(env):
        # one streamed matmul of the concatenated q/k/v column tiles
        w = torch.cat([p["wq"].reshape(D, qpr * dh),
                       p["wk"].reshape(D, kpr * dh),
                       p["wv"].reshape(D, kpr * dh)], -1)
        b = (torch.cat([p["bq"].reshape(-1), p["bk"].reshape(-1),
                        p["bv"].reshape(-1)]) if "bq" in p else None)
        y = esl.ag_matmul(x, w, axis=env.model, tp=env.tp,
                          overlap=plan.esl_overlap, b=b)
        # contiguous copies of the column splits: kernel 1 reads dense
        # rows, as the tp=1 path's separate products give them
        q, k, v = (t.contiguous() for t in
                   y.split([qpr * dh, kpr * dh, kpr * dh], -1))
        return (q.reshape(B, S, qpr, dh), k.reshape(B, S, kpr, dh),
                v.reshape(B, S, kpr, dh))
    q = x @ p["wq"].reshape(D, qpr * dh)
    k = x @ p["wk"].reshape(D, kpr * dh)
    v = x @ p["wv"].reshape(D, kpr * dh)
    if "bq" in p:
        q = q + p["bq"].reshape(-1)
        k = k + p["bk"].reshape(-1)
        v = v + p["bv"].reshape(-1)
    return (q.reshape(B, S, qpr, dh), k.reshape(B, S, kpr, dh),
            v.reshape(B, S, kpr, dh))


def out_proj(p: Params, attn_out: torch.Tensor, plan,
             env: Optional[AxisEnv] = None) -> torch.Tensor:
    """attn_out: (B,S,qpr,dh) -> (B,S,D); on the ring the sum over the
    ranks' heads, scattered (B,S,D/tp) when ESL overlap is on."""
    a = plan.attn
    B, S = attn_out.shape[0], attn_out.shape[1]
    w = p["wo"].reshape(a.q_per_rank * a.d_head, -1)
    if on_ring(env):
        return esl.rs_matmul(attn_out.reshape(B, S, -1), w, axis=env.model,
                             tp=env.tp, overlap=plan.esl_overlap,
                             scatter_out=plan.esl_overlap)
    return attn_out.reshape(B, S, -1) @ w


_KMAPS: Dict[Tuple, torch.Tensor] = {}


def local_kmap(plan, device, rank: int = 0) -> torch.Tensor:
    """(qpr,) local kv index per local q head of ring rank ``rank`` (0
    at tp=1).  Made once per map and device: a host-to-device copy
    cannot run inside a captured graph, and the first call happens in
    the eager warm-up."""
    kmap = tuple(int(i) for i in plan.attn.q_to_kv_local[rank])
    key = (kmap, torch.device(device))
    t = _KMAPS.get(key)
    if t is None:
        t = _KMAPS[key] = torch.as_tensor(kmap, dtype=torch.long,
                                          device=device)
    return t


def _expand_kv(k: torch.Tensor, kmap: torch.Tensor) -> torch.Tensor:
    """(B,S,kpr,dh) -> (B,S,qpr,dh) per the local q->kv map.  An indexed
    read, not ``index_select``: under autograd its backward is the
    sorted accumulation of ``index_put_``, the same sums in the same
    order on every run, where ``index_select``'s ``index_add_`` adds
    a kv head's query heads with atomics in no fixed order on the card."""
    return k[:, :, kmap]


def _pool_scales(cache: Dict[str, torch.Tensor]):
    """(k_scale, v_scale) of an int8/fp8 pool, (None, None) for an fp
    one; a quantized pool without its scale leaves is refused (its raw
    codes would be read as values)."""
    if "k_scale" in cache:
        return cache["k_scale"], cache["v_scale"]
    if not cache["k"].is_floating_point() or \
            cache["k"].dtype == torch.float8_e4m3fn:
        raise ValueError(f"a {cache['k'].dtype} pool needs its k_scale/"
                         "v_scale leaves")
    return None, None


def _quantized_rows(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                    v: torch.Tensor):
    """(K rows, V rows, K scales, V scales) as the pool stores them:
    quantized with their scales for an int8/fp8 pool, else the rows and
    None."""
    if "k_scale" not in cache:
        return k, v, None, None
    kq, ksc = quantize_kv_rows(k, cache["k"].dtype, cache["k_scale"].dtype)
    vq, vsc = quantize_kv_rows(v, cache["v"].dtype, cache["v_scale"].dtype)
    return kq, vq, ksc, vsc


def _gather_view(pages: torch.Tensor, scales: Optional[torch.Tensor],
                 tables: torch.Tensor) -> torch.Tensor:
    """The contiguous (B, T*bs, G, dh) view of each row's blocks through
    its (B, T) table, dequantized to f32 for an int8/fp8 pool."""
    B, T = tables.shape
    tbl = tables.long()
    view = pages[tbl].reshape(B, T * pages.shape[1], *pages.shape[2:])
    if scales is not None:
        view = dequantize_kv(view, scales[tbl].reshape(view.shape[:-1]))
    return view


# ---------------------------------------------------------------------------
# flash (online-softmax) core
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_valid_len: Optional[torch.Tensor] = None,
                    kv_base: int = 0,
                    chunk: int = 512,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked online-softmax attention.

    q: (B,Sq,H,dh); k,v: (B,Skv,H,dh) (same head count — pre-expanded).
    causal uses absolute positions ``q_offset + i`` vs ``kv_base + j``;
    ``kv_valid_len``: (B,) valid kv length."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    scale = scale or (1.0 / math.sqrt(dh))
    dev = q.device
    neg = big_neg()
    q32 = q.float() * scale
    q_pos = torch.arange(Sq, device=dev)
    if q_offset is not None:
        q_pos = q_offset[..., None] + q_pos                # (B,Sq)
    m = torch.full((B, H, Sq), neg, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, dh), dtype=torch.float32, device=dev)
    for start in range(0, Skv, min(chunk, Skv)):
        kb = k[:, start:start + chunk].float()
        vb = v[:, start:start + chunk].float()
        kv_pos = kv_base + start + torch.arange(kb.shape[1], device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb)
        if causal:
            qp = q_pos if q_pos.dim() == 2 else q_pos[None]
            mask = qp[:, None, :, None] >= kv_pos[None, None, None, :]
            s = torch.where(mask, s, neg)
        if kv_valid_len is not None:
            ok = kv_pos[None, :] < kv_valid_len[:, None]   # (B, chunk)
            s = torch.where(ok[:, None, None, :], s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / l[..., None].clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)                 # (B,Sq,H,dh)


def _flash_decode_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kmap: torch.Tensor, *, kv_valid_len: torch.Tensor,
                          chunk: int = 2048,
                          k_new: Optional[torch.Tensor] = None,
                          v_new: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Generation-stage flash attention over a contiguous cache.

    q: (B,1,qpr,dh); k,v: (B,S,kpr,dh); k_new/v_new (B,1,kpr,dh) are
    folded in after the cache.  -> (B,1,qpr,dh)."""
    B, _, qpr, dh = q.shape
    S = k.shape[1]
    dev = q.device
    neg = big_neg()
    chunk = min(chunk, S)
    scale = 1.0 / math.sqrt(dh)
    qs = (q[:, 0].float() * scale).to(k.dtype)             # (B,qpr,dh)
    heads = torch.arange(qpr, device=dev)
    m = torch.full((B, qpr), neg, dtype=torch.float32, device=dev)
    l = torch.zeros((B, qpr), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, qpr, dh), dtype=torch.float32, device=dev)
    for start in range(0, S, chunk):
        kb = k[:, start:start + chunk]
        vb = v[:, start:start + chunk]
        s_all = torch.einsum("bqd,bkgd->bqgk", qs, kb).float()
        s = s_all[:, heads, kmap]                          # (B,qpr,chunk)
        pos = start + torch.arange(kb.shape[1], device=dev)
        ok = pos[None, :] < kv_valid_len[:, None]
        s = torch.where(ok[:, None, :], s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv_all = torch.einsum("bqk,bkgd->bqgd", p.to(k.dtype), vb).float()
        acc = acc * corr[..., None] + pv_all[:, heads, kmap]
        m = m_new
    if k_new is not None:
        s_self = torch.einsum("bqd,bgd->bqg", qs, k_new[:, 0].to(qs.dtype)
                              ).float()[:, heads, kmap]    # (B,qpr)
        m_new = torch.maximum(m, s_self)
        p_self = torch.exp(s_self - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p_self
        vn = v_new[:, 0].float().index_select(1, kmap)     # (B,qpr,dh)
        acc = acc * corr[..., None] + p_self[..., None] * vn
    out = acc / l[..., None].clamp_min(1e-30)
    return out[:, None].to(q.dtype)


# ---------------------------------------------------------------------------
# layers: prefill and decode
# ---------------------------------------------------------------------------

def _qkv_rope(p: Params, x: torch.Tensor, cfg, plan,
              positions: torch.Tensor, env: Optional[AxisEnv] = None):
    q, k, v = qkv_proj(p, x, plan, env)
    if cfg.positional == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(p: Params, x: torch.Tensor, *, cfg, plan,
                   positions: torch.Tensor, causal: bool = True,
                   env: Optional[AxisEnv] = None) -> torch.Tensor:
    """Self-attention of a whole sequence (no cache): causal for a
    decoder, ``causal=False`` for whisper's encoder."""
    q, k, v = _qkv_rope(p, x, cfg, plan, positions, env)
    kmap = local_kmap(plan, x.device, model_rank(env))
    out = flash_attention(q, _expand_kv(k, kmap), _expand_kv(v, kmap),
                          causal=causal)
    return out_proj(p, out, plan, env)


def cross_attention(p: Params, x: torch.Tensor, *, cfg, plan,
                    enc_k: torch.Tensor, enc_v: torch.Tensor,
                    env: Optional[AxisEnv] = None) -> torch.Tensor:
    """Decoder cross-attention (whisper) to precomputed encoder K/V
    (B, S_enc, kpr, dh), already the rank's heads on the ring: only the
    query projection of x (with ``bq``; one ESL ``ag_matmul`` on the
    ring), no positions, no mask."""
    a = plan.attn
    D = p["wq"].shape[0]
    B, S = x.shape[0], x.shape[1]
    axis, tp = ring_axis(env)
    q = esl.ag_matmul(x, p["wq"].reshape(D, a.q_per_rank * a.d_head),
                      axis=axis, tp=tp, overlap=plan.esl_overlap,
                      b=p["bq"].reshape(-1) if "bq" in p else None)
    q = q.reshape(B, S, a.q_per_rank, a.d_head)
    kmap = local_kmap(plan, x.device, model_rank(env))
    out = flash_attention(q, _expand_kv(enc_k, kmap),
                          _expand_kv(enc_v, kmap), causal=False)
    return out_proj(p, out, plan, env)


def encode_cross_kv(p: Params, enc_x: torch.Tensor, *, cfg, plan,
                    env: Optional[AxisEnv] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V (B, S_enc, kpr, dh) of the encoder states for cross-attention
    (with ``bk``/``bv``), computed once per request; on the ring the
    rank's kv heads, from one ESL pass that feeds its k and v tiles
    (``esl.ag_matmuls``; the encoder states arrive scattered under ESL
    overlap)."""
    a = plan.attn
    D = p["wk"].shape[0]
    B, S = enc_x.shape[0], enc_x.shape[1]
    kpr, dh = a.kv_per_rank, a.d_head
    axis, tp = ring_axis(env)
    k, v = esl.ag_matmuls(enc_x, (p["wk"].reshape(D, kpr * dh),
                                  p["wv"].reshape(D, kpr * dh)),
                          axis=axis, tp=tp, overlap=plan.esl_overlap)
    if "bk" in p:
        k = k + p["bk"].reshape(-1)
        v = v + p["bv"].reshape(-1)
    return k.reshape(B, S, kpr, dh), v.reshape(B, S, kpr, dh)


def prefill_attention(p: Params, x: torch.Tensor, *, cfg, plan,
                      positions: torch.Tensor, cache: Dict[str, torch.Tensor],
                      env: Optional[AxisEnv] = None) -> torch.Tensor:
    """Prefill of a batch whose cache covers exactly the S positions:
    the cache (B,S,kpr,dh) is filled in place; a cache whose sequence is
    sharded over ``env.kv_seq_axis`` (B,1,S/width,kpr,dh) takes the
    rank's slice of the prompt (:func:`_cache_insert_prefix`)."""
    q, k, v = _qkv_rope(p, x, cfg, plan, positions, env)
    _cache_insert_prefix(cache["k"], k, env)
    _cache_insert_prefix(cache["v"], v, env)
    kmap = local_kmap(plan, x.device, model_rank(env))
    out = flash_attention(q, _expand_kv(k, kmap), _expand_kv(v, kmap),
                          causal=True)
    return out_proj(p, out, plan, env)


def decode_attention(p: Params, x: torch.Tensor, *, cfg, plan,
                     cache: Dict[str, torch.Tensor], positions: torch.Tensor,
                     block_table: Optional[torch.Tensor] = None,
                     paged_kernel: str = "stream",
                     block_s: int = 0,
                     env: Optional[AxisEnv] = None) -> torch.Tensor:
    """One-token generation step; updates ``cache`` in place.

    x: (B,1,D); positions: (B,) int32 position of each row's new token
    (= its resident length).  Dense cache: (B, Smax, Gp, dh).  Paged
    (``block_table`` (B,T) int32): the shared pool (N, bs, Gp, dh), where
    ``paged_kernel``, already resolved by the caller (see
    ``kernels.decode_attention.resolve_paged_kernel``), selects the
    dataflow:

    * ``"stream"`` — the paged kernel reads KV tiles straight from the
      pool through the block table and folds the new token in; no
      contiguous per-request view is materialized;
    * ``"gather"`` — the oracle: materialize the (B, T*bs) view through
      the table and run the chunked flash decode of the dense cache.

    Both read the pool before the update; the new row is scattered
    afterwards (rows of idle slots land in the null block 0).  On an
    int8/fp8 pool the new row is quantized FIRST and both dataflows fold
    its dequantized round-trip, the value every later read of the row
    sees; the stored row and its scale are then scattered.

    With ``env.kv_seq_axis`` (a dense cache whose sequence is sharded
    over the data axis, (B, 1, S/width, kpr, dh) on each rank) the
    step runs :func:`_seq_sharded_decode` and the rank that owns the new
    token's slot stores it (:func:`_seq_sharded_update`)."""
    q, k_new, v_new = _qkv_rope(p, x, cfg, plan, positions[:, None], env)
    kc, vc = cache["k"], cache["v"]
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    pos = positions.long()
    if block_table is not None:
        ks, vs = _pool_scales(cache)
        k_st, v_st, ksc, vsc = _quantized_rows(cache, k_new, v_new)
        if ks is not None:
            k_new = dequantize_kv(k_st, ksc).to(q.dtype)
            v_new = dequantize_kv(v_st, vsc).to(q.dtype)
        if paged_kernel == "stream":
            out = paged_decode_attention(
                q[:, 0], kc, vc, block_table, positions,
                k_new=k_new[:, 0], v_new=v_new[:, 0], k_scale=ks,
                v_scale=vs)[:, None]
        else:
            out = _flash_decode_chunked(
                q, _gather_view(kc, ks, block_table),
                _gather_view(vc, vs, block_table),
                local_kmap(plan, x.device, model_rank(env)),
                kv_valid_len=positions, chunk=block_s or 2048,
                k_new=k_new, v_new=v_new)
        bs = kc.shape[1]
        blk = block_table.long()[rows, pos // bs]
        kc[blk, pos % bs] = k_st[:, 0].to(kc.dtype)
        vc[blk, pos % bs] = v_st[:, 0].to(vc.dtype)
        if ks is not None:
            ks[blk, pos % bs] = ksc[:, 0]
            vs[blk, pos % bs] = vsc[:, 0]
    elif env is not None and env.kv_seq_axis is not None:
        # long context: the KV sequence sharded over kv_seq_axis; the
        # rank's shard (B, 1, S/width, kpr, dh) carries a singleton
        # width dim
        out = _seq_sharded_decode(q, kc[:, 0], vc[:, 0], k_new, v_new,
                                  positions, plan, env)
        _seq_sharded_update(kc, vc, k_new, v_new, positions, env)
    else:
        out = _flash_decode_chunked(
            q, kc, vc, local_kmap(plan, x.device, model_rank(env)),
            kv_valid_len=positions,
            chunk=block_s or 2048, k_new=k_new, v_new=v_new)
        kc[rows, pos] = k_new[:, 0].to(kc.dtype)
        vc[rows, pos] = v_new[:, 0].to(vc.dtype)
    return out_proj(p, out, plan, env)


def chunk_prefill_attention(p: Params, x: torch.Tensor, *, cfg, plan,
                            positions: torch.Tensor,
                            cache: Dict[str, torch.Tensor],
                            block_table: torch.Tensor,
                            kv_valid_len: torch.Tensor,
                            paged_kernel: str = "stream",
                            env: Optional[AxisEnv] = None) -> torch.Tensor:
    """Prefill ONE chunk of a partly resident prompt against the pool.

    x: (1,C,D) the chunk's activations; positions: (1,C) int32 absolute
    positions ``start + [0..C)``; cache: {"k","v": (N,bs,Gp,dh)} the
    shared pool (plus ``k_scale``/``v_scale`` for an int8/fp8 pool),
    updated in place; block_table: (1,T) int32 the request's physical
    blocks; kv_valid_len: int32 scalar, the resident tokens after this
    chunk (rows at or past it are padding: they go to the null block 0
    and are masked on read).

    The chunk's K and V are scattered through the table first (quantized
    on an int8/fp8 pool, so the chunk attends its own rows as stored),
    and one length mask covers history and self.  Then, with
    ``paged_kernel`` resolved by the caller:

    * ``"stream"`` — the C queries are the paged kernel's batch: one
      table broadcast over them, per-query lengths ``pos + 1`` (clamped
      to ``kv_valid_len`` for pad rows), no fold;
    * ``"gather"`` — the oracle: flash attention over the gathered view
      with the chunk's offset.
    """
    ks, vs = _pool_scales(cache)
    q, k, v = _qkv_rope(p, x, cfg, plan, positions, env)
    kc, vc = cache["k"], cache["v"]
    table = block_table[0]
    pos = positions[0]
    valid = pos < kv_valid_len
    k_st, v_st, ksc, vsc = _quantized_rows(cache, k[0], v[0])
    scatter_chunk_rows(kc, k_st, table, pos, valid)
    scatter_chunk_rows(vc, v_st, table, pos, valid)
    if ks is not None:
        scatter_chunk_rows(ks, ksc, table, pos, valid)
        scatter_chunk_rows(vs, vsc, table, pos, valid)
    C, T = q.shape[1], table.shape[0]
    if paged_kernel == "stream":
        lens = torch.minimum(pos + 1, kv_valid_len).to(torch.int32)
        tabs = table[None].expand(C, T).contiguous()
        out = paged_decode_attention(q[0], kc, vc, tabs, lens, k_scale=ks,
                                     v_scale=vs)[None]
    else:
        kmap = local_kmap(plan, x.device, model_rank(env))
        out = flash_attention(
            q, _expand_kv(_gather_view(kc, ks, block_table), kmap),
            _expand_kv(_gather_view(vc, vs, block_table), kmap),
            causal=True, q_offset=pos[:1],
            kv_valid_len=kv_valid_len.reshape(1))
    return out_proj(p, out, plan, env)


def verify_attention(p: Params, x: torch.Tensor, *, cfg, plan,
                     positions: torch.Tensor, cache: Dict[str, torch.Tensor],
                     block_tables: torch.Tensor, kv_valid_len: torch.Tensor,
                     paged_kernel: str = "stream",
                     env: Optional[AxisEnv] = None) -> torch.Tensor:
    """Score a speculative verify window against the pool, in place.

    Every decode slot's (last committed token + K drafts) are flattened
    into ONE batch of Q = slots*(K+1) single-token queries, each with its
    own block table.

    x: (1,Q,D); positions: (1,Q) each query's absolute position;
    cache: the shared pool (with scale leaves on an int8/fp8 pool);
    block_tables: (Q,T) int32, a slot's K+1 rows repeat its table (idle
    slots ride the null block); kv_valid_len: (Q,) int32 each query's
    span INCLUDING itself (``pos + 1``; 1 for idle rows).

    The window's K/V rows are scattered FIRST (quantized on an int8/fp8
    pool), each through its own table, so query i attends its resident
    history plus drafts < i of its window: decode's dataflow, with no
    fold.  Rejected drafts need no undo: their rows lie past the
    accepted length, stay masked, and later windows overwrite them.
    With ``paged_kernel`` resolved by the caller:

    * ``"stream"`` — the Q queries are the paged kernel's batch with
      their own tables and lengths;
    * ``"gather"`` — the oracle: flash attention of each query over its
      gathered view with ``q_offset = pos``.

    On the ring (``env``) x is the rank's (1, Q, D/tp) under ESL overlap,
    the window's rows go into the rank's head-sharded pool (the same
    block ids on every rank), the kernel reads the rank's kv heads, and
    ``out_proj`` reduces over the ranks.
    """
    ks, vs = _pool_scales(cache)
    q, k, v = _qkv_rope(p, x, cfg, plan, positions, env)
    kc, vc = cache["k"], cache["v"]
    pos = positions[0]
    lens = kv_valid_len
    valid = lens > pos
    k_st, v_st, ksc, vsc = _quantized_rows(cache, k[0], v[0])
    scatter_spec_rows(kc, k_st, block_tables, pos, valid)
    scatter_spec_rows(vc, v_st, block_tables, pos, valid)
    if ks is not None:
        scatter_spec_rows(ks, ksc, block_tables, pos, valid)
        scatter_spec_rows(vs, vsc, block_tables, pos, valid)
    if paged_kernel == "stream":
        out = paged_decode_attention(q[0], kc, vc, block_tables,
                                     lens.to(torch.int32), k_scale=ks,
                                     v_scale=vs)[None]
    else:
        kmap = local_kmap(plan, x.device, model_rank(env))
        out = flash_attention(
            q[0][:, None], _expand_kv(_gather_view(kc, ks, block_tables),
                                      kmap),
            _expand_kv(_gather_view(vc, vs, block_tables), kmap),
            causal=True, q_offset=pos, kv_valid_len=lens)
        out = out.transpose(0, 1)
    return out_proj(p, out, plan, env)


# ---------------------------------------------------------------------------
# KV sequence sharding (long context over the data axis)
# ---------------------------------------------------------------------------

SEQ_CHUNK = 65536      # cache rows per product of the sharded decode


def _kv_seq_ring(env: AxisEnv):
    """(the ring the KV sequence is sharded over, this rank's index)."""
    ring = env.axis(env.kv_seq_axis)
    return ring, dist.axis_index(ring)


def _cache_insert_prefix(cache: torch.Tensor, kv: torch.Tensor,
                         env: Optional[AxisEnv]) -> None:
    """Write the prefill K/V (B,S,kpr,dh) into ``cache`` in place: rows
    ``:S`` of a whole cache; on a cache sharded over ``kv_seq_axis``
    (B,1,S_loc,kpr,dh) the rank's slice ``[r*S_loc, (r+1)*S_loc)`` of the
    prompt zero-padded to ``S_loc * width`` (the reference's slice of
    the padded prompt, rows past it zero)."""
    S = kv.shape[1]
    if env is None or env.kv_seq_axis is None:
        cache[:, :S] = kv.to(cache.dtype)
        return
    _, r = _kv_seq_ring(env)
    s_loc = cache.shape[2]
    lo = r * s_loc
    n = max(0, min(S - lo, s_loc))
    if n:
        cache[:, 0, :n] = kv[:, lo:lo + n].to(cache.dtype)
    cache[:, 0, n:] = 0


def _seq_sharded_update(kc: torch.Tensor, vc: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        positions: torch.Tensor, env: AxisEnv) -> None:
    """Store the new token (B,1,kpr,dh) in place on the rank that owns
    its slot of the sharded cache (B,1,S_loc,kpr,dh); every other rank
    rewrites the row it already holds (the reference's masked update)."""
    _, r = _kv_seq_ring(env)
    s_loc = kc.shape[2]
    local = positions.long() - r * s_loc
    mine = ((local >= 0) & (local < s_loc))[:, None, None]
    safe = local.clamp(0, s_loc - 1)
    rows = torch.arange(kc.shape[0], device=kc.device)
    for c, new in ((kc, k_new), (vc, v_new)):
        c[rows, 0, safe] = torch.where(mine, new[:, 0].to(c.dtype),
                                       c[rows, 0, safe])


def _seq_sharded_decode(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        positions: torch.Tensor, plan, env: AxisEnv,
                        chunk: int = SEQ_CHUNK) -> torch.Tensor:
    """Decode attention with the KV sequence sharded over
    ``env.kv_seq_axis`` (the reference's ``_seq_sharded_decode``): each
    rank scores its slice (B,S_loc,kpr,dh) of the cache, read before
    this step's update; the scores' max is taken over the ranks with the
    new token's score (``pmax``), each rank sums its exponentials and
    their values, the sums are added over the ranks (``psum`` of ``l``
    and of ``acc``), and the new token, which may belong to another
    rank's slice, is folded in once after the merge.  A cache row counts
    when its position is strictly before the row's ``positions``.

    The reference expands K and V to the query heads over the whole
    slice; here the slice is read ``chunk`` rows at a time, each query
    head's scores and values taken from its kv head (``local_kmap``), so
    nothing of the slice's size is materialised but the scores (B, qpr,
    S_loc) in f32.  q: (B,1,qpr,dh) -> (B,1,qpr,dh)."""
    ring, r = _kv_seq_ring(env)
    B, _, qpr, dh = q.shape
    s_loc, kpr = kc.shape[1], kc.shape[2]
    dev = q.device
    kmap = local_kmap(plan, dev, model_rank(env))
    pick_s = kmap.view(1, qpr, 1, 1)                       # per-head kv head
    qs = (q[:, 0].float() * (1.0 / math.sqrt(dh))).to(kc.dtype)
    s = torch.empty((B, qpr, s_loc), dtype=torch.float32, device=dev)
    for start in range(0, s_loc, chunk):
        kb = kc[:, start:start + chunk]
        n = kb.shape[1]
        s_all = (qs @ kb.reshape(B, n * kpr, dh).transpose(1, 2)).float()
        s[:, :, start:start + n] = s_all.view(B, qpr, n, kpr).gather(
            -1, pick_s.expand(B, qpr, n, 1))[..., 0]
    kv_pos = r * s_loc + torch.arange(s_loc, device=dev)
    ok = kv_pos[None, :] < positions.long()[:, None]        # strictly past
    s = torch.where(ok[:, None, :], s, big_neg())
    s_self = torch.einsum("bqd,bgd->bqg", qs, k_new[:, 0].to(qs.dtype)
                          ).float().gather(-1, kmap.view(1, qpr, 1)
                                           .expand(B, qpr, 1))[..., 0]
    m_glob = dist.pmax(torch.maximum(s.amax(-1), s_self), ring)
    p = torch.exp(s - m_glob[..., None])
    l_loc = p.sum(-1)
    acc = torch.zeros((B, qpr, dh), dtype=torch.float32, device=dev)
    pick_v = kmap.view(1, qpr, 1, 1).expand(B, qpr, 1, dh)
    for start in range(0, s_loc, chunk):
        vb = vc[:, start:start + chunk]
        n = vb.shape[1]
        pv = (p[:, :, start:start + n].to(vc.dtype)
              @ vb.reshape(B, n, kpr * dh)).float()
        acc += pv.view(B, qpr, kpr, dh).gather(2, pick_v)[:, :, 0]
    l = dist.psum(l_loc, ring)
    acc = dist.psum(acc, ring)
    p_self = torch.exp(s_self - m_glob)
    l = l + p_self
    vn = v_new[:, 0].float().index_select(1, kmap)         # (B,qpr,dh)
    acc = acc + p_self[..., None] * vn
    out = acc / l[..., None].clamp_min(1e-30)
    return out[:, None].to(q.dtype)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(plan, batch: int, max_seq: int, dtype: torch.dtype,
               device: torch.device, paged: bool = False,
               num_blocks: int = 0, block_size: int = 0,
               scale_dtype: Optional[torch.dtype] = None,
               kv_seq_width: int = 1) -> Dict[str, torch.Tensor]:
    """One layer's KV cache of one rank in the stored (local-head)
    layout: dense (batch, max_seq, kpr, dh), or — paged — a shared pool
    (num_blocks, block_size, kpr, dh) with block 0 reserved as the null
    block; kpr = kv_per_rank, which is Gp at tp=1.

    ``scale_dtype`` (paged only) marks the pool as quantized: ``dtype``
    is the int8/fp8 storage type, and ``k_scale``/``v_scale`` leaves of
    shape (num_blocks, block_size, kpr) ride beside the values, zeroed so
    the null block dequantizes to exact zeros.

    ``kv_seq_width > 1`` (dense only) shards the sequence over that many
    ranks: a rank holds (batch, 1, max_seq / width, kpr, dh), its slice
    of the reference's rank-major (batch, width, max_seq / width, Gp,
    dh)."""
    a = plan.attn
    if kv_seq_width > 1:
        if paged:
            raise ValueError("a paged pool is not sequence-sharded (its "
                             "block dim replaces the sequence dim)")
        if max_seq % kv_seq_width:
            raise ValueError(f"max_seq={max_seq} does not split over "
                             f"{kv_seq_width} ranks")
    if paged:
        if num_blocks < 2 or block_size <= 0:
            raise ValueError(f"paged cache needs >= 2 blocks and a block "
                             f"size > 0, got {num_blocks}, {block_size}")
        shape = (num_blocks, block_size, a.kv_per_rank, a.d_head)
    else:
        if scale_dtype is not None:
            raise ValueError("quantized KV storage needs the paged pool "
                             "(the row scatters carry the scales)")
        shape = ((batch, max_seq, a.kv_per_rank, a.d_head)
                 if kv_seq_width == 1 else
                 (batch, 1, max_seq // kv_seq_width, a.kv_per_rank,
                  a.d_head))
    out = {"k": torch.zeros(shape, dtype=dtype, device=device),
           "v": torch.zeros(shape, dtype=dtype, device=device)}
    if scale_dtype is not None:
        out["k_scale"] = torch.zeros(shape[:-1], dtype=scale_dtype,
                                     device=device)
        out["v_scale"] = torch.zeros(shape[:-1], dtype=scale_dtype,
                                     device=device)
    return out
