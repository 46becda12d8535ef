"""GQA attention under the mapper's stored head layout, tp=1.

Weights live in the stored layout of ``plan.attn``: wq (D, Hp, dh),
wk/wv (D, Gp, dh), wo (Hp, dh, D).  At tp=1 the reference's ESL
``ag_matmul``/``rs_matmul`` are plain matmuls.

Decode reads the cache *before* this step's update and folds the new
token into the online softmax; the caller then scatters (k_new, v_new)
into the cache.  In the port the scatter happens in place, right after
the layer's attention, so the per-layer pool is never copied.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.models.common import apply_rope, big_neg

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def qkv_proj(p: Params, x: torch.Tensor, plan
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> q (B,S,qpr,dh), k, v (B,S,kpr,dh)."""
    a = plan.attn
    D = p["wq"].shape[0]
    B, S = x.shape[0], x.shape[1]
    qpr, kpr, dh = a.q_per_rank, a.kv_per_rank, a.d_head
    q = x @ p["wq"].reshape(D, qpr * dh)
    k = x @ p["wk"].reshape(D, kpr * dh)
    v = x @ p["wv"].reshape(D, kpr * dh)
    if "bq" in p:
        q = q + p["bq"].reshape(-1)
        k = k + p["bk"].reshape(-1)
        v = v + p["bv"].reshape(-1)
    return (q.reshape(B, S, qpr, dh), k.reshape(B, S, kpr, dh),
            v.reshape(B, S, kpr, dh))


def out_proj(p: Params, attn_out: torch.Tensor, plan) -> torch.Tensor:
    """attn_out: (B,S,qpr,dh) -> (B,S,D)."""
    a = plan.attn
    B, S = attn_out.shape[0], attn_out.shape[1]
    w = p["wo"].reshape(a.q_per_rank * a.d_head, -1)
    return attn_out.reshape(B, S, -1) @ w


def local_kmap(plan, device) -> torch.Tensor:
    """(qpr,) local kv index per local q head (rank 0 at tp=1)."""
    return torch.as_tensor(plan.attn.q_to_kv_local[0], dtype=torch.long,
                           device=device)


def _expand_kv(k: torch.Tensor, kmap: torch.Tensor) -> torch.Tensor:
    """(B,S,kpr,dh) -> (B,S,qpr,dh) per the local q->kv map."""
    return k.index_select(2, kmap)


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
              positions: torch.Tensor):
    q, k, v = qkv_proj(p, x, plan)
    if cfg.positional == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(p: Params, x: torch.Tensor, *, cfg, plan,
                   positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention of a whole sequence (no cache)."""
    q, k, v = _qkv_rope(p, x, cfg, plan, positions)
    kmap = local_kmap(plan, x.device)
    out = flash_attention(q, _expand_kv(k, kmap), _expand_kv(v, kmap),
                          causal=True)
    return out_proj(p, out, plan)


def prefill_attention(p: Params, x: torch.Tensor, *, cfg, plan,
                      positions: torch.Tensor, cache: Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
    """Prefill of a batch whose cache covers exactly the S positions:
    the cache (B,S,Gp,dh) is filled in place."""
    q, k, v = _qkv_rope(p, x, cfg, plan, positions)
    S = k.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    kmap = local_kmap(plan, x.device)
    out = flash_attention(q, _expand_kv(k, kmap), _expand_kv(v, kmap),
                          causal=True)
    return out_proj(p, out, plan)


def decode_attention(p: Params, x: torch.Tensor, *, cfg, plan,
                     cache: Dict[str, torch.Tensor], positions: torch.Tensor,
                     block_table: Optional[torch.Tensor] = None,
                     paged_kernel: str = "stream",
                     block_s: int = 0) -> torch.Tensor:
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
    afterwards (rows of idle slots land in the null block 0)."""
    q, k_new, v_new = _qkv_rope(p, x, cfg, plan, positions[:, None])
    kc, vc = cache["k"], cache["v"]
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    pos = positions.long()
    if block_table is not None:
        bs = kc.shape[1]
        if paged_kernel == "stream":
            out = paged_decode_attention(
                q[:, 0], kc, vc, block_table, positions,
                k_new=k_new[:, 0], v_new=v_new[:, 0])[:, None]
        else:
            T = block_table.shape[1]
            tbl = block_table.long()
            kview = kc[tbl].reshape(B, T * bs, kc.shape[2], kc.shape[3])
            vview = vc[tbl].reshape(B, T * bs, vc.shape[2], vc.shape[3])
            out = _flash_decode_chunked(
                q, kview, vview, local_kmap(plan, x.device),
                kv_valid_len=positions, chunk=block_s or 2048,
                k_new=k_new, v_new=v_new)
        blk = block_table.long()[rows, pos // bs]
        kc[blk, pos % bs] = k_new[:, 0].to(kc.dtype)
        vc[blk, pos % bs] = v_new[:, 0].to(vc.dtype)
    else:
        out = _flash_decode_chunked(
            q, kc, vc, local_kmap(plan, x.device), kv_valid_len=positions,
            chunk=block_s or 2048, k_new=k_new, v_new=v_new)
        kc[rows, pos] = k_new[:, 0].to(kc.dtype)
        vc[rows, pos] = v_new[:, 0].to(vc.dtype)
    return out_proj(p, out, plan)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(plan, batch: int, max_seq: int, dtype: torch.dtype,
               device: torch.device, paged: bool = False,
               num_blocks: int = 0, block_size: int = 0
               ) -> Dict[str, torch.Tensor]:
    """One layer's KV cache in the stored (local-head) layout: dense
    (batch, max_seq, Gp, dh), or — paged — a shared pool (num_blocks,
    block_size, Gp, dh) with block 0 reserved as the null block."""
    a = plan.attn
    if paged:
        if num_blocks < 2 or block_size <= 0:
            raise ValueError(f"paged cache needs >= 2 blocks and a block "
                             f"size > 0, got {num_blocks}, {block_size}")
        shape = (num_blocks, block_size, a.gp, a.d_head)
    else:
        shape = (batch, max_seq, a.gp, a.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
