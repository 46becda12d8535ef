"""Plain PyTorch version of the paged decode-attention kernel.

The oracle the CUDA kernel (``csrc/paged_decode_attention.cu``) is held
against on the card, and the path :func:`ops.paged_decode_attention`
takes for tensors that lie on the CPU.  It ports the reference's
``gather_kv_pages`` / ``paged_decode_attention_ref`` and computes the
kernel's exact function:

* q scaled by 1/sqrt(dh) in f32, scores over positions < ``lengths[b]``;
* the optional new token (``k_new``/``v_new``) attended in addition;
* a row with nothing to attend (length 0, no new token) returns zeros;
* positions past the length never contribute, whatever the pool holds
  there (the null block 0 is inert for any finite fill).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def gather_kv_pages(pages: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Materialize the contiguous per-request view of a paged pool.

    pages: (N, bs, ...) shared block pool; block_tables: (B, T) physical
    block id per logical block.  Returns (B, T*bs, ...)."""
    B, T = block_tables.shape
    g = pages[block_tables.long()]                   # (B, T, bs, ...)
    return g.reshape(B, T * pages.shape[1], *pages.shape[2:])


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor, *,
                               k_new: Optional[torch.Tensor] = None,
                               v_new: Optional[torch.Tensor] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """q: (B,H,dh); k_pages,v_pages: (N,bs,G,dh) with H = G*gs (q head
    ``h`` reads kv head ``h // gs``); block_tables: (B,T); lengths: (B,);
    k_new/v_new: (B,G,dh); k_scale/v_scale: (N,bs,G).  -> (B,H,dh)."""
    B, H, dh = q.shape
    G = k_pages.shape[2]
    gs = H // G
    k = gather_kv_pages(k_pages, block_tables).float()     # (B,S,G,dh)
    v = gather_kv_pages(v_pages, block_tables).float()
    if k_scale is not None:
        k = k * gather_kv_pages(k_scale, block_tables).float()[..., None]
        v = v * gather_kv_pages(v_scale, block_tables).float()[..., None]
    S = k.shape[1]
    qs = q.float().reshape(B, G, gs, dh) * (1.0 / math.sqrt(dh))
    s = torch.einsum("bgqd,bsgd->bgqs", qs, k)             # (B,G,gs,S)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), -math.inf, device=q.device))
    if k_new is not None:
        s_self = torch.einsum("bgqd,bgd->bgq", qs, k_new.float())
        s = torch.cat([s, s_self[..., None]], -1)
        v = torch.cat([v, v_new.float()[:, None]], 1)      # (B,S+1,G,dh)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros((), device=q.device))
    p = torch.exp(s - m)                                   # masked -> 0
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bgqs,bsgd->bgqd", p, v)
    out = acc / l.clamp_min(1e-30)
    return out.reshape(B, H, dh).to(q.dtype)
