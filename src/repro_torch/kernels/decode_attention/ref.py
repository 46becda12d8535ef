"""Plain PyTorch versions of the decode-attention kernels.

The oracles the CUDA kernels (``csrc/paged_decode_attention.cu``,
``csrc/decode_attention.cu``) are held against on the card, and the
paths :func:`ops.paged_decode_attention` / :func:`ops.decode_attention`
take for tensors that lie on the CPU.  They port the reference's
``gather_kv_pages`` / ``paged_decode_attention_ref`` /
``decode_attention_ref`` and compute the kernels' exact function:

* q scaled by 1/sqrt(dh) in f32, scores over positions < ``lengths[b]``
  (masked scores take the reference's fill, half the most negative f32);
* the optional new token (``k_new``/``v_new``) attended in addition;
* a row with nothing to attend (length 0, no new token) returns the mean
  of every V row it could see, as the reference does: every score is
  masked to the same fill, so the softmax is uniform;
* otherwise positions past the length never contribute, whatever the
  cache holds there (the null block 0 is inert for any finite fill).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_FILL = torch.finfo(torch.float32).min / 2


def gather_kv_pages(pages: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Materialize the contiguous per-request view of a paged pool.

    pages: (N, bs, ...) shared block pool; block_tables: (B, T) physical
    block id per logical block.  Returns (B, T*bs, ...)."""
    B, T = block_tables.shape
    g = pages[block_tables.long()]                   # (B, T, bs, ...)
    return g.reshape(B, T * pages.shape[1], *pages.shape[2:])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lengths: torch.Tensor, k_new: Optional[torch.Tensor],
            v_new: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,H,dh); k, v: (B,S,G,dh) f32 with H = G*gs (q head ``h``
    reads kv head ``h // gs``); k_new/v_new: (B,G,dh).  -> (B,H,dh)."""
    B, H, dh = q.shape
    S, G = k.shape[1], k.shape[2]
    gs = H // G
    qs = q.float().reshape(B, G, gs, dh) * (1.0 / math.sqrt(dh))
    s = torch.einsum("bgqd,bsgd->bgqs", qs, k)             # (B,G,gs,S)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), _FILL, device=q.device))
    if k_new is not None:
        s_self = torch.einsum("bgqd,bgd->bgq", qs, k_new.float())
        s = torch.cat([s, s_self[..., None]], -1)
        v = torch.cat([v, v_new.float()[:, None]], 1)      # (B,S+1,G,dh)
    p = torch.softmax(s, -1)
    out = torch.einsum("bgqs,bsgd->bgqd", p, v)
    return out.reshape(B, H, dh).to(q.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor, *,
                               k_new: Optional[torch.Tensor] = None,
                               v_new: Optional[torch.Tensor] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """q: (B,H,dh); k_pages,v_pages: (N,bs,G,dh) with H = G*gs;
    block_tables: (B,T); lengths: (B,); k_new/v_new: (B,G,dh);
    k_scale/v_scale: (N,bs,G) per-(row, kv head) scales of an int8/fp8
    pool.  -> (B,H,dh)."""
    k = gather_kv_pages(k_pages, block_tables).float()     # (B,S,G,dh)
    v = gather_kv_pages(v_pages, block_tables).float()
    if k_scale is not None:
        k = k * gather_kv_pages(k_scale, block_tables).float()[..., None]
        v = v * gather_kv_pages(v_scale, block_tables).float()[..., None]
    return _attend(q, k, v, lengths, k_new, v_new)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Dense decode attention: q (B,H,dh); k, v (B,S,G,dh) with
    H = G*gs; lengths (B,) valid cache length.  -> (B,H,dh)."""
    return _attend(q, k.float(), v.float(), lengths, None, None)
