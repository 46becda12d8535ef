"""Plain PyTorch version of the WKV recurrence kernel.

The oracle the CUDA kernel (``csrc/rwkv_scan.cu``) is held against on
the card, and the path :func:`ops.rwkv_scan` takes for tensors on the
CPU.  It ports the reference's ``rwkv_scan_ref``: a loop over the
sequence carrying the (dh, dh) state of every (batch, head).

It repeats the kernel's arithmetic in the kernel's order: every product
and sum rounded on its own (no fused multiply-add), and the output's sum
over i taken left to right.  The two then agree bit for bit, which an
f32 rwkv stack needs from its oracle: at full depth the model amplifies
any rounding difference in the state by orders of magnitude over a few
decode steps (PERF.md), so an einsum, whose order cuBLAS picks, is no
oracle for the kernel on the main path.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rwkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S + k v^T.

    r,k,v,w: (B,S,H,dh) f32; u: (H,dh); s0: (B,H,dh,dh).
    Returns (y (B,S,H,dh) in r's dtype, s_final (B,H,dh,dh))."""
    s = s0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]    # (B,H,dh)
        kv = kt[..., :, None] * vt[..., None, :]              # (B,H,dh,dh)
        terms = rt[..., :, None] * (u[..., None] * kv + s)    # [.., i, j]
        y = terms[..., 0, :]
        for i in range(1, terms.shape[-2]):
            y = y + terms[..., i, :]
        ys.append(y)
        s = wt[..., None] * s + kv
    return torch.stack(ys, 1).to(r.dtype), s
