"""Plain PyTorch versions of the selective-scan kernel's two entries.

The oracles the CUDA kernel (``csrc/mamba_scan.cu``) is held against on
the card, and the paths :func:`ops.mamba_scan` and
:func:`ops.mamba_scan_fused` take for tensors on the CPU.
:func:`mamba_scan_ref` ports the reference's ``mamba_scan_ref``: a loop
over the sequence carrying the (C, N) state of every batch row.
:func:`mamba_scan_fused_ref` first forms da and bx as the jamba model
did before the fused entry (``models/mamba.py``), then runs it.

It repeats the kernel's arithmetic in the kernel's order: every product
and sum rounded on its own (no fused multiply-add), and the output's sum
over n taken left to right.  The two then agree bit for bit, which an
f32 model at full depth needs from its oracle (PERF.md: the model
amplifies any rounding difference in a recurrent state over a few decode
steps), so an einsum, whose order the library picks, is no oracle for
the kernel on the main path.
"""
from __future__ import annotations

from typing import Tuple

import torch


def mamba_scan_ref(da: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = da_t * h_{t-1} + bx_t ;  y_t[c] = sum_n h_t[c, n] * c_t[n].

    da, bx: (B,S,C,N) f32; c: (B,S,N) f32; h0: (B,C,N) f32.
    Returns (y (B,S,C), h_final (B,C,N))."""
    h = h0
    ys = []
    for t in range(da.shape[1]):
        h = da[:, t] * h + bx[:, t]                           # (B,C,N)
        terms = h * c[:, t, None, :]
        y = terms[..., 0]
        for n in range(1, terms.shape[-1]):
            y = y + terms[..., n]
        ys.append(y)
    return torch.stack(ys, 1), h


def mamba_scan_fused_ref(dt: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, h0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """da = exp(dt * a), bx = (dt * x) * b, each product rounded on its
    own as the fused kernel rounds it, then :func:`mamba_scan_ref`.

    dt, x: (B,S,C) f32; a: (C,N) f32; b, c: (B,S,N) f32; h0: (B,C,N) f32.
    Returns (y (B,S,C), h_final (B,C,N))."""
    da = torch.exp(dt[..., None] * a)                     # (B,S,C,N)
    bx = (dt * x)[..., None] * b[:, :, None, :]
    return mamba_scan_ref(da, bx, c, h0)
