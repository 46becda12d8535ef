"""Plain PyTorch version of the decode GEMV kernel.

The oracle the CUDA kernel (``csrc/gemv.cu``) is held against on the
card, and the path :func:`ops.gemv` takes for tensors on the CPU.  It
ports the reference's ``gemv_ref``: f32 accumulation, then the per-column
scale of an int8 weight, then the bias, output in x's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch


def gemv_ref(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None, *,
             w_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, K) activation rows; w: (K, N) weights; b: (N,);
    w_scale: (N,) dequantizes an int8 ``w`` at the accumulator.
    -> (B, N) in x's dtype."""
    y = x.float() @ w.float()
    if w_scale is not None:
        y = y * w_scale.float()[None, :]
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)
