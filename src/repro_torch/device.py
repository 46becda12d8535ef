"""Device selection for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda`` and raises when no CUDA device is
present, so a run never drops to the CPU by accident.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def dtype_of(name: str) -> torch.dtype:
    """torch dtype for a plan dtype name (``"float32"``, ``"bfloat16"``)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt
