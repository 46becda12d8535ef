"""Feed-forward layer at tp=1.

The reference streams FC1 through the ESL ``ag_matmul`` and FC2 through
``rs_matmul``; on one device both reduce to plain matmuls
(``core/esl.py`` there), which is what this port computes.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.common import activate

Params = Dict[str, Any]


def mlp_fwd(p: Params, x: torch.Tensor, *, cfg, plan) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D)."""
    if "wg" in p:
        h = activate(x @ p["wg"], cfg.activation) * (x @ p["wu"])
    else:
        h = x @ p["wi"]
        if "bi" in p:
            h = h + p["bi"]
        h = activate(h, cfg.activation)
    y = h @ p["wd"]
    if "bd" in p:
        y = y + p["bd"]
    return y
