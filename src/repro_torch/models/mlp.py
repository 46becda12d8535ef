"""Feed-forward layer: column-parallel FC1 / row-parallel FC2.

At tp=1 both are plain matmuls.  On the ring (``env`` from
:mod:`repro_torch.core.dist`) the mapper gives the FFN column-wise
tiles: FC1 (gate and up fused into one tile for a gated MLP) streams
through the ESL ``ag_matmul`` and FC2 streams its partial products
around the ring with ``rs_matmul``, as the reference's
``models/mlp.py`` does; the ``bd`` bias is stored model-sharded and
gathered only in the blocking baseline (``esl.full_vec``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core import esl
from repro_torch.core.dist import AxisEnv, on_ring
from repro_torch.models.common import activate

Params = Dict[str, Any]


def mlp_fwd(p: Params, x: torch.Tensor, *, cfg, plan,
            env: Optional[AxisEnv] = None) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D); on the ring (B,S,D/tp) scattered in and
    out under ESL overlap, full in the blocking baseline."""
    if on_ring(env):
        return _ring_mlp(p, x, cfg=cfg, plan=plan, env=env)
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


def _ring_mlp(p: Params, x: torch.Tensor, *, cfg, plan,
              env: AxisEnv) -> torch.Tensor:
    ring, tp, overlap = env.model, env.tp, plan.esl_overlap
    if "wg" in p:
        w1 = torch.cat([p["wg"], p["wu"]], -1)
        g, u = esl.ag_matmul(x, w1, axis=ring, tp=tp,
                             overlap=overlap).chunk(2, -1)
        h = activate(g, cfg.activation) * u
    else:
        h = activate(esl.ag_matmul(x, p["wi"], axis=ring, tp=tp,
                                   overlap=overlap, b=p.get("bi")),
                     cfg.activation)
    y = esl.rs_matmul(h, p["wd"], axis=ring, tp=tp, overlap=overlap,
                      scatter_out=overlap)
    if "bd" in p:
        y = y + esl.full_vec(p["bd"], axis=ring, tp=tp,
                             scattered_activations=overlap)
    return y
