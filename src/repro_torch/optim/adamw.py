"""AdamW with global-norm clipping, the port of the reference's
``optim/adamw.py`` at one device.

The update is the reference's own, op for op in float32 (not
``torch.optim.AdamW``, whose rounding order differs): the global norm
of the gradients clips them to ``clip_norm``, the bias corrections
count from ``step + 1``, the step is ``mh / (sqrt(vh) + eps)``, and
weight decay applies to leaves with ``ndim >= 2`` only.  In the stored
layout the norm scales are stacked on the super-block axis as (n_sb,
D), so they are decayed, as in the reference; only the final norm and
whisper's unstacked vectors are not.

Parameters and moments are updated in place under ``torch.no_grad()``
(the reference donates its buffers); the moments are float32 whatever
the parameters' dtype.  ``int8_compress``/``int8_decompress`` are the
reference's per-tensor quantizer; its ``compressed_psum`` needs a pod
axis and arrives with the mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


class OptState(NamedTuple):
    step: torch.Tensor          # () int32, on the parameters' device
    m: Params
    v: Params


@dataclass
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Params) -> OptState:
        def zeros(t):
            return tree_map(lambda p: torch.zeros(p.shape,
                                                  dtype=torch.float32,
                                                  device=p.device), t)
        dev = tree_leaves(params)[0].device
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        m=zeros(params), v=zeros(params))

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: OptState
              ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
        """One update of ``params``, ``state.m`` and ``state.v`` in
        place.  Returns (params, OptState(step + 1, m, v), {"grad_norm",
        "lr"}), the metrics 0-dim float32 tensors."""
        step = state.step + 1
        gs = tree_leaves(grads)
        gsq = sum(torch.sum(torch.square(g.float())) for g in gs)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = self.lr(step)
        stepf = step.float()
        b1c = 1 - torch.pow(self.b1, stepf)
        b2c = 1 - torch.pow(self.b2, stepf)
        for p, g, m, v in zip(tree_leaves(params), gs,
                              tree_leaves(state.m), tree_leaves(state.v)):
            g = g.float() * scale
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * torch.square(g))
            step_p = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if p.dim() >= 2:                     # decay matrices only
                step_p = step_p + self.weight_decay * p.float()
            p.copy_(p.float() - lr * step_p)
        return params, OptState(step, state.m, state.v), {
            "grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# gradient compression (the pod axis's sync; the mesh slice uses them)
# ---------------------------------------------------------------------------

def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization."""
    amax = torch.amax(torch.abs(g)) + 1e-12
    q = torch.clamp(torch.round(g / amax * 127.0), -127, 127).to(torch.int8)
    return q, amax


def int8_decompress(q: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    return q.float() * (amax / 127.0)
