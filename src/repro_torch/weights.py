"""Carry the reference's parameters across to the port.

``params_from_jax(tree, cfg, plan, device)`` turns the JAX package's
stored-layout parameter tree — converted to numpy by the caller, so this
module imports no JAX — into the port's tensors, leaf for leaf.  The
layouts are the same in both packages: decoder layers stacked on a
leading super-block axis under ``blocks``; wq (D, hp, dh), wk/wv
(D, gp, dh), wo (hp, dh, D); the tied ``embed`` (vocab_padded, D).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.transformer import n_super_blocks

Params = Dict[str, Any]


def _expected_shapes(cfg, plan) -> Dict[str, tuple]:
    a, D, L = plan.attn, cfg.d_model, n_super_blocks(cfg)
    ff = plan.d_ff_shard * plan.tp
    return {
        "embed": (plan.vocab_padded, D),
        "blocks/l0/attn/wq": (L, D, a.hp, a.d_head),
        "blocks/l0/attn/wk": (L, D, a.gp, a.d_head),
        "blocks/l0/attn/wv": (L, D, a.gp, a.d_head),
        "blocks/l0/attn/wo": (L, a.hp, a.d_head, D),
        "blocks/l0/mlp/wg": (L, D, ff),
        "blocks/l0/mlp/wu": (L, D, ff),
        "blocks/l0/mlp/wd": (L, ff, D),
        "blocks/l0/ln1/scale": (L, D),
        "blocks/l0/ln2/scale": (L, D),
        "ln_f/scale": (D,),
    }


def params_from_jax(tree: Params, cfg, plan, device) -> Params:
    """numpy tree in the reference's stored layout -> tensors on
    ``device`` (dtype kept).  Raises when a known leaf has another shape
    than the plan's layout gives it."""
    want = _expected_shapes(cfg, plan)

    def conv(t, path):
        if isinstance(t, dict):
            return {k: conv(v, f"{path}/{k}" if path else k)
                    for k, v in t.items()}
        arr = np.asarray(t)
        if path in want and tuple(arr.shape) != want[path]:
            raise ValueError(f"{path}: shape {arr.shape}, the plan's "
                             f"stored layout is {want[path]}")
        return torch.from_numpy(np.array(arr, copy=True)).to(device)

    return conv(tree, "")
