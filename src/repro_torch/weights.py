"""Carry the reference's parameters across to the port.

``params_from_jax(tree, cfg, plan, device)`` turns the JAX package's
stored-layout parameter tree — converted to numpy by the caller, so this
module imports no JAX — into the port's tensors, leaf for leaf.  The
layouts are the same in both packages: decoder layers stacked on a
leading super-block axis under ``blocks``; wq (D, hp, dh), wk/wv
(D, gp, dh), wo (hp, dh, D); the tied ``embed`` (vocab_padded, D); for
rwkv the untied ``embed_in`` (vocab, D) and ``head`` (D, vocab_padded)
and the ``tmix``/``cmix`` leaves of ``models/rwkv.py`` there; for a
hybrid stack the untied embeddings and, per in-block index ``j``,
``blocks/l{j}`` with ``attn`` or ``mamba`` and ``mlp`` or ``moe`` (expert
leaves in the rank-major ``(n_sb, W, Ecell, ...)`` layout).
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
    if cfg.family == "rwkv":
        return _rwkv_shapes(cfg, plan)
    if cfg.family == "hybrid":
        return _hybrid_shapes(cfg, plan)
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


def _rwkv_shapes(cfg, plan) -> Dict[str, tuple]:
    r, D, L = cfg.rwkv, cfg.d_model, n_super_blocks(cfg)
    dproj, ff = plan.attn.hp * r.head_dim, plan.d_ff_padded
    tm, cm = "blocks/l0/tmix/", "blocks/l0/cmix/"
    want = {"embed_in": (cfg.vocab_size, D), "head": (D, plan.vocab_padded),
            "ln_f/scale": (D,), "ln_f/bias": (D,),
            tm + "mix_w1": (L, D, 5 * r.mix_lora),
            tm + "mix_w2": (L, 5, r.mix_lora, D),
            tm + "w_o": (L, dproj, D),
            tm + "decay_w1": (L, D, r.decay_lora),
            tm + "decay_w2": (L, r.decay_lora, dproj),
            cm + "w_k": (L, D, ff), cm + "w_v": (L, ff, D),
            cm + "w_r": (L, D, D)}
    for ln in ("ln1", "ln2"):
        want[f"blocks/l0/{ln}/scale"] = want[f"blocks/l0/{ln}/bias"] = (L, D)
    for nm in ("x", "r", "k", "v", "g", "w"):
        want[tm + f"mu_{nm}"] = (L, D)
    for nm in ("r", "k", "v", "g"):
        want[tm + f"w_{nm}"] = (L, D, dproj)
    for nm in ("decay_w0", "bonus_u", "ln_x"):
        want[tm + nm] = (L, dproj)
    for nm in ("mu_k", "mu_r"):
        want[cm + nm] = (L, D)
    return want


def _hybrid_shapes(cfg, plan) -> Dict[str, tuple]:
    from repro_torch.models.mamba import mamba_dims
    from repro_torch.models.moe import moe_layout
    from repro_torch.models.transformer import super_block_size
    a, D, L = plan.attn, cfg.d_model, n_super_blocks(cfg)
    m, ff = cfg.mamba, plan.d_ff_shard * plan.tp
    d_in, _ = mamba_dims(cfg, plan)
    want = {"embed_in": (cfg.vocab_size, D), "head": (D, plan.vocab_padded),
            "ln_f/scale": (D,)}
    for j in range(super_block_size(cfg)):
        pre = f"blocks/l{j}/"
        want[pre + "ln1/scale"] = want[pre + "ln2/scale"] = (L, D)
        if cfg.is_attention_layer(j):
            want.update({pre + "attn/wq": (L, D, a.hp, a.d_head),
                         pre + "attn/wk": (L, D, a.gp, a.d_head),
                         pre + "attn/wv": (L, D, a.gp, a.d_head),
                         pre + "attn/wo": (L, a.hp, a.d_head, D)})
        else:
            mb = pre + "mamba/"
            want.update({mb + "in_x": (L, D, d_in), mb + "in_z": (L, D, d_in),
                         mb + "conv_w": (L, m.d_conv, d_in),
                         mb + "conv_b": (L, d_in),
                         mb + "x_proj": (L, d_in, m.dt_rank + 2 * m.d_state),
                         mb + "dt_proj": (L, m.dt_rank, d_in),
                         mb + "dt_bias": (L, d_in),
                         mb + "a_log": (L, d_in, m.d_state),
                         mb + "d_skip": (L, d_in),
                         mb + "out_proj": (L, d_in, D)})
        if cfg.is_moe_layer(j):
            w, _, _, ecell, e_pad, ffh = moe_layout(plan)
            want.update({pre + "moe/router": (L, D, e_pad),
                         pre + "moe/wg": (L, w, ecell, D, ffh),
                         pre + "moe/wu": (L, w, ecell, D, ffh),
                         pre + "moe/wd": (L, w, ecell, ffh, D)})
        else:
            want.update({pre + "mlp/wg": (L, D, ff), pre + "mlp/wu": (L, D, ff),
                         pre + "mlp/wd": (L, ff, D)})
    return want


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
