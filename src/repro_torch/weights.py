"""Carry the reference's parameters across to the port.

``params_from_jax(tree, cfg, plan, device)`` turns the JAX package's
stored-layout parameter tree — converted to numpy by the caller, so this
module imports no JAX — into the port's tensors, leaf for leaf.  The
layouts are the same in both packages: decoder layers stacked on a
leading super-block axis under ``blocks``; wq (D, hp, dh), wk/wv
(D, gp, dh), wo (hp, dh, D) and, with a qkv bias, bq (hp, dh) and
bk/bv (gp, dh); the tied ``embed`` (vocab_padded, D) or the untied
``embed_in`` and ``head``; learned ``pos_embed`` (max_seq, D); a gated
MLP's wg/wu or an ungated one's wi with, under layernorm, bi/bd; norm
``scale`` and, for layernorm, ``bias``; for rwkv the untied
``embed_in`` (vocab, D) and ``head`` (D, vocab_padded) and the
``tmix``/``cmix`` leaves of ``models/rwkv.py`` there; for a
hybrid or an MoE stack, per in-block index ``j``, ``blocks/l{j}`` with
``attn`` or ``mamba`` and ``mlp`` or ``moe`` (expert leaves in the
rank-major ``(n_sb, W, Ecell, ...)`` layout; a shared expert's
``moe/shared`` wg/wu (D, dsh) and wd (dsh, D)); for a vlm the dense tree
and its ``projector`` (patch_embed_dim, D); for an encoder-decoder
(whisper) ``embed``, ``pos_embed``, ``enc_blocks`` ({ln1, attn, ln2,
mlp}), ``ln_enc``, ``dec_blocks`` ({ln1, attn, lnx, xattn, ln2, mlp})
and ``ln_f``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.common import mlp_has_bias
from repro_torch.models.transformer import n_super_blocks

Params = Dict[str, Any]


def _expected_shapes(cfg, plan) -> Dict[str, tuple]:
    """Every leaf path of the config's tree and its stored shape, drawn
    up from ``cfg`` the way ``init_params`` builds the tree."""
    if cfg.family == "rwkv":
        return _rwkv_shapes(cfg, plan)
    if cfg.family in ("hybrid", "moe"):
        return _hybrid_shapes(cfg, plan)
    if cfg.family == "encdec":
        return _encdec_shapes(cfg, plan)
    D, L = cfg.d_model, n_super_blocks(cfg)
    want = _embed_shapes(cfg, plan)
    if cfg.vlm is not None:
        want["projector"] = (cfg.vlm.patch_embed_dim, D)
    want.update(_layer_shapes(cfg, plan, "blocks/l0/", L))
    return want


def _layer_shapes(cfg, plan, pre: str, L: int,
                  cross: bool = False) -> Dict[str, tuple]:
    """One stacked attention + MLP layer (with whisper's ``lnx`` and
    ``xattn`` when ``cross``)."""
    D = cfg.d_model
    want = _norm_shapes(cfg, pre + "ln1", (L, D))
    want.update(_norm_shapes(cfg, pre + "ln2", (L, D)))
    want.update(_attn_shapes(cfg, plan, pre + "attn/", L))
    want.update(_mlp_shapes(cfg, plan, pre + "mlp/", L))
    if cross:
        want.update(_norm_shapes(cfg, pre + "lnx", (L, D)))
        want.update(_attn_shapes(cfg, plan, pre + "xattn/", L))
    return want


def _encdec_shapes(cfg, plan) -> Dict[str, tuple]:
    want = _embed_shapes(cfg, plan)
    want.update(_norm_shapes(cfg, "ln_enc", (cfg.d_model,)))
    want.update(_layer_shapes(cfg, plan, "enc_blocks/",
                              cfg.encdec.n_enc_layers))
    want.update(_layer_shapes(cfg, plan, "dec_blocks/", cfg.n_layers,
                              cross=True))
    return want


def _embed_shapes(cfg, plan) -> Dict[str, tuple]:
    """The embeddings (tied, or untied input and head), learned
    positions and the final norm."""
    D = cfg.d_model
    want = ({"embed": (plan.vocab_padded, D)} if cfg.tie_embeddings else
            {"embed_in": (cfg.vocab_size, D), "head": (D, plan.vocab_padded)})
    if cfg.positional == "learned":
        want["pos_embed"] = (cfg.max_seq, D)
    want.update(_norm_shapes(cfg, "ln_f", (D,)))
    return want


def _norm_shapes(cfg, path: str, shape: tuple) -> Dict[str, tuple]:
    want = {path + "/scale": shape}
    if cfg.norm == "layernorm":
        want[path + "/bias"] = shape
    return want


def _attn_shapes(cfg, plan, pre: str, L: int) -> Dict[str, tuple]:
    a, D = plan.attn, cfg.d_model
    want = {pre + "wq": (L, D, a.hp, a.d_head),
            pre + "wk": (L, D, a.gp, a.d_head),
            pre + "wv": (L, D, a.gp, a.d_head),
            pre + "wo": (L, a.hp, a.d_head, D)}
    if cfg.qkv_bias:
        want.update({pre + "bq": (L, a.hp, a.d_head),
                     pre + "bk": (L, a.gp, a.d_head),
                     pre + "bv": (L, a.gp, a.d_head)})
    return want


def _mlp_shapes(cfg, plan, pre: str, L: int) -> Dict[str, tuple]:
    D, ff = cfg.d_model, plan.d_ff_shard * plan.tp
    if cfg.mlp_gated:
        want = {pre + "wg": (L, D, ff), pre + "wu": (L, D, ff)}
    else:
        want = {pre + "wi": (L, D, ff)}
    want[pre + "wd"] = (L, ff, D)
    if mlp_has_bias(cfg):
        want.update({pre + "bi": (L, ff), pre + "bd": (L, D)})
    return want


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
    D, L, m = cfg.d_model, n_super_blocks(cfg), cfg.mamba
    want = _embed_shapes(cfg, plan)
    for j in range(super_block_size(cfg)):
        pre = f"blocks/l{j}/"
        want.update(_norm_shapes(cfg, pre + "ln1", (L, D)))
        want.update(_norm_shapes(cfg, pre + "ln2", (L, D)))
        if cfg.is_attention_layer(j):
            want.update(_attn_shapes(cfg, plan, pre + "attn/", L))
        else:
            mb = pre + "mamba/"
            d_in, _ = mamba_dims(cfg, plan)
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
            if cfg.moe.n_shared_experts:
                dsh = cfg.moe.n_shared_experts * plan.d_ff_shard * plan.tp
                want.update({pre + "moe/shared/wg": (L, D, dsh),
                             pre + "moe/shared/wu": (L, D, dsh),
                             pre + "moe/shared/wd": (L, dsh, D)})
        else:
            want.update(_mlp_shapes(cfg, plan, pre + "mlp/", L))
    return want


def params_from_jax(tree: Params, cfg, plan, device) -> Params:
    """numpy tree in the reference's stored layout -> tensors on
    ``device`` (dtype kept).  Raises when a leaf has another shape than
    the plan's layout gives it, when the tree holds a leaf the config
    does not have, and when one of the config's leaves is missing."""
    want = _expected_shapes(cfg, plan)
    seen = set()

    def conv(t, path):
        if isinstance(t, dict):
            return {k: conv(v, f"{path}/{k}" if path else k)
                    for k, v in t.items()}
        if path not in want:
            raise ValueError(f"{path}: not a leaf of {cfg.name}'s tree")
        arr = np.asarray(t)
        if tuple(arr.shape) != want[path]:
            raise ValueError(f"{path}: shape {arr.shape}, the plan's "
                             f"stored layout is {want[path]}")
        seen.add(path)
        if arr.dtype.name == "bfloat16":
            # ml_dtypes' bfloat16, which torch.from_numpy does not take
            return torch.from_numpy(arr.view(np.uint16).copy()).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(np.array(arr, copy=True)).to(device)

    out = conv(tree, "")
    missing = sorted(set(want) - seen)
    if missing:
        raise ValueError(f"{cfg.name}'s tree lacks {missing}")
    return out
