"""Whisper-style encoder-decoder backbone (the port of the reference's
``models/whisper.py``; the audio frontend is a stub there too:
``frames`` are precomputed (B, enc_seq, d_model) embeddings), at tp=1
and on the model ring (``env``): the encoder's and the decoder's
attention on the rank's heads, their MLPs on its FFN columns, the
learned positions D-sharded, the tied embedding and the logits
vocab-sharded, as the decoder-only stacks run there.

The encoder (non-causal self-attention + MLP per layer) runs once per
request, at prefill.  The decoder is a cached LM with one more block
per layer, cross-attention to the encoder states: their K/V are
computed once at prefill, stored in the cache beside the self-attention
K/V, and only read in decode.

Cache per decoder layer, stacked on a leading layer axis: ``{"k","v":
(L, B, max_seq, kpr, dh), "ck","cv": (L, B, enc_seq, kpr, dh)}`` (kpr
the rank's kv heads, Gp at tp=1). Prefill fills ``k``/``v`` at the
prompt's positions and ``ck``/``cv`` in place; decode writes one row of
``k``/``v`` per layer in place (the reference scatters it into its scan
carry).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.core import esl
from repro_torch.core.dist import AxisEnv, on_ring
from repro_torch.device import dtype_of
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (_init_attention, _init_dense_layer,
                                       _init_mlp, _init_norm, _stacked,
                                       map_leaves)
from repro_torch.models.transformer import (_no_gather, _norm,
                                            add_positional, embed_tokens,
                                            lm_logits, unstack_tree)

Params = Dict[str, Any]


def init_encdec(ini, cfg, plan, leaf=None) -> Params:
    """The reference's ``init_encdec`` tree: tied ``embed`` (vocab_padded,
    D), learned ``pos_embed`` (max_seq, D), ``enc_blocks`` (n_enc_layers
    x {ln1, attn, ln2, mlp}), ``ln_enc``, ``dec_blocks`` (n_layers x
    {ln1, attn, lnx, xattn, ln2, mlp}) and ``ln_f``; the MLPs ungated
    with ``bi``/``bd``, attention with the config's qkv bias.  Drawn by
    ``ini`` (:class:`repro_torch.models.common._Init`) in that order.
    ``leaf(t, path)``, where given, maps each leaf as soon as it is
    drawn (a layer's leaf without its layer axis, at
    ``enc_blocks/...`` or ``dec_blocks/...``), as
    :func:`repro_torch.models.common.draw_params` does."""
    D = cfg.d_model

    def put(tree, path):
        return tree if leaf is None else map_leaves(tree, leaf, path)

    def dec_layer():
        return {"ln1": _init_norm(ini, D, cfg.norm),
                "attn": _init_attention(ini, cfg, plan),
                "lnx": _init_norm(ini, D, cfg.norm),
                "xattn": _init_attention(ini, cfg, plan),
                "ln2": _init_norm(ini, D, cfg.norm),
                "mlp": _init_mlp(ini, cfg, plan)}

    return {"embed": put(ini.param((plan.vocab_padded, D)), "embed"),
            "pos_embed": put(ini.param((cfg.max_seq, D)), "pos_embed"),
            "enc_blocks": _stacked(
                cfg.encdec.n_enc_layers,
                lambda: put(_init_dense_layer(ini, cfg, plan),
                            "enc_blocks")),
            "ln_enc": put(_init_norm(ini, D, cfg.norm), "ln_enc"),
            "dec_blocks": _stacked(cfg.n_layers,
                                   lambda: put(dec_layer(), "dec_blocks")),
            "ln_f": put(_init_norm(ini, D, cfg.norm), "ln_f")}


def run_encoder(params: Params, frames: torch.Tensor, *, cfg, plan,
                env: Optional[AxisEnv] = None,
                gather_fn=None) -> torch.Tensor:
    """frames (B, enc_seq, D) stub embeddings -> encoder states; on the
    ring the rank's scattered (B, enc_seq, D/tp) under ESL overlap (the
    frames scattered first), whole in the blocking baseline.
    ``gather_fn`` gathers each layer's FSDP-sharded parameters (group
    ``"enc_block"``)."""
    gather_fn = gather_fn or _no_gather
    x = frames.to(dtype_of(plan.compute_dtype))
    if on_ring(env) and plan.esl_overlap:
        x = esl.scatter_full(x, axis=env.model, tp=env.tp)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for bp in unstack_tree(params["enc_blocks"], cfg.encdec.n_enc_layers):
        bp = gather_fn("enc_block", bp)
        x = x + attn_mod.self_attention(
            bp["attn"], _norm(bp["ln1"], x, cfg, plan, env), cfg=cfg,
            plan=plan, positions=positions, causal=False, env=env)
        x = x + mlp_mod.mlp_fwd(bp["mlp"], _norm(bp["ln2"], x, cfg, plan,
                                                 env),
                                cfg=cfg, plan=plan, env=env)
    return _norm(params["ln_enc"], x, cfg, plan, env)


def forward_encdec(params: Params, tokens: torch.Tensor, *, cfg, plan,
                   mode: str, frames: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   cache: Optional[Params] = None,
                   with_aux: bool = False,
                   env: Optional[AxisEnv] = None,
                   gather_fn=None):
    """Decoder logits (B, S, V_pad) in the train/prefill/decode modes.

    train/prefill: ``frames`` required; the encoder runs, and every
    layer's cross K/V come from its states (prefill stores them in
    ``cache["ck"]``/``["cv"]`` and the prompt's self K/V in
    ``cache["k"]``/``["v"]``, in place).  decode: ``tokens`` (B, 1),
    ``positions`` (B,); cross K/V are read from the cache, the encoder
    does not run.  Returns (logits, cache), and with ``with_aux`` (which
    only the train step passes) (logits, cache, a float32 zero: whisper
    has no auxiliary loss).  With a plan whose ``remat`` is not ``"none"``,
    train mode under autograd recomputes each decoder layer in backward,
    as the reference checkpoints its decoder scan's body.

    ``env`` (the rank's :class:`repro_torch.core.dist.AxisEnv` on the
    model ring) runs the encoder and the decoder on the rank's heads
    and FFN columns with its shards
    (:func:`repro_torch.weights.shard_params`) and its cache (the rank's
    kv_per_rank heads of self and cross K/V): the logits are then the
    rank's V_pad/tp columns.  ``gather_fn(group, subtree)`` (the train
    step's) gathers the FSDP-sharded parameters of the ``"embed"`` group
    (``embed``, ``pos_embed``), of each encoder layer (``"enc_block"``)
    and of each decoder layer (``"dec_block"``, inside the recomputed
    region under remat)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode={mode!r}: an encoder-decoder has no paged "
                         "pool (chunked prefill and verify run against one)")
    if mode != "decode" and frames is None:
        raise ValueError(f"mode={mode!r} needs the encoder's frames")
    if mode != "train" and cache is None:
        raise ValueError(f"mode={mode!r} needs the decoder cache")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    compute = dtype_of(plan.compute_dtype)
    gather_fn = gather_fn or _no_gather
    top = dict(params)
    top.update(gather_fn("embed", {k: params[k]
                                   for k in ("embed", "pos_embed")}))
    x = embed_tokens(top, tokens, cfg, plan, env).to(compute)
    x = add_positional(top, x, positions[:, None] if mode == "decode"
                       else positions, cfg, plan, env).to(compute)
    enc_x = None
    if mode != "decode":
        enc_x = run_encoder(params, frames, cfg=cfg, plan=plan, env=env,
                            gather_fn=gather_fn)
    remat = (mode == "train" and plan.remat != "none"
             and torch.is_grad_enabled())
    for i, bp in enumerate(unstack_tree(params["dec_blocks"], cfg.n_layers)):
        kw = dict(cfg=cfg, plan=plan, mode=mode, positions=positions,
                  cache=cache, env=env, gather_fn=gather_fn)
        if remat:
            # the whole layer replayed (see transformer's super-block)
            with set_checkpoint_early_stop(False):
                x = checkpoint(_decoder_layer, bp, x, enc_x, i,
                               use_reentrant=False, **kw)
        else:
            x = _decoder_layer(bp, x, enc_x, i, **kw)
    x = _norm(params["ln_f"], x, cfg, plan, env)
    logits = lm_logits(top, x, cfg, plan, env)
    if with_aux:
        return logits, cache, torch.zeros((), dtype=torch.float32,
                                          device=logits.device)
    return logits, cache


def _decoder_layer(bp: Params, x: torch.Tensor,
                   enc_x: Optional[torch.Tensor], i: int, *, cfg, plan,
                   mode: str, positions: torch.Tensor,
                   cache: Optional[Params],
                   env: Optional[AxisEnv] = None,
                   gather_fn=None) -> torch.Tensor:
    """Decoder layer ``i``: self-attention, cross-attention to the
    encoder states (their K/V from ``enc_x``, or read from the cache in
    decode), then the MLP; prefill writes the layer's cache rows.
    ``gather_fn`` gathers the layer's FSDP-sharded parameters first."""
    bp = (gather_fn or _no_gather)("dec_block", bp)
    h_in = _norm(bp["ln1"], x, cfg, plan, env)
    if mode == "decode":
        h = attn_mod.decode_attention(
            bp["attn"], h_in, cfg=cfg, plan=plan,
            cache={"k": cache["k"][i], "v": cache["v"][i]},
            positions=positions, env=env)
    elif mode == "prefill":
        h = attn_mod.prefill_attention(
            bp["attn"], h_in, cfg=cfg, plan=plan, positions=positions,
            cache={"k": cache["k"][i], "v": cache["v"][i]}, env=env)
    else:
        h = attn_mod.self_attention(bp["attn"], h_in, cfg=cfg,
                                    plan=plan, positions=positions, env=env)
    x = x + h
    h_in = _norm(bp["lnx"], x, cfg, plan, env)
    if mode == "decode":
        ck, cv = cache["ck"][i], cache["cv"][i]
    else:
        ck, cv = attn_mod.encode_cross_kv(bp["xattn"], enc_x, cfg=cfg,
                                          plan=plan, env=env)
        if cache is not None:
            cache["ck"][i].copy_(ck)
            cache["cv"][i].copy_(cv)
    x = x + attn_mod.cross_attention(bp["xattn"], h_in, cfg=cfg,
                                     plan=plan, enc_k=ck.to(x.dtype),
                                     enc_v=cv.to(x.dtype), env=env)
    return x + mlp_mod.mlp_fwd(bp["mlp"], _norm(bp["ln2"], x, cfg, plan,
                                                env),
                               cfg=cfg, plan=plan, env=env)


def init_encdec_cache(cfg, plan, batch: int, max_seq: int,
                      dtype: torch.dtype, device) -> Params:
    """Zeroed decoder cache of one rank: self K/V (L, batch, max_seq,
    kpr, dh) and cross K/V (L, batch, enc_seq, kpr, dh), kpr the plan's
    kv_per_rank (Gp at tp=1)."""
    a = plan.attn
    kv = (cfg.n_layers, batch, max_seq, a.kv_per_rank, a.d_head)
    ckv = (cfg.n_layers, batch, cfg.encdec.enc_seq, a.kv_per_rank,
           a.d_head)
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, shape in (("k", kv), ("v", kv), ("ck", ckv),
                             ("cv", ckv))}
