"""Decoder-only LM assembly for the dense, rwkv and hybrid (jamba)
families at tp=1.

Parameters keep the reference's layout: layers are grouped into
*super-blocks* (jamba: ``attn_every`` layers, attention at one index,
mamba at the others, MoE on every ``moe_every``-th; dense and rwkv: one
layer) and stacked on a leading super-block axis
(``params["blocks"]["l{j}"]``), which the reference scans and this port
loops over.  Decode updates the KV cache in place layer by layer (the
reference threads it through the scan carry and scatters the new rows in
``_scatter_cache_updates``); a recurrent layer (rwkv; mamba's ``conv``
and ``ssm``) overwrites its state in place, every row of the batch, as
the reference's whole-slice update does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import dtype_of
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import apply_norm

Params = Dict[str, Any]


def super_block_size(cfg) -> int:
    """Layers per super-block: the lcm of the family's interleave
    patterns (jamba: ``attn_every``; an MoE stack: ``moe_every``)."""
    if cfg.family == "hybrid":
        return cfg.mamba.attn_every
    if cfg.moe is not None:
        return cfg.moe.moe_every
    return 1


def n_super_blocks(cfg) -> int:
    sb = super_block_size(cfg)
    if cfg.n_layers % sb:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a "
                         f"multiple of the super-block {sb}")
    return cfg.n_layers // sb


def layer_params(params: Params, i: int) -> Params:
    """Super-block ``i`` of the stacked decoder parameters (views)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["blocks"])


def embed_tokens(p: Params, tokens: torch.Tensor, cfg, plan) -> torch.Tensor:
    """tokens (B,S) -> (B,S,D)."""
    w = p["embed_in"] if "embed_in" in p else p["embed"]
    return w[tokens.long()]


def lm_logits(p: Params, x: torch.Tensor, cfg, plan) -> torch.Tensor:
    """-> (B,S,V_pad) logits, padded vocab columns masked to
    finfo(f32).min / 2."""
    w = p["head"] if "head" in p else p["embed"].t()
    y = x @ w
    v_ids = torch.arange(y.shape[-1], device=y.device)
    return torch.where(v_ids < cfg.vocab_size, y,
                       torch.finfo(torch.float32).min / 2)


def apply_layer(p: Params, x: torch.Tensor, *, cfg, plan,
                positions: torch.Tensor, mode: str,
                cache: Optional[Params] = None,
                block_tables: Optional[torch.Tensor] = None,
                paged_kernel: str = "stream", block_s: int = 0,
                use_kernels: bool = True) -> torch.Tensor:
    """One decoder layer (pre-norm, residual): attention or mamba, then
    MLP or MoE; or time mix + channel mix of one rwkv layer.  A mamba
    layer with a cache overwrites its ``conv``/``ssm`` state in place;
    the MoE's auxiliary loss is dropped (no training path yet)."""
    if cfg.family == "rwkv":
        return _apply_rwkv_layer(p, x, cfg=cfg, plan=plan, mode=mode,
                                 cache=cache, use_kernels=use_kernels)
    h_in = apply_norm(p["ln1"], x, cfg.norm)
    if "mamba" in p:
        if mode not in ("train", "prefill", "decode"):
            raise NotImplementedError(
                f"mode={mode!r}: a hybrid stack has no paged pool "
                "(chunked prefill and verify run against one)")
        h, st = mamba_mod.mamba_fwd(p["mamba"], h_in, cfg=cfg, plan=plan,
                                    state=cache, use_kernels=use_kernels)
        if cache is not None:
            cache["conv"].copy_(st["conv"])
            cache["ssm"].copy_(st["ssm"])
    elif mode == "decode":
        h = attn_mod.decode_attention(
            p["attn"], h_in, cfg=cfg, plan=plan, cache=cache,
            positions=positions, block_table=block_tables,
            paged_kernel=paged_kernel, block_s=block_s)
    elif mode == "prefill":
        h = attn_mod.prefill_attention(p["attn"], h_in, cfg=cfg, plan=plan,
                                       positions=positions, cache=cache)
    elif mode == "train":
        h = attn_mod.self_attention(p["attn"], h_in, cfg=cfg, plan=plan,
                                    positions=positions)
    else:
        raise NotImplementedError(
            f"mode={mode!r} (chunked prefill / verify) arrives with a "
            "later slice of the port")
    x = x + h
    h_in = apply_norm(p["ln2"], x, cfg.norm)
    if "moe" in p:
        return x + moe_mod.moe_fwd(p["moe"], h_in, cfg=cfg, plan=plan)[0]
    return x + mlp_mod.mlp_fwd(p["mlp"], h_in, cfg=cfg, plan=plan)


def _apply_rwkv_layer(p: Params, x: torch.Tensor, *, cfg, plan, mode: str,
                      cache: Optional[Params], use_kernels: bool
                      ) -> torch.Tensor:
    """One rwkv layer; with a cache (prefill, decode) its state leaves
    ``shift_t``, ``shift_c`` and ``wkv`` are overwritten in place."""
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(
            f"mode={mode!r}: an rwkv stack has no paged pool (chunked "
            "prefill and verify run against one)")
    st = None
    if cache is not None:
        st = {"shift": cache["shift_t"], "wkv": cache["wkv"]}
    h, st2 = rwkv_mod.time_mix_fwd(p["tmix"], apply_norm(p["ln1"], x,
                                                         cfg.norm),
                                   cfg=cfg, plan=plan, state=st,
                                   use_kernels=use_kernels)
    x = x + h
    st_c = cache["shift_c"] if cache is not None else None
    h, st_c2 = rwkv_mod.channel_mix_fwd(p["cmix"], apply_norm(p["ln2"], x,
                                                             cfg.norm),
                                        cfg=cfg, plan=plan, state=st_c)
    if cache is not None:
        cache["shift_t"].copy_(st2["shift"])
        cache["wkv"].copy_(st2["wkv"])
        cache["shift_c"].copy_(st_c2)
    return x + h


def apply_super_block(p: Params, x: torch.Tensor, *, cfg, plan,
                      positions: torch.Tensor, mode: str,
                      cache: Optional[Params] = None,
                      block_tables: Optional[torch.Tensor] = None,
                      paged_kernel: str = "stream", block_s: int = 0,
                      use_kernels: bool = True) -> torch.Tensor:
    """Layers ``l0..l{sb-1}`` of one super-block in order; ``cache`` is
    the super-block's slice ({"l{j}": {leaf: view}}), updated in place."""
    for j in range(super_block_size(cfg)):
        x = apply_layer(p[f"l{j}"], x, cfg=cfg, plan=plan,
                        positions=positions, mode=mode,
                        cache=cache[f"l{j}"] if cache is not None else None,
                        block_tables=block_tables, paged_kernel=paged_kernel,
                        block_s=block_s, use_kernels=use_kernels)
    return x


def forward(params: Params, tokens: torch.Tensor, *, cfg, plan,
            mode: str = "train",
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Params] = None,
            block_tables: Optional[torch.Tensor] = None,
            paged_kernel: str = "stream",
            block_s: int = 0,
            use_kernels: bool = True) -> Tuple[torch.Tensor,
                                               Optional[Params]]:
    """Shared forward in the train/prefill/decode modes.

    ``cache`` ({"l{j}": {"k","v": (n_sb, ...)}}) is updated in place:
    prefill fills a batch cache covering exactly the S positions; decode
    reads each layer's cache before scattering that layer's new row.
    ``positions``: (B,S) for train/prefill (default arange), (B,) for
    decode.  ``paged_kernel`` is the resolved paged dataflow, ``"stream"``
    or ``"gather"`` (resolve ``"auto"`` with ``resolve_paged_kernel``
    once, as the engine does).  An rwkv stack's cache is {"l0":
    {"shift_t","shift_c","wkv"}}, overwritten in place; its positions are
    unused.  A hybrid stack's cache holds, per in-block index ``j``, the
    dense k/v of its attention layer or the ``conv``/``ssm`` state of a
    mamba layer.  ``use_kernels=False`` runs the recurrences (rwkv's
    decode recurrence, every mamba scan) on the plain versions of their
    kernels (the oracle; attention layers pick their kernel with
    ``paged_kernel``).  Returns (logits (B,S,V_pad), cache)."""
    if paged_kernel not in ("stream", "gather"):
        raise ValueError(f"paged_kernel={paged_kernel!r}: pass the resolved "
                         "dataflow, 'stream' or 'gather'")
    if not use_kernels and cfg.family not in ("rwkv", "hybrid"):
        raise ValueError("use_kernels=False switches the rwkv and mamba "
                         "recurrences; attention layers take their plain "
                         "path with paged_kernel='gather'")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_tokens(params, tokens, cfg, plan).to(
        dtype_of(plan.compute_dtype))
    for i in range(n_super_blocks(cfg)):
        block_cache = None
        if cache is not None:
            block_cache = {lj: {k: v[i] for k, v in c.items()}
                           for lj, c in cache.items()}
        x = apply_super_block(layer_params(params, i), x, cfg=cfg,
                              plan=plan, positions=positions, mode=mode,
                              cache=block_cache, block_tables=block_tables,
                              paged_kernel=paged_kernel, block_s=block_s,
                              use_kernels=use_kernels)
    x = apply_norm(params["ln_f"], x, cfg.norm)
    return lm_logits(params, x, cfg, plan), cache
