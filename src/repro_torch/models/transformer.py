"""Decoder-only LM assembly for the dense, moe, vlm, rwkv and hybrid
(jamba) families.

Parameters keep the reference's layout: layers are grouped into
*super-blocks* (jamba: ``attn_every`` layers, attention at one index,
mamba at the others, MoE on every ``moe_every``-th; an MoE stack:
``moe_every`` layers, the last one MoE, so llama4's is a dense layer and
an MoE layer; dense, vlm and rwkv: one layer) and stacked on a leading
super-block axis (``params["blocks"]["l{j}"]``), which the reference
scans and this port loops over.  Decode updates the KV cache in place
layer by layer (the reference threads it through the scan carry and
scatters the new rows in ``_scatter_cache_updates``); a recurrent layer
(rwkv; mamba's ``conv`` and ``ssm``) overwrites its state in place,
every row of the batch, as the reference's whole-slice update does.

Training (``mode="train"``) differentiates the same forward: the
recurrences take their kernels' plain versions there (a kernel has no
backward), ``with_aux=True`` returns the MoE layers' load-balancing
loss summed over the stack, a plan with ``remat != "none"`` recomputes
each super-block in backward (``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint`` of its scan body), and
:func:`sharded_xent` is the loss.

The dense, MoE, rwkv and hybrid families also run on the model ring
(``env`` from :mod:`repro_torch.core.dist`, one process per rank on its
own shards): activations flow *scattered* (B, S, D/tp) between layers
when ESL overlap is on (``plan.esl_overlap``) and full in the blocking
baseline; the tied embedding and the logits are vocab-sharded (the row
of a rank is V_pad/tp wide), the untied input table and the learned
positions D-sharded, and the norms combine their statistics over the
ring.  Attention runs on the rank's heads, mamba on its d_inner/tp
channels, rwkv on its heads, an MoE on its experts
(:mod:`repro_torch.models.mamba`, :mod:`~repro_torch.models.rwkv`,
:mod:`~repro_torch.models.moe`); a vlm's D-sharded projector gives its
patch rows in the activations' convention (:func:`project_patches`),
and a speculative verify window runs on the rank's heads and pool.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import dist as dist_mod
from repro_torch.core import esl
from repro_torch.core.dist import AxisEnv, model_rank, on_ring
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


def index_tree(tree: Params, i: int) -> Params:
    """Entry ``i`` of every leaf of a stacked tree (views)."""
    return {k: index_tree(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def layer_params(params: Params, i: int) -> Params:
    """Super-block ``i`` of the stacked decoder parameters (views)."""
    return index_tree(params["blocks"], i)


def unstack_tree(tree: Params, n: int) -> List[Params]:
    """The ``n`` entries of every leaf of a stacked tree (views, by one
    ``unbind`` a leaf: under autograd a leaf's gradient is then one
    ``stack`` of its entries', not ``n`` zero-padded full-size adds)."""
    out: List[Params] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = unstack_tree(v, n) if isinstance(v, dict) else v.unbind(0)
        for o, part in zip(out, parts):
            o[k] = part
    return out


def embed_tokens(p: Params, tokens: torch.Tensor, cfg, plan,
                 env: Optional[AxisEnv] = None) -> torch.Tensor:
    """tokens (B,S) -> (B,S,D), or on the ring the plan's convention:
    (B,S,D/tp) scattered under ESL overlap, (B,S,D) in the baseline.
    The untied table is D-sharded (a local lookup, natively scattered);
    the tied one is vocab-sharded: each rank looks up the ids in its
    rows, zeroes the others, and the ring sums (``psum_scatter`` into
    the scattered form, ``psum`` into the full one)."""
    if not on_ring(env):
        w = p["embed_in"] if "embed_in" in p else p["embed"]
        return w[tokens.long()]
    ring, scattered = env.model, plan.esl_overlap
    if "embed_in" in p:
        x = p["embed_in"][tokens.long()]
        return x if scattered else esl.gather_scattered(x, axis=ring,
                                                        tp=env.tp)
    w = p["embed"]
    v_loc = w.shape[0]
    local = tokens.long() - model_rank(env) * v_loc
    ok = (local >= 0) & (local < v_loc)
    x = torch.where(ok[..., None], w[local.clamp(0, v_loc - 1)], 0.0)
    if scattered:
        return dist_mod.psum_scatter(x, ring, dim=-1)
    return dist_mod.psum(x, ring)


def add_positional(p: Params, x: torch.Tensor, positions: torch.Tensor,
                   cfg, plan=None, env: Optional[AxisEnv] = None
                   ) -> torch.Tensor:
    """x (B,S,D) + the learned position rows ``pos_embed[positions]``
    (positions broadcastable to (B,S)); x itself for any other
    positional scheme.  An index past the table reads its last row: the
    engine refuses ``max_seq > cfg.max_seq``, so only the padded rows of
    a chunk or a prefix tail can reach past it, and those are dropped
    (the reference's ``jnp.take`` fills them with NaN; an index past the
    table would be a device-side assert on the card).  On the ring the
    table is D-sharded: its rows are the rank's columns, added to
    scattered activations as they are; for full ones the table is
    gathered whole (once, ``esl.full_vec``)."""
    if cfg.positional != "learned":
        return x
    pe = p["pos_embed"]
    if on_ring(env):
        pe = esl.full_vec(pe, axis=env.model, tp=env.tp,
                          scattered_activations=plan.esl_overlap)
    idx = positions.long().clamp(0, pe.shape[0] - 1)
    return x + pe[idx].to(x.dtype)


def project_patches(p: Params, patch_embeds: torch.Tensor, plan,
                    env: Optional[AxisEnv] = None) -> torch.Tensor:
    """A vlm's (B, n_patches, patch_embed_dim) patch embeddings through
    its ``projector`` -> rows in the activations' convention.  On the
    ring the projector is D-sharded (the reference's ``("patches",
    "embed_scatter")`` rule): the local product gives the rank's
    scattered (B, P, D/tp) rows, gathered whole in the blocking
    baseline."""
    compute = dtype_of(plan.compute_dtype)
    pe = patch_embeds.to(compute) @ p["projector"].to(compute)
    if on_ring(env) and not plan.esl_overlap:
        pe = esl.gather_scattered(pe, axis=env.model, tp=env.tp)
    return pe


def lm_logits(p: Params, x: torch.Tensor, cfg, plan,
              env: Optional[AxisEnv] = None) -> torch.Tensor:
    """-> (B,S,V_pad) logits, padded vocab columns masked to
    finfo(f32).min / 2; on the ring the rank's (B,S,V_pad/tp) columns
    (vocab-sharded, never gathered whole), masked by their global id."""
    w = p["head"] if "head" in p else p["embed"].t()
    if on_ring(env):
        y = esl.ag_matmul(x, w, axis=env.model, tp=env.tp,
                          overlap=plan.esl_overlap,
                          scattered_in=plan.esl_overlap)
    else:
        y = x @ w
    v_ids = (model_rank(env) * y.shape[-1]
             + torch.arange(y.shape[-1], device=y.device))
    return torch.where(v_ids < cfg.vocab_size, y,
                       torch.finfo(torch.float32).min / 2)


def sharded_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of (B,S,V) logits against (B,S) token ids (or
    ``ignore``), the reference's ``sharded_xent`` at tp=1.  Returns
    (sum of the loss, count of the labels that are not ``ignore``).

    The max stabilizer is taken outside autograd, as the reference's
    ``stop_gradient`` does (lse(x) = log sum exp(x - m) + m for any
    constant m)."""
    lg = logits.float()
    v = lg.shape[-1]
    m = lg.detach().amax(-1)
    se = torch.exp(lg - m[..., None]).sum(-1)
    lse = torch.log(se) + m                               # (B,S)
    ok = (labels >= 0) & (labels < v)
    picked = torch.gather(lg, -1, labels.long().clamp(0, v - 1)[..., None]
                          )[..., 0]
    picked = torch.where(ok, picked, 0.0)
    valid = labels != ignore
    loss = torch.where(valid, lse - picked, 0.0)
    return loss.sum(), valid.sum()


def _norm(pn: Params, x: torch.Tensor, cfg, plan,
          env: Optional[AxisEnv]) -> torch.Tensor:
    """The layer's norm; on the ring with scattered activations its
    statistics are combined over the ring, and in the blocking baseline
    its model-sharded scale and bias are gathered."""
    if not on_ring(env):
        return apply_norm(pn, x, cfg.norm)
    ring, scattered = env.model, plan.esl_overlap
    pl = {k: esl.full_vec(v, axis=ring, tp=env.tp,
                          scattered_activations=scattered)
          for k, v in pn.items()}
    return apply_norm(pl, x, cfg.norm,
                      stats_axis=ring if scattered else None)


def apply_layer(p: Params, x: torch.Tensor, *, cfg, plan,
                positions: torch.Tensor, mode: str,
                cache: Optional[Params] = None,
                block_tables: Optional[torch.Tensor] = None,
                paged_kernel: str = "stream", block_s: int = 0,
                use_kernels: bool = True,
                kv_valid_len: Optional[torch.Tensor] = None,
                env: Optional[AxisEnv] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One decoder layer (pre-norm, residual): attention or mamba, then
    MLP or MoE; or time mix + channel mix of one rwkv layer.  Returns
    (x, the MoE's auxiliary loss, or None for a layer without one).  A
    mamba layer with a cache overwrites its ``conv``/``ssm`` state in
    place.

    ``mode="chunk_prefill"`` (attention-only stacks) prefills one chunk
    of a partly resident prompt straight against the paged pool:
    ``cache`` is the pool, ``block_tables`` the request's (1, T) table
    and ``kv_valid_len`` the resident tokens after the chunk.
    ``mode="verify"`` (attention-only stacks) scores a speculative verify
    window of Q single-token queries against the pool: ``block_tables``
    is (Q, T), one table per query, and ``kv_valid_len`` (Q,) each
    query's span including itself."""
    if cfg.family == "rwkv":
        return _apply_rwkv_layer(p, x, cfg=cfg, plan=plan, mode=mode,
                                 cache=cache, use_kernels=use_kernels,
                                 env=env), None
    h_in = _norm(p["ln1"], x, cfg, plan, env)
    if "mamba" in p:
        if mode not in ("train", "prefill", "decode"):
            raise NotImplementedError(
                f"mode={mode!r}: a hybrid stack has no paged pool "
                "(chunked prefill and verify run against one)")
        h, st = mamba_mod.mamba_fwd(p["mamba"], h_in, cfg=cfg, plan=plan,
                                    state=cache, use_kernels=use_kernels,
                                    env=env)
        if cache is not None:
            cache["conv"].copy_(st["conv"])
            cache["ssm"].copy_(st["ssm"])
    elif mode == "decode":
        h = attn_mod.decode_attention(
            p["attn"], h_in, cfg=cfg, plan=plan, cache=cache,
            positions=positions, block_table=block_tables,
            paged_kernel=paged_kernel, block_s=block_s, env=env)
    elif mode == "prefill":
        h = attn_mod.prefill_attention(p["attn"], h_in, cfg=cfg, plan=plan,
                                       positions=positions, cache=cache,
                                       env=env)
    elif mode == "chunk_prefill":
        h = attn_mod.chunk_prefill_attention(
            p["attn"], h_in, cfg=cfg, plan=plan, positions=positions,
            cache=cache, block_table=block_tables,
            kv_valid_len=kv_valid_len, paged_kernel=paged_kernel, env=env)
    elif mode == "verify":
        h = attn_mod.verify_attention(
            p["attn"], h_in, cfg=cfg, plan=plan, positions=positions,
            cache=cache, block_tables=block_tables,
            kv_valid_len=kv_valid_len, paged_kernel=paged_kernel, env=env)
    elif mode == "train":
        h = attn_mod.self_attention(p["attn"], h_in, cfg=cfg, plan=plan,
                                    positions=positions, env=env)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + h
    h_in = _norm(p["ln2"], x, cfg, plan, env)
    if "moe" in p:
        h, aux = moe_mod.moe_fwd(p["moe"], h_in, cfg=cfg, plan=plan,
                                 env=env)
        return x + h, aux
    return x + mlp_mod.mlp_fwd(p["mlp"], h_in, cfg=cfg, plan=plan,
                               env=env), None


def _apply_rwkv_layer(p: Params, x: torch.Tensor, *, cfg, plan, mode: str,
                      cache: Optional[Params], use_kernels: bool,
                      env: Optional[AxisEnv] = None) -> torch.Tensor:
    """One rwkv layer; with a cache (prefill, decode) its state leaves
    ``shift_t``, ``shift_c`` and ``wkv`` are overwritten in place."""
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(
            f"mode={mode!r}: an rwkv stack has no paged pool (chunked "
            "prefill and verify run against one)")
    st = None
    if cache is not None:
        st = {"shift": cache["shift_t"], "wkv": cache["wkv"]}
    h, st2 = rwkv_mod.time_mix_fwd(p["tmix"],
                                   _norm(p["ln1"], x, cfg, plan, env),
                                   cfg=cfg, plan=plan, state=st,
                                   use_kernels=use_kernels, env=env)
    x = x + h
    st_c = cache["shift_c"] if cache is not None else None
    h, st_c2 = rwkv_mod.channel_mix_fwd(p["cmix"],
                                        _norm(p["ln2"], x, cfg, plan, env),
                                        cfg=cfg, plan=plan, state=st_c,
                                        env=env)
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
                      use_kernels: bool = True,
                      kv_valid_len: Optional[torch.Tensor] = None,
                      with_aux: bool = False,
                      env: Optional[AxisEnv] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layers ``l0..l{sb-1}`` of one super-block in order; ``cache`` is
    the super-block's slice ({"l{j}": {leaf: view}}), updated in place.
    Returns (x, the sum of its MoE layers' auxiliary losses in layer
    order, or None without ``with_aux`` or without an MoE layer)."""
    aux_sum = None
    for j in range(super_block_size(cfg)):
        x, aux = apply_layer(
            p[f"l{j}"], x, cfg=cfg, plan=plan, positions=positions,
            mode=mode, cache=cache[f"l{j}"] if cache is not None else None,
            block_tables=block_tables, paged_kernel=paged_kernel,
            block_s=block_s, use_kernels=use_kernels,
            kv_valid_len=kv_valid_len, env=env)
        if with_aux and aux is not None:
            aux_sum = aux if aux_sum is None else aux_sum + aux
    return x, aux_sum


def forward(params: Params, tokens: torch.Tensor, *, cfg, plan,
            mode: str = "train",
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Params] = None,
            block_tables: Optional[torch.Tensor] = None,
            paged_kernel: str = "stream",
            block_s: int = 0,
            use_kernels: bool = True,
            kv_valid_len: Optional[torch.Tensor] = None,
            patch_embeds: Optional[torch.Tensor] = None,
            with_aux: bool = False,
            env: Optional[AxisEnv] = None):
    """Shared forward in the train/prefill/decode/chunk_prefill/verify
    modes.

    ``patch_embeds`` (B, n_patches, patch_embed_dim), a vlm's stub vision
    tower output, go through the ``projector`` and sit before the text,
    as the reference's forward does: the sequence is then n_patches + S
    long and, outside decode, its positions are re-based to
    ``arange(n_patches + S)``; a decode step's positions already count
    the patches.

    ``cache`` ({"l{j}": {"k","v": (n_sb, ...)}}) is updated in place:
    prefill fills a batch cache covering exactly the S positions; decode
    reads each layer's cache before scattering that layer's new row.
    ``positions``: (B,S) for train/prefill (default arange), (B,) for
    decode, (1,C) absolute offsets for chunk_prefill, where
    ``block_tables`` is the request's (1,T) table and ``kv_valid_len``
    the resident length after the chunk (see
    :func:`repro_torch.models.attention.chunk_prefill_attention`), and
    (1,Q) for verify, with (Q,T) tables and (Q,) spans (see
    :func:`repro_torch.models.attention.verify_attention`); learned
    positions (OPT, GPT3) add ``pos_embed`` at exactly these positions
    (:func:`add_positional`).  ``paged_kernel`` is the resolved paged
    dataflow, ``"stream"`` or ``"gather"`` (resolve ``"auto"`` with
    ``resolve_paged_kernel`` once, as the engine does).  An rwkv stack's
    cache is {"l0": {"shift_t","shift_c","wkv"}}, overwritten in place;
    its positions are unused.  A hybrid stack's cache holds, per
    in-block index ``j``, the dense k/v of its attention layer or the
    ``conv``/``ssm`` state of a mamba layer.  ``use_kernels=False`` runs
    the recurrences (rwkv's decode recurrence, every mamba scan) on the
    plain versions of their kernels (the oracle; attention layers pick
    their kernel with ``paged_kernel``); train mode always does.
    Returns (logits (B,S,V_pad), cache), and with ``with_aux`` (which
    only the train step passes; the logits are the same either way)
    (logits, cache, aux): the MoE layers' auxiliary losses summed per
    super-block, then over the stack in order, as the reference's scan
    carries them (a float32 zero without MoE layers).  With a plan
    whose ``remat`` is not ``"none"``, train mode under autograd
    recomputes each super-block in backward.

    ``env`` (the rank's :class:`repro_torch.core.dist.AxisEnv` on the
    model ring) runs the dense, MoE, vlm, rwkv and hybrid families
    tensor-parallel on the rank's shards
    (:func:`repro_torch.weights.shard_params`) and its cache (kv_per_rank
    heads, the rank's rwkv heads and mamba channels): the logits are
    then the rank's V_pad/tp columns.  The ring's prefill, decode,
    chunked prefill and speculative verify are ported, and a vlm's
    patches; training raises (FSDP and the gradient sync are not
    ported).  On a ``("data", "model")`` grid ``tokens`` are the rank's
    data row's rows (the steps slice them), the cache is the rank's
    (:meth:`repro_torch.models.registry.Model.init_cache` with ``env``),
    and with ``env.kv_seq_axis`` an attention layer's dense cache holds
    the rank's slice of the sequence: prefill writes the prompt's rows
    of that slice, decode merges the slices' partial softmaxes over the
    data ring and the owning rank stores the new row
    (:func:`repro_torch.models.attention.decode_attention`)."""
    if on_ring(env) and (with_aux or torch.is_grad_enabled()
                         and mode == "train"):
        raise NotImplementedError(
            "training on the ring (FSDP gathers, gradient sync) is not "
            "ported yet; the ring's train mode is a no-grad forward")
    if env is not None and env.kv_seq_axis is not None and \
            mode not in ("prefill", "decode"):
        raise ValueError(
            f"mode={mode!r}: a KV sequence sharded over "
            f"{env.kv_seq_axis!r} serves prefill and decode of a dense "
            "cache (a paged pool's blocks replace the sequence dim)")
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
    compute = dtype_of(plan.compute_dtype)
    x = embed_tokens(params, tokens, cfg, plan, env).to(compute)
    if patch_embeds is not None:
        x = torch.cat([project_patches(params, patch_embeds, plan, env)
                       .to(compute), x], 1)
        if mode != "decode":
            S = x.shape[1]
            positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = add_positional(params, x, positions[:, None] if mode == "decode"
                       else positions, cfg, plan, env).to(compute)
    n_sb = n_super_blocks(cfg)
    remat = (mode == "train" and plan.remat != "none"
             and torch.is_grad_enabled())
    aux_total = (torch.zeros((), dtype=torch.float32, device=x.device)
                 if with_aux else None)
    for i, bp in enumerate(unstack_tree(params["blocks"], n_sb)):
        block_cache = None
        if cache is not None:
            block_cache = {lj: {k: v[i] for k, v in c.items()}
                           for lj, c in cache.items()}
        kw = dict(cfg=cfg, plan=plan, positions=positions, mode=mode,
                  cache=block_cache, block_tables=block_tables,
                  paged_kernel=paged_kernel, block_s=block_s,
                  use_kernels=use_kernels and mode != "train",
                  kv_valid_len=kv_valid_len, with_aux=with_aux, env=env)
        if remat:
            x, aux = checkpoint(apply_super_block, bp, x, use_reentrant=False,
                                **kw)
        else:
            x, aux = apply_super_block(bp, x, **kw)
        if aux is not None:
            aux_total = aux_total + aux
    x = _norm(params["ln_f"], x, cfg, plan, env)
    logits = lm_logits(params, x, cfg, plan, env)
    if with_aux:
        return logits, cache, aux_total
    return logits, cache
