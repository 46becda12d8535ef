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

``shard_params(tree, plan, rank)`` slices a full tree of any family,
in the stored layout at the plan's tp (padded and duplicated
heads), into rank ``rank``'s leaves by the plan's rule table: every
dim whose logical axis the table maps to the ring is cut into tp
blocks, of which the rank keeps block ``rank`` (the reference's
addressable shard of a ``NamedSharding`` over its ``model`` mesh).

``init_shard(cfg, plan, rank, seed, device)`` is the same shard drawn
without the full tree: the tp=1 values of ``init_params`` drawn layer by
layer in the same order from the same generator, each stored at the
ring's layout (:func:`relayout`) and cut to the rank's slice at once,
so a rank holds its shard and one layer of the tp=1 tree at most (a
model no card holds whole, opt-66b, is drawn this way).  It is
bit-equal to ``shard_params(relayout(init_params(cfg, plan1, seed),
cfg, plan1, plan), plan, rank)``.  :func:`redraw` refills named leaves
(zero biases, a position table) from a seeded generator, and
:func:`redraw_shard` refills a shard with the same values.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import dist
from repro_torch.models.common import map_leaves, mlp_has_bias
from repro_torch.models.transformer import n_super_blocks

Params = Dict[str, Any]

# the trees whose leaves are stacked on a leading layer axis
_STACKS = ("blocks", "enc_blocks", "dec_blocks")


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


# logical axes of each leaf (the reference's InitCtx records them by
# path); stacked layers gain a leading "layers"
_ATTN_AXES = {"wq": ("embed", "q_heads", "head_dim"),
              "wk": ("embed", "kv_heads", "head_dim"),
              "wv": ("embed", "kv_heads", "head_dim"),
              "wo": ("q_heads", "head_dim", "embed"),
              "bq": ("q_heads", "head_dim"),
              "bk": ("kv_heads", "head_dim"),
              "bv": ("kv_heads", "head_dim")}
_MLP_AXES = {"wg": ("embed", "ffn"), "wu": ("embed", "ffn"),
             "wi": ("embed", "ffn"), "wd": ("ffn", "embed"),
             "bi": ("ffn",), "bd": ("vec",)}
_MAMBA_AXES = {"in_x": ("embed", "mamba_inner"),
               "in_z": ("embed", "mamba_inner"),
               "conv_w": ("conv", "mamba_inner"),
               "conv_b": ("mamba_inner",),
               "x_proj": ("mamba_inner", None),
               "dt_proj": ("dt", "mamba_inner"),
               "dt_bias": ("mamba_inner",),
               "a_log": ("mamba_inner", "state"),
               "d_skip": ("mamba_inner",),
               "out_proj": ("mamba_inner", "embed")}
_TMIX_AXES = dict(
    {f"mu_{nm}": ("vec",) for nm in ("x", "r", "k", "v", "g", "w")},
    mix_w1=("embed", "lora"), mix_w2=(None, "lora", "embed_scatter"),
    w_r=("embed", "rwkv_heads"), w_k=("embed", "rwkv_heads"),
    w_v=("embed", "rwkv_heads"), w_g=("embed", "rwkv_heads"),
    w_o=("rwkv_heads", "embed"), decay_w0=("rwkv_heads",),
    decay_w1=("embed", "lora"), decay_w2=("lora", "rwkv_heads"),
    bonus_u=("rwkv_heads",), ln_x=("rwkv_heads",))
# cmix's receptance w_r (D, D) is column-tiled as an "ffn" dim, so its
# output matches the scattered one
_CMIX_AXES = {"mu_k": ("vec",), "mu_r": ("vec",), "w_k": ("embed", "ffn"),
              "w_v": ("ffn", "embed"), "w_r": ("embed", "ffn")}
_MOE_AXES = {"router": ("embed", None),
             "wg": ("experts", None, "embed", None),
             "wu": ("experts", None, "embed", None),
             "wd": ("experts", None, None, "embed")}
_OWNER_AXES = {"attn": _ATTN_AXES, "xattn": _ATTN_AXES, "mlp": _MLP_AXES,
               "mamba": _MAMBA_AXES,
               "tmix": _TMIX_AXES, "cmix": _CMIX_AXES, "moe": _MOE_AXES,
               "shared": _MLP_AXES}
_TOP_AXES = {"embed": ("vocab", "embed"),
             "embed_in": ("vocab_rep", "embed_scatter"),
             "head": ("embed", "vocab"),
             "pos_embed": ("pos", "embed_scatter"),
             "projector": ("patches", "embed_scatter")}


def leaf_axes(path: str) -> tuple:
    """The logical axes of the leaf at ``path`` of any family's tree
    (dense, MoE, vlm, rwkv, hybrid; whisper's ``enc_blocks`` and
    ``dec_blocks`` with ``lnx`` and ``xattn``, ``ln_enc``), as the
    reference's ``InitCtx`` records them.  A path of no family raises
    ``KeyError``."""
    parts = path.split("/")
    leaf = parts[-1]
    if parts[0] in _STACKS:
        owner = parts[-2]
        if owner in ("ln1", "ln2", "lnx"):
            ax = ("vec",)
        elif owner in _OWNER_AXES:
            ax = _OWNER_AXES[owner][leaf]
        else:
            raise KeyError(path)
        return ("layers",) + ax
    if parts[0] in ("ln_f", "ln_enc"):
        return ("vec",)
    return _TOP_AXES[leaf]


def mesh_axes_of(path: str, plan) -> tuple:
    """The mesh axes the leaf at ``path`` is sharded over at ``plan``
    (those the rule table maps its logical axes to; () off a mesh)."""
    out: list = []
    for a in leaf_axes(path):
        r = (plan.rules or {}).get(a)
        if r is not None:
            out += [r] if isinstance(r, str) else list(r)
    return tuple(out)


def _coords(plan, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s index on each mesh axis of ``plan``: on the ring
    its place; on a ``("data", "model")`` grid world rank ``l = d * tp +
    m`` (model innermost, as the reference's mesh)."""
    out, rest = {}, int(rank)
    for a, n in reversed(list(zip(plan.mesh_axes, plan.mesh_shape))):
        rest, out[a] = divmod(rest, n)
    return out


def _blocks(rule, plan, coords: Dict[str, int]) -> tuple:
    """(blocks, this rank's block) of a dim whose logical axis the rule
    table maps to ``rule`` (one mesh axis or a tuple of them, the first
    major): the reference's ``NamedSharding`` of that dim."""
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    sizes = dict(zip(plan.mesh_axes, plan.mesh_shape))
    n, idx = 1, 0
    for a in axes:
        n, idx = n * sizes[a], idx * sizes[a] + coords[a]
    return n, idx


def shard_leaf(t, path: str, plan, rank: int):
    """Rank ``rank``'s slice of the full leaf ``t`` (a tensor or a numpy
    array) at ``path``: each dim whose logical axis ``plan.rules`` maps
    to mesh axes keeps this rank's block of it, as the reference's
    addressable shard: on the ring its ``rank``-th of ``tp`` blocks; on
    a grid the model shard ``m`` of every dim on ``model`` (the same bits
    on every data row) and, for a giant MoE's experts on data x model,
    cell ``l`` of ``dwidth * tp``.  A tensor comes back as a contiguous
    copy, so the full leaf can be freed."""
    try:
        axes = leaf_axes(path)
    except KeyError:
        raise ValueError(f"{path}: not a leaf of any family's tree (no "
                         "logical axes to shard it by)") from None
    if len(axes) != len(t.shape):
        raise ValueError(f"{path}: axes {axes} vs shape {tuple(t.shape)}")
    coords = _coords(plan, rank)
    for d, a in enumerate(axes):
        rule = plan.rules.get(a)
        if rule is None:
            continue
        blocks, idx = _blocks(rule, plan, coords)
        n = t.shape[d]
        if n % blocks:
            raise ValueError(f"{path}: dim {d} of {n} does not split "
                             f"over {blocks} ranks")
        c = n // blocks
        t = (t.narrow(d, idx * c, c) if isinstance(t, torch.Tensor)
             else np.take(t, range(idx * c, (idx + 1) * c), axis=d))
    return t.contiguous().clone() if isinstance(t, torch.Tensor) else t


@torch.no_grad()
def gather_leaf(t: torch.Tensor, path: str, plan, env) -> torch.Tensor:
    """The plan's global tensor of the leaf at ``path`` from every
    rank's shard ``t``: each dim the rule table maps to mesh axes is
    all-gathered over their rings (the minor axis first), the inverse
    of :func:`shard_leaf`.  Every rank of ``env``'s mesh calls it, in
    the same order; every rank gets the whole leaf."""
    for d, a in enumerate(leaf_axes(path)):
        rule = plan.rules.get(a)
        if rule is None:
            continue
        for name in reversed((rule,) if isinstance(rule, str)
                             else tuple(rule)):
            ring = env.axis(name)
            if ring is not None and ring.size > 1:
                t = dist.all_gather(t, ring, dim=d)
    return t


def gather_shard(shard: Params, plan, env, to=None) -> Params:
    """The plan's global tree from every rank's ``shard``
    (:func:`gather_leaf` leaf by leaf, each moved ``to`` a device when
    given, so a checkpoint's writer holds one leaf on its card at a
    time).  ``relayout(..., plan, tp1_plan(cfg, plan))`` takes it to
    the tp=1 layout."""
    def one(t, path):
        g = gather_leaf(t, path, plan, env)
        return g if to is None else g.to(to)
    return map_leaves(shard, one)


def _check_ring_plan(plan, rank: int) -> None:
    if plan.mesh_axes is None:
        raise ValueError("a rank's shard needs a plan for the ring "
                         "(mesh_axes=('model',)) or the grid "
                         "(('data', 'model'))")
    world = int(np.prod(plan.mesh_shape))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not on a mesh of {world} ranks "
                         f"{plan.mesh_axes}{plan.mesh_shape}")


def shard_params(tree: Params, plan, rank: int) -> Params:
    """Rank ``rank``'s leaves of a full tree (tensors or numpy arrays)
    of any family at ``plan``'s mesh (:func:`shard_leaf` on every leaf;
    on a grid ``rank`` is the world rank)."""
    _check_ring_plan(plan, rank)
    return map_leaves(tree, lambda t, path: shard_leaf(t, path, plan, rank))


def _first_index(orig, n: int) -> list:
    """For each logical index < n, the first stored position holding it."""
    pos = {}
    for i, o in enumerate(orig):
        if o >= 0 and o not in pos:
            pos[o] = i
    return [pos[j] for j in range(n)]


def relayout_leaf(t: torch.Tensor, path: str, cfg, src_plan, dst_plan
                  ) -> torch.Tensor:
    """The full leaf ``t`` at ``path``, stored at ``src_plan``'s layout,
    stored again at ``dst_plan``'s (on its device): heads placed by the
    destination's ``q_orig``/``kv_orig`` (pad heads zero, duplicated kv
    heads copied; rwkv's heads are ``head_dim`` blocks of a flat dim),
    the vocabulary, FFN and mamba ``d_inner`` dims cut to the config's
    sizes and zero-padded to the destination's, and an MoE's experts
    (``src_plan`` must hold them on one rank, as tp=1 does) laid out
    rank-major for the destination (:func:`_relayout_experts`), its
    router's columns padded with zeros to the destination's padded
    expert count (a padded expert's logit is masked).  ``t`` itself
    where nothing moves."""
    sa, da = src_plan.attn, dst_plan.attn
    leaf = path.rsplit("/", 1)[-1]

    def heads(t, axis, n_logical, src_orig, dst_orig):
        src_idx = torch.as_tensor(_first_index(src_orig, n_logical),
                                  device=t.device)
        logical = t.index_select(axis, src_idx)
        cols = torch.as_tensor(dst_orig, device=t.device)
        out = logical.index_select(axis, cols.clamp_min(0))
        keep = (cols >= 0).view([-1 if d == axis else 1
                                 for d in range(t.dim())])
        return torch.where(keep, out, torch.zeros((), dtype=t.dtype,
                                                  device=t.device))

    def resize(t, axis, real, size):
        if t.shape[axis] == real == size:
            return t
        keep = t.narrow(axis, 0, real)
        shape = list(t.shape)
        shape[axis] = size
        out = torch.zeros(shape, dtype=t.dtype, device=t.device)
        out.narrow(axis, 0, real).copy_(keep)
        return out

    axes = leaf_axes(path)
    if "experts" in axes:
        return _relayout_experts(t, leaf == "wd", src_plan, dst_plan)
    if "/moe/" in path and leaf == "router":
        from repro_torch.models.moe import moe_layout
        return resize(t, t.dim() - 1, cfg.moe.n_experts,
                      moe_layout(dst_plan)[4])
    for d, a in enumerate(axes):
        if a == "q_heads":
            t = heads(t, d, sa.n_heads, sa.q_orig, da.q_orig)
        elif a == "kv_heads":
            t = heads(t, d, sa.n_kv_heads, sa.kv_orig, da.kv_orig)
        elif a == "rwkv_heads":
            dh = cfg.rwkv.head_dim
            t = heads(t.unflatten(d, (sa.hp, dh)), d, sa.n_heads,
                      sa.q_orig, da.q_orig).flatten(d, d + 1)
        elif a == "mamba_inner":
            from repro_torch.models.mamba import mamba_dims
            t = resize(t, d, cfg.mamba.expand * cfg.d_model,
                       mamba_dims(cfg, dst_plan)[0])
        elif a == "ffn" and "/shared/" in path:
            # the shared expert's n_shared x d_ff_padded columns are all
            # drawn (none is a pad): its width must not move
            if src_plan.d_ff_padded != dst_plan.d_ff_padded:
                raise NotImplementedError(
                    f"{path}: the shared expert's width changes between "
                    f"the plans ({src_plan.d_ff_padded} and "
                    f"{dst_plan.d_ff_padded} a shared expert)")
        elif a == "ffn" and path.endswith("cmix/w_r"):
            continue                    # a d_model dim, tiled as "ffn"
        elif a == "ffn":
            t = resize(t, d, cfg.d_ff, dst_plan.d_ff_padded)
        elif a == "vocab":
            t = resize(t, d, cfg.vocab_size, dst_plan.vocab_padded)
    return t


def _relayout_experts(t: torch.Tensor, rows: bool, src_plan, dst_plan
                      ) -> torch.Tensor:
    """An MoE expert stack ``(L, 1, E, D, f)`` (``wg``/``wu``) or ``(L,
    1, E, f, D)`` (``wd``, ``rows``) held by one rank at ``src_plan``,
    stored at ``dst_plan``'s rank-major layout ``(L, W, Ecell, ...)``:
    rank l holds expert group ``l // split`` and FFN part ``l % split``
    of it (the reference's ``init_moe`` builder), experts past the
    config's and FFN columns past the source's zero.  Every source
    column is kept (tp=1 draws them all).  A view of ``t`` when the
    experts only regroup."""
    from repro_torch.models.moe import moe_layout
    ws, _, _, ecs, _, fs = moe_layout(src_plan)
    if ws != 1 and moe_layout(dst_plan)[0] == 1:
        return _collect_experts(t, rows, src_plan, dst_plan)
    if ws != 1:
        raise NotImplementedError(
            "relayout of an MoE's experts from a plan that spreads them "
            f"over {ws} ranks to another that does: the source or the "
            "destination must hold every expert")
    w, split, n_groups, ecell, e_pad, ffh = moe_layout(dst_plan)
    e = dst_plan.moe.n_experts
    logical = t[:, 0, :e]                         # (L, E, D, f) / (L, E, f, D)
    fax = 2 if rows else 3                        # the FFN dim of logical
    if e_pad != e or ffh * split != fs:
        shape = list(logical.shape)
        shape[1], shape[fax] = e_pad, ffh * split
        pad = torch.zeros(shape, dtype=t.dtype, device=t.device)
        pad[:, :e].narrow(fax, 0, fs).copy_(logical)
        logical = pad
    L = t.shape[0]
    if split == 1:
        return logical.reshape((L, w, ecell) + tuple(logical.shape[2:]))
    # (L, groups, ecell, ..., split, ffh, ...) -> (L, groups, split,
    # ecell, ...): rank g * split + h holds part h of group g
    parts = logical.unflatten(fax, (split, ffh)).unflatten(1, (n_groups,
                                                               ecell))
    parts = parts.movedim(fax + 1, 2)
    return parts.reshape((L, w, ecell) + tuple(parts.shape[4:]))


def _collect_experts(t: torch.Tensor, rows: bool, src_plan, dst_plan
                     ) -> torch.Tensor:
    """The inverse of :func:`_relayout_experts`: a rank-major stack
    ``(L, W, Ecell, ...)`` of ``src_plan`` stored for ``dst_plan``,
    which holds every expert on one rank ``(L, 1, E_pad, ...)``: each
    group's FFN parts put back side by side, the experts past the
    config's and the FFN columns past the destination's dropped, then
    padded to the destination's widths."""
    from repro_torch.models.moe import moe_layout
    w, split, n_groups, ecell, _, ffh = moe_layout(src_plan)
    _, _, _, _, e_pad_d, ffh_d = moe_layout(dst_plan)
    e = src_plan.moe.n_experts
    L = t.shape[0]
    fax = 3 if rows else 4                      # the FFN dim of t
    parts = t.reshape((L, n_groups, split) + tuple(t.shape[2:]))
    # (L, groups, split, ecell, ...) -> (L, groups, ecell, ..., split, ffh)
    parts = parts.movedim(2, fax)
    full = parts.flatten(fax, fax + 1).flatten(1, 2)   # (L, E_pad_s, ...)
    fax -= 1                                    # the FFN dim of full
    real = full[:, :e].narrow(fax, 0, min(ffh * split, ffh_d))
    shape = list(real.shape)
    shape[1], shape[fax] = e_pad_d, ffh_d
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out[:, :e].narrow(fax, 0, real.shape[fax]).copy_(real)
    return out[:, None]


def relayout(tree: Params, cfg, src_plan, dst_plan) -> Params:
    """A full tree of any family stored at ``src_plan``'s layout,
    stored again at ``dst_plan``'s (:func:`relayout_leaf` on every
    leaf).  The logical model is unchanged: a zero pad head, FFN column
    or vocab row adds nothing (a padded logit column is masked).  This
    is how a tp=1 model is served on the ring with the same weights."""
    return map_leaves(tree, lambda t, path: relayout_leaf(
        t, path, cfg, src_plan, dst_plan))


def tp1_plan(cfg, plan):
    """The tp=1 plan whose ``init_params`` tree ``plan``'s ring serves:
    the same mode and dtypes, no mesh."""
    from repro_torch.compiler.mapper import plan_model
    return plan_model(cfg, None, (1,), plan.mode, esl_overlap=False,
                      remat=plan.remat, compute_dtype=plan.compute_dtype,
                      param_dtype=plan.param_dtype)


def init_shard(cfg, plan, rank, seed: int = 0, device=None) -> Params:
    """Rank ``rank``'s shard of the model ``cfg`` (any family) on
    ``plan``'s ring, drawn without the full tree.  ``rank`` is the rank's
    place on its ring: an int, or the rank's ring handle (a
    :class:`repro_torch.core.dist.SubRing` of a mesh fleet gives its
    place in its sub-ring, so every sub-ring draws the same replica): ``init_params(cfg,
    tp1_plan(cfg, plan), seed)``'s values drawn in its order
    (embeddings, positions, a vlm's projector, then layer after layer
    (whisper: the encoder's, its final norm, the decoder's), then the
    final norm), each part of a layer (an MoE's leaf by leaf) stored at
    the ring's layout and cut to the rank's slice as soon as it is
    drawn.  Bit-equal to ``shard_params(relayout(init_params(...)),
    plan, rank)``; the peak is the shard plus one part of a tp=1 layer
    (jamba's largest: an expert stack, drawn in f32, 3.8 GB).
    ``device``: ``cuda`` unless the caller asks for the CPU."""
    from repro_torch.device import dtype_of, resolve_device
    from repro_torch.models.common import _Init, draw_params
    rank = int(getattr(rank, "rank", rank))
    _check_ring_plan(plan, rank)
    plan1 = tp1_plan(cfg, plan)
    ini = _Init(seed, resolve_device(device), dtype_of(plan1.param_dtype))

    def keep(t, path):
        # a stacked layer's leaf is drawn without its layer axis
        stacked = path.split("/")[0] in _STACKS
        full = t.unsqueeze(0) if stacked else t
        out = shard_leaf(relayout_leaf(full, path, cfg, plan1, plan), path,
                         plan, rank)
        return out[0] if stacked else out
    if cfg.family == "encdec":
        from repro_torch.models.whisper import init_encdec
        return init_encdec(ini, cfg, plan1, keep)
    return draw_params(ini, cfg, plan1, keep)


def redraw(tree: Params, std: Dict[str, float], seed: int) -> None:
    """Refill in place every leaf of ``tree`` whose name is a key of
    ``std`` with N(0, std^2) drawn from a generator seeded ``seed`` on
    the leaves' device, leaf after leaf in the tree's order, each at its
    whole shape (a stacked leaf with its layer axis)."""
    g = None
    for path, t in _leaves(tree):
        name = path.rsplit("/", 1)[-1]
        if name in std:
            if g is None:
                g = torch.Generator(device=t.device).manual_seed(seed)
            t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                    * std[name])


def redraw_shard(shard: Params, cfg, plan, rank: int,
                 std: Dict[str, float], seed: int) -> None:
    """Refill rank ``rank``'s ``shard`` in place with its slice of what
    :func:`redraw` writes into the tp=1 tree: each named leaf drawn at
    its tp=1 shape in the same order (these leaves are vectors and the
    position table, small beside the shard), stored at the ring's layout
    and cut to the rank's slice."""
    plan1 = tp1_plan(cfg, plan)
    shapes = _expected_shapes(cfg, plan1)
    g = None
    for path, t in _leaves(shard):
        name = path.rsplit("/", 1)[-1]
        if name in std:
            if g is None:
                g = torch.Generator(device=t.device).manual_seed(seed)
            full = (torch.randn(shapes[path], generator=g, device=t.device)
                    * std[name]).to(t.dtype)
            t.copy_(shard_leaf(relayout_leaf(full, path, cfg, plan1, plan),
                               path, plan, rank))


def _leaves(tree: Params, path: str = ""):
    """(path, leaf) of a nested dict, in its order."""
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


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
