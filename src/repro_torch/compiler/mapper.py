"""HyperDex-analog model & memory mapper (compilation layer).

``plan_model(cfg, mesh_axes, mesh_shape, mode, ...)`` -> PhysicalPlan

The port of the JAX package's ``compiler/mapper.py``: the single-device
plan (``mesh_axes=None``) for every family, and the plan of the serving
ring (``mesh_axes=("model",)``, ``mesh_shape=(tp,)``): head-wise
attention tiles (padded kv heads, or kv heads duplicated when there are
fewer than ranks), column-wise FFN tiles padded to ``tp * 8``, the
vocabulary padded to ``tp * 128``, and the reference's rule table
mapping each logical parameter axis to the ring (``rules``), which
:func:`repro_torch.weights.shard_params` reads to slice a rank's
leaves.  An MoE's experts are spread as the reference's plan spreads
them: ``ep = gcd(E, W)`` expert groups, each split into ``ffn_split``
column parts, over the model ring (W = tp), or, for a giant MoE served
on a ``("data", "model")`` grid (``total_params * 2 > 12e9 * tp``),
over data x model (W = dwidth * tp).

On the grid (``mesh_axes=("data", "model")``, ``mesh_shape=(dwidth,
tp)``) a serving plan splits the batch over ``data`` (``dp_axes``; the
weights are replicated over it) and carries ``kv_seq_axis`` and
``seq_shard_kv`` (a hybrid's KV sequence sharded over ``data`` for long
context, :func:`plan_for_cell`).  A train plan on the grid shards every
parameter over ``data`` as well (ZeRO-3, ``fsdp_axes=("data",)``: the
rule table maps the ``"embed"`` and ``"vocab_rep"`` dims to it), as the
reference's does.  A pod axis raises.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.compiler.plan import (MoEPlan, PhysicalPlan, _ceil_to,
                                       plan_attention)
from repro_torch.configs.base import ArchConfig

LANE = 128  # padding unit of d_ff / vocab (kept so plans match the reference)


def plan_model(cfg: ArchConfig,
               mesh_axes: Optional[Sequence[str]],
               mesh_shape: Sequence[int],
               mode: str,
               *,
               esl_overlap: bool = True,
               esl_chunks: int = 4,
               seq_shard_kv: bool = False,
               kv_seq_axis: Optional[str] = None,
               remat: str = "block",
               scan_unroll: bool = False,
               use_kernels: bool = False,
               compute_dtype: str = "bfloat16",
               param_dtype: Optional[str] = None) -> PhysicalPlan:
    """Derive the physical plan for (arch x mesh x mode)."""
    if cfg.family not in ("dense", "moe", "vlm", "encdec", "rwkv",
                          "hybrid"):
        raise ValueError(f"plan_model: unknown family {cfg.family!r}")
    if mesh_axes is None:
        mesh_axes_t: Optional[Tuple[str, ...]] = None
        mesh_shape_t: Tuple[int, ...] = (1,)
        tp, tp_axis = 1, None
        dp_axes: Tuple[str, ...] = ()
    else:
        mesh_axes_t = tuple(mesh_axes)
        mesh_shape_t = tuple(int(s) for s in mesh_shape)
        if mesh_axes_t not in (("model",), ("data", "model")) or \
                len(mesh_shape_t) != len(mesh_axes_t):
            raise NotImplementedError(
                f"mesh {mesh_axes_t}{mesh_shape_t}: the port's meshes are "
                "the serving ring ('model',) of shape (tp,) and the grid "
                "('data', 'model') of shape (dwidth, tp); a pod axis is "
                "not ported")
        if min(mesh_shape_t) < 1:
            raise ValueError(f"mesh_shape {mesh_shape_t}: every axis must "
                             "be >= 1")
        sizes = dict(zip(mesh_axes_t, mesh_shape_t))
        tp, tp_axis = sizes["model"], "model"
        dp_axes = tuple(a for a in mesh_axes_t if a != "model")
    # ZeRO-3: shard params over every non-model axis during training
    fsdp_axes = dp_axes if mode == "train" else ()
    if param_dtype is None:
        param_dtype = "float32" if mode == "train" else "bfloat16"
    if cfg.family == "rwkv":
        # attention-free, but time-mix is head-structured: plan its heads
        attn = plan_attention(cfg.n_heads, cfg.n_heads, cfg.rwkv.head_dim, tp)
    else:
        attn = plan_attention(cfg.n_heads, cfg.n_kv_heads, cfg.d_head, tp)
    d_ff_padded = _ceil_to(cfg.d_ff, max(tp * 8, LANE))
    vocab_padded = _ceil_to(cfg.vocab_size, max(tp * LANE, LANE))
    moe_plan = None
    if cfg.moe is not None:
        e = cfg.moe.n_experts
        if mode == "serve" and cfg.total_params() * 2 > 12e9 * tp:
            # giant MoE serving (llama4, jamba): experts over data x model
            # so the weights fit; attention stays model-parallel
            expert_axes: Tuple[str, ...] = tuple(
                a for a in ("data", "model")
                if mesh_axes_t and a in mesh_axes_t)
        else:
            expert_axes = ("model",) if tp_axis else ()
        ep_width = 1
        for a in expert_axes:
            ep_width *= dict(zip(mesh_axes_t, mesh_shape_t))[a]
        ep = math.gcd(e, ep_width) if ep_width > 1 else 1
        ffn_split = ep_width // ep if ep_width > 1 else 1
        dffe = _ceil_to(cfg.moe.d_ff_expert, max(ffn_split * 8, 8))
        moe_plan = MoEPlan(
            n_experts=e, ep=ep, ffn_split=ffn_split,
            experts_per_rank=e // ep,
            d_ff_expert_shard=dffe // max(ffn_split, 1),
            expert_axes=expert_axes,
            capacity_factor=cfg.moe.capacity_factor)
    rules = _rule_table(tp_axis, fsdp_axes, moe_plan) if mesh_axes_t else {}
    return PhysicalPlan(
        arch=cfg.name, mode=mode, mesh_axes=mesh_axes_t,
        mesh_shape=mesh_shape_t, tp=tp, tp_axis=tp_axis, dp_axes=dp_axes,
        fsdp_axes=fsdp_axes, attn=attn, d_ff_shard=d_ff_padded // tp,
        d_ff_padded=d_ff_padded, vocab_padded=vocab_padded, moe=moe_plan,
        esl_overlap=esl_overlap, esl_chunks=esl_chunks,
        seq_shard_kv=seq_shard_kv, kv_seq_axis=kv_seq_axis, remat=remat,
        scan_unroll=scan_unroll, use_kernels=use_kernels,
        compute_dtype=compute_dtype, param_dtype=param_dtype, rules=rules)


def _rule_table(tp_axis: Optional[str], fsdp_axes=(),
                moe_plan=None) -> Dict[Any, Any]:
    """logical axis -> mesh axes (None = replicated along that dim): the
    reference's ``_rule_table``."""
    fsdp = tuple(fsdp_axes) if fsdp_axes else None
    rules: Dict[Any, Any] = {
        "embed": fsdp,                 # FSDP shards the d_model dim in train
        "embed_scatter": tp_axis,      # d_model dims that live scattered
        "vec": tp_axis,                # rank-local vector params (norms)
        "vocab_rep": fsdp,             # untied input-embedding rows
        "q_heads": tp_axis,
        "kv_heads": tp_axis,
        "head_dim": None,
        "ffn": tp_axis,
        "vocab": tp_axis,
        "layers": None,
        "pos": None,
        "conv": None,
        "state": None,
        "lora": None,
        "dt": None,
        "mamba_inner": tp_axis,        # mamba d_inner: column tiles
        "rwkv_heads": tp_axis,
        "patches": None,
        None: None,
    }
    if moe_plan is not None:
        rules["experts"] = tuple(moe_plan.expert_axes) or None
        rules["expert_ffn"] = None     # split factor folded into experts
    return rules


def summarize(plan) -> Dict[str, Any]:
    """The mapper's decisions in a few fields (the reference's
    ``summarize``): the padded widths, the head layout and, for an MoE,
    its expert parallelism."""
    out: Dict[str, Any] = {
        "arch": plan.arch, "mode": plan.mode, "tp": plan.tp,
        "d_ff_padded": plan.d_ff_padded, "vocab_padded": plan.vocab_padded,
        "esl_overlap": plan.esl_overlap,
    }
    if plan.attn:
        a = plan.attn
        out.update({
            "kv_shards": a.kv_shards, "dup": a.dup,
            "q_per_rank": a.q_per_rank, "kv_per_rank": a.kv_per_rank,
            "stored_q": a.hp, "stored_kv": a.gp,
            "q_pad_waste": round(a.waste_q, 3),
            "kv_storage_x": round(a.kv_storage_factor, 3),
        })
    if plan.moe:
        m = plan.moe
        out.update({"ep": m.ep, "ffn_split": m.ffn_split,
                    "experts_per_rank": m.experts_per_rank,
                    "expert_axes": m.expert_axes})
    return out


def plan_for_cell(cfg: ArchConfig, shape, mesh_axes, mesh_shape, *,
                  esl_overlap: bool = True, remat: str = "block",
                  seq_shard_kv: bool = False) -> PhysicalPlan:
    """The reference's ``launch/dryrun.py`` ``plan_for_cell`` without its
    lowering: a train cell plans for training, any other for serving; a
    hybrid at the ``long_500k`` decode cell shards its KV sequence over
    ``data``; decode cells plan in f32."""
    mode = "train" if shape.kind == "train" else "serve"
    kv_seq_axis = None
    if (shape.name == "long_500k" and cfg.family in ("hybrid",)
            and shape.kind == "decode"):
        kv_seq_axis = "data"          # sequence-parallel KV (flash-decode)
    dtypes = {}
    if shape.kind == "decode":
        dtypes = dict(compute_dtype="float32", param_dtype="float32")
    return plan_model(cfg, mesh_axes, mesh_shape, mode,
                      esl_overlap=esl_overlap, remat=remat,
                      seq_shard_kv=seq_shard_kv, kv_seq_axis=kv_seq_axis,
                      **dtypes)
