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
leaves.  An MoE's experts are spread over the ring as the reference's
plan spreads them (``ep = gcd(E, tp)`` expert groups, each split into
``ffn_split`` column halves; the giant-MoE rule's data axis does not
exist on the serving ring, so its expert axes are ``("model",)`` too).
Data-parallel/FSDP axes (training on a mesh, and with them the giant
MoE's data x model experts) and KV sequence sharding are not in this
slice and raise.
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
    if seq_shard_kv or kv_seq_axis:
        raise NotImplementedError(
            "KV sequence sharding (seq_shard_kv / kv_seq_axis) is not "
            "ported yet")
    if mesh_axes is None:
        mesh_axes_t: Optional[Tuple[str, ...]] = None
        mesh_shape_t: Tuple[int, ...] = (1,)
        tp, tp_axis = 1, None
    else:
        mesh_axes_t = tuple(mesh_axes)
        mesh_shape_t = tuple(int(s) for s in mesh_shape)
        if mesh_axes_t != ("model",) or len(mesh_shape_t) != 1:
            raise NotImplementedError(
                f"mesh {mesh_axes_t}{mesh_shape_t}: the port's ring is the "
                "serving mesh ('model',) of shape (tp,); data-parallel and "
                "FSDP axes (training on a mesh) are not ported yet")
        tp, tp_axis = mesh_shape_t[0], "model"
        if tp < 1:
            raise ValueError(f"mesh_shape {mesh_shape_t}: tp must be >= 1")
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
        # the reference's rule: a giant MoE serves its experts over data
        # x model, any other over the model ring; the serving ring has
        # no data axis, so both give ("model",) there, and () on one
        # device
        expert_axes: Tuple[str, ...] = ("model",) if tp_axis else ()
        ep_width = tp if expert_axes else 1
        ep = math.gcd(e, ep_width) if ep_width > 1 else 1
        ffn_split = ep_width // ep if ep_width > 1 else 1
        dffe = _ceil_to(cfg.moe.d_ff_expert, max(ffn_split * 8, 8))
        moe_plan = MoEPlan(
            n_experts=e, ep=ep, ffn_split=ffn_split,
            experts_per_rank=e // ep,
            d_ff_expert_shard=dffe // max(ffn_split, 1),
            expert_axes=expert_axes,
            capacity_factor=cfg.moe.capacity_factor)
    rules = _rule_table(tp_axis, moe_plan) if mesh_axes_t else {}
    return PhysicalPlan(
        arch=cfg.name, mode=mode, mesh_axes=mesh_axes_t,
        mesh_shape=mesh_shape_t, tp=tp, tp_axis=tp_axis, dp_axes=(),
        fsdp_axes=(), attn=attn, d_ff_shard=d_ff_padded // tp,
        d_ff_padded=d_ff_padded, vocab_padded=vocab_padded, moe=moe_plan,
        esl_overlap=esl_overlap, esl_chunks=esl_chunks, remat=remat,
        scan_unroll=scan_unroll, use_kernels=use_kernels,
        compute_dtype=compute_dtype, param_dtype=param_dtype, rules=rules)


def _rule_table(tp_axis: Optional[str], moe_plan=None) -> Dict[Any, Any]:
    """logical axis -> mesh axis (None = replicated along that dim): the
    reference's ``_rule_table`` on the serving ring (no FSDP axes)."""
    rules: Dict[Any, Any] = {
        "embed": None,                 # FSDP shards it in training only
        "embed_scatter": tp_axis,      # d_model dims that live scattered
        "vec": tp_axis,                # rank-local vector params (norms)
        "vocab_rep": None,             # untied input-embedding rows
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
