"""HyperDex-analog model & memory mapper (compilation layer), tp=1.

``plan_model(cfg, mesh_axes, mesh_shape, mode, ...)`` -> PhysicalPlan

The port of the JAX package's ``compiler/mapper.py`` without its
``jax.sharding`` rule table: only the single-device plan
(``mesh_axes=None``) is built here; the ring (tp > 1) arrives with the
tensor-parallel slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

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
               remat: str = "block",
               scan_unroll: bool = False,
               use_kernels: bool = False,
               compute_dtype: str = "bfloat16",
               param_dtype: Optional[str] = None) -> PhysicalPlan:
    """Derive the physical plan for (arch x single device x mode)."""
    if mesh_axes is not None:
        raise NotImplementedError(
            "plan_model: tensor parallelism (mesh_axes) arrives with the "
            "port's tp slice; only mesh_axes=None (tp=1) is supported")
    if cfg.family not in ("dense", "rwkv", "hybrid"):
        raise NotImplementedError(
            f"plan_model: family {cfg.family!r} arrives with its own "
            "slice of the port; dense, rwkv and hybrid stacks are planned "
            "here")
    if param_dtype is None:
        param_dtype = "float32" if mode == "train" else "bfloat16"
    tp = 1
    if cfg.family == "rwkv":
        # attention-free, but time-mix is head-structured: plan its heads
        attn = plan_attention(cfg.n_heads, cfg.n_heads, cfg.rwkv.head_dim, tp)
    else:
        attn = plan_attention(cfg.n_heads, cfg.n_kv_heads, cfg.d_head, tp)
    d_ff_padded = _ceil_to(cfg.d_ff, max(tp * 8, LANE))
    vocab_padded = _ceil_to(cfg.vocab_size, max(tp * LANE, LANE))
    moe_plan = None
    if cfg.moe is not None:
        # one device: no expert axes, every expert local, no FFN split
        e = cfg.moe.n_experts
        moe_plan = MoEPlan(
            n_experts=e, ep=1, ffn_split=1, experts_per_rank=e,
            d_ff_expert_shard=_ceil_to(cfg.moe.d_ff_expert, 8),
            expert_axes=(), capacity_factor=cfg.moe.capacity_factor)
    return PhysicalPlan(
        arch=cfg.name, mode=mode, mesh_axes=None, mesh_shape=(1,), tp=tp,
        tp_axis=None, dp_axes=(), fsdp_axes=(), attn=attn,
        d_ff_shard=d_ff_padded // tp, d_ff_padded=d_ff_padded,
        vocab_padded=vocab_padded, moe=moe_plan, esl_overlap=esl_overlap,
        esl_chunks=esl_chunks, remat=remat, scan_unroll=scan_unroll,
        use_kernels=use_kernels, compute_dtype=compute_dtype,
        param_dtype=param_dtype)
