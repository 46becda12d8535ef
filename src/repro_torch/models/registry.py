"""Model registry: forward and cache constructors for the dense, rwkv
and hybrid (jamba) families.

``build_model(cfg, plan, device)`` returns a :class:`Model` — the port
of the reference's ``registry.Model`` for decoder-only dense stacks,
attention-free rwkv stacks and mamba/attention/MoE hybrids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.device import dtype_of
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import transformer as tf
from repro_torch.models.common import init_params

Params = Dict[str, Any]


@dataclass
class Model:
    cfg: Any
    plan: Any
    device: torch.device

    def init(self, seed: int = 0) -> Params:
        """Seeded random weights (see :func:`models.common.init_params`)."""
        return init_params(self.cfg, self.plan, seed, self.device)

    def forward(self, params: Params, tokens: torch.Tensor, *, mode: str,
                positions=None, cache=None, block_tables=None,
                paged_kernel: str = "stream", block_s: int = 0,
                use_kernels: bool = True):
        return tf.forward(params, tokens, cfg=self.cfg, plan=self.plan,
                          mode=mode, positions=positions, cache=cache,
                          block_tables=block_tables,
                          paged_kernel=paged_kernel, block_s=block_s,
                          use_kernels=use_kernels)

    def supports_paged_kv(self) -> bool:
        """Paged KV needs every layer to be attention (pure transformer):
        recurrent states (mamba/rwkv) are per slot, not per token."""
        cfg = self.cfg
        if cfg.family == "rwkv":
            return False
        return all(cfg.is_attention_layer(j)
                   for j in range(tf.super_block_size(cfg)))

    def init_cache(self, batch: int, max_seq: int, *,
                   dtype: Optional[torch.dtype] = None, paged: bool = False,
                   num_blocks: int = 0, block_size: int = 0) -> Params:
        """Zeroed cache stacked per super-block, one entry per in-block
        index: {"l{j}": {"k","v": (n_sb, ...)}} with the layer's dense or
        paged shape; for rwkv the recurrent state {"l0": {"shift_t",
        "shift_c": (n_sb, batch, 1, D), "wkv": (n_sb, batch, H, dh, dh)
        f32}}; for a hybrid stack, mamba indices hold {"conv": (n_sb,
        batch, K-1, d_in) in the cache dtype, "ssm": (n_sb, batch, d_in,
        N) f32}.  ``max_seq`` sizes only the dense k/v."""
        if paged and not self.supports_paged_kv():
            raise ValueError(f"{self.cfg.name}: paged KV needs an "
                             "attention-only stack")
        cfg, plan = self.cfg, self.plan
        dtype = dtype or dtype_of(plan.cache_dtype)
        meta = torch.device("meta")
        n_sb = tf.n_super_blocks(cfg)
        out = {}
        for j in range(tf.super_block_size(cfg)):
            if cfg.family == "rwkv":
                one = rwkv_mod.init_rwkv_state(cfg, plan, batch, dtype, meta)
            elif cfg.is_attention_layer(j):
                one = attn_mod.init_cache(plan, batch, max_seq, dtype, meta,
                                          paged=paged, num_blocks=num_blocks,
                                          block_size=block_size)
            else:
                one = mamba_mod.init_mamba_state(cfg, plan, batch, dtype,
                                                 meta)
            out[f"l{j}"] = {k: torch.zeros((n_sb,) + tuple(v.shape),
                                           dtype=v.dtype, device=self.device)
                            for k, v in one.items()}
        return out


def build_model(cfg, plan, device) -> Model:
    return Model(cfg=cfg, plan=plan, device=torch.device(device))
