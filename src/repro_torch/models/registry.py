"""Model registry: forward and cache constructors for the dense and
rwkv families.

``build_model(cfg, plan, device)`` returns a :class:`Model` — the port
of the reference's ``registry.Model`` for decoder-only dense stacks and
attention-free rwkv stacks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.device import dtype_of
from repro_torch.models import attention as attn_mod
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
        an rwkv state is per slot, not per token."""
        return self.cfg.family == "dense" and self.cfg.moe is None

    def init_cache(self, batch: int, max_seq: int, *,
                   dtype: Optional[torch.dtype] = None, paged: bool = False,
                   num_blocks: int = 0, block_size: int = 0) -> Params:
        """Zeroed cache stacked per layer: {"l0": {"k","v": (n_layers,
        ...)}} with the layer's dense or paged shape, or for rwkv the
        recurrent state {"l0": {"shift_t","shift_c": (n_layers, batch, 1,
        D), "wkv": (n_layers, batch, H, dh, dh) f32}} (``max_seq`` unused)."""
        if paged and not self.supports_paged_kv():
            raise ValueError(f"{self.cfg.name}: paged KV needs an "
                             "attention-only stack")
        dtype = dtype or dtype_of(self.plan.cache_dtype)
        meta = torch.device("meta")
        if self.cfg.family == "rwkv":
            one = rwkv_mod.init_rwkv_state(self.cfg, self.plan, batch, dtype,
                                           meta)
        else:
            one = attn_mod.init_cache(self.plan, batch, max_seq, dtype, meta,
                                      paged=paged, num_blocks=num_blocks,
                                      block_size=block_size)
        n_sb = tf.n_super_blocks(self.cfg)
        return {"l0": {k: torch.zeros((n_sb,) + tuple(v.shape),
                                      dtype=v.dtype, device=self.device)
                       for k, v in one.items()}}


def build_model(cfg, plan, device) -> Model:
    return Model(cfg=cfg, plan=plan, device=torch.device(device))
