"""Model registry: forward and cache constructors for every family.

``build_model(cfg, plan, device)`` returns a :class:`Model` — the port
of the reference's ``registry.Model``: decoder-only dense, MoE and vlm
stacks, attention-free rwkv stacks and mamba/attention/MoE hybrids
(:mod:`repro_torch.models.transformer`), and whisper's encoder-decoder
(:mod:`repro_torch.models.whisper`).
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
from repro_torch.models import whisper as wh
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
                use_kernels: bool = True, kv_valid_len=None, frames=None,
                patch_embeds=None, with_aux: bool = False, env=None,
                gather_fn=None):
        """(logits, cache).  ``frames`` feed whisper's encoder (train and
        prefill), ``patch_embeds`` a vlm's projector.  ``with_aux``
        (which only the train step passes) returns (logits, cache, aux),
        the MoE layers' auxiliary loss summed over the stack (a float32
        zero for a family without MoE layers).  ``env``: the rank's
        :class:`repro_torch.core.dist.AxisEnv` on the model ring (every
        family), with the rank's shards and cache; the logits are then
        its V_pad/tp columns.  ``gather_fn(group, subtree)`` (the train
        step's) gathers FSDP-sharded parameters where the reference's
        forward calls it."""
        if self.cfg.family == "encdec":
            if block_s:
                raise ValueError(
                    "block_s override is not supported for encdec decode "
                    "(no paged/flash-chunk seam to tune)")
            if mode in ("chunk_prefill", "verify"):
                raise ValueError(f"mode={mode!r} needs the paged pool; "
                                 "encdec has no paged cache")
            return wh.forward_encdec(params, tokens, cfg=self.cfg,
                                     plan=self.plan, mode=mode,
                                     frames=frames, positions=positions,
                                     cache=cache, with_aux=with_aux,
                                     env=env, gather_fn=gather_fn)
        return tf.forward(params, tokens, cfg=self.cfg, plan=self.plan,
                          mode=mode, positions=positions, cache=cache,
                          block_tables=block_tables,
                          paged_kernel=paged_kernel, block_s=block_s,
                          use_kernels=use_kernels,
                          kv_valid_len=kv_valid_len,
                          patch_embeds=patch_embeds, with_aux=with_aux,
                          env=env, gather_fn=gather_fn)

    def supports_paged_kv(self) -> bool:
        """Paged KV needs every layer to be attention (pure transformer):
        recurrent states (mamba/rwkv) are per slot, not per token, and
        an encoder-decoder's cache holds the cross K/V per slot."""
        cfg = self.cfg
        if cfg.family in ("rwkv", "encdec"):
            return False
        return all(cfg.is_attention_layer(j)
                   for j in range(tf.super_block_size(cfg)))

    def init_cache(self, batch: int, max_seq: int, *,
                   dtype: Optional[torch.dtype] = None, paged: bool = False,
                   num_blocks: int = 0, block_size: int = 0,
                   scale_dtype: Optional[torch.dtype] = None,
                   env=None) -> Params:
        """Zeroed cache stacked per super-block, one entry per in-block
        index: {"l{j}": {"k","v": (n_sb, ...)}} with the layer's dense or
        paged shape (one rank's: its kv_per_rank heads); for rwkv the recurrent state {"l0": {"shift_t",
        "shift_c": (n_sb, batch, 1, D), "wkv": (n_sb, batch, H, dh, dh)
        f32}}; for a hybrid stack, mamba indices hold {"conv": (n_sb,
        batch, K-1, d_in) in the cache dtype, "ssm": (n_sb, batch, d_in,
        N) f32} (on the ring one rank's: H its heads, d_in its channels,
        D its channels under ESL overlap); for an encoder-decoder
        {"k","v": (L, batch, max_seq, kpr, dh), "ck","cv": (L, batch,
        enc_seq, kpr, dh)}, kpr the rank's kv heads
        (:func:`repro_torch.models.whisper.init_encdec_cache`).
        ``max_seq`` sizes only the dense k/v.  ``scale_dtype``
        (paged only) makes the pool an int8/fp8 one: ``dtype`` is its
        storage type and each attention layer gains zeroed ``k_scale``/
        ``v_scale`` leaves (n_sb, N, bs, Gp).

        ``env`` (the rank's :class:`repro_torch.core.dist.AxisEnv` on a
        ``("data", "model")`` grid) gives the rank's cache
        (:meth:`cache_specs`): ``batch`` is the global batch, of which a
        rank holds its data row's ``batch / dwidth`` rows when the batch
        is split over ``data`` (every cache, the recurrent states too),
        and a dense k/v whose sequence is sharded over ``kv_seq_axis``
        holds (batch, 1, max_seq / width, kpr, dh)."""
        if paged and not self.supports_paged_kv():
            raise ValueError(f"{self.cfg.name}: paged KV needs an "
                             "attention-only stack")
        cfg, plan = self.cfg, self.plan
        dtype = dtype or dtype_of(plan.cache_dtype)
        kv_w = 1
        if env is not None:
            if batch % env.dp_width:
                raise ValueError(f"a batch of {batch} does not split over "
                                 f"{env.dp_width} data rows")
            batch //= env.dp_width
            kv_w = env.kv_seq_width
        if cfg.family == "encdec":
            return wh.init_encdec_cache(cfg, plan, batch, max_seq, dtype,
                                        self.device)
        meta = torch.device("meta")
        n_sb = tf.n_super_blocks(cfg)
        out = {}
        for j in range(tf.super_block_size(cfg)):
            if cfg.family == "rwkv":
                one = rwkv_mod.init_rwkv_state(cfg, plan, batch, dtype, meta)
            elif cfg.is_attention_layer(j):
                one = attn_mod.init_cache(plan, batch, max_seq, dtype, meta,
                                          paged=paged, num_blocks=num_blocks,
                                          block_size=block_size,
                                          scale_dtype=scale_dtype,
                                          kv_seq_width=kv_w)
            else:
                one = mamba_mod.init_mamba_state(cfg, plan, batch, dtype,
                                                 meta)
            out[f"l{j}"] = {k: torch.zeros((n_sb,) + tuple(v.shape),
                                           dtype=v.dtype, device=self.device)
                            for k, v in one.items()}
        return out


    def cache_specs(self, env, paged: bool = False,
                    kv_quant: bool = False) -> Params:
        """The mesh axes of every dim of :meth:`init_cache`'s leaves (the
        reference's ``cache_specs``, a tuple per leaf where it has a
        ``PartitionSpec``): the batch dim on ``env.dp``, the stored kv
        heads, mamba channels and rwkv heads on ``model``, a sharded KV
        sequence on ``env.kv_seq_axis``; the rank holds its block of each
        named dim."""
        cfg, plan = self.cfg, self.plan
        dp = tuple(env.dp) if env.dp else None
        m = plan.tp_axis
        scat = m if plan.esl_overlap else None
        kv_w = plan_kv_seq_width(plan)
        if cfg.family == "encdec":
            kv = (None, dp, None, m, None)
            return {"k": kv, "v": kv, "ck": kv, "cv": kv}
        out = {}
        for j in range(tf.super_block_size(cfg)):
            if cfg.family == "rwkv":
                out[f"l{j}"] = {"shift_t": (None, dp, None, scat),
                                "shift_c": (None, dp, None, scat),
                                "wkv": (None, dp, m, None, None)}
            elif cfg.is_attention_layer(j):
                if paged:
                    out[f"l{j}"] = {"k": (None, None, None, m, None),
                                    "v": (None, None, None, m, None)}
                    if kv_quant:
                        out[f"l{j}"]["k_scale"] = (None, None, None, m)
                        out[f"l{j}"]["v_scale"] = (None, None, None, m)
                elif kv_w > 1:
                    kv = (None, dp, env.kv_seq_axis, None, m, None)
                    out[f"l{j}"] = {"k": kv, "v": kv}
                else:
                    out[f"l{j}"] = {"k": (None, dp, None, m, None),
                                    "v": (None, dp, None, m, None)}
            else:
                out[f"l{j}"] = {"conv": (None, dp, None, m),
                                "ssm": (None, dp, m, None)}
        return out


def plan_kv_seq_width(plan) -> int:
    """Ranks the plan's KV sequence is sharded over (1 without
    ``kv_seq_axis``)."""
    if getattr(plan, "kv_seq_axis", None):
        return dict(zip(plan.mesh_axes, plan.mesh_shape))[plan.kv_seq_axis]
    return 1


def build_model(cfg, plan, device) -> Model:
    return Model(cfg=cfg, plan=plan, device=torch.device(device))
