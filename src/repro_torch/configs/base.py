"""Architecture + shape configuration system (a copy of the JAX
package's ``configs/base.py``; the port imports nothing from it).

Every selectable architecture (``--arch <id>``) is described by an
:class:`ArchConfig`.  The config is *logical*: it records the published
model dimensions exactly.  The HyperDex-analog mapper
(:mod:`repro_torch.compiler.mapper`) derives the *physical* (padded,
sharded) configuration from it.

Shapes (``--shape <id>``) are the assigned (seq_len, global_batch, kind)
cells.  ``kind`` decides which program is lowered:

* ``train``   -> ``train_step``   (fwd + bwd + optimizer update)
* ``prefill`` -> ``prefill_step`` (summarization stage, KV-cache build)
* ``decode``  -> ``serve_step``   (generation stage: 1 new token against a
  KV cache of ``seq_len`` — the LPU's target regime)
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


# --------------------------------------------------------------------------
# Shapes
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# --------------------------------------------------------------------------
# Architecture config
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # 1 => every layer is MoE; 2 => every other layer (jamba), etc.
    moe_every: int = 1
    n_shared_experts: int = 0
    router_jitter: float = 0.0
    capacity_factor: float = 2.0


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 256
    # in a hybrid stack: one attention layer per `attn_every` layers
    # (jamba: 1:7 => attn_every=8, attention at layer index `attn_offset`)
    attn_every: int = 8
    attn_offset: int = 4


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64   # low-rank dim of the data-dependent decay (w) path
    mix_lora: int = 32     # low-rank dim of token-shift mixing lerps
    gate_lora: int = 64


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 4
    enc_seq: int = 1500      # whisper: 30 s of audio -> 1500 frames
    enc_causal: bool = False


@dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 2880    # anyres: base 576 + 4 tiles * 576
    patch_embed_dim: int = 1024  # raw vision-tower output fed to projector


@dataclass(frozen=True)
class ArchConfig:
    """Logical (published) architecture description."""

    name: str
    family: str                 # dense | moe | hybrid | rwkv | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # derived if 0
    qkv_bias: bool = False
    mlp_gated: bool = True      # SwiGLU-style (llama family) vs plain 2-mat
    activation: str = "silu"    # silu | gelu | relu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    positional: str = "rope"    # rope | learned | none (rwkv)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    max_seq: int = 32_768
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # which assigned shapes this arch supports (full-attention archs skip
    # long_500k; encoder-only archs would skip decode -- none assigned here)
    shape_skips: Tuple[str, ...] = ()
    source: str = ""

    # ---- derived ---------------------------------------------------------

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads > 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "rwkv"

    @property
    def group_size(self) -> int:
        """GQA group size (#query heads sharing one KV head)."""
        if self.n_kv_heads == 0:
            return 1
        return max(1, self.n_heads // self.n_kv_heads)

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return layer_idx % self.moe.moe_every == (self.moe.moe_every - 1)

    def is_attention_layer(self, layer_idx: int) -> bool:
        """Hybrid stacks (jamba) interleave attention among mamba layers."""
        if self.family != "hybrid" or self.mamba is None:
            return not self.attention_free
        m = self.mamba
        return layer_idx % m.attn_every == m.attn_offset

    # ---- parameter counting (used by roofline + latency model) -----------

    def attn_params(self) -> int:
        if self.n_heads == 0:
            return 0
        q = self.d_model * self.n_heads * self.d_head
        kv = 2 * self.d_model * self.n_kv_heads * self.d_head
        o = self.n_heads * self.d_head * self.d_model
        b = (self.n_heads + 2 * self.n_kv_heads) * self.d_head if self.qkv_bias else 0
        return q + kv + o + b

    def mlp_params(self, d_ff: Optional[int] = None) -> int:
        dff = self.d_ff if d_ff is None else d_ff
        n_mat = 3 if self.mlp_gated else 2
        return n_mat * self.d_model * dff

    def mamba_params(self) -> int:
        if self.mamba is None:
            return 0
        m = self.mamba
        d_in = m.expand * self.d_model
        in_proj = self.d_model * 2 * d_in
        conv = d_in * m.d_conv
        x_proj = d_in * (m.dt_rank + 2 * m.d_state)
        dt_proj = m.dt_rank * d_in
        a_d = d_in * m.d_state + d_in
        out_proj = d_in * self.d_model
        return in_proj + conv + x_proj + dt_proj + a_d + out_proj

    def rwkv_params(self) -> int:
        if self.rwkv is None:
            return 0
        r = self.rwkv
        # time-mix: r,k,v,g,o square mats + low-rank decay/mix paths
        tm = 5 * self.d_model * self.d_model
        tm += 2 * self.d_model * r.decay_lora          # w lora
        tm += 5 * 2 * self.d_model * r.mix_lora        # token-shift loras
        # channel-mix: two mats (d_model x d_ff) + (d_ff x d_model)
        cm = 2 * self.d_model * self.d_ff
        return tm + cm

    def layer_params(self, layer_idx: int) -> int:
        """Parameters of decoder layer `layer_idx` (norms excluded, ~0)."""
        if self.family == "rwkv":
            return self.rwkv_params()
        if self.family == "hybrid":
            core = (self.attn_params() if self.is_attention_layer(layer_idx)
                    else self.mamba_params())
        else:
            core = self.attn_params()
        if self.is_moe_layer(layer_idx):
            moe = self.moe
            router = self.d_model * moe.n_experts
            experts = moe.n_experts * self.mlp_params(moe.d_ff_expert)
            shared = moe.n_shared_experts * self.mlp_params(moe.d_ff_expert)
            return core + router + experts + shared
        return core + self.mlp_params()

    def active_layer_params(self, layer_idx: int) -> int:
        """Per-token *activated* parameters (MoE: top_k experts only)."""
        if self.family == "rwkv":
            return self.rwkv_params()
        if self.family == "hybrid":
            core = (self.attn_params() if self.is_attention_layer(layer_idx)
                    else self.mamba_params())
        else:
            core = self.attn_params()
        if self.is_moe_layer(layer_idx):
            moe = self.moe
            router = self.d_model * moe.n_experts
            act = (moe.top_k + moe.n_shared_experts) * self.mlp_params(moe.d_ff_expert)
            return core + router + act
        return core + self.mlp_params()

    def embed_params(self) -> int:
        pos = self.max_seq * self.d_model if self.positional == "learned" else 0
        n = self.vocab_size * self.d_model + pos
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        return n

    def encoder_params(self) -> int:
        if self.encdec is None:
            return 0
        per = self.attn_params() + self.mlp_params()
        # decoder cross-attention adds one more attention block per dec layer
        cross = self.n_layers * self.attn_params()
        return self.encdec.n_enc_layers * per + cross

    def total_params(self) -> int:
        body = sum(self.layer_params(i) for i in range(self.n_layers))
        return body + self.embed_params() + self.encoder_params()

    def active_params(self) -> int:
        body = sum(self.active_layer_params(i) for i in range(self.n_layers))
        return body + self.embed_params() + self.encoder_params()

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes appended per generated token (all layers)."""
        if self.attention_free:
            return 0
        n_attn = sum(1 for i in range(self.n_layers) if self.is_attention_layer(i))
        return n_attn * 2 * self.n_kv_heads * self.d_head * dtype_bytes

    def supports_shape(self, shape_name: str) -> bool:
        return shape_name not in self.shape_skips

    # ---- smoke-test reduction --------------------------------------------

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes: dict = dict(
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 8),
            d_model=128,
            d_ff=256,
            vocab_size=512,
            max_seq=128,
            d_head=32,
        )
        if self.family == "rwkv":
            # heads = d_model / head_dim must hold at any tp
            changes["n_heads"] = changes["d_model"] // 32
            changes["n_kv_heads"] = 0
            changes["d_head"] = 32
        elif self.n_heads > 0:
            # preserve the GQA *ratio* so the mapper path is exercised
            g = max(1, self.group_size)
            changes["n_kv_heads"] = max(1, min(self.n_kv_heads, 2))
            changes["n_heads"] = changes["n_kv_heads"] * g
            changes["d_head"] = 128 // max(changes["n_heads"], 4) * 2 or 16
            changes["d_head"] = max(16, min(32, changes["d_head"]))
        if self.moe is not None:
            # capacity 8x: smoke tests assert exact train/decode parity,
            # so the reduced config must never drop a token
            changes["moe"] = replace(
                self.moe, n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2), d_ff_expert=128,
                capacity_factor=8.0)
        if self.mamba is not None:
            changes["mamba"] = replace(
                self.mamba, d_state=8, dt_rank=16,
                attn_every=4, attn_offset=2)
            changes["n_layers"] = 8
        if self.rwkv is not None:
            changes["rwkv"] = replace(
                self.rwkv, head_dim=32, decay_lora=16, mix_lora=8,
                gate_lora=16)
            changes["n_layers"] = 2
        if self.encdec is not None:
            changes["encdec"] = replace(self.encdec, n_enc_layers=2, enc_seq=16)
        if self.vlm is not None:
            changes["vlm"] = replace(self.vlm, n_patches=8, patch_embed_dim=64)
        return replace(self, name=self.name + "-reduced", **changes)


# shapes skipped by pure full-attention archs (quadratic 512k decode)
FULL_ATTN_SKIPS = ("long_500k",)
