"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
vocab=65536, MoE 16 experts top-2, Mamba+attention 1:7 interleave.
[arXiv:2403.19887; hf]

Layer schedule (published): blocks of 8 layers -- attention at in-block
index 4, mamba elsewhere; MoE replaces the MLP on every other layer.
Sub-quadratic overall => runs the long_500k shape.
"""
from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=65_536,
    mlp_gated=True,
    activation="silu",
    norm="rmsnorm",
    positional="none",          # jamba uses no explicit positional encoding
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14_336, moe_every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=256,
                      attn_every=8, attn_offset=4),
    max_seq=524_288,
    shape_skips=(),             # hybrid: long_500k runs
    source="arXiv:2403.19887; hf",
)
