"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512,
vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, FULL_ATTN_SKIPS

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    mlp_gated=True,
    activation="silu",
    norm="rmsnorm",
    positional="rope",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512, moe_every=1),
    shape_skips=FULL_ATTN_SKIPS,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
