"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, vocab=202048, MoE 128 experts top-1 + shared expert, early
fusion.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, FULL_ATTN_SKIPS

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    mlp_gated=True,
    activation="silu",
    norm="rmsnorm",
    positional="rope",
    rope_theta=500_000.0,
    # interleaved expert layers (every other layer is MoE), as published for
    # Maverick -- this also lands the total at ~400B as the model id states.
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, moe_every=2,
                  n_shared_experts=1),
    shape_skips=FULL_ATTN_SKIPS,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
