"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936 -- QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import ArchConfig, FULL_ATTN_SKIPS

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
    mlp_gated=True,
    activation="silu",
    norm="rmsnorm",
    positional="rope",
    rope_theta=1_000_000.0,
    shape_skips=FULL_ATTN_SKIPS,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
