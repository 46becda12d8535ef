"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 -- llama-arch.  [arXiv:2401.14196; hf]
"""
from repro_torch.configs.base import ArchConfig, FULL_ATTN_SKIPS

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19_200,
    vocab_size=32_256,
    mlp_gated=True,
    activation="silu",
    norm="rmsnorm",
    positional="rope",
    rope_theta=100_000.0,
    shape_skips=FULL_ATTN_SKIPS,
    source="arXiv:2401.14196; hf",
)
