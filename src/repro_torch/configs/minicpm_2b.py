"""minicpm-2b [dense]: 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753 -- WSD schedule (arch=llama-like).  [arXiv:2404.06395; hf]

The WSD (warmup-stable-decay) schedule belongs to training, which the
port has not reached yet; the name is kept as the reference records it.
"""
from repro_torch.configs.base import ArchConfig, FULL_ATTN_SKIPS

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    mlp_gated=True,
    activation="silu",
    norm="rmsnorm",
    positional="rope",
    tie_embeddings=True,
    shape_skips=FULL_ATTN_SKIPS,
    source="arXiv:2404.06395; hf",
)

TRAIN_SCHEDULE = "wsd"
