"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152 -- llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.configs.base import ArchConfig, FULL_ATTN_SKIPS

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49_152,
    mlp_gated=True,
    activation="silu",
    norm="rmsnorm",
    positional="rope",
    tie_embeddings=True,
    shape_skips=FULL_ATTN_SKIPS,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)
