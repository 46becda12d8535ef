"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 -- anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Backbone only per assignment: the vision tower is a stub; ``input_specs()``
supplies precomputed patch embeddings that the projector maps to d_model.
"""
from repro_torch.configs.base import ArchConfig, VLMConfig, FULL_ATTN_SKIPS

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    mlp_gated=True,
    activation="silu",
    norm="rmsnorm",
    positional="rope",
    vlm=VLMConfig(n_patches=2880, patch_embed_dim=1024),
    shape_skips=FULL_ATTN_SKIPS,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
