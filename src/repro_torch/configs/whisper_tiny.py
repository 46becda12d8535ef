"""whisper-tiny [audio]: enc-dec transformer backbone, conv frontend stubbed.

4L decoder (+4L encoder), d_model=384, 6H MHA (kv=6), d_ff=1536,
vocab=51865.  [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig, FULL_ATTN_SKIPS

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    qkv_bias=True,              # whisper uses biased q/v projections
    mlp_gated=False,
    activation="gelu",
    norm="layernorm",
    positional="learned",
    tie_embeddings=True,
    max_seq=32_768,             # assigned shapes exceed the published 448 ctx
    encdec=EncDecConfig(n_enc_layers=4, enc_seq=1500, enc_causal=False),
    shape_skips=FULL_ATTN_SKIPS,
    source="arXiv:2212.04356; unverified",
)
