"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 -- Finch, data-dependent decay.  [arXiv:2404.05892; hf]

No KV cache: per-layer state is (heads, head_dim, head_dim) + shift
vectors => constant-memory decode; runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=64,                 # d_model / head_dim(64)
    n_kv_heads=0,               # attention-free
    d_ff=14_336,
    vocab_size=65_536,
    mlp_gated=False,            # rwkv channel-mix is its own structure
    activation="relu",          # channel-mix uses relu^2
    norm="layernorm",
    positional="none",
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, gate_lora=64),
    max_seq=524_288,
    shape_skips=(),
    source="arXiv:2404.05892; hf",
)
