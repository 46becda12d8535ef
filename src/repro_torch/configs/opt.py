"""The paper's own evaluation models: OPT 1.3B/6.7B/30B/66B + GPT3-20B.

These drive the paper-reproduction benchmarks (Fig. 2a bandwidth, Fig. 7a
latency, Fig. 7b efficiency, Fig. 7c scalability).  Dims from Zhang et al.,
"OPT: Open Pre-trained Transformer Language Models" (arXiv:2205.01068);
GPT3-20B matches the NVIDIA FasterTransformer benchmark model.
"""
from repro_torch.configs.base import ArchConfig, FULL_ATTN_SKIPS


def _opt(name, n_layers, d_model, n_heads, d_ff):
    return ArchConfig(
        name=name,
        family="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        d_ff=d_ff,
        vocab_size=50_272,
        qkv_bias=True,
        mlp_gated=False,
        activation="relu",
        norm="layernorm",
        positional="learned",
        tie_embeddings=True,        # OPT ties input/output embeddings
        max_seq=2048,
        shape_skips=FULL_ATTN_SKIPS,
        source="arXiv:2205.01068; hf",
    )


OPT_1_3B = _opt("opt-1.3b", 24, 2048, 32, 8192)
OPT_6_7B = _opt("opt-6.7b", 32, 4096, 32, 16_384)
OPT_30B = _opt("opt-30b", 48, 7168, 56, 28_672)
OPT_66B = _opt("opt-66b", 64, 9216, 72, 36_864)

GPT3_20B = ArchConfig(
    name="gpt3-20b",
    family="dense",
    n_layers=44,
    d_model=6144,
    n_heads=48,
    n_kv_heads=48,
    d_ff=24_576,
    vocab_size=51_200,
    qkv_bias=True,
    mlp_gated=False,
    activation="gelu",
    norm="layernorm",
    positional="learned",
    max_seq=2048,
    shape_skips=FULL_ATTN_SKIPS,
    source="NVIDIA FasterTransformer GPT benchmark; unverified",
)
