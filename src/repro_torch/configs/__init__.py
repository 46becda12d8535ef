"""Config registry of the port: ``get_config(name)`` / ``--arch <id>``.

Every architecture of the reference's registry, under the reference's
names and aliases: the ten assigned ones (dense decoders, the MoE
stacks granite and llama4, the llava VLM, whisper's encoder-decoder,
the jamba hybrid and rwkv) and the paper's own OPT and GPT3-20B models.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_coder_33b, granite_moe_3b,
                                 jamba_v01_52b, llama4_maverick,
                                 llava_next_34b, minicpm_2b, opt, qwen15_4b,
                                 rwkv6_7b, smollm_135m, whisper_tiny)
from repro_torch.configs.base import ArchConfig

# the ten assigned architectures
ASSIGNED: Dict[str, ArchConfig] = {
    c.name: c for c in [
        whisper_tiny.CONFIG, qwen15_4b.CONFIG, deepseek_coder_33b.CONFIG,
        minicpm_2b.CONFIG, smollm_135m.CONFIG, llava_next_34b.CONFIG,
        granite_moe_3b.CONFIG, llama4_maverick.CONFIG, jamba_v01_52b.CONFIG,
        rwkv6_7b.CONFIG]}

# the paper's own evaluation models
PAPER_MODELS: Dict[str, ArchConfig] = {
    c.name: c for c in [opt.OPT_1_3B, opt.OPT_6_7B, opt.OPT_30B,
                        opt.OPT_66B, opt.GPT3_20B]}

REGISTRY: Dict[str, ArchConfig] = {**ASSIGNED, **PAPER_MODELS}

ALIASES = {"whisper-tiny": "whisper-tiny", "qwen": "qwen1.5-4b",
           "deepseek": "deepseek-coder-33b", "minicpm": "minicpm-2b",
           "smollm": "smollm-135m", "llava": "llava-next-34b",
           "granite": "granite-moe-3b-a800m",
           "llama4": "llama4-maverick-400b-a17b", "jamba": "jamba-v0.1-52b",
           "rwkv6": "rwkv6-7b"}


def get_config(name: str) -> ArchConfig:
    name = ALIASES.get(name, name)
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; the port knows {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ArchConfig", "ASSIGNED", "PAPER_MODELS", "REGISTRY",
           "get_config"]
