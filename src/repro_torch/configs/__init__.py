"""Config registry of the port: ``get_config(name)`` / ``--arch <id>``.

Only the architectures whose family the port already serves are
registered (the dense decoders, among them the paper's own OPT and
GPT3-20B models, rwkv and the jamba hybrid); the other configs arrive
with their family's slice.  Names and aliases are the reference's.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_coder_33b, jamba_v01_52b,
                                 minicpm_2b, opt, qwen15_4b, rwkv6_7b,
                                 smollm_135m)
from repro_torch.configs.base import ArchConfig

# the paper's own evaluation models
PAPER_MODELS: Dict[str, ArchConfig] = {
    c.name: c for c in [opt.OPT_1_3B, opt.OPT_6_7B, opt.OPT_30B,
                        opt.OPT_66B, opt.GPT3_20B]}

REGISTRY: Dict[str, ArchConfig] = {
    **{c.name: c for c in [qwen15_4b.CONFIG, deepseek_coder_33b.CONFIG,
                           minicpm_2b.CONFIG, smollm_135m.CONFIG,
                           jamba_v01_52b.CONFIG, rwkv6_7b.CONFIG]},
    **PAPER_MODELS}

ALIASES = {"qwen": "qwen1.5-4b", "deepseek": "deepseek-coder-33b",
           "minicpm": "minicpm-2b", "smollm": "smollm-135m",
           "rwkv6": "rwkv6-7b", "jamba": "jamba-v0.1-52b"}


def get_config(name: str) -> ArchConfig:
    name = ALIASES.get(name, name)
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; the port knows {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ArchConfig", "PAPER_MODELS", "REGISTRY", "get_config"]
