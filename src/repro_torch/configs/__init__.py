"""Config registry of the port: ``get_config(name)`` / ``--arch <id>``.

Only the architectures whose family the port already serves are
registered; the other configs arrive with their family's slice.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import jamba_v01_52b, rwkv6_7b, smollm_135m
from repro_torch.configs.base import ArchConfig

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in [smollm_135m.CONFIG, rwkv6_7b.CONFIG,
                        jamba_v01_52b.CONFIG]}

ALIASES = {"smollm": "smollm-135m", "rwkv6": "rwkv6-7b",
           "jamba": "jamba-v0.1-52b"}


def get_config(name: str) -> ArchConfig:
    name = ALIASES.get(name, name)
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; the port knows {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ArchConfig", "REGISTRY", "get_config"]
