"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

One module per assigned architecture; each exposes ``CONFIG`` (the exact
published geometry) and ``SMOKE`` (a reduced same-family config for CPU
smoke tests).
"""

from __future__ import annotations

import importlib

from .base import ModelConfig, MoEConfig, RWKVConfig, SSMConfig

ARCHS = [
    "zamba2_1p2b",
    "rwkv6_1p6b",
    "command_r_plus_104b",
    "mistral_nemo_12b",
    "nemotron_4_340b",
    "starcoder2_15b",
    "deepseek_moe_16b",
    "granite_moe_3b_a800m",
    "llava_next_34b",
    "whisper_small",
]

# canonical ids as assigned (dashes) -> module names
ALIASES = {a.replace("_", "-").replace("-1p2b", "-1.2b").replace(
    "-1p6b", "-1.6b"): a for a in ARCHS}


def _module_for(arch: str):
    name = arch.replace("-", "_").replace(".", "p")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f".{name}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module_for(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module_for(arch).SMOKE


def list_archs() -> list[str]:
    return sorted(ALIASES)


__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "RWKVConfig",
    "get_config",
    "get_smoke_config",
    "list_archs",
    "ARCHS",
]
