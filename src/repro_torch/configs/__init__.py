"""Configs of the port: `base` (copied whole), the paper's PCA and logistic
regression experiments, and the architecture registry: ``--arch <id>``
resolves through :func:`get_config`. Every architecture id of the reference
is known and resolves: the dense GQA, MLA, MoE and early-fusion families,
the SSD (`mamba2-2.7b`), RG-LRU hybrid (`recurrentgemma-9b`) and
encoder-decoder (`seamless-m4t-medium`) ones."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced  # noqa: F401

_ARCH_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "starcoder2-15b": "starcoder2_15b",
    "granite-8b": "granite_8b",
    "minicpm3-4b": "minicpm3_4b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "chameleon-34b": "chameleon_34b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mamba2-2.7b": "mamba2_2_7b",
}
_PORTED = ("granite-8b", "phi4-mini-3.8b", "starcoder2-15b", "chameleon-34b",
           "minicpm3-4b", "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
           "mamba2-2.7b", "recurrentgemma-9b", "seamless-m4t-medium")

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    if arch not in _PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; ported: {list(_PORTED)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG
