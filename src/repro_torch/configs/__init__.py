"""Architecture config registry — only the architectures ported so far.

``get_config(arch_id)`` returns the full published config;
``get_reduced_config(arch_id)`` the small one the CPU tests use (2 layers,
d_model 128), both identical to the reference's.
"""
from __future__ import annotations

from repro_torch.configs import qwen2_7b
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen2-7b": qwen2_7b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r}; "
                       f"known: {sorted(_MODULES)}")
    return _MODULES[arch_id].CONFIG


def get_reduced_config(arch_id: str) -> ModelConfig:
    get_config(arch_id)
    return _MODULES[arch_id].reduced()


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "get_reduced_config"]
