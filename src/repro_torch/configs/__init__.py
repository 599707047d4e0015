"""Architecture config registry — the architectures ported so far.

``get_config(arch_id)`` returns the full published config;
``get_reduced_config(arch_id)`` the small one the CPU tests use (2 to 4
layers, d_model 128 or 144), both identical to the reference's.  Ported: the dense
``qwen2-7b``, ``yi-6b``, ``h2o-danube-3-4b`` (sliding window) and
``minicpm-2b`` (tied head), the VLM backbone ``qwen2-vl-2b`` (M-RoPE, a
stubbed vision prefix), the attention-free ``mamba2-370m`` and
``rwkv6-7b``, the hybrid ``zamba2-1.2b`` (mamba2 layers and one shared
attention block) and the encoder-decoder ``whisper-small`` (a stubbed
audio frontend) and the MoE ``qwen3-moe-235b-a22b`` (128 experts, top 8)
and ``llama4-maverick-400b-a17b`` (a dense and a MoE layer per unit, top 1
and a shared expert).  Every architecture of the reference is ported:
``NOT_PORTED`` is empty.
"""
from __future__ import annotations

from repro_torch.configs import (h2o_danube3_4b, llama4_maverick_400b_a17b,
                                 mamba2_370m, minicpm_2b, qwen2_7b,
                                 qwen2_vl_2b, qwen3_moe_235b_a22b, rwkv6_7b,
                                 whisper_small, yi_6b, zamba2_1_2b)
from repro_torch.configs.base import (SHAPE_BY_NAME, SHAPES, InputShape,
                                      ModelConfig)

_MODULES = {
    "yi-6b": yi_6b,
    "minicpm-2b": minicpm_2b,
    "rwkv6-7b": rwkv6_7b,
    "mamba2-370m": mamba2_370m,
    "qwen2-vl-2b": qwen2_vl_2b,
    "qwen2-7b": qwen2_7b,
    "h2o-danube-3-4b": h2o_danube3_4b,
    "zamba2-1.2b": zamba2_1_2b,
    "whisper-small": whisper_small,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
}

ARCH_IDS = tuple(_MODULES)

# the reference's architectures not ported: none
NOT_PORTED: tuple = ()


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(f"{arch_id} is not ported yet")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES)}")
    return _MODULES[arch_id].CONFIG


def get_reduced_config(arch_id: str) -> ModelConfig:
    get_config(arch_id)
    return _MODULES[arch_id].reduced()


__all__ = ["ARCH_IDS", "InputShape", "ModelConfig", "NOT_PORTED", "SHAPES",
           "SHAPE_BY_NAME", "get_config", "get_reduced_config"]
