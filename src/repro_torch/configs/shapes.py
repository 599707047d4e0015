"""Input shapes and the shapes and dtypes of every step's inputs (port of
``repro.configs.shapes``).

``input_specs(config, shape)`` returns a dict of :class:`TensorSpec` —
the shape and ``torch.dtype`` of each input a train, prefill or decode
step consumes — and ``cache_specs`` those of the decode cache, which
``repro_torch.models.api.init_cache`` allocates.  The reference returns
``jax.ShapeDtypeStruct``\\ s; the shapes and dtypes are the same: K / V,
``conv_state`` and ``rwkv_shift`` in bf16, ``ssm_state`` and
``rwkv_state`` in fp32, tokens in int32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import (SHAPE_BY_NAME, SHAPES, InputShape,
                                      ModelConfig)

__all__ = ["SHAPES", "SHAPE_BY_NAME", "TensorSpec", "cache_specs",
           "input_specs", "shape_applicable"]

CONV_K = 4     # mamba2's causal conv kernel (``models.mamba2.CONV_K``)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether an (arch, shape) pair is in scope; the reason if not.

    long_500k decode needs sub-quadratic attention: it runs for the ssm /
    hybrid / sliding-window archs and is skipped for pure full-attention
    ones.  Whisper has a fixed 1500-frame encoder context, so 32k / 500k
    decode is outside its architecture; it runs train_4k and prefill."""
    if shape.name == "long_500k":
        subquadratic = (cfg.family in ("ssm", "hybrid")
                        or cfg.sliding_window > 0)
        if not subquadratic:
            return False, ("full quadratic attention at 524288 tokens; no "
                           "sub-quadratic variant configured (DESIGN.md §4)")
    if cfg.is_encoder_decoder and shape.seq_len > cfg.max_seq_len:
        return False, ("whisper decoder positions extended to 32k for the "
                       "assigned shapes; 500k exceeds both the learned "
                       "position table and the quadratic-attention policy "
                       "(DESIGN.md §4)")
    return True, ""


def _frontend_specs(cfg: ModelConfig, B: int, T: int) -> Dict[str, TensorSpec]:
    """The stubbed encoder / vision inputs of a train or prefill step."""
    specs = {}
    if cfg.is_encoder_decoder:
        S = cfg.max_source_positions
        specs["encoder_embeds"] = TensorSpec((B, S, cfg.d_model),
                                             torch.bfloat16)
    if cfg.family == "vlm":
        P = cfg.frontend_embed_tokens
        specs["vision_embeds"] = TensorSpec((B, P, cfg.d_model),
                                            torch.bfloat16)
        specs["mrope_positions"] = TensorSpec((3, B, T), torch.int32)
    return specs


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, TensorSpec]:
    """The spec of every model input of the given step kind."""
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.mode == "train":
        return {"tokens": TensorSpec((B, T), i32),
                "labels": TensorSpec((B, T), i32),
                **_frontend_specs(cfg, B, T)}
    if shape.mode == "prefill":
        return {"tokens": TensorSpec((B, T), i32),
                **_frontend_specs(cfg, B, T)}
    if shape.mode != "decode":
        raise ValueError(f"unknown step kind {shape.mode!r}")
    # decode: one new token per sequence over a cache of seq_len
    specs = {"tokens": TensorSpec((B, 1), i32),
             "cache": cache_specs(cfg, B, T),
             "cache_index": TensorSpec((), i32)}
    if cfg.family == "vlm":
        specs["mrope_positions"] = TensorSpec((3, B, 1), i32)
    return specs


def _kv(cfg: ModelConfig, n: int, batch: int, seq_len: int
        ) -> Dict[str, TensorSpec]:
    """K and V of ``n`` attention layers, bounded by the sliding window."""
    kv_len = (min(seq_len, cfg.sliding_window) if cfg.sliding_window
              else seq_len)
    s = TensorSpec((n, batch, kv_len, cfg.num_kv_heads, cfg.head_dim),
                   torch.bfloat16)
    return {"k": s, "v": s}


def _mamba(cfg: ModelConfig, n: int, batch: int) -> Dict[str, TensorSpec]:
    """The SSD state and the causal conv's input tail of ``n`` layers."""
    d_in = cfg.ssm_expand * cfg.d_model
    return {"ssm_state": TensorSpec((n, batch, cfg.ssm_num_heads,
                                     cfg.ssm_head_dim, cfg.ssm_state_dim),
                                    torch.float32),
            "conv_state": TensorSpec((n, batch, CONV_K, d_in),
                                     torch.bfloat16)}


def cache_specs(cfg: ModelConfig, batch: int,
                seq_len: int) -> Dict[str, TensorSpec]:
    """The decode cache, stacked over layers: KV, SSM state or both."""
    L = cfg.num_layers
    kinds = cfg.layer_kinds()
    if cfg.family == "ssm" and cfg.ssm_kind == "mamba2":
        return _mamba(cfg, L, batch)
    if cfg.family == "ssm":
        # RWKV6: per-layer (H, hd, hd) state and the two token shifts
        hd = cfg.rwkv_head_dim
        return {"rwkv_state": TensorSpec((L, batch, cfg.d_model // hd, hd,
                                          hd), torch.float32),
                "rwkv_shift": TensorSpec((L, 2, batch, cfg.d_model),
                                         torch.bfloat16)}
    if cfg.family == "hybrid":
        cache = _mamba(cfg, sum(k == "mamba" for k in kinds), batch)
        n_attn = sum(k.startswith("attn") for k in kinds)
        if n_attn:
            cache.update(_kv(cfg, n_attn, batch, seq_len))
        return cache
    # dense / moe / vlm / the audio decoder: a KV cache
    cache = _kv(cfg, L, batch, seq_len)
    if cfg.is_encoder_decoder:
        cache["enc_out"] = TensorSpec(
            (batch, cfg.max_source_positions, cfg.d_model), torch.bfloat16)
    return cache
