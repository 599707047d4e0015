"""Unified model API (port of ``repro.models.api``: the dense, moe and vlm
families, the attention-free ``ssm`` family (mamba2, rwkv6), the
``hybrid`` zamba2 and the ``audio`` encoder-decoder whisper).

``build(cfg)`` -> ``LM`` with ``init``, ``loss_fn``, the serving entry
points ``prefill`` (last-position logits) and ``decode_step`` (one token
over a cache from :func:`init_cache`), and the depth hooks
``num_depth_units`` / ``apply_range`` / ``forward_hidden`` that
``repro_torch.core.blockwise`` consumes.  ``image_model(cfg)`` is the
module (``init``, ``apply``) of an image config: PreResNet or ViT.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import cache_specs
from repro_torch.configs.vit_t16 import ViTConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import (mamba2_lm, resnet, rwkv6, transformer, vit,
                                whisper, zamba2)


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig
    module: Any  # the family module

    def init(self, seed: Union[int, torch.Generator], *,
             device: DeviceLike = None, dtype=torch.float32):
        """Random parameters on ``device`` (the GPU unless ``"cpu"``),
        drawn from ``seed`` or a generator on that device.  On ``"meta"``
        (shapes and dtypes, no data: ``launch.steps.abstract_params``)
        nothing is drawn."""
        dev = resolve_device(device)
        gen_dev = "cpu" if dev.type == "meta" else dev
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator(device=gen_dev).manual_seed(int(seed))
        return self.module.init(self.cfg, generator=gen, device=dev,
                                dtype=dtype)

    def loss_fn(self, params, batch):
        return self.module.loss_fn(params, self.cfg, batch)

    # ---- serving: no gradient ---------------------------------------------
    @torch.inference_mode()
    def prefill(self, params, batch) -> torch.Tensor:
        """Last-position logits (B, 1, V) of ``batch["tokens"]`` (and, for
        a VLM, its optional ``vision_embeds`` / ``mrope_positions``; for
        whisper, its ``encoder_embeds``)."""
        return self.module.prefill(params, self.cfg, batch)

    @torch.inference_mode()
    def decode_step(self, params, tokens, cache, cache_index: int, *,
                    mrope_positions=None):
        """One token (B, 1) at position ``cache_index`` -> (logits (B, 1,
        V), the new cache)."""
        return self.module.decode_step(params, self.cfg, tokens, cache,
                                       int(cache_index),
                                       mrope_positions=mrope_positions)

    # ---- depth structure for FeDepth ------------------------------------
    @property
    def num_depth_units(self) -> int:
        """Finest decomposition granularity (paper: 'finest blocks'): a
        layer (``moe_every`` layers for an interleaved MoE), a zamba2
        group, whisper's encoder then decoder layers."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return zamba2.group_layout(cfg)[0]
        if cfg.family == "ssm":
            return cfg.num_layers
        if cfg.is_encoder_decoder:
            return cfg.encoder_layers + cfg.num_layers
        return cfg.num_layers // cfg.moe_every

    def apply_range(self, params, x, lo: int, hi: int, *,
                    remat: bool = True):
        """Depth units [lo, hi) over hidden states x -> (x, aux); each
        unit rematerialized unless ``remat`` is off
        (``common.maybe_checkpoint``)."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return zamba2.apply_group_range(params, cfg, x, lo, hi,
                                            remat=remat)
        if cfg.family == "ssm":
            return self.module.apply_layer_range(params, cfg, x, lo, hi,
                                                 remat=remat)
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                "whisper's blocks run through core.blockwise's encoder / "
                "decoder split")
        return self.module.apply_unit_range(params, cfg, x, lo, hi,
                                            remat=remat)

    def forward_hidden(self, params, tokens, **kw):
        return self.module.forward_hidden(params, self.cfg, tokens, **kw)


def build(cfg: ModelConfig) -> LM:
    if cfg.family in ("dense", "moe", "vlm"):
        return LM(cfg, transformer)
    if cfg.family == "ssm":
        return LM(cfg, mamba2_lm if cfg.ssm_kind == "mamba2" else rwkv6)
    if cfg.family == "hybrid":
        return LM(cfg, zamba2)
    if cfg.family == "audio":
        return LM(cfg, whisper)
    raise NotImplementedError(
        f"unknown model family {cfg.family!r}")


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A zeroed decode cache on ``device`` (the GPU unless ``"cpu"``),
    with the shapes and dtypes of ``configs.shapes.cache_specs``."""
    dev = resolve_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in cache_specs(cfg, batch, seq_len).items()}


def image_model(cfg):
    """``models.vit`` for a ``ViTConfig``, else ``models.resnet``."""
    return vit if isinstance(cfg, ViTConfig) else resnet
