"""Unified model API (port of ``repro.models.api``, dense family).

``build(cfg)`` -> ``LM`` with ``init``, ``loss_fn`` and the depth hooks
``num_depth_units`` / ``apply_range`` / ``forward_hidden`` that
``repro_torch.core.blockwise`` consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig
    module: Any  # the family module

    def init(self, seed: Union[int, torch.Generator], *,
             device: DeviceLike = None, dtype=torch.float32):
        """Random parameters on ``device`` (the GPU unless ``"cpu"``),
        drawn from ``seed`` or a generator on that device."""
        dev = resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator(device=dev).manual_seed(int(seed))
        return self.module.init(self.cfg, generator=gen, device=dev,
                                dtype=dtype)

    def loss_fn(self, params, batch):
        return self.module.loss_fn(params, self.cfg, batch)

    # ---- depth structure for FeDepth ------------------------------------
    @property
    def num_depth_units(self) -> int:
        """Finest decomposition granularity (paper: 'finest blocks')."""
        return self.cfg.num_layers // self.cfg.moe_every

    def apply_range(self, params, x, lo: int, hi: int):
        return self.module.apply_unit_range(params, self.cfg, x, lo, hi)

    def forward_hidden(self, params, tokens):
        return self.module.forward_hidden(params, self.cfg, tokens)


def build(cfg: ModelConfig) -> LM:
    if cfg.family == "dense":
        transformer._check_family(cfg)
        return LM(cfg, transformer)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (dense only)")
