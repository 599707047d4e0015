"""Helpers shared by the built-in strategies (image + LM evals)."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.preresnet20 import ResNetConfig
from repro_torch.configs.vit_t16 import ViTConfig
from repro_torch.fl.strategy import accuracy
from repro_torch.models import build, common as mcommon, image_model


def image_accuracy(cfg: Union[ResNetConfig, ViTConfig], params,
                   x: torch.Tensor, y: torch.Tensor) -> float:
    """Top-1 accuracy of an image model: PreResNet, or ViT for a
    ``ViTConfig``."""
    apply = image_model(cfg).apply
    return accuracy(lambda xb: apply(params, cfg, xb), x, y)


@torch.no_grad()
def lm_accuracy(cfg: ModelConfig, params, x: torch.Tensor, y: torch.Tensor,
                *, batch: int = 64) -> float:
    """Next-token top-1 accuracy over ``(M, T)`` token / label tensors,
    normalized by VALID positions (labels >= 0)."""
    lm = build(cfg)
    correct, total = 0, 0
    for i in range(0, len(x), batch):
        xb, yb = x[i:i + batch], y[i:i + batch]
        h, _ = lm.forward_hidden(params, xb)
        h = mcommon.rms_norm(h, params["final_norm"], cfg.norm_eps)
        pred = (h @ mcommon.head_weight(params, cfg)).argmax(dim=-1)
        valid = yb >= 0
        correct += int(((pred == yb) & valid).sum())
        total += int(valid.sum())
    return correct / max(total, 1)
