"""Helpers shared by the built-in strategies (LM eval)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build, common as mcommon
from repro_torch.models.transformer import lm_head_weight


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
        pred = (h @ lm_head_weight(params, cfg)).argmax(dim=-1)
        valid = yb >= 0
        correct += int(((pred == yb) & valid).sum())
        total += int(valid.sum())
    return correct / max(total, 1)
