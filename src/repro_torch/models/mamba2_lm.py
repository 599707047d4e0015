"""Mamba2 LM — a pure stack of SSD-form mamba2 layers (port of
``repro.models.mamba2_lm``; arXiv:2405.21060).

Structure: embed -> N x (residual ``models.mamba2`` layer) -> final
rms-norm -> tied lm head.  ``params["layers"]`` is a list with one
parameter dict per layer, so a FeDepth block [lo, hi) is a list slice.
The head is tied to the embedding, so the FeDepth runner reports
``prefix_stable=False``: head updates reach the embedding that feeds the
frozen prefix, and buffered activations are re-buffered per subproblem.
Prefill and decode wait for the serving slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common, mamba2

Params = Dict[str, Any]


def init(cfg: ModelConfig, *, generator: torch.Generator, device,
         dtype=common.DEFAULT_DTYPE) -> Params:
    kw = dict(device=device, dtype=dtype)
    p: Params = {
        "layers": [mamba2.init(generator, cfg, **kw)
                   for _ in range(cfg.num_layers)],
        "embed": common.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                   **kw),
        "final_norm": torch.ones(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = common.dense_init(generator,
                                         (cfg.d_model, cfg.vocab_size), **kw)
    return p


def apply_layer_range(p: Params, cfg: ModelConfig, x: torch.Tensor, lo: int,
                      hi: int) -> Tuple[torch.Tensor, float]:
    """Residual layers [lo, hi) over hidden states x; no auxiliary loss."""
    for lp in p["layers"][lo:hi]:
        x = x + mamba2.forward(lp, cfg, x)
    return x, 0.0


def forward_hidden(p: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """Embeddings -> every layer -> hidden states (pre final-norm)."""
    return apply_layer_range(p, cfg, p["embed"][tokens], 0, cfg.num_layers)


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token CE on a train batch."""
    x, _ = forward_hidden(p, cfg, batch["tokens"])
    x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
    ce, n = ops.cross_entropy(x, common.head_weight(p, cfg),
                              batch["labels"])
    return ce, {"ce": ce, "aux": 0.0, "n_tokens": n}
