"""Mamba2 LM — a pure stack of SSD-form mamba2 layers (port of
``repro.models.mamba2_lm``; arXiv:2405.21060).

Structure: embed -> N x (residual ``models.mamba2`` layer) -> final
rms-norm -> tied lm head.  ``params["layers"]`` is a list with one
parameter dict per layer, so a FeDepth block [lo, hi) is a list slice.
The head is tied to the embedding, so the FeDepth runner reports
``prefix_stable=False``: head updates reach the embedding that feeds the
frozen prefix, and buffered activations are re-buffered per subproblem.
Decode carries each layer's conv tail and SSM state (``init_cache``).
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
                      hi: int, *, remat: bool = True
                      ) -> Tuple[torch.Tensor, float]:
    """Residual layers [lo, hi) over hidden states x; no auxiliary loss.
    With ``remat`` each layer is one rematerialized body."""
    def layer_body(x, lp):
        return x + mamba2.forward(lp, cfg, x)[0]

    body = common.maybe_checkpoint(layer_body, remat)
    for lp in p["layers"][lo:hi]:
        x = body(x, lp)
    return x, 0.0


def forward_hidden(p: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   remat: bool = True):
    """Embeddings -> every layer -> hidden states (pre final-norm)."""
    return apply_layer_range(p, cfg, p["embed"][tokens], 0, cfg.num_layers,
                             remat=remat)


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token CE on a train batch."""
    x, _ = forward_hidden(p, cfg, batch["tokens"])
    x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
    ce, n = ops.cross_entropy(x, common.head_weight(p, cfg),
                              batch["labels"])
    return ce, {"ce": ce, "aux": 0.0, "n_tokens": n}


def prefill(p: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """The prompt's forward: last-position logits (B, 1, V)."""
    x, _ = forward_hidden(p, cfg, batch["tokens"], remat=False)
    x = common.rms_norm(x[:, -1:], p["final_norm"], cfg.norm_eps)
    return x @ common.head_weight(p, cfg)


def decode_step(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_index: int, *,
                mrope_positions=None):
    """One decode step.  cache: {"ssm_state": (L, B, H, P, N) fp32,
    "conv_state": (L, B, CONV_K, d_inner) bf16}.  Returns (logits (B, 1,
    V), the new cache); ``cache`` is left as it was.  ``mrope_positions``
    (a VLM's) is ignored."""
    x = p["embed"][tokens]                      # (B, 1, d)
    convs, states = [], []
    for lp, conv, ssm in zip(p["layers"], cache["conv_state"],
                             cache["ssm_state"]):
        out, new_conv, new_ssm = mamba2.forward(
            lp, cfg, x, conv_state=conv.to(x.dtype), ssm_state=ssm)
        x = x + out
        convs.append(new_conv)
        states.append(new_ssm)
    x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
    return x @ common.head_weight(p, cfg), {
        "conv_state": torch.stack(convs).to(cache["conv_state"].dtype),
        "ssm_state": torch.stack(states)}
