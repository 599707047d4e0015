"""Decoder-only transformer LM, dense family (port of
``repro.models.transformer``; MoE, VLM, prefill and decode wait).

Depth structure: one unit is one layer.  The reference stacks units on a
leading axis for ``lax.scan``; here ``params["units"]`` is a list with one
parameter dict per layer, so a FeDepth block [lo, hi) is a list slice and
the layers run as a Python loop.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention, common

Params = Dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe_every != 1:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported, got "
            f"{cfg.family!r}")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _init_layer(gen: torch.Generator, cfg: ModelConfig, *, device,
                dtype) -> Params:
    d = cfg.d_model
    d_ff = cfg.dense_d_ff or cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    return {
        "attn_norm": torch.ones(d, **kw),
        "attn": attention.init(gen, cfg, **kw),
        "mlp_norm": torch.ones(d, **kw),
        "mlp": {
            "w_gate": common.dense_init(gen, (d, d_ff), **kw),
            "w_up": common.dense_init(gen, (d, d_ff), **kw),
            "w_down": common.dense_init(gen, (d_ff, d), **kw),
        },
    }


def init(cfg: ModelConfig, *, generator: torch.Generator, device,
         dtype=common.DEFAULT_DTYPE) -> Params:
    _check_family(cfg)
    kw = dict(device=device, dtype=dtype)
    p: Params = {
        "embed": common.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                   **kw),
        "units": [_init_layer(generator, cfg, **kw)
                  for _ in range(cfg.num_layers)],
        "final_norm": torch.ones(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = common.dense_init(generator,
                                         (cfg.d_model, cfg.vocab_size), **kw)
    return p


def lm_head_weight(p: Params, cfg: ModelConfig) -> torch.Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _layer_forward(layer: Params, cfg: ModelConfig, x, positions):
    h = common.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    x = x + attention.forward(layer["attn"], cfg, h, positions)
    h = common.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    mlp = layer["mlp"]
    return x + common.swiglu(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"])


def apply_unit_range(p: Params, cfg: ModelConfig, x: torch.Tensor, lo: int,
                     hi: int) -> Tuple[torch.Tensor, float]:
    """Run units [lo, hi) over hidden states x at positions 0..T-1.
    Returns (x, aux_loss); the dense family has no auxiliary loss.  No
    per-unit rematerialization: a FeDepth block step keeps one block's
    activations, far below the card's memory at the slice's shapes."""
    positions = common.causal_positions(x.shape[0], x.shape[1],
                                        device=x.device)
    for layer in p["units"][lo:hi]:
        x = _layer_forward(layer, cfg, x, positions)
    return x, 0.0


def embed_inputs(p: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def forward_hidden(p: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """Embeddings -> every unit -> hidden states (pre final-norm)."""
    return apply_unit_range(p, cfg, embed_inputs(p, cfg, tokens), 0,
                            cfg.num_layers)


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token CE on a train batch."""
    x, aux = forward_hidden(p, cfg, batch["tokens"])
    x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
    ce, n = ops.cross_entropy(x, lm_head_weight(p, cfg), batch["labels"])
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux, "n_tokens": n}
