"""Zamba2 hybrid — a Mamba2 backbone with one SHARED attention + MLP block
invoked every ``hybrid_attn_every`` layers (port of
``repro.models.zamba2``; arXiv:2411.15242).

The shared block's parameters exist once; each invocation applies its own
pair of input norms (``invocation_norms``, standing in for Zamba2's
per-invocation LoRA).  FeDepth trains the shared block with the head φ in
every depth block, so the runner reports ``prefix_stable=False``.

Depth structure: ``groups`` of (hybrid_attn_every - 1 mamba layers + one
shared-block invocation).  The reference stacks the mamba layers as
(G, M, ...) leaves; here ``params["mamba_groups"]`` is a list of G groups,
each a list of M per-layer dicts, so a FeDepth block [lo, hi) is a list
slice of groups.  The mamba layers run ``models.mamba2`` (the scan K3 on
the card), the shared attention ``models.attention`` (K2), the head the
chunked CE (K1).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention, common, mamba2

Params = Dict[str, Any]


def group_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(num_groups, mamba_per_group): the layers are groups * (m + 1),
    the + 1 the shared block's invocation; a remainder is dropped, as in
    the reference (38 layers at every 6: 6 groups of 5 + 1)."""
    every = cfg.hybrid_attn_every
    return cfg.num_layers // every, every - 1


def init(cfg: ModelConfig, *, generator: torch.Generator, device,
         dtype=common.DEFAULT_DTYPE) -> Params:
    n_groups, m_per = group_layout(cfg)
    kw = dict(device=device, dtype=dtype)
    d = cfg.d_model
    return {
        "embed": common.embed_init(generator, (cfg.vocab_size, d), **kw),
        "mamba_groups": [[mamba2.init(generator, cfg, **kw)
                          for _ in range(m_per)] for _ in range(n_groups)],
        "shared": {
            "attn": attention.init(generator, cfg, **kw),
            "mlp": {
                "w_gate": common.dense_init(generator, (d, cfg.d_ff), **kw),
                "w_up": common.dense_init(generator, (d, cfg.d_ff), **kw),
                "w_down": common.dense_init(generator, (cfg.d_ff, d), **kw),
            },
        },
        "invocation_norms": torch.ones(n_groups, 2, d, **kw),
        "final_norm": torch.ones(d, **kw),
        "lm_head": common.dense_init(generator, (d, cfg.vocab_size), **kw),
    }


def _shared_block(p: Params, cfg: ModelConfig, x: torch.Tensor, g: int,
                  positions: Optional[torch.Tensor], *, cache=None,
                  cache_index: Optional[int] = None) -> torch.Tensor:
    """Invocation ``g`` of the shared attention + SwiGLU block.  With
    ``cache`` = (k, v) of this invocation, one decode step that writes
    its K / V slot in place."""
    norms = p["invocation_norms"][g]
    h = common.rms_norm(x, norms[0], cfg.norm_eps)
    if cache is None:
        a = attention.forward(p["shared"]["attn"], cfg, h, positions)
    else:
        a = attention.decode(p["shared"]["attn"], cfg, h, cache[0],
                             cache[1], cache_index)
    x = x + a
    h = common.rms_norm(x, norms[1], cfg.norm_eps)
    mlp = p["shared"]["mlp"]
    return x + common.swiglu(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"])


def apply_group_range(p: Params, cfg: ModelConfig, x: torch.Tensor, lo: int,
                      hi: int, *, remat: bool = True
                      ) -> Tuple[torch.Tensor, float]:
    """Run groups [lo, hi) over hidden states x at positions 0..T-1: each
    group's mamba layers (residual), then the shared block.  Returns (x,
    aux = 0).  With ``remat`` each group, its shared-block invocation
    included, is one rematerialized body (the reference rematerializes
    each mamba layer and keeps the shared block's activations; a group
    is the unit FeDepth splits at, and its recompute runs K2 again)."""
    positions = common.causal_positions(x.shape[0], x.shape[1],
                                        device=x.device)

    def group_body(x, layers, shared, g, positions):
        for lp in layers:
            x = x + mamba2.forward(lp, cfg, x)[0]
        return _shared_block(shared, cfg, x, g, positions)

    body = common.maybe_checkpoint(group_body, remat)
    shared = {"shared": p["shared"],
              "invocation_norms": p["invocation_norms"]}
    for g in range(lo, hi):
        x = body(x, p["mamba_groups"][g], shared, g, positions)
    return x, 0.0


def forward_hidden(p: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   remat: bool = True):
    """Embeddings -> every group -> hidden states (pre final-norm)."""
    return apply_group_range(p, cfg, p["embed"][tokens], 0,
                             group_layout(cfg)[0], remat=remat)


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token CE on a train batch."""
    x, _ = forward_hidden(p, cfg, batch["tokens"])
    x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
    ce, n = ops.cross_entropy(x, p["lm_head"], batch["labels"])
    return ce, {"ce": ce, "aux": 0.0, "n_tokens": n}


def prefill(p: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """The prompt's forward: last-position logits (B, 1, V)."""
    x, _ = forward_hidden(p, cfg, batch["tokens"], remat=False)
    x = common.rms_norm(x[:, -1:], p["final_norm"], cfg.norm_eps)
    return x @ p["lm_head"]


def decode_step(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_index: int, *,
                mrope_positions=None):
    """One decode step.  cache: {"ssm_state": (n_mamba, B, H, P, N),
    "conv_state": (n_mamba, B, CONV_K, d_inner), "k" / "v": (G, B, S, Hkv,
    hd)}, layer g * M + m of the mamba leaves for group g's m-th layer.
    Returns (logits (B, 1, V), the new cache): the mamba leaves stacked
    anew over the G * M layers the groups run (``init_cache`` allots one
    per mamba layer of ``layer_kinds``, which may be more; the conv tails
    come back in the hidden states' dtype, as the reference's do), K and
    V the given tensors with this step's slot written in place.
    ``mrope_positions`` is ignored."""
    n_groups, m_per = group_layout(cfg)
    x = p["embed"][tokens]
    convs, states = [], []
    for g in range(n_groups):
        for m, lp in enumerate(p["mamba_groups"][g]):
            li = g * m_per + m
            out, new_conv, new_ssm = mamba2.forward(
                lp, cfg, x, conv_state=cache["conv_state"][li].to(x.dtype),
                ssm_state=cache["ssm_state"][li])
            x = x + out
            convs.append(new_conv)
            states.append(new_ssm)
        x = _shared_block(p, cfg, x, g, None,
                          cache=(cache["k"][g], cache["v"][g]),
                          cache_index=cache_index)
    x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
    return x @ p["lm_head"], {"ssm_state": torch.stack(states),
                              "conv_state": torch.stack(convs),
                              "k": cache["k"], "v": cache["v"]}
