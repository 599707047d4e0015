"""Decoder-only transformer LM, the dense, MoE and VLM families (port of
``repro.models.transformer``): training loss, prefill and one-token
decode over a stacked KV cache.

Depth structure: one unit is ``moe_every`` layers (1 for the dense, VLM
and pure-MoE archs; 2 for llama4's dense layer then MoE layer), of the
kinds ``cfg.layer_kinds()`` gives.  The reference stacks units on a
leading axis for ``lax.scan``; here ``params["units"]`` is a list with one
parameter dict per unit, so a FeDepth block [lo, hi) is a list slice and
the units run as a Python loop.  A unit of one layer is that layer's
dict; a unit of m > 1 layers is ``{"sub_0": ..., "sub_{m-1}": ...}``.
A layer's feed-forward is a SwiGLU ``"mlp"`` (of ``dense_d_ff`` if the
config sets it) or a ``"moe"`` (``models.moe``).  The VLM's vision tower
is stubbed: ``vision_embeds`` (B, P, d) are prepended to the token
embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dtensor import grad_as_value, vocab_whole
from repro_torch.kernels import ops
from repro_torch.models import attention, common, moe

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str, *,
                device, dtype) -> Params:
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    p = {
        "attn_norm": torch.ones(d, **kw),
        "attn": attention.init(gen, cfg, **kw),
        "mlp_norm": torch.ones(d, **kw),
    }
    if kind == "moe":
        p["moe"] = moe.init(gen, cfg, **kw)
    else:
        d_ff = cfg.dense_d_ff or cfg.d_ff
        p["mlp"] = {
            "w_gate": common.dense_init(gen, (d, d_ff), **kw),
            "w_up": common.dense_init(gen, (d, d_ff), **kw),
            "w_down": common.dense_init(gen, (d_ff, d), **kw),
        }
    return p


def _init_unit(gen: torch.Generator, cfg: ModelConfig, **kw) -> Params:
    kinds = cfg.layer_kinds()
    if cfg.moe_every == 1:
        return _init_layer(gen, cfg, kinds[0], **kw)
    return {f"sub_{i}": _init_layer(gen, cfg, kinds[i], **kw)
            for i in range(cfg.moe_every)}


def init(cfg: ModelConfig, *, generator: torch.Generator, device,
         dtype=common.DEFAULT_DTYPE) -> Params:
    kw = dict(device=device, dtype=dtype)
    p: Params = {
        "embed": common.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                   **kw),
        "units": [_init_unit(generator, cfg, **kw)
                  for _ in range(cfg.num_layers // cfg.moe_every)],
        "final_norm": torch.ones(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = common.dense_init(generator,
                                         (cfg.d_model, cfg.vocab_size), **kw)
    return p


def _sublayers(unit: Params, cfg: ModelConfig) -> List[Params]:
    """A unit's layers in depth order."""
    if cfg.moe_every == 1:
        return [unit]
    return [unit[f"sub_{i}"] for i in range(cfg.moe_every)]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _ffn(layer: Params, cfg: ModelConfig, kind: str, x):
    """The layer's feed-forward sub-block (pre-norm, SwiGLU or MoE,
    residual) -> (x, the MoE router's aux loss or 0.0)."""
    h = grad_as_value(common.rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
    if kind == "moe":
        out, aux = moe.forward(layer["moe"], cfg, h)
        return x + common.batch_hint(out), aux
    mlp = layer["mlp"]
    return x + common.batch_hint(common.swiglu(h, mlp["w_gate"], mlp["w_up"],
                                               mlp["w_down"])), 0.0


def _layer_forward(layer: Params, cfg: ModelConfig, kind: str, x,
                   positions, mrope_positions):
    # on DTensors: each sublayer's output is reduced over "model" where the
    # row-split projection makes it (``batch_hint``), and the gradient of
    # each normed input where the column-split products make it
    # (``grad_as_value``): Megatron's two all-reduces a sublayer; no-ops
    # on plain tensors
    h = grad_as_value(common.rms_norm(x, layer["attn_norm"], cfg.norm_eps))
    x = x + common.batch_hint(attention.forward(
        layer["attn"], cfg, h, positions, mrope_positions=mrope_positions))
    return _ffn(layer, cfg, kind, x)


def apply_unit_range(p: Params, cfg: ModelConfig, x: torch.Tensor, lo: int,
                     hi: int, *, mrope_positions=None, remat: bool = True
                     ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """Run units [lo, hi) over hidden states x at positions 0..T-1.
    Returns (x, the summed MoE aux loss; 0.0 when no layer is MoE).  With
    ``remat`` (training's default) each unit, all its ``moe_every``
    layers and their aux, is one rematerialized body
    (``common.maybe_checkpoint``), as the reference's scan body."""
    kinds = cfg.layer_kinds()
    positions = common.causal_positions(x.shape[0], x.shape[1],
                                        device=x.device)

    def unit_body(x, aux, unit, positions, mrope_positions):
        for i, layer in enumerate(_sublayers(unit, cfg)):
            x, a = _layer_forward(layer, cfg, kinds[i],
                                  common.batch_hint(x), positions,
                                  mrope_positions)
            aux = aux + a
        return x, aux

    body = common.maybe_checkpoint(unit_body, remat)
    aux = 0.0
    for unit in p["units"][lo:hi]:
        x, aux = body(x, aux, unit, positions, mrope_positions)
    return x, aux


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; on a DTensor table the embedding op (the
    indexing's backward, an ``index_put``, fails DTensor's propagation in
    PyTorch 2.11), with a vocab-split table first resplit on its model
    dim (an all-to-all): 2.11 cannot take the lookup's backward through
    the masked partial a vocab split gives."""
    if not common.is_dtensor(table):
        return table[tokens]
    table = vocab_whole(table)
    return F.embedding(tokens, table)


def embed_inputs(p: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                 vision_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    x = _lookup(p["embed"], tokens)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    return x


def forward_hidden(p: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   vision_embeds=None, mrope_positions=None,
                   remat: bool = True):
    """Embeddings (after the vision prefix, if any) -> every unit ->
    hidden states (pre final-norm).  With both a vision prefix of P
    tokens and text ``mrope_positions`` (3, B, T), the prefix takes the
    stub positions 0..P-1 on all three axes and the text's are shifted
    by P."""
    x = embed_inputs(p, cfg, tokens, vision_embeds=vision_embeds)
    if mrope_positions is not None and vision_embeds is not None:
        P = vision_embeds.shape[1]
        vis = common.replicate_like(torch.arange(
            P, dtype=mrope_positions.dtype, device=x.device).expand(
                3, x.shape[0], P), mrope_positions)
        mrope_positions = torch.cat([vis, mrope_positions + P], dim=2)
    return apply_unit_range(p, cfg, x, 0, cfg.num_layers // cfg.moe_every,
                            mrope_positions=mrope_positions, remat=remat)


def _forward_batch(p: Params, cfg: ModelConfig, batch, remat: bool = True):
    return forward_hidden(p, cfg, batch["tokens"],
                          vision_embeds=batch.get("vision_embeds"),
                          mrope_positions=batch.get("mrope_positions"),
                          remat=remat)


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token CE (+ ``router_aux_coef`` x the MoE aux loss) on a
    train batch; no loss on the vision prefix."""
    x, aux = _forward_batch(p, cfg, batch)
    x = grad_as_value(common.rms_norm(x, p["final_norm"], cfg.norm_eps))
    if batch.get("vision_embeds") is not None:
        # K1 reads the hidden states as one contiguous (B*T, D) block
        x = x[:, batch["vision_embeds"].shape[1]:].contiguous()
    ce, n = ops.cross_entropy(x, common.head_weight(p, cfg),
                              batch["labels"])
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux, "n_tokens": n}


def prefill(p: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """The prompt's forward: last-position logits (B, 1, V)."""
    x, _ = _forward_batch(p, cfg, batch, remat=False)
    x = common.rms_norm(x[:, -1:], p["final_norm"], cfg.norm_eps)
    return x @ common.head_weight(p, cfg)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def decode_step(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_index: int, *,
                mrope_positions=None):
    """One decode step.  tokens: (B, 1); cache: {"k", "v"}: (L, B, S, Hkv,
    hd) in bf16, layer l = unit * moe_every + i, each layer's slot written
    in place.  A MoE layer routes the B tokens with the capacity of B
    tokens (as the reference: at B 4, top 8 of 128 experts, one slot an
    expert).  Returns (logits (B, 1, V), ``cache``)."""
    kinds = cfg.layer_kinds()
    x = common.ws_replicate(_lookup(p["embed"], tokens))
    for u, unit in enumerate(p["units"]):
        for i, layer in enumerate(_sublayers(unit, cfg)):
            l = u * cfg.moe_every + i
            h = common.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
            a = attention.decode(layer["attn"], cfg, h, cache["k"][l],
                                 cache["v"][l], cache_index,
                                 mrope_positions=mrope_positions)
            x, _ = _ffn(layer, cfg, kinds[i], x + a)
    x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
    return x @ common.head_weight(p, cfg), cache
