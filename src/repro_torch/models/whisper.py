"""Whisper-small backbone — a transformer encoder-decoder (port of
``repro.models.whisper``; arXiv:2212.04356).

The mel-spectrogram + conv feature extractor is a stub, as in the
reference: ``encoder_embeds`` (precomputed frame embeddings, (B,
max_source_positions, d_model)) arrive as input.  The encoder stack runs
over them with non-causal self-attention; the decoder runs causal
self-attention, then cross-attention over the encoder output (Tq != Tk),
then the MLP.  LayerNorm (not RMSNorm), learned positions, no RoPE, MHA,
tanh GELU (``jax.nn.gelu``'s default), and the head tied to the
embedding (K1 reads ``embed`` as (V, D) in place).

``params["enc_layers"]`` / ``params["dec_layers"]`` are lists with one
dict per layer (the reference stacks them on a leading axis).  A bf16
``encoder_embeds`` or cached ``enc_out`` is promoted to fp32 where it
meets the fp32 parameters.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention, common

Params = Dict[str, Any]


def _ln_init(d: int, **kw) -> Params:
    return {"w": torch.ones(d, **kw), "b": torch.zeros(d, **kw)}


def _mlp_init(gen, d: int, dff: int, **kw) -> Params:
    return {"w1": common.dense_init(gen, (d, dff), **kw),
            "b1": torch.zeros(dff, **kw),
            "w2": common.dense_init(gen, (dff, d), **kw),
            "b2": torch.zeros(d, **kw)}


def _enc_layer_init(gen, cfg: ModelConfig, **kw) -> Params:
    d = cfg.d_model
    return {"ln1": _ln_init(d, **kw), "attn": attention.init(gen, cfg, **kw),
            "ln2": _ln_init(d, **kw),
            "mlp": _mlp_init(gen, d, cfg.d_ff, **kw)}


def _dec_layer_init(gen, cfg: ModelConfig, **kw) -> Params:
    d = cfg.d_model
    return {"ln1": _ln_init(d, **kw),
            "self_attn": attention.init(gen, cfg, **kw),
            "ln2": _ln_init(d, **kw),
            "cross_attn": attention.init(gen, cfg, **kw),
            "ln3": _ln_init(d, **kw),
            "mlp": _mlp_init(gen, d, cfg.d_ff, **kw)}


def init(cfg: ModelConfig, *, generator: torch.Generator, device,
         dtype=common.DEFAULT_DTYPE) -> Params:
    kw = dict(device=device, dtype=dtype)
    d = cfg.d_model
    return {
        "embed": common.embed_init(generator, (cfg.vocab_size, d), **kw),
        "pos_dec": common.embed_init(generator, (cfg.max_seq_len, d), **kw),
        "pos_enc": common.embed_init(generator,
                                     (cfg.max_source_positions, d), **kw),
        "enc_layers": [_enc_layer_init(generator, cfg, **kw)
                       for _ in range(cfg.encoder_layers)],
        "dec_layers": [_dec_layer_init(generator, cfg, **kw)
                       for _ in range(cfg.num_layers)],
        "enc_norm": _ln_init(d, **kw),
        "dec_norm": _ln_init(d, **kw),
    }


def ln(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    return common.layer_norm(x, p["w"], p["b"], eps)


def mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] \
        + p["b2"]


def embed_frames(p: Params, encoder_embeds: torch.Tensor) -> torch.Tensor:
    """The stubbed frames plus the learned encoder positions.  bf16
    frames (``configs.shapes``' stub dtype) are promoted to the
    positions' fp32 first: the reference casts the positions to the
    frames' dtype instead, and its encoder scan then refuses the bf16
    carry (ROADMAP.md queue 3, fault 8), so it runs fp32 frames only."""
    S = encoder_embeds.shape[1]
    pos = p["pos_enc"][None, :S]
    return encoder_embeds.to(torch.promote_types(encoder_embeds.dtype,
                                                 pos.dtype)) + pos


def encoder_range(p: Params, cfg: ModelConfig, x: torch.Tensor, lo: int,
                  hi: int, *, remat: bool = True) -> torch.Tensor:
    """Encoder layers [lo, hi) over x (positions already added), then
    ``enc_norm`` when the range ends at the encoder's last layer.  With
    ``remat`` each layer is one rematerialized body."""
    def layer_body(x, lp):
        h = ln(x, lp["ln1"], cfg.norm_eps)
        x = x + attention.forward(lp["attn"], cfg, h, None, causal=False)
        return x + mlp(ln(x, lp["ln2"], cfg.norm_eps), lp["mlp"])

    body = common.maybe_checkpoint(layer_body, remat)
    for lp in p["enc_layers"][lo:hi]:
        x = body(x, lp)
    if hi == cfg.encoder_layers:
        x = ln(x, p["enc_norm"], cfg.norm_eps)
    return x


def encode(p: Params, cfg: ModelConfig, encoder_embeds: torch.Tensor, *,
           lo: int = 0, hi: Optional[int] = None,
           remat: bool = True) -> torch.Tensor:
    """The encoder stack over stubbed frame embeddings (positions added
    here)."""
    hi = hi if hi is not None else cfg.encoder_layers
    return encoder_range(p, cfg, embed_frames(p, encoder_embeds), lo, hi,
                         remat=remat)


def apply_decoder_range(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        enc_out: torch.Tensor, lo: int, hi: int, *,
                        remat: bool = True) -> torch.Tensor:
    """Decoder layers [lo, hi) over x, attending to ``enc_out``.  With
    ``remat`` each layer is one rematerialized body."""
    def layer_body(x, lp, enc_out):
        h = ln(x, lp["ln1"], cfg.norm_eps)
        x = x + attention.forward(lp["self_attn"], cfg, h, None)
        h = ln(x, lp["ln2"], cfg.norm_eps)
        x = x + attention.cross_forward(lp["cross_attn"], cfg, h, enc_out)
        return x + mlp(ln(x, lp["ln3"], cfg.norm_eps), lp["mlp"])

    body = common.maybe_checkpoint(layer_body, remat)
    for lp in p["dec_layers"][lo:hi]:
        x = body(x, lp, enc_out)
    return x


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the learned decoder positions 0..T-1."""
    return p["embed"][tokens] + p["pos_dec"][None, :tokens.shape[1]]


def forward_hidden(p: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   encoder_embeds: torch.Tensor, remat: bool = True):
    """Encoder, then every decoder layer -> decoder hidden states (pre
    ``dec_norm``) and aux = 0."""
    enc_out = encode(p, cfg, encoder_embeds, remat=remat)
    x = apply_decoder_range(p, cfg, embed_tokens(p, tokens), enc_out, 0,
                            cfg.num_layers, remat=remat)
    return x, 0.0


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token CE of the decoder, through the tied head."""
    x, _ = forward_hidden(p, cfg, batch["tokens"],
                          encoder_embeds=batch["encoder_embeds"])
    x = ln(x, p["dec_norm"], cfg.norm_eps)
    ce, n = ops.cross_entropy(x, p["embed"].T, batch["labels"])
    return ce, {"ce": ce, "aux": 0.0, "n_tokens": n}


def prefill(p: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """The prompt's forward over its frames: last-position logits (B, 1,
    V)."""
    x, _ = forward_hidden(p, cfg, batch["tokens"],
                          encoder_embeds=batch["encoder_embeds"],
                          remat=False)
    x = ln(x[:, -1:], p["dec_norm"], cfg.norm_eps)
    return x @ p["embed"].T


def decode_step(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_index: int, *,
                mrope_positions=None):
    """One decode step.  cache: {"k", "v": (L, B, S, Hkv, hd) self-
    attention K / V, "enc_out": (B, S_enc, D) the encoder output}.  As in
    the reference, cross-attention K / V are recomputed from ``enc_out``
    at every step (K2, Tq = 1 against Tk = S_enc).  Returns (logits (B,
    1, V), the cache with this step's K / V slots written in place).
    ``mrope_positions`` is ignored."""
    x = p["embed"][tokens] + p["pos_dec"][cache_index][None, None]
    enc_out = cache["enc_out"]
    for i, lp in enumerate(p["dec_layers"]):
        h = ln(x, lp["ln1"], cfg.norm_eps)
        x = x + attention.decode(lp["self_attn"], cfg, h, cache["k"][i],
                                 cache["v"][i], cache_index)
        h = ln(x, lp["ln2"], cfg.norm_eps)
        x = x + attention.cross_forward(lp["cross_attn"], cfg, h, enc_out)
        x = x + mlp(ln(x, lp["ln3"], cfg.norm_eps), lp["mlp"])
    x = ln(x, p["dec_norm"], cfg.norm_eps)
    return x @ p["embed"].T, cache
