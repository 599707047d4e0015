"""GQA attention layer: params, full-sequence forward and one-token
decode over a KV cache (port of ``repro.models.attention``).

The forward (causal self-attention, or non-causal for whisper's encoder)
and whisper's cross-attention call ``repro_torch.kernels.ops.attention``:
the CUDA flash-attention kernel on the card, its plain version on the
CPU.  Decode attends one query over the cache in plain PyTorch, as the
reference does in plain ``jnp``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dtensor import grad_as_value, whole_where_uneven
from repro_torch.kernels import ops
from repro_torch.models import common


def init(gen: torch.Generator, cfg: ModelConfig, *, device,
         dtype=common.DEFAULT_DTYPE) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    kw = dict(device=device, dtype=dtype)
    p = {
        "wq": common.dense_init(gen, (d, nq * hd), **kw),
        "wk": common.dense_init(gen, (d, nkv * hd), **kw),
        "wv": common.dense_init(gen, (d, nkv * hd), **kw),
        "wo": common.dense_init(gen, (nq * hd, d), **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(nq * hd, **kw)
        p["bk"] = torch.zeros(nkv * hd, **kw)
        p["bv"] = torch.zeros(nkv * hd, **kw)
    return p


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    # a DTensor's heads split evenly, or not at all (DTensor has no rule
    # for an uneven unflatten)
    q = whole_where_uneven(q, -1, cfg.num_heads)
    k = whole_where_uneven(k, -1, cfg.num_kv_heads)
    v = whole_where_uneven(v, -1, cfg.num_kv_heads)
    return (q.reshape(B, T, cfg.num_heads, hd),
            k.reshape(B, T, cfg.num_kv_heads, hd),
            v.reshape(B, T, cfg.num_kv_heads, hd))


def _rotate(cfg: ModelConfig, q, k, positions, mrope_positions):
    """M-RoPE when the config has sections and the caller gives (3, B, T)
    positions, else 1-D RoPE at ``positions`` (none for whisper, whose
    positions are learned)."""
    if cfg.mrope_sections is not None and mrope_positions is not None:
        return (common.apply_mrope(q, mrope_positions, cfg.rope_theta,
                                   cfg.mrope_sections),
                common.apply_mrope(k, mrope_positions, cfg.rope_theta,
                                   cfg.mrope_sections))
    if cfg.num_heads and not cfg.is_encoder_decoder:
        return (common.apply_rope(q, positions, cfg.rope_theta),
                common.apply_rope(k, positions, cfg.rope_theta))
    return q, k


def forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
            positions: Optional[torch.Tensor], *,
            mrope_positions: Optional[torch.Tensor] = None,
            causal: bool = True) -> torch.Tensor:
    """Full-sequence attention. x: (B, T, D); positions: (B, T) (None for
    whisper, whose positions are learned); mrope_positions: (3, B, T) or
    None."""
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rotate(cfg, q, k, positions, mrope_positions)
    out = ops.attention(q, k, v, causal=causal,
                        sliding_window=cfg.sliding_window)
    B, T = out.shape[:2]
    return grad_as_value(out.reshape(B, T, -1)) @ p["wo"]


def decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
           cache_k: torch.Tensor, cache_v: torch.Tensor, cache_index: int,
           *, mrope_positions: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """One-token decode. x: (B, 1, D); cache_k, cache_v: (B, S, Hkv, hd),
    S the KV window (the sequence length, or the sliding window if set).

    Writes the new K / V, in the cache's dtype, into one slot of the
    caches in place: ``cache_index % S`` (a ring buffer) under a sliding
    window, else ``min(cache_index, S - 1)``; attends over the written
    slots with an fp32 softmax, each KV head for its group of q heads.
    Returns out (B, 1, D)."""
    B, S, Hkv, hd = cache_k.shape
    x = common.ws_replicate(x)
    q, k, v = _project_qkv(p, cfg, x)
    q = common.ws_batch_sharded(q)
    k = common.ws_batch_sharded(k)
    v = common.ws_batch_sharded(v)
    pos = torch.full((B, 1), cache_index, dtype=torch.int32, device=x.device)
    q, k = _rotate(cfg, q, k, pos, mrope_positions)

    slot = cache_index % S if cfg.sliding_window > 0 \
        else min(cache_index, S - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    # q head g * rep + r reads KV head g; slots past cache_index are
    # unwritten (a ring buffer's are all written once cache_index >= S)
    qf = whole_where_uneven(q.float(), 2, Hkv).reshape(B, Hkv, -1, hd) \
        * (hd ** -0.5)
    logits = torch.einsum("bgrd,bkgd->bgrk", qf, cache_k.float())
    valid = torch.arange(S, device=x.device) < min(cache_index + 1, S)
    # the same on every rank: replicated for a DTensor run
    logits = torch.where(common.replicate_like(valid, logits), logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", probs, cache_v.float()).to(x.dtype)
    out = common.ws_replicate(out.reshape(B, 1, -1))
    return out @ p["wo"]


def cross_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  enc_out: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention over the encoder output: no mask, no RoPE.
    x: (B, T, D); enc_out: (B, S, D), cast to x's dtype (JAX promotes a
    bf16 ``enc_out`` against the fp32 weights).  As in the reference only
    the query takes its bias."""
    B, T, _ = x.shape
    S = enc_out.shape[1]
    hd = cfg.head_dim
    enc_out = enc_out.to(torch.promote_types(enc_out.dtype, p["wk"].dtype))
    q = whole_where_uneven(x @ p["wq"], -1, cfg.num_heads).reshape(
        B, T, cfg.num_heads, hd)
    k = whole_where_uneven(enc_out @ p["wk"], -1, cfg.num_kv_heads
                           ).reshape(B, S, cfg.num_kv_heads, hd)
    v = whole_where_uneven(enc_out @ p["wv"], -1, cfg.num_kv_heads
                           ).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(1, 1, cfg.num_heads, hd)
    out = ops.attention(q, k, v, causal=False)
    return grad_as_value(out.reshape(B, T, -1)) @ p["wo"]
