"""GQA attention layer: params and full-sequence forward (port of
``repro.models.attention``; decode waits for the serving slice).

Calls ``repro_torch.kernels.ops.attention``: the CUDA flash-attention
kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
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
    return (q.reshape(B, T, cfg.num_heads, hd),
            k.reshape(B, T, cfg.num_kv_heads, hd),
            v.reshape(B, T, cfg.num_kv_heads, hd))


def forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention. x: (B, T, D); positions: (B, T)."""
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet")
    q, k, v = _project_qkv(p, cfg, x)
    if cfg.num_heads and not cfg.is_encoder_decoder:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    out = ops.attention(q, k, v, causal=True,
                        sliding_window=cfg.sliding_window)
    B, T = out.shape[:2]
    return out.reshape(B, T, -1) @ p["wo"]
