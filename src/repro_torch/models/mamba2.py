"""Mamba2 layer in the SSD form (port of ``repro.models.mamba2``).

Structure per layer: norm -> in_proj [z | x | B | C | dt] -> causal
depthwise conv(4) on x -> silu -> SSD scan (``ops.mamba2``, the CUDA
kernel K3 on the card) -> gate by silu(z) -> out_proj.  The decode caches
(conv and SSM state carried across calls) wait for the serving slice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common

Params = Dict[str, Any]
CONV_K = 4


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def init(gen: torch.Generator, cfg: ModelConfig, *, device,
         dtype=common.DEFAULT_DTYPE) -> Params:
    d = cfg.d_model
    din = d_inner(cfg)
    N = cfg.ssm_state_dim
    nh = cfg.ssm_num_heads
    kw = dict(device=device, dtype=dtype)
    conv_w = torch.randn(CONV_K, din, generator=gen, device=device)
    return {
        "norm": torch.ones(d, **kw),
        "in_proj": common.dense_init(gen, (d, 2 * din + 2 * N + nh), **kw),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros(din, **kw),
        "dt_bias": torch.zeros(nh, **kw),
        "A_log": torch.zeros(nh, **kw),        # A = -exp(A_log)
        "D": torch.ones(nh, **kw),
        "out_proj": common.dense_init(gen, (din, d), **kw),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """[z | x | B | C | dt] along the last axis."""
    din = d_inner(cfg)
    N = cfg.ssm_state_dim
    return torch.split(proj, [din, din, N, N, cfg.ssm_num_heads], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel CONV_K, as the reference's shifted
    sum.  x: (B, T, C); w: (K, C)."""
    K = w.shape[0]
    T = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))                     # (B, T+K-1, C)
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return out + b


def forward(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, d) -> the layer's output (B, T, d), before the
    residual."""
    B, T, _ = x.shape
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    h = common.rms_norm(x, lp["norm"], cfg.norm_eps)
    z, xs, Bm, Cm, dt = _split_proj(cfg, h @ lp["in_proj"])
    xs = F.silu(_causal_conv(xs, lp["conv_w"], lp["conv_b"]))
    Bm = F.silu(Bm)
    Cm = F.silu(Cm)
    dt = F.softplus(dt + lp["dt_bias"])
    A = -torch.exp(lp["A_log"].float())
    y, _ = ops.mamba2(xs.reshape(B, T, nh, hd), dt, A, Bm, Cm, lp["D"])
    y = y.reshape(B, T, -1) * F.silu(z)
    return y @ lp["out_proj"]
