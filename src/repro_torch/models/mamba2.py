"""Mamba2 layer in the SSD form (port of ``repro.models.mamba2``).

Structure per layer: norm -> in_proj [z | x | B | C | dt] -> causal
depthwise conv(4) on x -> silu -> SSD scan (``ops.mamba2``, the CUDA
kernel K3 on the card) -> gate by silu(z) -> out_proj.  Decode carries
the conv's input tail and the SSM state across calls, O(1) in sequence
length.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, kernel CONV_K, as the reference's shifted
    sum.  x: (B, T, C); w: (K, C); conv_state: the previous call's tail
    (B, >= K-1, C), or None for zeros.  Returns (out, the new tail: the
    last CONV_K rows of the padded input)."""
    K = w.shape[0]
    T = x.shape[1]
    if conv_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))                 # (B, T+K-1, C)
    else:
        xp = torch.cat([conv_state[:, -(K - 1):], x], dim=1)
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return out + b, xp[:, -CONV_K:]


def forward(lp: Params, cfg: ModelConfig, x: torch.Tensor, *,
            conv_state: Optional[torch.Tensor] = None,
            ssm_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (the layer's output (B, T, d) before the residual,
    the new conv tail, the new SSM state (B, H, P, N) fp32)."""
    B, T, _ = x.shape
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    h = common.rms_norm(x, lp["norm"], cfg.norm_eps)
    z, xs, Bm, Cm, dt = _split_proj(cfg, h @ lp["in_proj"])
    xs, new_conv = _causal_conv(xs, lp["conv_w"], lp["conv_b"], conv_state)
    xs = F.silu(xs)
    Bm = F.silu(Bm)
    Cm = F.silu(Cm)
    dt = F.softplus(dt + lp["dt_bias"])
    A = -torch.exp(lp["A_log"].float())
    y, new_ssm = ops.mamba2(xs.reshape(B, T, nh, hd), dt, A, Bm, Cm,
                            lp["D"], ssm_state)
    y = y.reshape(B, T, -1) * F.silu(z)
    return y @ lp["out_proj"], new_conv, new_ssm
