"""Shared building blocks of the transformer models (plain functions on
tensors; port of ``repro.models.common``).

Parameters are trees of tensors (``repro_torch.tree``).  Initialisation
draws from an explicit ``torch.Generator`` on the target device; it does
not reproduce ``jax.random`` — parity tests start both sides from the
reference's parameters (``repro_torch.testing.convert``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

DEFAULT_DTYPE = torch.float32
PARAM_SCALE = 0.02


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, *, device,
               dtype=DEFAULT_DTYPE) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], *, device,
               dtype=DEFAULT_DTYPE) -> torch.Tensor:
    return dense_init(gen, shape, PARAM_SCALE, device=device, dtype=dtype)


# --------------------------------------------------------------------------
# norms / activations
# --------------------------------------------------------------------------
def head_weight(p: Dict[str, Any], cfg) -> torch.Tensor:
    """The (D, V) output head: ``embed.T`` when the config ties it."""
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with fp32 statistics."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of a norm's or a softmax's statistics: fp32, or the
    input's own dtype when it is wider (float64 runs stay float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis with fp32 statistics (population
    variance), as the reference's ``common.layer_norm``."""
    dt = stat_dtype(x)
    out = F.layer_norm(x.to(dt), x.shape[-1:], weight.to(dt), bias.to(dt),
                       eps)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T).  Rotates the split halves
    (x1, x2) = x[..., :D/2], x[..., D/2:], not interleaved pairs."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                  # (D/2,)
    angles = positions[..., None].float() * freqs           # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: (B, T, H, D); positions: (3, B, T),
    the temporal / height / width position ids; ``sections`` splits the
    D/2 rotary frequencies among the three axes (they sum to D/2), and
    each frequency rotates by its axis's position."""
    D = x.shape[-1]
    if sum(sections) != D // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {D // 2}")
    freqs = rope_freqs(D, theta, x.device)                  # (D/2,)
    axis_of_slot = torch.cat([torch.full((s,), i, device=x.device)
                              for i, s in enumerate(sections)])
    pos_bt3 = positions.movedim(0, -1).float()              # (B, T, 3)
    angles = pos_bt3[..., axis_of_slot] * freqs             # (B, T, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------
def causal_positions(batch: int, seq: int, offset: int = 0,
                     device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device) + offset
    return pos.expand(batch, seq)
