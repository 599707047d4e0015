"""Shared building blocks of the transformer models (plain functions on
tensors; port of ``repro.models.common``).

Parameters are trees of tensors (``repro_torch.tree``).  Initialisation
draws from an explicit ``torch.Generator`` on the target device; it does
not reproduce ``jax.random`` — parity tests start both sides from the
reference's parameters (``repro_torch.testing.convert``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

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
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with fp32 statistics."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


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


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------
def causal_positions(batch: int, seq: int, offset: int = 0,
                     device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device) + offset
    return pos.expand(batch, seq)
