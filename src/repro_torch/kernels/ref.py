"""Plain PyTorch versions of the hand-written kernels.

Ports of ``repro.kernels.ref.attention`` and ``cross_entropy_logits``: the
semantic ground truth.  The kernel wrappers take these for tensors on the
CPU (the tests), and ``chip_smoke.py`` holds each CUDA kernel against them
on the card.  Nothing on the main path calls them when a card is present.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor,          # (B, Tq, Hq, D)
              k: torch.Tensor,          # (B, Tk, Hkv, D)
              v: torch.Tensor,          # (B, Tk, Hkv, D)
              *, causal: bool = True, sliding_window: int = 0,
              q_offset: int = 0,        # absolute position of q[0]
              scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention with optional causal mask / sliding window.

    Returns (B, Tq, Hq, D) in q's dtype; softmax in fp32."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    rep = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)

    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)

    q_pos = torch.arange(Tq, device=q.device) + q_offset
    k_pos = torch.arange(Tk, device=q.device)
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if sliding_window:
        mask &= k_pos[None, :] > q_pos[:, None] - sliding_window
    logits = torch.where(mask[None, None], logits, NEG_INF)

    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


def cross_entropy_logits(hidden: torch.Tensor,     # (B, T, D)
                         lm_head: torch.Tensor,    # (D, V)
                         labels: torch.Tensor,     # (B, T); -100 = ignore
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE computed with the full logits materialized (what the chunked
    kernel avoids).  Returns (mean loss over valid labels, n_valid)."""
    logits = hidden.float() @ lm_head.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    valid = labels >= 0
    n = valid.sum().clamp(min=1)
    return torch.where(valid, logz - gold, 0.0).sum() / n, n
