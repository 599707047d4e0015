"""The plain attention for long sequences: an online softmax over key
blocks (port of ``repro.kernels.flash_jnp.flash_attention_jnp``'s forward).

Same semantics as ``kernels/ref.py``'s ``attention`` (causal, sliding
window, GQA, ``q_offset``) with O(Tq x block) live memory: no (Tq, Tk)
score tensor exists.  GQA is handled in the einsums (q reshaped to
(Hkv, group)), so K / V heads are never expanded.

It is a plain version, not a kernel: the CPU branch of
``kernels/flash_attention.py`` takes it where the reference's non-TPU
dispatch does (Tq·Tk ≥ ``MIN_PAIRS``, ``repro.kernels.ops:_REF_NAIVE_MAX_T``),
and on the card K2 runs at every size.  Forward only: the backward is
``kernels.ops.attention_bwd``, which already recomputes over q chunks.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ref import NEG_INF

# Tq·Tk at and above which the CPU takes this path (the reference's
# ``_REF_NAIVE_MAX_T ** 2``)
MIN_PAIRS = 2048 ** 2
BLOCK_K = 1024       # keys a block (the reference's default ``block_k``)


def flash_chunked(q: torch.Tensor,          # (B, Tq, Hq, D)
                  k: torch.Tensor,          # (B, Tk, Hkv, D)
                  v: torch.Tensor,          # (B, Tk, Hkv, D)
                  *, causal: bool = True, sliding_window: int = 0,
                  q_offset: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention -> (B, Tq, Hq, D) in q's dtype, computed in fp32 (in
    float64 for float64 inputs), one block of ``BLOCK_K`` keys at a
    time."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32

    qf = (q.to(ct) * scale).reshape(B, Tq, Hkv, G, D)
    q_pos = torch.arange(Tq, device=q.device) + q_offset
    acc = q.new_zeros((B, Tq, Hkv, G, D), dtype=ct)
    m = q.new_full((B, Hkv, G, Tq, 1), NEG_INF, dtype=ct)
    l = q.new_zeros((B, Hkv, G, Tq, 1), dtype=ct)
    for start in range(0, Tk, BLOCK_K):
        k_blk = k[:, start:start + BLOCK_K].to(ct)
        v_blk = v[:, start:start + BLOCK_K].to(ct)
        k_pos = torch.arange(start, start + k_blk.shape[1], device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_blk)
        mask = None
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        if sliding_window:
            w = k_pos[None, :] > q_pos[:, None] - sliding_window
            mask = w if mask is None else mask & w
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = (acc * alpha[..., 0].permute(0, 3, 1, 2)[..., None]
               + torch.einsum("bhgqk,bkhd->bqhgd", p, v_blk))
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = acc / l[..., 0].permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Tq, Hq, D).to(q.dtype)
