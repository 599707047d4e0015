"""Public kernel ops: device dispatch + differentiable wrappers.

Models call these, never the kernels directly.  Dispatch follows the
tensors: a CUDA tensor goes to the hand-written kernel, a CPU tensor to the
kernel's plain version (``kernels/ref.py``) — there is no fallback from one
to the other.  Each op is a ``torch.autograd.Function`` whose forward is
the kernel and whose backward recomputes in plain PyTorch with the
reference's chunking (``repro.kernels.ops._fa_bwd`` / ``_ce_bwd``): it
saves only the inputs and none of the kernel's intermediates, so live
memory is one chunk, not (Tq x Tk) or (B*T x V).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.chunked_ce import chunked_cross_entropy
from repro_torch.kernels.flash_attention import flash_attention

# the reference's backward chunks: q rows of 4 * block_q at the Pallas
# default block_q=128 (ops.py:_fa_bwd), tokens of 2048 (_ce_chunked_jnp)
ATTN_BWD_Q_CHUNK = 4 * 128
CE_CHUNK = 2048


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window, q_offset, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, sliding_window, q_offset, scale)
        return flash_attention(q, k, v, causal=causal,
                               sliding_window=sliding_window,
                               q_offset=q_offset, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, g, *ctx.opts)
        return dq, dk, dv, None, None, None, None


def attention_bwd(q, k, v, g, causal, sliding_window, q_offset, scale):
    """Recompute-based backward over q chunks: live memory is one chunk's
    (chunk x Tk) scores.  The last chunk is the ragged remainder (the
    reference slices a fixed-size window instead — see ROADMAP.md queue
    3)."""
    Tq = q.shape[1]
    cq = min(ATTN_BWD_Q_CHUNK, Tq)
    dqs = []
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    with torch.enable_grad():
        kd = k.detach().requires_grad_()
        vd = v.detach().requires_grad_()
        for start in range(0, Tq, cq):
            qs = q[:, start:start + cq].detach().requires_grad_()
            out = ref.attention(qs, kd, vd, causal=causal,
                                sliding_window=sliding_window,
                                q_offset=q_offset + start, scale=scale)
            dq_i, dk_i, dv_i = torch.autograd.grad(
                out, (qs, kd, vd), g[:, start:start + cq])
            dqs.append(dq_i)
            dk += dk_i
            dv += dv_i
    return torch.cat(dqs, dim=1), dk, dv


def attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
              q_offset: int = 0, scale: Optional[float] = None):
    """Differentiable GQA attention (see ``kernels/flash_attention.py``)."""
    return FlashAttention.apply(q, k, v, causal, sliding_window, q_offset,
                                scale)


# --------------------------------------------------------------------------
# cross-entropy over a large vocab
# --------------------------------------------------------------------------
class ChunkedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, lm_head, labels):
        ctx.save_for_backward(hidden, lm_head, labels)
        loss, n = chunked_cross_entropy(hidden, lm_head, labels)
        ctx.mark_non_differentiable(n)
        return loss, n

    @staticmethod
    def backward(ctx, gloss, _gn):
        hidden, lm_head, labels = ctx.saved_tensors
        dh, dw = cross_entropy_bwd(hidden, lm_head, labels, gloss)
        return dh, dw, None


def cross_entropy_bwd(hidden, lm_head, labels, gloss, chunk: int = CE_CHUNK):
    """Gradient of the chunked mean NLL, recomputed over token chunks:
    per chunk, d(loss)/d(logits) = valid * (softmax - onehot) * g / n, then
    one product each for d hidden and d lm_head.  Only one chunk's logits
    are ever live."""
    B, T, D = hidden.shape
    h = hidden.reshape(B * T, D).float()
    lbl = labels.reshape(B * T)
    w = lm_head.float()
    valid = lbl >= 0
    coef = valid.float() * (gloss.float() / valid.sum().clamp(min=1))
    dh = torch.empty_like(h)
    dw = torch.zeros_like(w)
    for s in range(0, B * T, chunk):
        p = torch.softmax(h[s:s + chunk] @ w, dim=-1)
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows, lbl[s:s + chunk].clamp(min=0).long()] -= 1.0
        p *= coef[s:s + chunk, None]
        dh[s:s + chunk] = p @ w.T
        dw += h[s:s + chunk].T @ p
    return (dh.reshape(hidden.shape).to(hidden.dtype),
            dw.to(lm_head.dtype))


def cross_entropy(hidden, lm_head, labels
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (mean NLL over valid labels, n_valid) of
    ``hidden @ lm_head`` (see ``kernels/chunked_ce.py``)."""
    return ChunkedCrossEntropy.apply(hidden, lm_head, labels)
