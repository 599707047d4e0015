"""Public kernel ops: device dispatch + differentiable wrappers.

Models call these, never the kernels directly.  Dispatch follows the
tensors: a CUDA tensor goes to the hand-written kernel, a CPU tensor to the
kernel's plain version (``kernels/ref.py``) — there is no fallback from one
to the other.  Each op is a ``torch.autograd.Function`` whose forward is
the kernel and whose backward recomputes in plain PyTorch with the
reference's chunking (``repro.kernels.ops._fa_bwd`` / ``_ce_bwd`` /
``_scan_chunk_bwd``): it saves only the inputs and none of the kernel's
intermediates, so live memory is one chunk, not (Tq x Tk), (B*T x V) or a
whole sequence of scan states.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.chunked_ce import chunked_cross_entropy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba2_ssd import mamba2_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan

# the reference's backward chunks: q rows of 4 * block_q at the Pallas
# default block_q=128 (ops.py:_fa_bwd), tokens of 2048 (_ce_chunked_jnp),
# time steps of 4 * block_t at the default block_t=128 (_rwkv_bwd, _ssd_bwd)
ATTN_BWD_Q_CHUNK = 4 * 128
CE_CHUNK = 2048
SCAN_BWD_CHUNK = 4 * 128


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


# --------------------------------------------------------------------------
# linear-state scans (mamba2 SSD, rwkv6 WKV)
# --------------------------------------------------------------------------
def scan_chunk_bwd(scan_fn, seq_args, bcast_args, s0, gy, gs,
                   chunk: int = SCAN_BWD_CHUNK):
    """Gradient of a linear-state scan by chunked recompute (port of
    ``repro.kernels.ops._scan_chunk_bwd``).

    ``scan_fn(*seq_chunks, *bcast, state) -> (y_chunk, state_out)`` must
    chain exactly across time chunks.  Pass 1 recomputes only the
    chunk-entry states; pass 2 walks the chunks in reverse, differentiating
    one chunk at a time with the state cotangent chained backward, so live
    memory is one chunk's activations.  Returns (d seq_args, d bcast_args
    summed over chunks, d s0)."""
    T = seq_args[0].shape[1]
    bounds = [(lo, min(lo + chunk, T)) for lo in range(0, T, chunk)]
    entry = [s0]
    with torch.no_grad():
        for lo, hi in bounds[:-1]:
            _, s = scan_fn(*(a[:, lo:hi] for a in seq_args), *bcast_args,
                           entry[-1])
            entry.append(s)
    dseq = [[] for _ in seq_args]
    dbcast = [torch.zeros_like(b) for b in bcast_args]
    ds = gs
    with torch.enable_grad():
        bcast = [b.detach().requires_grad_() for b in bcast_args]
        for idx in reversed(range(len(bounds))):
            lo, hi = bounds[idx]
            seq = [a[:, lo:hi].detach().requires_grad_() for a in seq_args]
            s_in = entry[idx].detach().requires_grad_()
            y, s_out = scan_fn(*seq, *bcast, s_in)
            grads = torch.autograd.grad((y, s_out), (*seq, *bcast, s_in),
                                        (gy[:, lo:hi], ds),
                                        allow_unused=True)
            for i, g in enumerate(grads[:len(seq)]):
                dseq[i].append(torch.zeros_like(seq[i]) if g is None else g)
            for i, g in enumerate(grads[len(seq):-1]):
                if g is not None:
                    dbcast[i] += g
            ds = grads[-1]
    return ([torch.cat(parts[::-1], dim=1) for parts in dseq], dbcast, ds)


def _mamba2_recompute(x, dt, Bm, Cm, A, D, s):
    return ref.mamba2_scan_chunked(x, dt, A, Bm, Cm, D, s)


class Mamba2Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, s0):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, s0)
        return mamba2_scan(x, dt, A, Bm, Cm, D, s0)

    @staticmethod
    def backward(ctx, gy, gs):
        """The reference's chunked recompute (``ops.py:_ssd_bwd``), each
        chunk in the SSD chunked form (float64) rather than a T-step
        loop, which would be launch-bound on the card."""
        x, dt, A, Bm, Cm, D, s0 = ctx.saved_tensors
        (dx, ddt, dB, dC), (dA, dD), ds = scan_chunk_bwd(
            _mamba2_recompute, (x, dt, Bm, Cm), (A, D), s0, gy, gs,
            min(SCAN_BWD_CHUNK, x.shape[1]))
        return dx, ddt, dA, dB, dC, dD, ds


def mamba2(x, dt, A, Bm, Cm, D, initial_state=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable Mamba2 SSD scan -> (y (B,T,H,P), final state
    (B,H,P,N)) (see ``kernels/mamba2_ssd.py``)."""
    if initial_state is None:
        B, _, H, P = x.shape
        initial_state = x.new_zeros(B, H, P, Bm.shape[-1],
                                    dtype=torch.float32)
    return Mamba2Scan.apply(*(t.contiguous() for t in
                              (x, dt, A, Bm, Cm, D, initial_state)))


class Rwkv6Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        return rwkv6_scan(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, gy, gs):
        """The reference's chunked recompute (``ops.py:_rwkv_bwd``) through
        the sequential plain scan: the per-channel decay makes the chunked
        matmul form unsafe."""
        r, k, v, w, u, s0 = ctx.saved_tensors
        (dr, dk, dv, dw), (du,), ds = scan_chunk_bwd(
            ref.rwkv6_scan, (r, k, v, w), (u,), s0, gy, gs,
            min(SCAN_BWD_CHUNK, r.shape[1]))
        return dr, dk, dv, dw, du, ds


def rwkv6(r, k, v, w, u, initial_state=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable RWKV6 WKV scan -> (y (B,T,H,D), final state
    (B,H,D,D)) (see ``kernels/rwkv6_scan.py``)."""
    if initial_state is None:
        B, _, H, D = r.shape
        initial_state = r.new_zeros(B, H, D, D, dtype=torch.float32)
    return Rwkv6Scan.apply(*(t.contiguous() for t in
                             (r, k, v, w, u, initial_state)))
