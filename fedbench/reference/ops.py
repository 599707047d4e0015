"""Plain PyTorch operations of the reference models, in float32.

No kernel, no chunked recompute and no cache: the attention materializes
its scores, the cross-entropy its logits, and the Mamba2 scan runs in
the chunked SSD form with autograd taking its gradient.  Every product
goes through :func:`mm` or :func:`einsum`, so that the control can run
the same reference one precision lower: on the card by turning TF32 on
(:func:`precision`), on the CPU by rounding each product's operands to
TF32's 10-bit mantissa (``emulate_tf32``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_EMULATE_TF32 = False
# the scan's compute dtype: float64 in the reference (fp32's chunked form
# drifts where its cumulative sums cancel), fp32 in the control
SCAN_DTYPE = torch.float64


@contextlib.contextmanager
def precision(tf32: bool, *, emulate: bool = False):
    """float32 products with TF32 off (the reference), or TF32's: on
    the card's tensor cores, or emulated (``emulate``, for the CPU)."""
    global _EMULATE_TF32, SCAN_DTYPE
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, _EMULATE_TF32, SCAN_DTYPE)
    torch.backends.cuda.matmul.allow_tf32 = tf32 and not emulate
    torch.backends.cudnn.allow_tf32 = tf32 and not emulate
    _EMULATE_TF32 = tf32 and emulate
    SCAN_DTYPE = torch.float32 if tf32 else torch.float64
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _EMULATE_TF32, SCAN_DTYPE) = saved


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to 10 mantissa bits (to nearest), the gradient
    passed straight through."""
    if not _EMULATE_TF32:
        return x
    bits = x.detach().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _tf32(a) @ _tf32(b)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, _tf32(a), _tf32(b))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def cross_entropy(x: torch.Tensor, head: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL of ``x @ head`` (the logits materialized)."""
    logits = mm(x.reshape(-1, x.shape[-1]), head)
    return F.cross_entropy(logits, labels.reshape(-1))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding at positions 0..T-1 over the split halves of the
    head dim.  x: (B, T, H, hd)."""
    T, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                         dtype=torch.float32) / hd)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Causal GQA softmax attention with the (T, T) scores materialized.
    q: (B, T, Hq, hd); k, v: (B, T, Hkv, hd)."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    T = q.shape[1]
    s = einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, k)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return einsum("bhqk,bkhd->bqhd", p, v)


def ssd_scan(x, dt, A, Bm, Cm, D, chunk: int = 64) -> torch.Tensor:
    """Mamba2's SSD from a zero state: h_t = exp(A dt_t) h_{t-1} +
    dt_t x_t B_tᵀ, y_t = h_t C_t + D x_t, in the chunked form (within a
    chunk one masked product, across chunks the carried state).
    x: (B, T, H, P); dt: (B, T, H); A, D: (H,); Bm, Cm: (B, T, N)."""
    out_dtype = x.dtype
    x, dt, A, Bm, Cm, D = (t.to(SCAN_DTYPE) for t in (x, dt, A, Bm, Cm, D))
    Bs, T, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"sequence {T} is not a multiple of chunk {L}")
    nc = T // L
    xc = x.reshape(Bs, nc, L, H, P)
    dtc = dt.reshape(Bs, nc, L, H)
    Bc = Bm.reshape(Bs, nc, L, N)
    Cc = Cm.reshape(Bs, nc, L, N)
    cs = torch.cumsum(A * dtc, dim=2)                          # (B,c,L,H)
    rel = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (B,c,t,i,H)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(rel.masked_fill(~causal[:, :, None], float("-inf")))
    scores = einsum("bctn,bcin->bcti", Cc, Bc)
    M = scores[..., None] * decay * dtc[:, :, None, :, :]
    y = einsum("bctih,bcihp->bcthp", M, xc)
    w = torch.exp(cs[:, :, -1:, :] - cs) * dtc                 # (B,c,L,H)
    local = einsum("bcihp,bcin->bchpn", xc * w[..., None], Bc)
    h = x.new_zeros(Bs, H, P, N)
    entry = []
    for c in range(nc):
        entry.append(h)
        h = torch.exp(cs[:, c, -1, :])[..., None, None] * h + local[:, c]
    h_in = torch.stack(entry, dim=1)                           # (B,c,H,P,N)
    y = y + einsum("bctn,bchpn->bcthp", Cc, h_in) * torch.exp(cs)[..., None]
    return (y.reshape(Bs, T, H, P) + x * D[:, None]).to(out_dtype)
