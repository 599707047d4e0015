"""Plain PyTorch versions of the hand-written kernels.

Ports of ``repro.kernels.ref.attention``, ``cross_entropy_logits``,
``mamba2_scan`` and ``rwkv6_scan``: the semantic ground truth
(``cross_entropy_rows`` is the per-token form of the CE; it, ``attention``
and the scans compute in float64 for float64 inputs, which holds the
kernels to float64 on the card).  The kernel wrappers take these for
tensors on the CPU (the tests), and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  Nothing on the main path calls them
when a card is present.

Grouped forms (the stacked path's client axis, ``kernels/ops.py``'s vmap
rules): ``cross_entropy_rows`` takes a ``(G, D, V)`` head, the scans a
``(G, H)`` ``A`` / ``D`` or a ``(G, H, D)`` ``u``.  Batch rows
``[g·B/G, (g+1)·B/G)`` belong to group g and read its parameters; an
ungrouped parameter is shared by every row.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _per_row(p: torch.Tensor, ungrouped_dim: int, B: int) -> torch.Tensor:
    """A per-head parameter as one entry per batch row: ``p`` ungrouped
    (``ungrouped_dim`` dims) gains a leading axis of 1, a grouped ``p``
    (G, ...) repeats each group's entry for its B/G rows."""
    if p.dim() == ungrouped_dim:
        return p[None]
    G = p.shape[0]
    if B % G:
        raise ValueError(f"{B} batch rows do not split into {G} groups")
    return p.repeat_interleave(B // G, dim=0)


def attention(q: torch.Tensor,          # (B, Tq, Hq, D)
              k: torch.Tensor,          # (B, Tk, Hkv, D)
              v: torch.Tensor,          # (B, Tk, Hkv, D)
              *, causal: bool = True, sliding_window: int = 0,
              q_offset: int = 0,        # absolute position of q[0]
              scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention with optional causal mask / sliding window.

    Returns (B, Tq, Hq, D) in q's dtype.  Computes in fp32, or in float64
    when q is float64 (which holds the kernel to float64 on the card)."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    rep = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(ct) * scale
    kf = k.to(ct)
    vf = v.to(ct)
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
    n = (labels >= 0).sum().clamp(min=1)
    return cross_entropy_rows(hidden, lm_head, labels).sum() / n, n


def cross_entropy_rows(hidden: torch.Tensor,     # (B, T, D)
                       lm_head: torch.Tensor,    # (D, V) or (G, D, V)
                       labels: torch.Tensor,     # (B, T); -100 = ignore
                       ) -> torch.Tensor:
    """Per-token NLL, shape (B*T,), 0 where the label is ignored.
    Computes in fp32, or in float64 when hidden is float64.  A (G, D, V)
    head is one head per group of B/G batch rows."""
    ct = torch.float64 if hidden.dtype == torch.float64 else torch.float32
    if lm_head.dim() == 3:
        G, B = lm_head.shape[0], hidden.shape[0]
        if B % G:
            raise ValueError(f"{B} batch rows do not split into {G} groups")
        logits = torch.bmm(hidden.to(ct).reshape(G, -1, hidden.shape[-1]),
                           lm_head.to(ct)).reshape(*hidden.shape[:2], -1)
    else:
        logits = hidden.to(ct) @ lm_head.to(ct)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    return torch.where(labels >= 0, logz - gold, 0.0).reshape(-1)


def cross_entropy_lse_gold(hidden: torch.Tensor,    # (B, T, D)
                           lm_head: torch.Tensor,   # (D, V)
                           labels: torch.Tensor,    # (B, T) in [0, V]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per token, shape (B*T,) each: the log-sum-exp of the logits over
    the head's V columns, and the gold logit, 0 where the label is V (a
    column the head lacks).  A vocab shard's half of the CE."""
    ct = torch.float64 if hidden.dtype == torch.float64 else torch.float32
    logits = hidden.to(ct) @ lm_head.to(ct)
    V = logits.shape[-1]
    gold = torch.gather(logits, -1,
                        labels.clamp(max=V - 1).long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1).reshape(-1),
            torch.where(labels < V, gold, 0.0).reshape(-1))


def mamba2_scan(x: torch.Tensor,     # (B, T, H, P)
                dt: torch.Tensor,    # (B, T, H)  positive step sizes
                A: torch.Tensor,     # (H,) or (G, H)  negative decay rates
                Bm: torch.Tensor,    # (B, T, N)  shared across heads
                Cm: torch.Tensor,    # (B, T, N)
                D: torch.Tensor,     # (H,) or (G, H)  skip connection
                initial_state: Optional[torch.Tensor] = None,  # (B,H,P,N)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD, sequential over time: h_t = exp(A dt_t) h_{t-1} +
    dt_t (x_t ⊗ B_t), y_t = C_t · h_t + D x_t.  Computes in fp32, or in
    float64 when x is float64.  Returns (y in x's dtype, final state in
    the compute dtype)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, dtf, Bf, Cf = (t.to(ct) for t in (x, dt, Bm, Cm))
    Af, Df = (_per_row(t.to(ct), 1, Bsz) for t in (A, D))      # (1|B, H)
    h = (torch.zeros(Bsz, H, P, N, device=x.device, dtype=ct)
         if initial_state is None else initial_state.to(ct))
    ys = []
    for t in range(T):
        da = torch.exp(Af * dtf[:, t])                           # (B, H)
        dBx = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]
               * Bf[:, t, None, None, :])                        # (B,H,P,N)
        h = da[..., None, None] * h + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * Df[:, None, :, None]
    return y.to(x.dtype), h


def mamba2_scan_chunked(x, dt, A, Bm, Cm, D, initial_state=None, *,
                        chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as :func:`mamba2_scan` in the chunked SSD form
    (``repro.kernels.mamba2_ssd._ssd_kernel``): per chunk of ``chunk``
    steps, with cs = cumsum(A dt),
      y = (C Bᵀ ∘ exp(cs_t − cs_i) ∘ dt_i, i ≤ t) @ x
          + exp(cs_t) C · h_in + D x,
      h_out = exp(cs_last) h_in + (x ∘ exp(cs_last − cs) dt)ᵀ @ B.
    A handful of batched products instead of a T-step loop, so the
    backward's recompute is not launch-bound on the card.  The entries
    above the diagonal are set to −inf before ``exp``, so no inf (and no
    NaN in the gradient) ever arises; padded steps have dt = 0, which
    neither decays nor feeds the state.

    It computes in float64 and returns y in x's dtype and the state in
    float32.  The chunked form reassociates the sequential sums, and in
    float32 its gradient drifts ~1e-5 from the sequential one where terms
    cancel (the dt gradient through the cumulative sum); in float64 it
    agrees with the sequential float32 gradient to that gradient's own
    rounding."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    f64 = torch.float64
    L = min(chunk, T)
    pad = (-T) % L
    xf, dtf, Bf, Cf = (t.to(f64) for t in (x, dt, Bm, Cm))
    if pad:
        xf, dtf, Bf, Cf = (torch.nn.functional.pad(
            a, (0, 0) * (a.dim() - 2) + (0, pad)) for a in (xf, dtf, Bf, Cf))
    nc = (T + pad) // L
    xc = xf.reshape(Bsz, nc, L, H, P)
    dtc = dtf.reshape(Bsz, nc, L, H)
    Bc = Bf.reshape(Bsz, nc, L, N)
    Cc = Cf.reshape(Bsz, nc, L, N)
    cs = torch.cumsum(_per_row(A.to(f64), 1, Bsz)[:, None, None] * dtc,
                      dim=2)                                   # (B,nc,L,H)
    rel = cs[:, :, :, None, :] - cs[:, :, None, :, :]         # (B,nc,t,i,H)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[:, :, None], rel, -torch.inf))
    scores = torch.einsum("bctn,bcin->bcti", Cc, Bc)
    M = scores[..., None] * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bctih,bcihp->bcthp", M, xc)
    wgt = torch.exp(cs[:, :, -1:, :] - cs) * dtc               # (B,nc,L,H)
    local = torch.einsum("bcih,bcihp,bcin->bchpn", wgt, xc, Bc)
    h = (torch.zeros(Bsz, H, P, N, device=x.device, dtype=f64)
         if initial_state is None else initial_state.to(f64))
    entry = []
    for c in range(nc):
        entry.append(h)
        h = torch.exp(cs[:, c, -1, :])[..., None, None] * h + local[:, c]
    h_in = torch.stack(entry, dim=1)                           # (B,nc,H,P,N)
    y = y + torch.einsum("bctn,bchpn->bcthp", Cc, h_in) \
        * torch.exp(cs)[..., None]
    y = y.reshape(Bsz, nc * L, H, P)[:, :T] \
        + xf[:, :T] * _per_row(D.to(f64), 1, Bsz)[:, None, :, None]
    return y.to(x.dtype), h.float()


def rwkv6_scan(r: torch.Tensor,      # (B, T, H, D) receptance
               k: torch.Tensor,      # (B, T, H, D) key
               v: torch.Tensor,      # (B, T, H, D) value
               w: torch.Tensor,      # (B, T, H, D) decay logits
               u: torch.Tensor,      # (H, D) or (G, H, D) current-token bonus
               initial_state: Optional[torch.Tensor] = None,  # (B,H,D,D)
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6, sequential over time: S_t = diag(d_t) S_{t-1} + k_tᵀ v_t,
    y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t), d_t = exp(−exp(w_t)).
    Computes in fp32, or in float64 when r is float64.  Returns (y in r's
    dtype, final state in the compute dtype)."""
    Bsz, T, H, D = r.shape
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf = r.to(ct), k.to(ct), v.to(ct)
    decay = torch.exp(-torch.exp(w.to(ct)))
    uf = _per_row(u.to(ct), 2, Bsz)[..., None]                  # (1|B,H,D,1)
    # a copy of the initial state, never an alias of the argument: under
    # vmap of a vjp (the stacked path's rematerialized units) an aliased
    # zero state made inside the transform fails functorch's internal
    # assert in the backward
    S = (torch.zeros(Bsz, H, D, D, device=r.device, dtype=ct)
         if initial_state is None else initial_state.to(ct, copy=True))
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]         # (B,H,D,D)
        ys.append(torch.einsum("bhd,bhde->bhe", rf[:, t], S + uf * kv))
        S = decay[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S
