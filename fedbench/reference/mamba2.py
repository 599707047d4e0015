"""Plain Mamba2 language model: the reference of the ``mamba2`` configs.

The layer is the one ``repro_torch`` runs (its ``models/mamba2.py``):
rms-norm -> one input projection to [z | x | B | C | dt] -> causal
depthwise conv (kernel 4) on x -> silu on x, B, C -> dt = softplus(dt +
dt_bias), A = -exp(A_log) -> SSD scan with one B and C shared by the
heads -> gate by silu(z) -> output projection, added to the residual.
Departures from the published Mamba2 block (arXiv:2405.21060), which
both sides share: the conv covers x only (not B and C), and there is no
gated rms-norm before the output projection.  The embedding is tied to
the head when the config says so.

The parameters are a nested tree in the program's layout, made here on
the device from a generator, in a few large draws.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from fedbench.reference import ops

CONV_K = 4


def _din(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def _proj(cfg) -> int:
    return 2 * _din(cfg) + 2 * cfg.ssm_state_dim + cfg.ssm_num_heads


# ------------------------------------------------------------ the prices
def num_units(cfg) -> int:
    return cfg.num_layers


def unit_param_count(cfg) -> int:
    d, din, nh = cfg.d_model, _din(cfg), cfg.ssm_num_heads
    return d * _proj(cfg) + din * d + 5 * din + 3 * nh + d


def unit_act_elems(cfg, n_tokens: int) -> int:
    return n_tokens * (_proj(cfg) + 2 * _din(cfg))


def head_param_count(cfg) -> int:
    d = cfg.d_model
    return d + (0 if cfg.tie_embeddings else d * cfg.vocab_size)


def prefix_stable(cfg) -> bool:
    """A tied head trains the embedding that feeds the frozen prefix."""
    return not cfg.tie_embeddings


def unit_matmul_flops(cfg, n_tokens: int) -> float:
    """Forward FLOPs of one layer's two projections: 2 a weight a
    token."""
    d, din = cfg.d_model, _din(cfg)
    return 2.0 * n_tokens * (d * _proj(cfg) + din * d)


def unit_flops(cfg, batch: int, seq: int) -> float:
    """Useful forward FLOPs of one layer on ``batch`` x ``seq`` tokens:
    its projections, the conv (2 a tap a channel a token) and the scan's
    recurrence (5 a state element and 3 a head channel, a token:
    ``counts.k3_call``)."""
    n = batch * seq
    H, P, N = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim
    return (unit_matmul_flops(cfg, n) + 2.0 * n * CONV_K * _din(cfg)
            + 5.0 * n * H * P * N + 3.0 * n * H * P)


# ------------------------------------------------------------ the weights
def init(cfg, gen: torch.Generator, device) -> dict:
    L, d, din = cfg.num_layers, cfg.d_model, _din(cfg)
    nh, V = cfg.ssm_num_heads, cfg.vocab_size
    kw = dict(generator=gen, device=device)
    in_proj = torch.randn(L, d, _proj(cfg), **kw).mul_(d ** -0.5)
    out_proj = torch.randn(L, din, d, **kw).mul_(din ** -0.5)
    conv_w = torch.randn(L, CONV_K, din, **kw).mul_(0.1)
    ones_d = torch.ones(L, d, device=device)
    zeros_din = torch.zeros(L, din, device=device)
    heads = torch.zeros(3, L, nh, device=device)
    heads[2] = 1.0                                  # D
    layers = [{"norm": ones_d[i], "in_proj": in_proj[i],
               "conv_w": conv_w[i], "conv_b": zeros_din[i],
               "dt_bias": heads[0, i], "A_log": heads[1, i],
               "D": heads[2, i], "out_proj": out_proj[i]}
              for i in range(L)]
    p = {"layers": layers,
         "embed": torch.randn(V, d, **kw).mul_(0.02),
         "final_norm": torch.ones(d, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = torch.randn(d, V, **kw).mul_(d ** -0.5)
    return p


def trains(cfg, path: str, lo: int, hi: int) -> bool:
    """Whether the block [lo, hi) trains the leaf at ``path``: its
    layers, the head (and the tied embedding), the embedding at 0."""
    top, _, rest = path.partition(".")
    if top == "layers":
        return lo <= int(rest.partition(".")[0]) < hi
    if top == "embed":
        return cfg.tie_embeddings or lo == 0
    return top in ("final_norm", "lm_head")


# ------------------------------------------------------------ the model
def embed(p, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    T = x.shape[1]
    xp = F.pad(x, (0, 0, CONV_K - 1, 0))
    out = xp[:, 0:T] * w[0]
    for i in range(1, CONV_K):
        out = out + xp[:, i:i + T] * w[i]
    return out + b


def _layer(lp, cfg, x: torch.Tensor) -> torch.Tensor:
    B, T, _ = x.shape
    din, N, nh = _din(cfg), cfg.ssm_state_dim, cfg.ssm_num_heads
    h = ops.rms_norm(x, lp["norm"], cfg.norm_eps)
    z, xs, Bm, Cm, dt = torch.split(ops.mm(h, lp["in_proj"]),
                                    [din, din, N, N, nh], dim=-1)
    xs = F.silu(_conv(xs, lp["conv_w"], lp["conv_b"]))
    dt = F.softplus(dt + lp["dt_bias"])
    y = ops.ssd_scan(xs.reshape(B, T, nh, cfg.ssm_head_dim), dt,
                     -torch.exp(lp["A_log"]), F.silu(Bm), F.silu(Cm),
                     lp["D"])
    return x + ops.mm(y.reshape(B, T, din) * F.silu(z), lp["out_proj"])


def apply_units(p, cfg, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    for lp in p["layers"][lo:hi]:
        x = _layer(lp, cfg, x)
    return x


def head_weight(p, cfg) -> torch.Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


def head_loss(p, cfg, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return ops.cross_entropy(ops.rms_norm(x, p["final_norm"], cfg.norm_eps),
                             head_weight(p, cfg), labels)
