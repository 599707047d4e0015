"""Plain dense decoder (GQA attention, SwiGLU): the reference of the
``dense`` configs.

A layer is the one ``repro_torch`` runs (its ``models/transformer.py``
and ``models/attention.py``), as Qwen2 publishes it (arXiv:2407.10671):
rms-norm -> q, k, v projections (with their biases when ``qkv_bias``)
-> rotary embedding over the split halves of each head at positions
0..T-1 -> causal softmax attention, each kv head serving its group of q
heads -> output projection, added to the residual; rms-norm -> SwiGLU
(silu(x W_gate) * x W_up) W_down, added to the residual.  The head is
rms-norm -> ``lm_head`` (or the tied embedding).

The parameters are a nested tree in the program's layout (one dict a
layer under ``units``), made here on the device from a generator, in a
few large draws.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from fedbench.reference import ops


def _hd(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.num_heads


# ------------------------------------------------------------ the prices
def num_units(cfg) -> int:
    return cfg.num_layers


def _attn_params(cfg) -> int:
    d, hd, nq, nkv = cfg.d_model, _hd(cfg), cfg.num_heads, cfg.num_kv_heads
    p = 2 * d * nq * hd + 2 * d * nkv * hd
    return p + ((nq + 2 * nkv) * hd if cfg.qkv_bias else 0)


def unit_param_count(cfg) -> int:
    return _attn_params(cfg) + 3 * cfg.d_model * cfg.d_ff + 2 * cfg.d_model


def unit_act_elems(cfg, n_tokens: int) -> int:
    d, hd, nq, nkv = cfg.d_model, _hd(cfg), cfg.num_heads, cfg.num_kv_heads
    att = 2 * d + (nq + 2 * nkv) * hd + nq * hd
    return n_tokens * (att + d + 3 * cfg.d_ff)


def head_param_count(cfg) -> int:
    d = cfg.d_model
    return d + (0 if cfg.tie_embeddings else d * cfg.vocab_size)


def prefix_stable(cfg) -> bool:
    return not cfg.tie_embeddings


def unit_matmul_flops(cfg, n_tokens: int) -> float:
    """Forward FLOPs of one layer's projections: 2 a weight a token."""
    d, hd, nq, nkv = cfg.d_model, _hd(cfg), cfg.num_heads, cfg.num_kv_heads
    return 2.0 * n_tokens * (2 * d * nq * hd + 2 * d * nkv * hd
                             + 3 * d * cfg.d_ff)


def unit_flops(cfg, batch: int, seq: int) -> float:
    """Useful forward FLOPs of one layer on ``batch`` x ``seq`` tokens:
    its projections and attention's 4 hd a live (causal) q, k pair and q
    head (``counts.k2_call``)."""
    pairs = seq * (seq + 1) // 2
    return (unit_matmul_flops(cfg, batch * seq)
            + 4.0 * _hd(cfg) * pairs * batch * cfg.num_heads)


# ------------------------------------------------------------ the weights
def init(cfg, gen: torch.Generator, device) -> dict:
    L, d, f, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd, nq, nkv = _hd(cfg), cfg.num_heads, cfg.num_kv_heads
    kw = dict(generator=gen, device=device)

    def dense(shape, fan_in):
        return torch.randn(L, *shape, **kw).mul_(fan_in ** -0.5)

    wq, wk, wv = (dense((d, n * hd), d) for n in (nq, nkv, nkv))
    wo = dense((nq * hd, d), nq * hd)
    gate, up = dense((d, f), d), dense((d, f), d)
    down = dense((f, d), f)
    norms = torch.ones(2, L, d, device=device)
    bias = torch.zeros(L, (nq + 2 * nkv) * hd, device=device)
    units = []
    for i in range(L):
        attn = {"wq": wq[i], "wk": wk[i], "wv": wv[i], "wo": wo[i]}
        if cfg.qkv_bias:
            attn["bq"], attn["bk"], attn["bv"] = torch.split(
                bias[i], [nq * hd, nkv * hd, nkv * hd])
        units.append({"attn_norm": norms[0, i], "attn": attn,
                      "mlp_norm": norms[1, i],
                      "mlp": {"w_gate": gate[i], "w_up": up[i],
                              "w_down": down[i]}})
    p = {"units": units,
         "embed": torch.randn(V, d, **kw).mul_(0.02),
         "final_norm": torch.ones(d, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = torch.randn(d, V, **kw).mul_(d ** -0.5)
    return p


def trains(cfg, path: str, lo: int, hi: int) -> bool:
    """Whether the block [lo, hi) trains the leaf at ``path``: its
    layers, the head (and the tied embedding), the embedding at 0."""
    top, _, rest = path.partition(".")
    if top == "units":
        return lo <= int(rest.partition(".")[0]) < hi
    if top == "embed":
        return cfg.tie_embeddings or lo == 0
    return top in ("final_norm", "lm_head")


# ------------------------------------------------------------ the model
def embed(p, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def _attention(a, cfg, x: torch.Tensor) -> torch.Tensor:
    B, T, _ = x.shape
    hd = _hd(cfg)
    q, k, v = ops.mm(x, a["wq"]), ops.mm(x, a["wk"]), ops.mm(x, a["wv"])
    if cfg.qkv_bias:
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    q = ops.rope(q.reshape(B, T, cfg.num_heads, hd), cfg.rope_theta)
    k = ops.rope(k.reshape(B, T, cfg.num_kv_heads, hd), cfg.rope_theta)
    out = ops.causal_attention(q, k, v.reshape(B, T, cfg.num_kv_heads, hd))
    return ops.mm(out.reshape(B, T, -1), a["wo"])


def _layer(u, cfg, x: torch.Tensor) -> torch.Tensor:
    x = x + _attention(u["attn"], cfg,
                       ops.rms_norm(x, u["attn_norm"], cfg.norm_eps))
    h = ops.rms_norm(x, u["mlp_norm"], cfg.norm_eps)
    m = u["mlp"]
    return x + ops.mm(F.silu(ops.mm(h, m["w_gate"])) * ops.mm(h, m["w_up"]),
                      m["w_down"])


def apply_units(p, cfg, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    for u in p["units"][lo:hi]:
        x = _layer(u, cfg, x)
    return x


def head_weight(p, cfg) -> torch.Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


def head_loss(p, cfg, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return ops.cross_entropy(ops.rms_norm(x, p["final_norm"], cfg.norm_eps),
                             head_weight(p, cfg), labels)
