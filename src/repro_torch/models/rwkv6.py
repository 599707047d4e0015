"""RWKV-6 (Finch) — attention-free LM with data-dependent decay (port of
``repro.models.rwkv6``; arXiv:2404.05892).

Per layer:
  * time-mix: token-shift lerp with a data-dependent mix (LoRA on the
    shifted input), r/k/v/g/w projections, the WKV recurrence
    (``ops.rwkv6``, the CUDA kernel K4 on the card), a per-head group norm
    and the output gate;
  * channel-mix: token-shift lerp and a squared-ReLU FFN.
``params["layers"]`` is a list with one parameter dict per layer, so a
FeDepth block [lo, hi) is a list slice.  Prefill and decode (the state
and token-shift caches) wait for the serving slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common

Params = Dict[str, Any]
LORA_R = 32
GROUP_NORM_EPS = 64e-5


def _init_layer(gen: torch.Generator, cfg: ModelConfig, *, device,
                dtype) -> Params:
    d, dff = cfg.d_model, cfg.d_ff
    hd = cfg.rwkv_head_dim
    H = d // hd
    kw = dict(device=device, dtype=dtype)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return {
        "tm_norm": torch.ones(d, **kw),
        # token-shift mix coefficients (static part) for r, k, v, g, w
        "mix": (uniform(5, d) * 0.5).to(dtype),
        # data-dependent mix LoRA
        "mix_lora_a": common.dense_init(gen, (d, LORA_R * 5), **kw),
        "mix_lora_b": common.dense_init(gen, (5, LORA_R, d), 0.01, **kw),
        "wr": common.dense_init(gen, (d, d), **kw),
        "wk": common.dense_init(gen, (d, d), **kw),
        "wv": common.dense_init(gen, (d, d), **kw),
        "wg": common.dense_init(gen, (d, d), **kw),
        # data-dependent decay: w = base + lora
        "w_base": (normal(d) * 0.5 - 0.5).to(dtype),
        "w_lora_a": common.dense_init(gen, (d, LORA_R), **kw),
        "w_lora_b": common.dense_init(gen, (LORA_R, d), 0.01, **kw),
        "bonus_u": (normal(H, hd) * 0.1).to(dtype),
        "ln_x": torch.ones(d, **kw),
        "wo": common.dense_init(gen, (d, d), **kw),
        "cm_norm": torch.ones(d, **kw),
        "cm_mix": (uniform(2, d) * 0.5).to(dtype),
        "cm_k": common.dense_init(gen, (d, dff), **kw),
        "cm_v": common.dense_init(gen, (dff, d), **kw),
        "cm_r": common.dense_init(gen, (d, d), **kw),
    }


def init(cfg: ModelConfig, *, generator: torch.Generator, device,
         dtype=common.DEFAULT_DTYPE) -> Params:
    kw = dict(device=device, dtype=dtype)
    return {
        "layers": [_init_layer(generator, cfg, **kw)
                   for _ in range(cfg.num_layers)],
        "embed": common.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                   **kw),
        "final_norm": torch.ones(cfg.d_model, **kw),
        "lm_head": common.dense_init(generator,
                                     (cfg.d_model, cfg.vocab_size), **kw),
    }


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """The x_{t-1} sequence, zeros at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _time_mix(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    B, T, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    xs = _token_shift(x)
    base = xs + (x - xs) * 0.5  # anchor of the data-dependent mix
    lora = torch.tanh(base @ lp["mix_lora_a"]).reshape(B, T, 5, LORA_R)
    dyn = torch.einsum("btfr,frd->btfd", lora, lp["mix_lora_b"])
    mixed = xs[:, :, None, :] + (x - xs)[:, :, None, :] * \
        (lp["mix"][None, None] + dyn)                       # (B, T, 5, d)
    mr, mk, mv, mg, mw = mixed.unbind(dim=2)

    r = (mr @ lp["wr"]).reshape(B, T, H, hd)
    k = (mk @ lp["wk"]).reshape(B, T, H, hd)
    v = (mv @ lp["wv"]).reshape(B, T, H, hd)
    g = F.silu(mg @ lp["wg"])
    w = (lp["w_base"] + torch.tanh(mw @ lp["w_lora_a"]) @ lp["w_lora_b"]
         ).reshape(B, T, H, hd)

    y, _ = ops.rwkv6(r, k, v, w, lp["bonus_u"])
    # per-head group norm, population variance (as jnp.var)
    yh = y.float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    y = (yh.reshape(B, T, d) * lp["ln_x"]).to(x.dtype)
    return (y * g) @ lp["wo"]


def _channel_mix(lp: Params, x: torch.Tensor) -> torch.Tensor:
    xs = _token_shift(x)
    mk = xs + (x - xs) * lp["cm_mix"][0]
    mr = xs + (x - xs) * lp["cm_mix"][1]
    k = torch.square(torch.relu(mk @ lp["cm_k"]))
    return torch.sigmoid(mr @ lp["cm_r"]) * (k @ lp["cm_v"])


def _layer_forward(lp: Params, cfg: ModelConfig,
                   x: torch.Tensor) -> torch.Tensor:
    h = common.rms_norm(x, lp["tm_norm"], cfg.norm_eps)
    x = x + _time_mix(lp, cfg, h)
    h = common.rms_norm(x, lp["cm_norm"], cfg.norm_eps)
    return x + _channel_mix(lp, h)


def apply_layer_range(p: Params, cfg: ModelConfig, x: torch.Tensor, lo: int,
                      hi: int) -> Tuple[torch.Tensor, float]:
    """Layers [lo, hi) over hidden states x; no auxiliary loss."""
    for lp in p["layers"][lo:hi]:
        x = _layer_forward(lp, cfg, x)
    return x, 0.0


def forward_hidden(p: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """Embeddings -> every layer -> hidden states (pre final-norm)."""
    return apply_layer_range(p, cfg, p["embed"][tokens], 0, cfg.num_layers)


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token CE on a train batch."""
    x, _ = forward_hidden(p, cfg, batch["tokens"])
    x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
    ce, n = ops.cross_entropy(x, common.head_weight(p, cfg), batch["labels"])
    return ce, {"ce": ce, "aux": 0.0, "n_tokens": n}
