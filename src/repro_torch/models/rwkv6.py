"""RWKV-6 (Finch) — attention-free LM with data-dependent decay (port of
``repro.models.rwkv6``; arXiv:2404.05892).

Per layer:
  * time-mix: token-shift lerp with a data-dependent mix (LoRA on the
    shifted input), r/k/v/g/w projections, the WKV recurrence
    (``ops.rwkv6``, the CUDA kernel K4 on the card), a per-head group norm
    and the output gate;
  * channel-mix: token-shift lerp and a squared-ReLU FFN.
``params["layers"]`` is a list with one parameter dict per layer, so a
FeDepth block [lo, hi) is a list slice.  Decode carries each layer's WKV
state and its two token shifts (the last input of the time mix and of
the channel mix), O(1) in sequence length.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dtensor import whole_where_uneven
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


def _token_shift(x: torch.Tensor,
                 shifted_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The x_{t-1} sequence: zeros at t = 0, or the carried (B, 1, d)
    input of the previous call."""
    if shifted_in is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([shifted_in.to(x.dtype), x[:, :-1]], dim=1)


def _time_mix(lp: Params, cfg: ModelConfig, x: torch.Tensor, state=None,
              shift=None):
    """Returns (output, the new WKV state, the last input (B, 1, d))."""
    B, T, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    xs = _token_shift(x, shift)
    base = xs + (x - xs) * 0.5  # anchor of the data-dependent mix
    # a DTensor's 5 mixes and H heads split evenly over the mesh, or not
    # at all (DTensor has no rule for an uneven unflatten)
    lora = whole_where_uneven(torch.tanh(base @ lp["mix_lora_a"]), -1,
                              5).reshape(B, T, 5, LORA_R)
    dyn = torch.einsum("btfr,frd->btfd", lora, lp["mix_lora_b"])
    mixed = xs[:, :, None, :] + (x - xs)[:, :, None, :] * \
        (lp["mix"][None, None] + dyn)                       # (B, T, 5, d)
    mr, mk, mv, mg, mw = mixed.unbind(dim=2)

    def heads(t):
        return whole_where_uneven(t, -1, H).reshape(B, T, H, hd)

    r = heads(mr @ lp["wr"])
    k = heads(mk @ lp["wk"])
    v = heads(mv @ lp["wv"])
    g = F.silu(mg @ lp["wg"])
    w = heads(lp["w_base"] + torch.tanh(mw @ lp["w_lora_a"])
              @ lp["w_lora_b"])

    y, new_state = ops.rwkv6(r, k, v, w, lp["bonus_u"], state)
    # per-head group norm, population variance (as jnp.var)
    yh = y.float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    y = (yh.reshape(B, T, d) * lp["ln_x"]).to(x.dtype)
    return (y * g) @ lp["wo"], new_state, x[:, -1:]


def _channel_mix(lp: Params, x: torch.Tensor, shift=None):
    """Returns (output, the last input (B, 1, d))."""
    xs = _token_shift(x, shift)
    mk = xs + (x - xs) * lp["cm_mix"][0]
    mr = xs + (x - xs) * lp["cm_mix"][1]
    k = torch.square(torch.relu(mk @ lp["cm_k"]))
    return torch.sigmoid(mr @ lp["cm_r"]) * (k @ lp["cm_v"]), x[:, -1:]


def _layer_forward(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                   state=None, shifts=None):
    """Returns (x, the new WKV state, (time-mix, channel-mix) last
    inputs)."""
    h = common.rms_norm(x, lp["tm_norm"], cfg.norm_eps)
    tm, new_state, tm_last = _time_mix(lp, cfg, h, state,
                                       None if shifts is None else shifts[0])
    x = x + tm
    h = common.rms_norm(x, lp["cm_norm"], cfg.norm_eps)
    cm, cm_last = _channel_mix(lp, h, None if shifts is None else shifts[1])
    return x + cm, new_state, (tm_last, cm_last)


def apply_layer_range(p: Params, cfg: ModelConfig, x: torch.Tensor, lo: int,
                      hi: int, *, remat: bool = True
                      ) -> Tuple[torch.Tensor, float]:
    """Layers [lo, hi) over hidden states x; no auxiliary loss.  With
    ``remat`` each layer is one rematerialized body."""
    def layer_body(x, lp):
        return _layer_forward(lp, cfg, x)[0]

    body = common.maybe_checkpoint(layer_body, remat)
    for lp in p["layers"][lo:hi]:
        x = body(x, lp)
    return x, 0.0


def forward_hidden(p: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   remat: bool = True):
    """Embeddings -> every layer -> hidden states (pre final-norm)."""
    return apply_layer_range(p, cfg, p["embed"][tokens], 0, cfg.num_layers,
                             remat=remat)


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token CE on a train batch."""
    x, _ = forward_hidden(p, cfg, batch["tokens"])
    x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
    ce, n = ops.cross_entropy(x, common.head_weight(p, cfg), batch["labels"])
    return ce, {"ce": ce, "aux": 0.0, "n_tokens": n}


def prefill(p: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """The prompt's forward: last-position logits (B, 1, V)."""
    x, _ = forward_hidden(p, cfg, batch["tokens"], remat=False)
    x = common.rms_norm(x[:, -1:], p["final_norm"], cfg.norm_eps)
    return x @ common.head_weight(p, cfg)


def decode_step(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_index: int, *,
                mrope_positions=None):
    """One decode step.  cache: {"rwkv_state": (L, B, H, hd, hd) fp32,
    "rwkv_shift": (L, 2, B, d)}.  Returns (logits (B, 1, V), the new
    cache); ``cache`` is left as it was; ``mrope_positions`` (a VLM's) is
    ignored.  The new shifts are in the
    hidden states' dtype (fp32), not the bf16 of ``init_cache``'s zeros,
    as the reference's ``decode_step`` returns them."""
    x = p["embed"][tokens]                      # (B, 1, d)
    states, shifts = [], []
    for lp, state, shift in zip(p["layers"], cache["rwkv_state"],
                                cache["rwkv_shift"]):
        x, new_state, (tm_last, cm_last) = _layer_forward(
            lp, cfg, x, state, (shift[0][:, None], shift[1][:, None]))
        states.append(new_state)
        shifts.append(torch.stack([tm_last[:, 0], cm_last[:, 0]]))
    x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
    return x @ common.head_weight(p, cfg), {
        "rwkv_state": torch.stack(states), "rwkv_shift": torch.stack(shifts)}
