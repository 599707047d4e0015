"""ViT-T/16 — the paper's depth-wise fine-tuning model (port of
``repro.models.vit``).

All encoder blocks have identical activation shapes, which is the
paper's observation for why FeDepth skip connections are noise-free on
ViT.  Width-scalable for the FedAvg x1/6 baseline of paper Fig. 7.

Layout: ``params["blocks"]`` is a list with one dict per layer (the
reference stacks them on a leading layer axis; ``testing/convert.py``
carries them across), so a runner's ``split`` / ``merge`` are list
slices and splices, and they work unchanged on the vectorized path's
client-stacked trees.  Images arrive NHWC, and :func:`patchify` orders a
patch's features (row, column, channel) as the reference does.
Attention is plain PyTorch, ``softmax(q kᵀ / sqrt(hd))`` in fp32 over all
``N x N`` scores, as the reference computes and prices it (no kernel).
The GELU is the tanh approximation, ``jax.nn.gelu``'s default.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.vit_t16 import ViTConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common

Params = Dict[str, Any]


def dims(cfg: ViTConfig):
    d = max(8, int(round(cfg.d_model * cfg.width_ratio)))
    d -= d % cfg.num_heads
    dff = max(8, int(round(cfg.d_ff * cfg.width_ratio)))
    return d, dff


def _ln_init(d, **kw):
    return {"w": torch.ones(d, **kw), "b": torch.zeros(d, **kw)}


def _block_init(gen, d, dff, **kw):
    return {
        "ln1": _ln_init(d, **kw),
        "wqkv": common.dense_init(gen, (d, 3 * d), **kw),
        "wo": common.dense_init(gen, (d, d), **kw),
        "ln2": _ln_init(d, **kw),
        "w1": common.dense_init(gen, (d, dff), **kw),
        "b1": torch.zeros(dff, **kw),
        "w2": common.dense_init(gen, (dff, d), **kw),
        "b2": torch.zeros(d, **kw),
    }


def init(seed: Union[int, torch.Generator], cfg: ViTConfig, *,
         device: DeviceLike = None, dtype=torch.float32) -> Params:
    """Random parameters on ``device`` (the GPU unless ``"cpu"``), drawn
    from ``seed`` or a generator on that device.  Does not reproduce
    ``jax.random``: parity tests carry the reference's parameters across
    instead."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) \
        else torch.Generator(device=dev).manual_seed(int(seed))
    kw = dict(device=dev, dtype=dtype)
    d, dff = dims(cfg)
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.in_channels

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    return {
        "patch_embed": common.dense_init(gen, (patch_dim, d), **kw),
        "cls": normal(1, 1, d),
        "pos": normal(1, cfg.num_patches + 1, d),
        "blocks": [_block_init(gen, d, dff, **kw)
                   for _ in range(cfg.num_layers)],
        "head_norm": _ln_init(d, **kw),
        "classifier": {
            "w": common.dense_init(gen, (d, cfg.num_classes), **kw),
            "b": torch.zeros(cfg.num_classes, **kw),
        },
    }


def patchify(cfg: ViTConfig, images):
    """(B, H, W, C) -> (B, N, patch_dim), features ordered (row in patch,
    column in patch, channel)."""
    B, H, W, C = images.shape
    ps = cfg.patch_size
    x = images.reshape(B, H // ps, ps, W // ps, ps, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // ps) * (W // ps), ps * ps * C)


def _block_forward(bp, cfg: ViTConfig, x):
    B, N, d = x.shape
    nh = cfg.num_heads
    h = common.layer_norm(x, bp["ln1"]["w"], bp["ln1"]["b"])
    qkv = (h @ bp["wqkv"]).reshape(B, N, 3, nh, d // nh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (d // nh) ** 0.5
    attn = torch.softmax(scores.to(common.stat_dtype(scores)),
                         dim=-1).to(x.dtype)
    a = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, d)
    x = x + a @ bp["wo"]
    h = common.layer_norm(x, bp["ln2"]["w"], bp["ln2"]["b"])
    return x + F.gelu(h @ bp["w1"] + bp["b1"], approximate="tanh") \
        @ bp["w2"] + bp["b2"]


def embed(p: Params, cfg: ViTConfig, images):
    x = patchify(cfg, images) @ p["patch_embed"]
    cls = p["cls"].expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    return x + p["pos"]


def forward_blocks(p: Params, cfg: ViTConfig, x, lo: int, hi: int):
    """Run encoder blocks [lo, hi) on (B, N, d) tokens."""
    for bp in p["blocks"][lo:hi]:
        x = _block_forward(bp, cfg, x)
    return x


def head(p: Params, cfg: ViTConfig, x):
    h = common.layer_norm(x[:, 0], p["head_norm"]["w"], p["head_norm"]["b"])
    return h @ p["classifier"]["w"] + p["classifier"]["b"]


def apply(p: Params, cfg: ViTConfig, images):
    """images: (B, H, W, C) -> logits (B, num_classes)."""
    x = embed(p, cfg, images)
    x = forward_blocks(p, cfg, x, 0, cfg.num_layers)
    return head(p, cfg, x)
