"""Pre-activation ResNet-20 (He et al. 2016b) — the paper's FL model
(port of ``repro.models.resnet``).

Depth-decomposable: stem + 9 two-conv blocks + head, the paper's Table 1
B_1..B_9.  GroupNorm in place of BatchNorm, as in the reference.

Layout: conv weights are OIHW and activations NCHW inside the port (the
reference keeps HWIO / NHWC; ``testing/convert.py`` carries weights
across).  Images arrive NHWC, as the data module and the reference hold
them, and :func:`stem` permutes them once.  Convolutions use the
reference's SAME padding, which is asymmetric for a 3x3 stride-2 conv on
an even input: (0, 1), not (1, 1).  On the card the convolutions run
in fp32 (cuDNN's TF32 off, :func:`repro_torch.device.use_fp32`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.preresnet20 import ResNetConfig
from repro_torch.device import DeviceLike, resolve_device, use_fp32
from repro_torch.models import common

Params = Dict[str, Any]
GN_GROUPS = 8


def _conv_init(gen, kh, kw, cin, cout, *, device, dtype):
    scale = (2.0 / (kh * kw * cin)) ** 0.5
    w = torch.randn(cout, cin, kh, kw, generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of XLA's "SAME" along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    if x.is_cuda:
        use_fp32()      # also for parameters moved to the card by hand
    (h0, h1), (w0, w1) = (_same_pads(x.shape[d], w.shape[d], stride)
                          for d in (2, 3))
    if h0 == h1 and w0 == w1:
        return F.conv2d(x, w, stride=stride, padding=(h0, w0))
    return F.conv2d(F.pad(x, (w0, w1, h0, h1)), w, stride=stride)


def groups_for(channels: int, groups: int = GN_GROUPS) -> int:
    """The reference's group count: ``min(groups, C)``, stepped down
    until it divides C."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def group_norm(x, w, b, groups=GN_GROUPS, eps=1e-5):
    """GroupNorm over NCHW with fp32 statistics (float64 for float64
    inputs; biased variance) on
    contiguous channel groups, as the reference's reshape groups them."""
    g = groups_for(x.shape[1], groups)
    dt = common.stat_dtype(x)
    return F.group_norm(x.to(dt), g, w.to(dt), b.to(dt), eps).to(x.dtype)


def _norm_init(c, *, device, dtype):
    return {"w": torch.ones(c, device=device, dtype=dtype),
            "b": torch.zeros(c, device=device, dtype=dtype)}


def block_channels(cfg: ResNetConfig) -> List[Tuple[int, int, int]]:
    """Per residual block: (c_in, c_out, stride)."""
    widths = cfg.widths()
    out = []
    c_in = widths[0]
    for s, (n, w) in enumerate(zip(cfg.stage_blocks, widths)):
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            out.append((c_in, w, stride))
            c_in = w
    return out


def init(seed: Union[int, torch.Generator], cfg: ResNetConfig, *,
         device: DeviceLike = None, dtype=torch.float32) -> Params:
    """Random parameters on ``device`` (the GPU unless ``"cpu"``), drawn
    from ``seed`` or a generator on that device.  Does not reproduce
    ``jax.random``: parity tests carry the reference's parameters across
    instead."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) \
        else torch.Generator(device=dev).manual_seed(int(seed))
    kw = dict(device=dev, dtype=dtype)
    widths = cfg.widths()
    stem_w = _conv_init(gen, 3, 3, cfg.in_channels, widths[0], **kw)
    blocks = []
    for cin, cout, stride in block_channels(cfg):
        bp = {
            "n1": _norm_init(cin, **kw),
            "conv1": _conv_init(gen, 3, 3, cin, cout, **kw),
            "n2": _norm_init(cout, **kw),
            "conv2": _conv_init(gen, 3, 3, cout, cout, **kw),
        }
        if stride != 1 or cin != cout:
            bp["proj"] = _conv_init(gen, 1, 1, cin, cout, **kw)
        blocks.append(bp)
    return {
        "stem": stem_w,
        "blocks": blocks,
        "head_norm": _norm_init(widths[-1], **kw),
        "classifier": {
            "w": common.dense_init(gen, (widths[-1], cfg.num_classes), **kw),
            "b": torch.zeros(cfg.num_classes, **kw),
        },
    }


def _block_forward(bp, x, stride):
    h = F.relu(group_norm(x, bp["n1"]["w"], bp["n1"]["b"]))
    sc = _conv(h, bp["proj"], stride) if "proj" in bp else x
    h = _conv(h, bp["conv1"], stride)
    h = F.relu(group_norm(h, bp["n2"]["w"], bp["n2"]["b"]))
    h = _conv(h, bp["conv2"], 1)
    return sc + h


def forward_blocks(p: Params, cfg: ResNetConfig, x, lo: int, hi: int):
    """Run residual blocks [lo, hi) on NCHW feature maps x."""
    chans = block_channels(cfg)
    for i in range(lo, hi):
        x = _block_forward(p["blocks"][i], x, chans[i][2])
    return x


def stem(p: Params, images):
    """NHWC images -> NCHW stem features."""
    return _conv(images.permute(0, 3, 1, 2).contiguous(), p["stem"], 1)


def head(p: Params, cfg: ResNetConfig, x):
    x = F.relu(group_norm(x, p["head_norm"]["w"], p["head_norm"]["b"]))
    x = x.mean((2, 3))
    return x @ p["classifier"]["w"] + p["classifier"]["b"]


def apply(p: Params, cfg: ResNetConfig, images):
    """images: (B, H, W, C) -> logits (B, num_classes)."""
    x = stem(p, images)
    x = forward_blocks(p, cfg, x, 0, cfg.num_blocks)
    return head(p, cfg, x)


# ----- FeDepth skip-connection head (paper: zero-pad channels + pool) -----
def head_from_block(p: Params, cfg: ResNetConfig, x, block_idx: int):
    """Attach the classifier to an intermediate block's activation via the
    paper's skip connection: zero-pad channels to the head width, then the
    normal head.

    When the padding fills whole norm groups (PreResNet-20's widths: 16
    and 32 channels of 64, groups of 8), the padded channels are never
    built: a group of zeros normalizes to its bias, so each padded
    channel's pooled feature is ``relu(bias)``, whatever the input.  The
    head then norms and pools the real channels only, and backward holds
    the block's own activations, not four times their size of padding
    (the memory auditor's finding, ROADMAP.md §3, fault 17).  The values
    are the padded head's up to the order of the pooling sum."""
    c_head = cfg.widths()[-1]
    c_cur = x.shape[1]
    if c_cur < c_head:
        per = c_head // groups_for(c_head)
        if c_cur % per:
            return head(p, cfg, F.pad(x, (0, 0, 0, 0, 0, c_head - c_cur)))
        n = p["head_norm"]
        real = F.relu(group_norm(x, n["w"][:c_cur], n["b"][:c_cur],
                                 groups=c_cur // per)).mean((2, 3))
        pad = F.relu(n["b"][c_cur:]).to(real.dtype)
        x = torch.cat([real, pad.expand(real.shape[0], -1)], dim=1)
        return x @ p["classifier"]["w"] + p["classifier"]["b"]
    return head(p, cfg, x)
