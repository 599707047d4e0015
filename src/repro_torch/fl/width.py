"""Width-slimming utilities for the HeteroFL / SplitMix baselines and
FedAvg at the cohort's lowest common width (port of ``repro.fl.width``).

HeteroFL subnetworks are PREFIX channel slices of the global PreResNet:
a client at ratio r takes the first round(r*C) channels of every conv /
norm / classifier input.  Padding a local model back to full size plus
a 0/1 mask enables the server's nested aggregation.

Layout: the port keeps conv weights OIHW (the reference HWIO), so a
conv is sliced ``[:c_out, :c_in]`` and the stem ``[:w0]``; the classifier
is ``(C, classes)`` on both sides and is sliced on its rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.preresnet20 import ResNetConfig
from repro_torch.models import resnet


def subnet_config(cfg_full: ResNetConfig, ratio: float) -> ResNetConfig:
    return dataclasses.replace(cfg_full, width_ratio=ratio,
                               name=f"{cfg_full.name}-x{ratio:g}")


def _norm(n, c: int):
    return {"w": n["w"][:c], "b": n["b"][:c]}


def slice_resnet(params, cfg_full: ResNetConfig,
                 ratio: float) -> Tuple[Dict[str, Any], ResNetConfig]:
    """Take the prefix-channel subnetwork at width ``ratio``.  Returns
    (sub_params, sub_cfg); the sub-tree's leaves are views of
    ``params``."""
    sub_cfg = subnet_config(cfg_full, ratio)
    w0 = sub_cfg.widths()[0]
    blocks = []
    for bp, (sin, sout, _) in zip(params["blocks"],
                                  resnet.block_channels(sub_cfg)):
        nb = {"n1": _norm(bp["n1"], sin),
              "conv1": bp["conv1"][:sout, :sin],
              "n2": _norm(bp["n2"], sout),
              "conv2": bp["conv2"][:sout, :sout]}
        if "proj" in bp:
            nb["proj"] = bp["proj"][:sout, :sin]
        blocks.append(nb)
    wl = sub_cfg.widths()[-1]
    out = {"stem": params["stem"][:w0], "blocks": blocks,
           "head_norm": _norm(params["head_norm"], wl),
           "classifier": {"w": params["classifier"]["w"][:wl],
                          "b": params["classifier"]["b"]}}
    return out, sub_cfg


def pad_resnet(sub_params, cfg_full: ResNetConfig, sub_cfg: ResNetConfig):
    """Zero-pad a subnetwork back to full shape, plus a matching float32
    0/1 mask.  The full shapes come from ``resnet.init`` on the meta
    device (no memory, no second draw on the card)."""
    template = resnet.init(torch.Generator(), cfg_full, device="meta")
    flat_small = _flatten(sub_params)
    device = next(iter(flat_small.values())).device
    padded, masks = {}, {}
    for k, big in _flatten(template).items():
        p = torch.zeros(big.shape, dtype=big.dtype, device=device)
        m = torch.zeros(big.shape, dtype=torch.float32, device=device)
        small = flat_small.get(k)
        if small is not None:   # a leaf absent in the subnetwork stays 0
            corner = tuple(slice(0, s) for s in small.shape)
            p[corner] = small
            m[corner] = 1.0
        padded[k] = p
        masks[k] = m
    return _unflatten(padded), _unflatten(masks)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        return [_listify(node[str(i)]) for i in range(len(keys))]
    return {k: _listify(v) for k, v in node.items()}
