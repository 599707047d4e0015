"""FL baselines the paper compares against (port of
``repro.fl.baselines``): FedAvg at a fixed width ratio (x min r), the
lowest-common-denominator baseline (McMahan et al. 2017).  HeteroFL,
SplitMix and DepthFL wait for their slice.

The local solver is SGD-momentum, as in the paper's setup.  A client
trains private copies: the tree it is given is never written.
"""
from __future__ import annotations

import torch

from repro_torch.configs.preresnet20 import ResNetConfig
from repro_torch.core import blockwise
from repro_torch.models import resnet
from repro_torch.tree import tree_map


_ce = blockwise._ce_logits


def fedavg_local(cfg: ResNetConfig, params, batches, *, lr=0.1,
                 momentum=0.9, local_steps=1):
    """Local SGD-momentum on the CE loss of the whole model from
    ``params`` (not written), ``local_steps`` passes over ``batches``;
    returns the trained copy."""
    params = tree_map(lambda t: t.detach().clone(), params)
    vel = tree_map(torch.zeros_like, params)
    for _ in range(local_steps):
        for b in batches:
            blockwise.sgd_momentum_(
                lambda: _ce(resnet.apply(params, cfg, b["images"]),
                            b["labels"]),
                params, vel, lr=lr, momentum=momentum)
    return params
