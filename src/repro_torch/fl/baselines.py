"""FL baselines the paper compares against (port of
``repro.fl.baselines``), on PreResNet:

  * ``fedavg_local``  — FedAvg at a fixed width ratio (x min r), the
    lowest-common-denominator baseline (McMahan et al. 2017); also on
    ViT (paper Fig. 7's x1/6 baseline).  ``fedavg_local_batched`` runs a
    group of clients as one stacked update.
  * ``heterofl_*``    — width slimming with nested prefix-slice
    aggregation (Diao et al. 2021).
  * ``SplitMixState`` — base sub-networks of width r, mixed into an
    ensemble (Hong et al. 2022); its round is ``SplitMixStrategy``'s.
  * ``depthfl_*``     — FIXED-depth prefix sub-models with auxiliary
    classifiers (Kim et al. 2023), sized to memory budgets as the paper
    did (footnote 2).

Every local solver is SGD-momentum, as in the paper's setup.  A client
trains private copies: the trees it is given are never written.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.configs.preresnet20 import ResNetConfig
from repro_torch.core import blockwise
from repro_torch.core.memory_model import resnet_memory
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl import width as width_util
from repro_torch.models import image_model, resnet
from repro_torch.tree import tree_leaves, tree_map


_ce = blockwise._ce_logits


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def fedavg_local(cfg, params, batches, *, lr=0.1, momentum=0.9,
                 local_steps=1):
    """Local SGD-momentum on the CE loss of the whole image model (a
    PreResNet or ViT ``cfg``) from ``params`` (not written),
    ``local_steps`` passes over ``batches``; returns the trained copy."""
    apply = image_model(cfg).apply
    params = _clone(params)
    vel = tree_map(torch.zeros_like, params)
    for _ in range(local_steps):
        for b in batches:
            blockwise.sgd_momentum_(
                lambda: _ce(apply(params, cfg, b["images"]), b["labels"]),
                params, vel, lr=lr, momentum=momentum)
    return params


def fedavg_group_update(cfg, lr: float, momentum: float, local_steps: int):
    """The group counterpart of :func:`fedavg_local`'s loop over stacked
    ``(clients, ...)`` parameters (updated in place) and ``(clients,
    batches, ...)`` data: each step takes every client's gradient in one
    backward pass (:func:`blockwise.stacked_grads`), then the momentum
    update on the stacked leaves."""
    apply = image_model(cfg).apply

    def loss(p, b):
        return _ce(apply(p, cfg, b["images"]), b["labels"])

    grads = blockwise.stacked_grads(loss, in_dims=(0, 0))

    def step(carry, batch):
        p, v = carry
        blockwise._momentum_step_(tree_leaves(p), tree_leaves(v),
                                  grads(p, batch), lr=lr,
                                  momentum=momentum)
        return p, v

    def update(params, batches):
        vel = tree_map(torch.zeros_like, params)
        params, _ = blockwise.run_local_steps(step, (params, vel), batches,
                                              local_steps)
        return params

    return update


def fedavg_local_batched(cfg, params, batches_per_client, *, lr=0.1,
                         momentum=0.9, local_steps=1):
    """Group counterpart of :func:`fedavg_local`: every client starts from
    ``params`` (not written) and trains on its own batches.  Returns the
    per-client trees in input order."""
    group = len(batches_per_client)
    update = fedavg_group_update(cfg, lr, momentum, local_steps)
    out = update(blockwise.broadcast_tree(params, group),
                 blockwise.stack_batches(batches_per_client))
    return blockwise.unstack_tree(out, group)


# --------------------------------------------------------------------------
# HeteroFL
# --------------------------------------------------------------------------
def heterofl_local(cfg_full: ResNetConfig, global_params, ratio: float,
                   batches, *, lr=0.1, momentum=0.9, local_steps=1):
    """Slice -> local train -> pad back with mask."""
    sub, sub_cfg = width_util.slice_resnet(global_params, cfg_full, ratio)
    sub = fedavg_local(sub_cfg, sub, batches, lr=lr, momentum=momentum,
                       local_steps=local_steps)
    return width_util.pad_resnet(sub, cfg_full, sub_cfg)


@torch.no_grad()
def heterofl_aggregate(global_params, padded_list: Sequence,
                       mask_list: Sequence, weights: Sequence[float]):
    """Nested aggregation: each coordinate averages over the clients
    whose slice covers it, ``sum(w m p) / max(sum(w m), 1e-12)`` with the
    unnormalised weights in fp32; uncovered coordinates keep the global
    value."""
    w = torch.tensor(weights, dtype=torch.float32).tolist()
    n = len(padded_list)

    def combine(g, *rest):
        ps, ms = rest[:n], rest[n:]
        num = ms[0] * w[0] * ps[0].float()
        den = ms[0] * w[0]
        for wi, p, m in zip(w[1:], ps[1:], ms[1:]):
            num += m * wi * p.float()
            den += m * wi
        out = num / den.clamp(min=1e-12)
        return torch.where(den > 0, out, g.float()).to(g.dtype)

    return tree_map(combine, global_params, *padded_list, *mask_list)


# --------------------------------------------------------------------------
# SplitMix
# --------------------------------------------------------------------------
class SplitMixState:
    """K = round(1/r) independent base networks of width r, each drawn
    from its own ``torch.Generator`` (seeds spawned from ``seed``); the
    global model is their logit-mean ensemble."""

    def __init__(self, cfg_full: ResNetConfig, base_ratio: float,
                 seed: int, *, device: DeviceLike = None):
        dev = resolve_device(device)
        self.base_cfg = width_util.subnet_config(cfg_full, base_ratio)
        self.k = max(1, int(round(1.0 / base_ratio)))
        seeds = np.random.SeedSequence(seed).generate_state(self.k)
        self.bases = [resnet.init(torch.Generator(device=dev)
                                  .manual_seed(int(s)), self.base_cfg,
                                  device=dev) for s in seeds]

    def capacity(self, ratio: float) -> int:
        """How many base nets a client at width ratio ``ratio`` trains:
        its budget is ~ratio activations; each base costs ~1/k."""
        per_base = 1.0 / self.k
        return max(1, min(self.k, int(ratio / per_base)))

    @torch.no_grad()
    def ensemble_logits(self, images):
        out = resnet.apply(self.bases[0], self.base_cfg, images)
        for p in self.bases[1:]:
            out += resnet.apply(p, self.base_cfg, images)
        return out / len(self.bases)


# --------------------------------------------------------------------------
# DepthFL (fixed-depth split + aux classifiers)
# --------------------------------------------------------------------------
EXIT_EVERY = 2          # an aux exit (and a depth option) every 2 blocks
OPTIMIZER_SLOTS = 2     # optimizer-state copies per parameter in pricing


def depthfl_depth_for_budget(cfg: ResNetConfig, budget_bytes: int,
                             batch: int) -> int:
    """Deepest PREFIX (in fixed 2-block steps, or the full depth) whose
    end-to-end training cost fits the budget; 0 when none does.  The
    prefix trains jointly, so its cost is the SUM over its units —
    DepthFL's structural disadvantage under tight memory."""
    mem = resnet_memory(cfg, batch)
    n = len(mem.units)
    best = 0
    # fixed-step exits plus the FULL depth, so that the richest tier
    # trains the real classifier head
    options = sorted(set(list(range(EXIT_EVERY, n, EXIT_EVERY)) + [n]))
    for d in options:
        cost = (mem.embed.train_bytes(OPTIMIZER_SLOTS)
                + sum(u.train_bytes(OPTIMIZER_SLOTS) for u in mem.units[:d])
                + mem.head.train_bytes(OPTIMIZER_SLOTS))
        if cost <= budget_bytes:
            best = d
    return best


def depthfl_init_aux(cfg: ResNetConfig, gen: torch.Generator, *,
                     device: DeviceLike = None):
    """An aux classifier ``exit_e`` at every fixed-depth exit e (every
    ``EXIT_EVERY`` blocks), weights ``normal / sqrt(c)`` from ``gen``."""
    dev = resolve_device(device)
    chans = resnet.block_channels(cfg)
    aux = {}
    for e in range(EXIT_EVERY, cfg.num_blocks + 1, EXIT_EVERY):
        c = chans[e - 1][1]
        w = torch.randn(c, cfg.num_classes, generator=gen, device=dev)
        aux[f"exit_{e}"] = {"w": w * (1 / np.sqrt(c)),
                            "b": torch.zeros(cfg.num_classes, device=dev)}
    return aux


def depthfl_logits(cfg: ResNetConfig, params, aux, depth: int,
                   images) -> List[torch.Tensor]:
    """The prefix [0, depth)'s exits: one logit tensor per aux exit
    <= depth (the block output pooled, no norm before it), then the real
    head's when ``depth`` is the full depth."""
    x = resnet.stem(params, images)
    out, lo = [], 0
    for e in range(EXIT_EVERY, depth + 1, EXIT_EVERY):
        x = resnet.forward_blocks(params, cfg, x, lo, e)
        lo = e
        a = aux[f"exit_{e}"]
        out.append(x.mean((2, 3)) @ a["w"] + a["b"])
    if depth == cfg.num_blocks:
        x = resnet.forward_blocks(params, cfg, x, lo, depth)
        out.append(resnet.head(params, cfg, x))
    return out


def depthfl_loss(exit_logits: Sequence[torch.Tensor],
                 labels) -> torch.Tensor:
    """DepthFL's joint loss: the mean CE over the prefix's exits
    (:func:`depthfl_logits`)."""
    return sum(_ce(logits, labels) for logits in exit_logits) \
        / len(exit_logits)


def _merge(params, aux, trained, aux_t, depth: int):
    merged = dict(params)
    merged["stem"] = trained["stem"]
    merged["blocks"] = list(trained["blocks"]) + list(params["blocks"][depth:])
    merged["head_norm"] = trained["head_norm"]
    merged["classifier"] = trained["classifier"]
    return merged, {**aux, **aux_t}


def depthfl_local(cfg: ResNetConfig, params, aux, depth: int, batches, *,
                  lr=0.1, momentum=0.9, local_steps=1):
    """Train the prefix [0, depth) end to end with every aux exit <= depth
    supervised jointly; blocks past ``depth`` are read from ``params``.
    The stem, the prefix blocks, the head and the covered aux heads
    train together (the head's gradient is 0 below the full depth, so it
    comes back unchanged).  Returns (params, aux, depth), new trees that
    share the untrained tensors with the inputs."""
    if depth == 0:
        return params, aux, None
    trained = _clone({"stem": params["stem"],
                      "blocks": params["blocks"][:depth],
                      "head_norm": params["head_norm"],
                      "classifier": params["classifier"]})
    aux_t = _clone({k: v for k, v in aux.items()
                    if int(k.split("_")[1]) <= depth})
    tp = (trained, aux_t)
    vel = tree_map(torch.zeros_like, tp)

    def loss(batch):
        p, a = _merge(params, aux, trained, aux_t, depth)
        return depthfl_loss(depthfl_logits(cfg, p, a, depth,
                                           batch["images"]),
                            batch["labels"])

    for _ in range(local_steps):
        for b in batches:
            blockwise.sgd_momentum_(lambda: loss(b), tp, vel, lr=lr,
                                    momentum=momentum)
    merged, new_aux = _merge(params, aux, trained, aux_t, depth)
    return merged, new_aux, depth
