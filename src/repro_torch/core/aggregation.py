"""Server-side aggregation (paper Algorithm 1, line 7): port of
``repro.core.aggregation.fedavg`` with its non-finite guard.

FeDepth clients return full-size models, so aggregation is plain weighted
FedAvg over the sampled cohort, over every leaf — a leaf no client
trained averages copies of the same tensor, as in the reference.
``aggregate_masked`` (a beyond-paper refinement, off by default) instead
reweights each leaf by who actually trained it: partial-training clients
skip a prefix.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.obs import active as _obs_active
from repro_torch.tree import tree_leaves, tree_map


def _all_finite(tree) -> bool:
    flags = [torch.isfinite(t).all() for t in tree_leaves(tree)
             if torch.is_floating_point(t)]
    return bool(torch.stack(flags).all()) if flags else True


def _finite_filter(client_params: tuple, *aligned: Sequence):
    """Drop non-finite client payloads (one NaN client would poison every
    coordinate of the average), keeping ``aligned`` sequences (weights) in
    step.  When every payload is non-finite the full set passes through
    unchanged; the all-finite path returns the inputs untouched."""
    flags = [_all_finite(p) for p in client_params]
    if all(flags):
        return (client_params,) + aligned
    obs = _obs_active()
    if obs is not None:
        obs.metrics.counter("aggregate_nonfinite_dropped").inc(
            sum(1 for f in flags if not f))
    keep = [i for i, f in enumerate(flags) if f]
    if not keep:
        return (client_params,) + aligned
    return tuple(tuple(seq[i] for i in keep)
                 for seq in (client_params,) + tuple(aligned))


def _weighted_sum(w: Sequence[float], xs: Sequence[torch.Tensor]):
    # the reference's sum(wi * x): each product rounded, then added in
    # cohort order, in fp32
    acc = xs[0].float() * w[0]
    for wi, x in zip(w[1:], xs[1:]):
        acc += x.float() * wi
    return acc.to(xs[0].dtype)


@torch.no_grad()
def fedavg(client_params: Sequence, weights: Sequence[float],
           guard: bool = True):
    """Weighted average of client trees; weights ~ p_k, renormalized over
    the cohort in fp32.  ``guard`` (default on) drops non-finite client
    payloads first (:func:`_finite_filter`)."""
    params, weights = tuple(client_params), tuple(weights)
    if guard:
        params, weights = _finite_filter(params, weights)
    w = torch.tensor(weights, dtype=torch.float32)
    w = (w / w.sum()).tolist()
    return tree_map(lambda *xs: _weighted_sum(w, xs), *params)


@torch.no_grad()
def aggregate_masked(global_params, client_params: Sequence,
                     weights: Sequence[float], trained_masks: Sequence,
                     guard: bool = True):
    """Per-parameter reweighting by who actually trained each leaf.

    ``trained_masks[k]`` is a tree of {0, 1} tensors congruent with the
    params, marking what client k trained.  Weights are not renormalized
    (the per-leaf denominator does it, in fp32); leaves nobody trained
    keep the global value.  ``guard`` (default on) drops non-finite client
    payloads, with their weights and masks, first."""
    params, weights = tuple(client_params), tuple(weights)
    masks = tuple(trained_masks)
    if guard:
        params, weights, masks = _finite_filter(params, weights, masks)
    # the weights rounded to fp32, as the reference takes them
    w = torch.tensor(weights, dtype=torch.float32).tolist()
    n = len(params)

    def combine(g, *pairs):
        xs, ms = pairs[:n], pairs[n:]
        den = ms[0] * w[0]
        num = den * xs[0].float()
        any_trained = ms[0].clone()
        for i in range(1, n):
            wm = ms[i] * w[i]
            num += wm * xs[i].float()
            den += wm
            any_trained += ms[i]
        out = num / den.clamp(min=1e-12)
        return torch.where(any_trained > 0, out, g.float()).to(g.dtype)

    return tree_map(combine, global_params, *params, *masks)


def trained_mask_for(params, dec, runner):
    """Mask tree: 1 for leaves in any trained block of ``dec``, plus the
    head (and the stem / embed for a block at 0); 0 for the skipped
    prefix."""
    mask = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)
    for lo, hi in dec.blocks:
        train = runner.split(mask, lo, hi)
        mask = runner.merge(mask, tree_map(torch.ones_like, train), lo=lo,
                            hi=hi)
    return mask
