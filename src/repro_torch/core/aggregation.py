"""Server-side aggregation (paper Algorithm 1, line 7): port of
``repro.core.aggregation.fedavg`` with its non-finite guard.

FeDepth clients return full-size models, so aggregation is plain weighted
FedAvg over the sampled cohort, over every leaf — a leaf no client
trained averages copies of the same tensor, as in the reference.  Masked
aggregation waits for a later slice.
"""
from __future__ import annotations

from typing import Sequence

import torch

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
