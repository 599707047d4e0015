"""Staleness discounts for asynchronous aggregation (port of
``repro.fl.systime.staleness``).

A result's *staleness* is the number of server versions applied between
the snapshot the client trained on and the merge — the FedBuff measure
(Nguyen et al. 2022).  The default discount is the polynomial rule
``s(tau) = (1 + tau)^-alpha``; ``alpha = 0`` disables discounting,
larger alpha suppresses stale updates harder.

:func:`default_aggregate_async` is the engine's fallback for strategies
without an ``aggregate_async`` override: discount each result's
aggregation weight and delegate to the strategy's own synchronous
``aggregate`` over its torch trees — exact for weight-linear
aggregators (FedAvg-family), a no-op for weight-ignoring ones (SplitMix
averages uniformly).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence


def polynomial_discount(staleness: float, alpha: float = 0.5) -> float:
    """FedBuff's s(tau) = (1 + tau)^-alpha; s(0) == 1 for any alpha."""
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    if alpha < 0:
        raise ValueError(f"alpha must be >= 0, got {alpha}")
    return float((1.0 + staleness) ** -alpha)


def discount_results(results: Sequence, stalenesses: Sequence[float],
                     alpha: float = 0.5) -> List:
    """Copies of ``results`` with weights scaled by the discount (the
    payloads are shared, never copied)."""
    return [dataclasses.replace(r, weight=r.weight
                                * polynomial_discount(t, alpha))
            for r, t in zip(results, stalenesses)]


def default_aggregate_async(strategy, ctx, state, results: Sequence,
                            stalenesses: Sequence[float],
                            alpha: float = 0.5):
    """Discount weights, then run the strategy's synchronous aggregate.
    With all-zero staleness this IS ``strategy.aggregate`` (discounts are
    exactly 1), which anchors the async engine's sync-equivalence."""
    return strategy.aggregate(ctx, state,
                              discount_results(results, stalenesses, alpha))
