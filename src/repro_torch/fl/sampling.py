"""Cohort samplers and the client scheduler (port of
``repro.fl.sampling``).

``UniformSampler`` reproduces the paper's protocol (participation-fraction
uniform without replacement); ``AvailabilityTraceSampler`` and
``StragglerSampler`` are the scenario extensions.  All three draw from
the shared numpy stream in the reference's order, so a seed gives the
reference's cohorts.  The vectorized scheduler waits for vectorized
cohort execution.
"""
from __future__ import annotations

from typing import Optional, Protocol, Sequence

import numpy as np

from repro_torch.fl.strategy import Context


class CohortSampler(Protocol):
    def sample(self, ctx: Context, round_idx: int) -> np.ndarray:
        ...


def _cohort_size(ctx: Context, population: int) -> int:
    k = max(1, int(np.ceil(ctx.sim.participation * ctx.num_clients)))
    return min(k, population)


class UniformSampler:
    """The paper's sampler: ceil(participation * N) uniform without
    replacement, drawn from the shared simulation stream."""

    def sample(self, ctx: Context, round_idx: int) -> np.ndarray:
        k = _cohort_size(ctx, ctx.num_clients)
        return ctx.rng.choice(ctx.num_clients, size=k, replace=False)


class AvailabilityTraceSampler:
    """Sample only among the clients listed available for the round.

    ``trace`` is a sequence of per-round available-id collections, cycled
    when rounds outrun it.  An empty round falls back to the full
    population rather than stalling."""

    def __init__(self, trace: Sequence[Sequence[int]]):
        if not len(trace):
            raise ValueError("availability trace must cover >= 1 round")
        self.trace = [np.asarray(t, dtype=np.int64) for t in trace]

    def sample(self, ctx: Context, round_idx: int) -> np.ndarray:
        avail = self.trace[round_idx % len(self.trace)]
        if avail.size == 0:
            avail = np.arange(ctx.num_clients)
        k = _cohort_size(ctx, len(avail))
        return ctx.rng.choice(avail, size=k, replace=False)


class StragglerSampler:
    """Wrap another sampler and drop each selected client with probability
    ``drop_prob`` (the device went slow or offline after selection),
    always keeping at least one so that the round makes progress."""

    def __init__(self, drop_prob: float = 0.3,
                 base: Optional[CohortSampler] = None):
        if not 0.0 <= drop_prob < 1.0:
            raise ValueError("drop_prob must be in [0, 1)")
        self.drop_prob = drop_prob
        self.base = base or UniformSampler()

    def sample(self, ctx: Context, round_idx: int) -> np.ndarray:
        cohort = np.asarray(self.base.sample(ctx, round_idx))
        keep = ctx.rng.random(len(cohort)) >= self.drop_prob
        if not keep.any():
            keep[int(ctx.rng.integers(len(cohort)))] = True
        return cohort[keep]


class SequentialScheduler:
    """Run clients one after another — the reference execution model."""

    def run(self, ctx, strategy, state, cohort, batch_fn):
        return [strategy.client_update(ctx, state, int(k), batch_fn(int(k)))
                for k in cohort]
