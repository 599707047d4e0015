"""Cohort sampler and client scheduler (port of ``repro.fl.sampling``:
``UniformSampler`` and ``SequentialScheduler``; the trace / straggler
samplers and the vectorized scheduler wait)."""
from __future__ import annotations

from typing import Protocol

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


class SequentialScheduler:
    """Run clients one after another — the reference execution model."""

    def run(self, ctx, strategy, state, cohort, batch_fn):
        return [strategy.client_update(ctx, state, int(k), batch_fn(int(k)))
                for k in cohort]
