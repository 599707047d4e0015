"""Cohort samplers and the client scheduler (port of
``repro.fl.sampling``).

``UniformSampler`` reproduces the paper's protocol (participation-fraction
uniform without replacement); ``AvailabilityTraceSampler`` and
``StragglerSampler`` are the scenario extensions.  All three draw from
the shared numpy stream in the reference's order, so a seed gives the
reference's cohorts.  ``SequentialScheduler`` runs a cohort client by
client; ``VectorizedScheduler`` stacks the clients that run the same
computation (``core.blockwise.client_update_batched``);
``fl.scale.executor.ShardedScheduler`` fans each stacked group out over
a list of devices (``"sharded"``).  With a telemetry capture active
(``repro_torch.obs``) the schedulers record client-update and
cohort-group spans and their dispatch counters.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Protocol, Sequence

import numpy as np

from repro_torch.core.blockwise import stackable
from repro_torch.fl.strategy import ClientResult, Context, FLStrategy
from repro_torch.obs import active as obs_active


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


class ClientScheduler(Protocol):
    def run(self, ctx: Context, strategy: FLStrategy, state,
            cohort: Sequence[int],
            batch_fn: Callable[[int], list]) -> List[ClientResult]:
        """Execute the cohort's local updates, returning one
        ``ClientResult`` per client, in cohort order."""
        ...


class SequentialScheduler:
    """Run clients one after another — the reference execution model."""

    def run(self, ctx, strategy, state, cohort, batch_fn):
        obs = obs_active()
        if obs is None:
            return [strategy.client_update(ctx, state, int(k),
                                           batch_fn(int(k)))
                    for k in cohort]
        results = []
        for k in cohort:
            with obs.tracer.span("client-update", client=int(k)):
                results.append(strategy.client_update(ctx, state, int(k),
                                                      batch_fn(int(k))))
        return results


class VectorizedScheduler:
    """Stack the clients that run the SAME computation and execute each
    group as one vmap-over-clients update.

    The group key is the strategy's ``client_group_key`` (FeDepth: the
    decomposition).  A group goes through the strategy's
    ``client_update_batched`` when it has at least ``min_group`` clients,
    a non-``None`` key and stackable batch lists (equal count, shapes,
    dtypes); otherwise its clients run one by one.  Strategies without
    the :class:`repro_torch.fl.strategy.BatchableFLStrategy` hooks are
    handed to :class:`SequentialScheduler` wholesale, which keeps their
    draws from the shared stream in order (SplitMix draws inside
    ``client_update``).

    Determinism: every client's batches are drawn up front in cohort
    order, so the shared stream advances exactly as under the sequential
    scheduler, and the results come back in cohort order — the choice of
    scheduler changes the wall clock, not the experiment."""

    def __init__(self, min_group: int = 2):
        self.min_group = max(1, int(min_group))
        self.fallback = SequentialScheduler()

    def run(self, ctx, strategy, state, cohort, batch_fn):
        update_batched = getattr(strategy, "client_update_batched", None)
        group_key = getattr(strategy, "client_group_key", None)
        if update_batched is None or group_key is None:
            return self.fallback.run(ctx, strategy, state, cohort, batch_fn)

        ids = [int(k) for k in cohort]
        batches = [batch_fn(k) for k in ids]      # cohort-order draws
        groups: dict = {}
        for pos, cid in enumerate(ids):
            groups.setdefault(group_key(ctx, cid), []).append(pos)
        obs = obs_active()
        results: List[Optional[ClientResult]] = [None] * len(ids)
        for key, positions in groups.items():
            group_batches = [batches[p] for p in positions]
            if (key is None or len(positions) < self.min_group
                    or not stackable(group_batches)):
                for p in positions:
                    if obs is not None:
                        with obs.tracer.span("client-update",
                                             client=ids[p], fallback=True):
                            results[p] = strategy.client_update(
                                ctx, state, ids[p], batches[p])
                        continue
                    results[p] = strategy.client_update(ctx, state, ids[p],
                                                        batches[p])
                if obs is not None:
                    obs.metrics.counter("scheduler_fallback_clients",
                                        scheduler="vectorized",
                                        ).inc(len(positions))
                continue
            if obs is None:
                outs = update_batched(ctx, state,
                                      [ids[p] for p in positions],
                                      group_batches)
            else:
                # one span per stacked dispatch; on a CUDA device its
                # seconds are the host's dispatch time (no span
                # synchronizes the device)
                with obs.tracer.span("cohort-group", size=len(positions),
                                     signature=str(key)) as sp:
                    outs = update_batched(ctx, state,
                                          [ids[p] for p in positions],
                                          group_batches)
                obs.metrics.histogram("group_update_seconds",
                                      signature=str(key),
                                      ).observe(sp.wall_seconds)
                obs.metrics.counter("group_dispatches",
                                    scheduler="vectorized").inc()
                obs.metrics.counter("group_clients",
                                    scheduler="vectorized",
                                    ).inc(len(positions))
            for p, res in zip(positions, outs):
                results[p] = res
        return results


# "module:Class" entries resolve lazily in make_scheduler: the sharded
# scheduler lives in fl/scale (which imports this module), so a direct
# class reference here would be a circular import
SCHEDULERS = {
    "sequential": SequentialScheduler,
    "vectorized": VectorizedScheduler,
    "sharded": "repro_torch.fl.scale.executor:ShardedScheduler",
}


def make_scheduler(spec=None) -> ClientScheduler:
    """Resolve a scheduler spec: ``None`` -> the sequential default, a
    name from ``SCHEDULERS`` ("sequential", "vectorized", "sharded"), or
    a ready instance passed through."""
    if spec is None:
        return SequentialScheduler()
    if isinstance(spec, str):
        if spec not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {spec!r}; "
                             f"available: {sorted(SCHEDULERS)}")
        entry = SCHEDULERS[spec]
        if isinstance(entry, str):
            import importlib
            mod, _, cls = entry.partition(":")
            entry = getattr(importlib.import_module(mod), cls)
            SCHEDULERS[spec] = entry
        return entry()
    return spec
