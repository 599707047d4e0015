"""Availability traces driven by SIMULATED time (port of
``repro.fl.systime.availability``, a copy with numpy only).

``fl.sampling.AvailabilityTraceSampler`` indexes a trace by round number
— fine for barrier rounds, meaningless once progress is event-driven.
These models answer "who is reachable at virtual time t", which is what
both the async dispatcher and the sync engine's time-aware sampling ask.
"""
from __future__ import annotations

from typing import Protocol, Sequence, Tuple

import numpy as np


class AvailabilityModel(Protocol):
    def available(self, ctx, t: float) -> np.ndarray:
        """Client ids reachable at simulated time ``t`` (seconds)."""
        ...


class AlwaysAvailable:
    def available(self, ctx, t: float) -> np.ndarray:
        return np.arange(ctx.num_clients)


class WindowedAvailability:
    """Explicit (t_start, t_end, ids) windows, cycled with ``period``
    (e.g. a diurnal pattern).  Times outside every window fall back to
    the full population rather than stalling the simulation."""

    def __init__(self, windows: Sequence[Tuple[float, float, Sequence[int]]],
                 *, period: float = None):
        if not len(windows):
            raise ValueError("need >= 1 availability window")
        self.windows = [(float(a), float(b), np.asarray(ids, np.int64))
                        for a, b, ids in windows]
        self.period = float(period) if period is not None \
            else max(b for _, b, _ in self.windows)

    def available(self, ctx, t: float) -> np.ndarray:
        tm = t % self.period if self.period > 0 else t
        hit = [ids for a, b, ids in self.windows if a <= tm < b]
        if not hit:
            return np.arange(ctx.num_clients)
        return np.unique(np.concatenate(hit))


class DutyCycleAvailability:
    """Each client is up for ``duty`` of every ``period_s`` seconds, with
    a seeded per-client phase — the classic device-charging / on-wifi
    pattern.  Deterministic for a given (seed, num_clients).

    ``store`` (a ``repro_torch.fl.scale.state_store`` ClientStateStore)
    parks the materialized phase array so it can spill with the rest of
    the per-client state; at population scale
    ``repro_torch.fl.scale.population.HashedDutyCycle`` needs no phase
    array at all."""

    def __init__(self, period_s: float, duty: float, *, seed: int = 0,
                 store=None):
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"duty must be in (0, 1], got {duty}")
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        self.period_s = float(period_s)
        self.duty = float(duty)
        self.seed = seed
        self._store = store
        self._phases = None

    def _phases_for(self, n: int) -> np.ndarray:
        if self._store is not None:
            ph = self._store.get(("phases", n))
            if ph is None:
                rng = np.random.default_rng(self.seed)
                ph = rng.uniform(0.0, self.period_s, size=n)
                self._store[("phases", n)] = ph
            return ph
        if self._phases is None or len(self._phases) != n:
            rng = np.random.default_rng(self.seed)
            self._phases = rng.uniform(0.0, self.period_s, size=n)
        return self._phases

    def available(self, ctx, t: float) -> np.ndarray:
        ph = self._phases_for(ctx.num_clients)
        up = ((t + ph) % self.period_s) < self.duty * self.period_s
        ids = np.flatnonzero(up)
        return ids if ids.size else np.arange(ctx.num_clients)
