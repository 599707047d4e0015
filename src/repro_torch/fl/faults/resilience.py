"""Resilience policies: what the engines DO about injected (or real)
faults (port of ``repro.fl.faults.resilience``).

:class:`ResiliencePolicy` bundles the three server-side defenses:

* **Retry with exponential backoff** — a transient fault (``crash`` /
  ``drop``) is retried up to ``max_retries`` times; retry ``i`` waits
  ``backoff_base_s * backoff_mult**(i-1)`` simulated seconds before the
  client re-runs its local update.  The systime engines price the
  backoff, every wasted attempt's compute, and every lost upload in sim
  seconds through ``SystemModel``; the wall-clock ``RoundEngine`` has no
  virtual clock and only counts attempts.
* **Quarantine** — pre-aggregation validation
  (:class:`~repro_torch.fl.faults.quarantine.UpdateValidator`); rejected
  updates roll the error-feedback residual back so their transmitted
  mass is retransmitted, not lost.
* **Cohort-shortfall degradation** — what a sync round does when
  clients fail for good: ``"accept"`` aggregates whatever arrived
  (possibly nothing: the round becomes a no-op), ``"overprovision"``
  samples ``over_frac`` extra clients up front, ``"resample"`` draws
  one replacement wave for the shortfall after the fact.

:class:`FaultRuntime` is the engine-side bundle (injector + policy +
validator) both engines hold; with ``faults=None, resilience=None`` it
passes every result through unchanged, keeping the fault-free runs
bitwise identical.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fl.faults.plan import FaultInjector, as_injector
from repro_torch.fl.faults.quarantine import UpdateValidator, Verdict
from repro_torch.obs import active as obs_active

DEGRADATION_MODES = ("accept", "overprovision", "resample")


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Server-side resilience knobs (see module docstring)."""
    max_retries: int = 2
    backoff_base_s: float = 5.0
    backoff_mult: float = 2.0
    quarantine: bool = True
    abs_limit: float = 1e12
    norm_factor: float = 100.0
    min_history: int = 4
    degradation: str = "accept"
    over_frac: float = 0.25        # extra cohort fraction (overprovision)

    def __post_init__(self):
        if self.degradation not in DEGRADATION_MODES:
            raise ValueError(f"degradation must be one of "
                             f"{DEGRADATION_MODES}, "
                             f"got {self.degradation!r}")
        if self.max_retries < 0 or self.backoff_base_s < 0:
            raise ValueError("max_retries/backoff_base_s must be >= 0")

    def backoff_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        return self.backoff_base_s * self.backoff_mult ** (attempt - 1)


@dataclasses.dataclass
class AttemptOutcome:
    """How one client dispatch resolved after fault injection and (if a
    policy allows) retries.  Sim-time pricing contract
    : every crashed attempt spent
    ``frac * compute``; every dropped attempt spent a full compute and a
    full upload; the surviving attempt (if any) spends the usual
    download+compute+upload; ``slowdown`` multiplies ALL compute; each
    retry adds its exponential backoff."""
    result: Optional[object]            # surviving ClientResult, or None
    attempts: int = 1
    kinds: Tuple[str, ...] = ()         # fault kinds drawn, in order
    crash_fracs: Tuple[float, ...] = ()
    drops: int = 0
    backoff_s: float = 0.0
    slowdown: float = 1.0

    @property
    def delivered(self) -> bool:
        return self.result is not None

    def total_seconds(self, lat) -> float:
        """Total simulated seconds this dispatch occupied the client,
        given the base per-attempt :class:`~repro_torch.fl.systime.profiles
        .Latency` (one download is paid regardless; failed dispatches
        stop before their final upload)."""
        comp = lat.compute * self.slowdown
        t = lat.download + self.backoff_s
        t += comp * sum(self.crash_fracs)              # crashed attempts
        t += (comp + lat.upload) * self.drops          # dropped attempts
        if self.delivered:
            t += comp + lat.upload                     # the one that landed
        return t


class FaultRuntime:
    """Injector + policy + validator, engine-side.  With both knobs off
    (``enabled`` False) every hook is the identity: ``resolve`` delivers
    the result as it is, the cohort is neither extended nor resampled and
    nothing is validated."""

    def __init__(self, faults, resilience: Optional[ResiliencePolicy]):
        self.injector: Optional[FaultInjector] = as_injector(faults)
        if resilience is not None \
                and not isinstance(resilience, ResiliencePolicy):
            raise ValueError(f"resilience must be None or a "
                             f"ResiliencePolicy, got {resilience!r}")
        self.policy = resilience
        self.validator: Optional[UpdateValidator] = None
        if resilience is not None and resilience.quarantine:
            self.validator = UpdateValidator(
                abs_limit=resilience.abs_limit,
                norm_factor=resilience.norm_factor,
                min_history=resilience.min_history)

    @property
    def enabled(self) -> bool:
        return self.injector is not None or self.policy is not None

    # ------------------------------------------------------- checkpointing
    def export_state(self) -> dict:
        return {"validator": self.validator.export_state()
                if self.validator is not None else None}

    def import_state(self, state: dict) -> None:
        if self.validator is not None and state.get("validator"):
            self.validator.import_state(state["validator"])

    # ----------------------------------------------------------- attempts
    def resolve(self, round_idx: int, client_id: int, result,
                recompute: Callable[[], object]) -> AttemptOutcome:
        """Run one client dispatch through the fault plan and the retry
        policy.  ``recompute`` re-runs the client's local update (fresh
        batches — stateless clients retrain from the same broadcast
        state); it is only called when a transient fault is retried."""
        if self.injector is None:
            return AttemptOutcome(result)
        max_retries = self.policy.max_retries if self.policy else 0
        attempts, kinds = 0, []
        crash_fracs: List[float] = []
        drops, backoff, slow = 0, 0.0, 1.0
        while True:
            fault = self.injector.decide(round_idx, client_id, attempts)
            attempts += 1
            if fault is None:
                break
            kinds.append(fault.kind)
            if fault.kind == "slowdown":
                slow = max(slow, fault.factor)
                break
            if fault.kind in ("corrupt", "diverge"):
                result = self.injector.damage_result(result, fault)
                break
            # transient loss: crash or drop
            if fault.kind == "crash":
                crash_fracs.append(fault.frac)
            else:
                drops += 1
            if attempts > max_retries:
                result = None
                break
            backoff += self.policy.backoff_s(attempts)
            obs = obs_active()
            if obs is not None:
                obs.metrics.counter("fault_retries", kind=fault.kind).inc()
                obs.metrics.histogram("retry_backoff_s").observe(
                    self.policy.backoff_s(attempts))
            result = recompute()
        out = AttemptOutcome(result, attempts, tuple(kinds),
                             tuple(crash_fracs), drops, backoff, slow)
        if not out.delivered:
            obs = obs_active()
            if obs is not None:
                obs.metrics.counter("client_failures").inc()
        return out

    # --------------------------------------------------------- degradation
    def overprovision(self, ctx, cohort: List[int]) -> List[int]:
        """Extend a sampled cohort with ``over_frac`` extra distinct
        clients (drawn from the shared stream) so the round still has
        ~cohort-size survivors under the expected failure rate."""
        if self.policy is None or self.policy.degradation != "overprovision":
            return cohort
        extra = int(np.ceil(self.policy.over_frac * len(cohort)))
        pool = np.setdiff1d(np.arange(ctx.num_clients),
                            np.asarray(cohort, dtype=np.int64))
        if extra <= 0 or pool.size == 0:
            return cohort
        picks = ctx.rng.choice(pool, size=min(extra, pool.size),
                               replace=False)
        return cohort + [int(k) for k in picks]

    def resample(self, ctx, cohort: Sequence[int], need: int) -> List[int]:
        """One replacement wave for a shortfall of ``need`` clients,
        drawn outside the original cohort."""
        if self.policy is None or self.policy.degradation != "resample" \
                or need <= 0:
            return []
        pool = np.setdiff1d(np.arange(ctx.num_clients),
                            np.asarray(list(cohort), dtype=np.int64))
        if pool.size == 0:
            return []
        picks = ctx.rng.choice(pool, size=min(need, pool.size),
                               replace=False)
        return [int(k) for k in picks]

    # ----------------------------------------------------------- validate
    def validate_one(self, payload, state) -> Optional[Verdict]:
        if self.validator is None:
            return None
        return self.validator.validate_one(payload, state)

    def record_quarantine(self, client_id: int, verdict: Verdict) -> None:
        if self.validator is not None:
            self.validator.observe_rejection(verdict, client_id)

    def record_shortfall(self, missing: int) -> None:
        obs = obs_active()
        if obs is not None and missing > 0:
            obs.metrics.counter("cohort_shortfall").inc(missing)
