"""Unified telemetry: typed span tracing, metrics and exporters (port of
``repro.obs``).

* :mod:`~repro_torch.obs.trace` — typed spans / events with sim-time and
  wall-clock stamps; :class:`~repro_torch.obs.trace.SysEvent` is the
  systime engine's scheduling event (the legacy ``AsyncEngine.trace``
  list is its projection, tuple for tuple).
* :mod:`~repro_torch.obs.metrics` — process-local counters / gauges /
  histograms (codec ratios, EF residual norms, prefix-cache events,
  deadline misses, spill-store churn, ...).
* :mod:`~repro_torch.obs.export` — JSONL (composes with
  ``JsonlHistorySink``), the Chrome trace-event format (Perfetto; read
  by ``tools/trace_report.py``) and a Prometheus textfile snapshot.
* :mod:`~repro_torch.obs.audit` and :mod:`~repro_torch.obs.dynamics` —
  the opt-in diagnostics (``make_obs("full")``): the measured memory of
  each block step beside the memory model's prediction, and
  learning-dynamics analytics at the aggregation boundary.

**Nothing when disabled.**  Both engines take ``obs=`` (default ``None``
= off).  Off means no tracer, no registry, and every instrumented site
does one :func:`active` lookup that returns ``None`` and nothing else:
histories, aggregated parameters and the legacy trace are bitwise those
of a run without the knob.  On, they are bitwise the same too: no site
writes a tensor of the run or synchronizes the device
(``tests/test_torch_obs.py``).

Enablement flows through one contextvar: an engine whose ``obs`` is set
wraps its run in :func:`activate`, and deep sites that never see the
engine (``PrefixCache``, ``SpillStore``, ``CommChannel``) read
:func:`active`.  Pass one :class:`Obs` to several engines to pool their
capture.

The reference's jit-cache metrics (:data:`NOT_PORTED_METRICS`) have no
counterpart: the port compiles nothing and keeps no jit cache, so there
is nothing to count.  Every other metric name of the reference is
recorded under the same name and labels.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Union

from repro_torch.obs.audit import MemoryAuditor  # noqa: F401
from repro_torch.obs.dynamics import DynamicsAnalyzer  # noqa: F401
from repro_torch.obs.metrics import (Counter, Gauge,  # noqa: F401
                                     Histogram, MetricsRegistry)
from repro_torch.obs.trace import (LEGACY_FIELDS,  # noqa: F401
                                   SYS_EVENT_KINDS, Event, Span, SysEvent,
                                   Tracer)

#: The reference's metric names the port does not record: they count
#: hits, misses and build seconds of XLA jit caches, and the port has none.
NOT_PORTED_METRICS = ("jit_cache_hits", "jit_cache_misses",
                      "jit_build_seconds")


@dataclasses.dataclass
class Obs:
    """One telemetry capture: a tracer and a metrics registry, plus the
    opt-in diagnostics — a memory auditor and a learning-dynamics
    analyzer (both ``None`` = off)."""
    tracer: Tracer = dataclasses.field(default_factory=Tracer)
    metrics: MetricsRegistry = dataclasses.field(
        default_factory=MetricsRegistry)
    audit: Optional[MemoryAuditor] = None
    dynamics: Optional[DynamicsAnalyzer] = None

    # ---------------------------------------------------------- lifecycle
    def bind(self, ctx) -> "Obs":
        """Attach an experiment context to the diagnostics (the engines
        call this at construction; a no-op without audit / dynamics)."""
        if self.audit is not None:
            self.audit.bind(ctx, self.metrics)
        if self.dynamics is not None:
            self.dynamics.bind(self.metrics)
        return self

    def reset(self) -> "Obs":
        """A fresh capture in place: spans, metrics and diagnostics
        cleared (the auditor keeps its experiment binding)."""
        self.tracer.reset()
        self.metrics.reset()
        if self.audit is not None:
            self.audit.reset()
        if self.dynamics is not None:
            self.dynamics.reset()
        return self

    # ------------------------------------------------------ exporters
    def export_jsonl(self, sink_or_path) -> int:
        from repro_torch.obs.export import to_jsonl
        return to_jsonl(self, sink_or_path)

    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        from repro_torch.obs.export import to_chrome_trace
        return to_chrome_trace(self, path)

    def export_prometheus(self, path_or_file=None) -> str:
        from repro_torch.obs.export import to_prometheus
        return to_prometheus(self.metrics, path_or_file)


def make_obs(spec: Union[None, bool, str, Obs]) -> Optional[Obs]:
    """Resolve the engines' ``obs=`` knob: ``None`` / ``False`` / "off"
    -> disabled; ``True`` / "on" -> a fresh capture; "full" -> a capture
    with the memory auditor and the dynamics analyzer; an :class:`Obs`
    passes through (one capture shared across engines)."""
    if spec is None or spec is False or spec == "off":
        return None
    if spec is True or spec == "on":
        return Obs()
    if spec == "full":
        return Obs(audit=MemoryAuditor(), dynamics=DynamicsAnalyzer())
    if isinstance(spec, Obs):
        return spec
    raise ValueError(f"obs must be 'on', 'off', 'full', None, a bool, or "
                     f"an Obs instance, got {spec!r}")


# --------------------------------------------------------------------------
# the active-capture contextvar
# --------------------------------------------------------------------------
_ACTIVE: contextvars.ContextVar[Optional[Obs]] = contextvars.ContextVar(
    "repro_torch_obs_active", default=None)


def active() -> Optional[Obs]:
    """The capture activated by an enclosing engine run, or ``None`` —
    the guard every deep instrumentation site starts with."""
    return _ACTIVE.get()


@contextlib.contextmanager
def activate(obs: Optional[Obs]):
    """Make ``obs`` the active capture for the dynamic extent (nests;
    ``None`` explicitly deactivates)."""
    token = _ACTIVE.set(obs)
    try:
        yield obs
    finally:
        _ACTIVE.reset(token)


def scope(obs: Optional[Obs]):
    """``activate(obs)`` when enabled, a no-op context otherwise."""
    if obs is None:
        return contextlib.nullcontext()
    return activate(obs)


def span_if(obs: Optional[Obs], kind: str, **attrs):
    """``obs.tracer.span(kind, **attrs)`` when enabled, a no-op context
    otherwise."""
    if obs is None:
        return contextlib.nullcontext()
    return obs.tracer.span(kind, **attrs)


__all__ = [
    "Obs", "make_obs", "active", "activate", "scope", "span_if",
    "Tracer", "Span", "Event", "SysEvent", "LEGACY_FIELDS",
    "SYS_EVENT_KINDS", "NOT_PORTED_METRICS",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "MemoryAuditor", "DynamicsAnalyzer",
]
