"""Typed span/event tracing — the schema behind every timeline the repo
emits (port of ``repro.obs.trace``, a copy; docs/observability.md §Event
schema).

Three record types, all plain dataclasses so exporters and tests can
walk them without reverse-engineering tuple positions:

* :class:`Span` — a nested interval (round → cohort-group →
  client-update → block), stamped in BOTH timebases: wall-clock
  (``time.perf_counter``) and simulated seconds (the tracer's
  ``sim_clock``, the systime engines' virtual clock; 0.0 under the
  wall-clock ``RoundEngine``).  Carrying both is what makes a virtual
  run diff-able against a future real-concurrency run of the same
  experiment (ROADMAP live-serving item).
* :class:`Event` — an instantaneous mark attached to the innermost open
  span.
* :class:`SysEvent` — the systime engines' scheduling event, the typed
  replacement for ``AsyncEngine.trace``'s heterogeneous tuples.  Its
  first five fields ARE the legacy schema, in order
  (:data:`LEGACY_FIELDS`); :meth:`SysEvent.legacy` projects back to the
  exact tuple, so the legacy list stays byte-identical per seed when
  telemetry is on (regression-tested in tests/test_torch_obs.py).

The tracer never touches the simulation's rng streams or any tensor —
enabling it cannot perturb an experiment (asserted bitwise in
tests/test_torch_obs.py).

Wall stamps are ``time.perf_counter`` on the host.  No span synchronizes
the device, so on a CUDA device a span's wall seconds are the host's
dispatch time of the work inside it, not the device's execution time
(a synchronization would change nothing numerically, but would change
what it measures and cost a stall per span).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

#: The documented field order of the legacy ``AsyncEngine.trace`` tuples
#: — and, by construction, of :class:`SysEvent`'s leading fields.  The
#: schema (kind-by-kind meaning of ``extra``) is specified in
#: docs/system_model.md §Trace event schema and asserted in
#: tests/test_torch_obs.py::test_sys_event_field_order.
LEGACY_FIELDS = ("kind", "t", "client", "version", "extra")

#: Every kind a systime engine emits.  ``dispatch_forced`` is the
#: deadlock-escape dispatch (nobody available, nothing in flight);
#: ``miss`` is a sync-mode deadline miss (discarded update).  The
#: robustness layer (docs/robustness.md) adds ``fail`` (a client's
#: dispatch exhausted its retries — ``extra`` is the "|"-joined fault
#: kinds drawn), ``quarantine`` (a delivered update was rejected
#: pre-aggregation — ``extra`` is the verdict reason), and
#: ``checkpoint`` (the engine persisted a resumable checkpoint —
#: ``extra`` is the round/version saved).
SYS_EVENT_KINDS = ("dispatch", "dispatch_forced", "finish", "miss",
                   "aggregate", "fail", "quarantine", "checkpoint")


@dataclasses.dataclass
class SysEvent:
    """One systime scheduling event.  Field order of the first five
    fields is the stable legacy schema (:data:`LEGACY_FIELDS`):

    ========================= ============================= ==============
    kind                      client / version              extra
    ========================= ============================= ==============
    ``dispatch``              started client / its snapshot simulated
    (async mode)              server version                latency (s)
    ``dispatch_forced``       same, but the deadlock-escape same
    (async mode)              path (availability ignored)
    ``finish`` (sync mode)    finished client / round index latency (s)
    ``finish`` (async mode)   finished client / CURRENT     staleness
                              server version                (versions)
    ``miss`` (sync mode)      deadline-missing client /     latency that
                              round index                   overran (s)
    ``aggregate``             ``-1`` / round index (sync)   merged result
                              or new version (async)        count
    ========================= ============================= ==============

    ``t`` is simulated seconds: the completion time for ``finish`` /
    ``aggregate``, the start time for ``dispatch*``, and the give-up
    time (round start + deadline) for ``miss``.  ``wall_t`` and
    ``attrs`` are telemetry-only extensions — they never appear in the
    legacy projection.  ``attrs`` carries the per-phase latency split
    (``tier`` / ``start`` / ``download`` / ``compute`` / ``upload``) on
    the event that opens a client's in-flight interval (``dispatch*`` in
    async mode, ``finish`` / ``miss`` in sync mode), which is what the
    Chrome-trace exporter turns into per-client lanes."""
    kind: str
    t: float
    client: int
    version: int
    extra: Any
    wall_t: float = 0.0
    attrs: Optional[Dict[str, Any]] = None

    def legacy(self) -> tuple:
        """The exact tuple the pre-telemetry engines appended to
        ``AsyncEngine.trace`` — the thin projection the legacy list is
        built from when telemetry is enabled."""
        return (self.kind, self.t, self.client, self.version, self.extra)


@dataclasses.dataclass
class Span:
    """A nested interval.  ``parent_id`` is the enclosing span's
    ``span_id`` (None at top level); ``*_end`` stay None while open."""
    kind: str
    span_id: int
    parent_id: Optional[int]
    wall_start: float
    sim_start: float
    wall_end: Optional[float] = None
    sim_end: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def wall_seconds(self) -> Optional[float]:
        return None if self.wall_end is None \
            else self.wall_end - self.wall_start

    @property
    def sim_seconds(self) -> Optional[float]:
        return None if self.sim_end is None \
            else self.sim_end - self.sim_start


@dataclasses.dataclass
class Event:
    """An instantaneous mark, attached to the innermost open span."""
    kind: str
    wall_t: float
    sim_t: float
    span_id: Optional[int] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Tracer:
    """Process-local trace recorder.

    ``sim_clock`` (a zero-arg callable) supplies the simulated-seconds
    stamp; the systime engines point it at their virtual clock, the
    wall-clock engine leaves it unset (sim stamps 0.0).  Spans nest via
    an explicit stack, so ``span_id``/``parent_id`` reconstruct the
    round → cohort-group → client-update → block hierarchy without any
    global state."""

    def __init__(self, sim_clock: Optional[Callable[[], float]] = None):
        self.sim_clock = sim_clock
        self.spans: List[Span] = []
        self.events: List[Event] = []
        self.sys_events: List[SysEvent] = []
        self._stack: List[int] = []
        self._next_id = 0

    def reset(self) -> None:
        """Drop every recorded span/event and restart ids — part of
        ``Obs.reset()`` between back-to-back runs (keeps ``sim_clock``,
        which the owning engine rebinds anyway)."""
        self.spans.clear()
        self.events.clear()
        self.sys_events.clear()
        self._stack.clear()
        self._next_id = 0

    # ------------------------------------------------------------- clocks
    def _sim_now(self) -> float:
        return float(self.sim_clock()) if self.sim_clock is not None else 0.0

    # -------------------------------------------------------------- spans
    def begin(self, kind: str, **attrs) -> Span:
        """Open a span (child of the innermost open one)."""
        span = Span(kind=kind, span_id=self._next_id,
                    parent_id=self._stack[-1] if self._stack else None,
                    wall_start=time.perf_counter(),
                    sim_start=self._sim_now(), attrs=attrs)
        self._next_id += 1
        self.spans.append(span)
        self._stack.append(span.span_id)
        return span

    def end(self, span: Span, **attrs) -> Span:
        """Close a span (stamps both end clocks; merges extra attrs)."""
        span.wall_end = time.perf_counter()
        span.sim_end = self._sim_now()
        if attrs:
            span.attrs.update(attrs)
        if self._stack and self._stack[-1] == span.span_id:
            self._stack.pop()
        elif span.span_id in self._stack:       # out-of-order close
            self._stack.remove(span.span_id)
        return span

    @contextlib.contextmanager
    def span(self, kind: str, **attrs):
        span = self.begin(kind, **attrs)
        try:
            yield span
        finally:
            self.end(span)

    # ------------------------------------------------------------- events
    def event(self, kind: str, **attrs) -> Event:
        ev = Event(kind=kind, wall_t=time.perf_counter(),
                   sim_t=self._sim_now(),
                   span_id=self._stack[-1] if self._stack else None,
                   attrs=attrs)
        self.events.append(ev)
        return ev

    def sys(self, kind: str, t: float, client: int, version: int, extra,
            attrs: Optional[Dict[str, Any]] = None) -> SysEvent:
        """Record one systime scheduling event (see :class:`SysEvent`)."""
        ev = SysEvent(kind, t, client, version, extra,
                      wall_t=time.perf_counter(), attrs=attrs)
        self.sys_events.append(ev)
        return ev

    # ----------------------------------------------------------- views
    def legacy_trace(self) -> List[tuple]:
        """The whole systime trace as legacy tuples, in emission order."""
        return [ev.legacy() for ev in self.sys_events]

    def __len__(self) -> int:
        return len(self.spans) + len(self.events) + len(self.sys_events)
