"""Exporters: one telemetry capture, three output formats (port of
``repro.obs.export``, a copy).

* :func:`to_jsonl` — every span / event / sys-event / metric as one
  JSON object per line, composing with
  :class:`repro_torch.fl.scale.history.JsonlHistorySink` (same file can carry
  round records, trace events, and telemetry side by side; non-finite
  floats are sanitized to ``null`` by the sink).
* :func:`to_chrome_trace` — Chrome trace-event format (the
  ``traceEvents`` array), loadable in Perfetto / ``chrome://tracing``.
  Client lanes live on the **sim-time** process: each in-flight client
  interval is split into its ``download`` / ``compute`` / ``upload``
  phases (the systime latency model's three terms), one lane (tid) per
  client, so a round renders as the paper's straggler picture.  Wall
  clock spans (round / cohort-group / client-update / block) go on a
  second process, normalized to the capture's first span.
* :func:`to_prometheus` — Prometheus textfile-collector snapshot
  (``# TYPE`` headers, ``name{label="v"} value`` samples, histograms as
  cumulative ``_bucket``/``_sum``/``_count`` series).

``tools/trace_report.py`` consumes the Chrome trace and folds the phase
slices into a per-device-tier round-time breakdown.
"""
from __future__ import annotations

import json
import math
import re
from typing import IO, Optional, Union

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import Tracer

#: The three phase slices a client lane is made of (== the systime
#: ``Latency`` fields, in wire-time order).
PHASES = ("download", "compute", "upload")

_SIM_PID, _WALL_PID = 1, 2


def _finite(x):
    try:
        f = float(x)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


# --------------------------------------------------------------------------
# JSONL
# --------------------------------------------------------------------------
def to_jsonl(obs, sink_or_path: Union[str, "object"]) -> int:
    """Stream the whole capture through a
    :class:`~repro_torch.fl.scale.history.JsonlHistorySink` (an open sink, or
    a path one is created for and closed).  Returns the line count.
    Line kinds: ``span`` / ``event`` / ``sys_event`` / ``metric``, plus
    ``audit_cell`` / ``dynamics_round`` / ``dynamics_rejection`` when
    the capture's diagnostics layer is enabled."""
    from repro_torch.fl.scale.history import JsonlHistorySink
    own = not isinstance(sink_or_path, JsonlHistorySink)
    sink = JsonlHistorySink(sink_or_path) if own else sink_or_path
    n = 0
    try:
        tr = obs.tracer
        for s in tr.spans:
            sink.emit("span", name=s.kind, span_id=s.span_id,
                      parent_id=s.parent_id, wall_start=s.wall_start,
                      wall_end=s.wall_end, sim_start=s.sim_start,
                      sim_end=s.sim_end, attrs=s.attrs)
            n += 1
        for e in tr.events:
            sink.emit("event", name=e.kind, wall_t=e.wall_t, sim_t=e.sim_t,
                      span_id=e.span_id, attrs=e.attrs)
            n += 1
        for ev in tr.sys_events:
            sink.emit("sys_event", name=ev.kind, t=ev.t, client=ev.client,
                      version=ev.version, extra=ev.extra, wall_t=ev.wall_t,
                      attrs=ev.attrs)
            n += 1
        for m in obs.metrics.snapshot():
            sink.emit("metric", **m)
            n += 1
        audit = getattr(obs, "audit", None)
        if audit is not None:
            for row in audit.table():
                sink.emit("audit_cell", **row)
                n += 1
        dyn = getattr(obs, "dynamics", None)
        if dyn is not None:
            for row in dyn.rounds:
                sink.emit("dynamics_round", **row)
                n += 1
            for row in dyn.rejections:
                sink.emit("dynamics_rejection", **row)
                n += 1
    finally:
        if own:
            sink.close()
    return n


# --------------------------------------------------------------------------
# Chrome trace-event format
# --------------------------------------------------------------------------
def _lane_meta(events: list, pid: int, tid: int, name: str) -> None:
    events.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                   "args": {"name": name}})


def to_chrome_trace(obs, path: Optional[str] = None) -> dict:
    """Build (and optionally write) the Chrome trace dict.

    Sim-time process (pid 1): tid 0 is the server lane (``aggregate``
    instants, round spans); tid ``client+1`` is that client's lane,
    carrying one ``download``/``compute``/``upload`` slice triple per
    in-flight interval — sourced from the SysEvent that OPENS the
    interval (``dispatch*`` in async mode, ``finish``/``miss`` in sync
    mode; the phase split rides in its ``attrs``).  Deadline misses keep
    their slices with ``args.missed = true`` so the wasted work is
    visible on the timeline.  Wall-clock process (pid 2): the tracer's
    span hierarchy, ts-normalized to the first span."""
    events: list = []
    _lane_meta(events, _SIM_PID, 0, "server")
    events.append({"ph": "M", "pid": _SIM_PID, "name": "process_name",
                   "args": {"name": "sim-time"}})
    events.append({"ph": "M", "pid": _WALL_PID, "name": "process_name",
                   "args": {"name": "wall-clock"}})
    seen_lanes = set()
    tr = obs.tracer
    for ev in tr.sys_events:
        if ev.kind == "aggregate":
            events.append({"ph": "i", "pid": _SIM_PID, "tid": 0, "s": "t",
                           "ts": ev.t * 1e6, "name": "aggregate",
                           "cat": "server",
                           "args": {"version": ev.version,
                                    "merged": ev.extra}})
            continue
        attrs = ev.attrs or {}
        if "start" not in attrs:
            continue            # interval-closing event (async finish)
        tid = ev.client + 1
        if tid not in seen_lanes:
            seen_lanes.add(tid)
            tier = attrs.get("tier", "?")
            _lane_meta(events, _SIM_PID, tid,
                       f"client {ev.client} ({tier})")
        t0 = float(attrs["start"])
        missed = ev.kind == "miss"
        first = True            # marks one slice per interval for reports
        for phase in PHASES:
            dur = _finite(attrs.get(phase))
            if dur is None or dur <= 0.0:
                continue
            events.append({
                "ph": "X", "pid": _SIM_PID, "tid": tid, "name": phase,
                "cat": "miss" if missed else "client",
                "ts": t0 * 1e6, "dur": dur * 1e6,
                "args": {"tier": attrs.get("tier"), "client": ev.client,
                         "version": ev.version, "missed": missed,
                         "interval_start": first}})
            t0 += dur
            first = False
    # wall-clock span hierarchy, normalized to the capture start
    closed = [s for s in tr.spans if s.wall_end is not None]
    if closed:
        origin = min(s.wall_start for s in closed)
        for s in closed:
            events.append({
                "ph": "X", "pid": _WALL_PID, "tid": 0, "name": s.kind,
                "cat": "span", "ts": (s.wall_start - origin) * 1e6,
                "dur": (s.wall_end - s.wall_start) * 1e6,
                "args": dict(s.attrs, span_id=s.span_id,
                             parent_id=s.parent_id)})
            # spans that progressed the virtual clock mirror onto the
            # server's sim-time lane (round markers over client lanes)
            if s.sim_end is not None and s.sim_end > s.sim_start:
                events.append({
                    "ph": "X", "pid": _SIM_PID, "tid": 0, "name": s.kind,
                    "cat": "span", "ts": s.sim_start * 1e6,
                    "dur": (s.sim_end - s.sim_start) * 1e6,
                    "args": dict(s.attrs, span_id=s.span_id)})
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


# --------------------------------------------------------------------------
# Prometheus textfile snapshot
# --------------------------------------------------------------------------
def _prom_name(name: str) -> str:
    return "repro_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _prom_escape(value) -> str:
    """Escape a label value per the Prometheus text exposition format:
    backslash, double-quote, and newline must be backslash-escaped."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels, extra: Optional[dict] = None) -> str:
    items = list(labels) + sorted((extra or {}).items())
    if not items:
        return ""
    body = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def to_prometheus(metrics: MetricsRegistry,
                  path_or_file: Union[str, IO[str], None] = None) -> str:
    """Render the registry as a Prometheus textfile-collector snapshot
    (optionally writing it) and return the text."""
    by_name: dict = {}
    for m in metrics:
        by_name.setdefault(m.name, []).append(m)
    lines = []
    for name in sorted(by_name):
        group = by_name[name]
        pname = _prom_name(name)
        kind = ("counter" if isinstance(group[0], Counter)
                else "gauge" if isinstance(group[0], Gauge)
                else "histogram")
        lines.append(f"# TYPE {pname} {kind}")
        for m in sorted(group, key=lambda m: m.labels):
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{pname}{_prom_labels(m.labels)} {m.value}")
                continue
            cum = m.cumulative()
            for le, c in zip(list(m.buckets) + ["+Inf"], cum):
                lines.append(
                    f"{pname}_bucket"
                    f"{_prom_labels(m.labels, {'le': le})} {c}")
            lines.append(f"{pname}_sum{_prom_labels(m.labels)} {m.total}")
            lines.append(f"{pname}_count{_prom_labels(m.labels)} {m.count}")
    text = "\n".join(lines) + "\n"
    if path_or_file is None:
        return text
    if hasattr(path_or_file, "write"):
        path_or_file.write(text)
    else:
        with open(path_or_file, "w") as f:
            f.write(text)
    return text
