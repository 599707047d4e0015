"""Streaming history sinks (port of ``repro.fl.scale.history``, a copy
with numpy only; docs/scale.md §History).

Both engines historically ACCUMULATE: ``RoundEngine.run`` appends one
``RoundRecord`` per eval checkpoint to a list, and the systime
``AsyncEngine`` additionally grows an unbounded per-event trace — at a
million simulated rounds/events that is real host memory
(ROADMAP "unbounded history growth").  A history sink replaces the
lists with an append-only JSONL stream: ``write(record)`` for round
records, ``write_trace(event)`` for systime trace tuples, one JSON
object per line, flushed per record so a crashed run keeps its history.

Both engines accept ``history_sink=`` (a sink instance, or a PATH — the
engine then owns the sink and closes it when ``run`` completes); the
default (``None``) keeps the in-memory lists bitwise-unchanged.  When a
sink is set, ``run()`` returns an EMPTY history list — the stream is
the history.

Every line is valid JSON even when the simulation produces non-finite
floats (a diverged run's ``accuracy=nan``): values are sanitized to
``null`` before serialization and ``json.dumps`` runs with
``allow_nan=False``, so a bare ``NaN``/``Infinity`` token — which
``json.loads`` in spec-compliant readers rejects — can never reach the
file (tests/test_torch_obs.py).
"""
from __future__ import annotations

import json
import math
import os
from typing import IO, Optional, Union

import numpy as np


def sanitize(obj):
    """Recursively map non-finite floats to ``None`` and numpy scalars
    to python scalars — the one normalization every line goes through
    so the stream is always spec-compliant JSON."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, np.floating):
        f = float(obj)
        return f if math.isfinite(f) else None
    if isinstance(obj, (np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    return obj


def read_jsonl(path: str, *, kind: Optional[str] = None) -> list:
    """Crash-tolerant JSONL reader (the resume side of the sink).

    A server killed mid-``write`` leaves a TRUNCATED final line; that
    line is skipped with a warning instead of raising — every complete
    line before it is returned.  A malformed line anywhere else (torn
    page, manual edit) is skipped the same way.  ``kind=`` filters to
    one line kind ("round", "trace", ...)."""
    import warnings
    out = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            stripped = line.strip()
            if not stripped:
                continue
            try:
                obj = json.loads(stripped)
            except json.JSONDecodeError:
                warnings.warn(f"{path}:{lineno}: skipping truncated/"
                              f"malformed JSONL line")
                continue
            if kind is None or obj.get("kind") == kind:
                out.append(obj)
    return out


class JsonlHistorySink:
    """JSONL writer for ``RoundRecord`` streams, systime traces, and
    telemetry exports.

    Records become ``{"kind": "round", ...fields}`` lines; trace events
    (heterogeneous tuples like ``("dispatch", t, client)``) become
    ``{"kind": "trace", "event": [...]}``; :meth:`emit` writes any
    other tagged line (the ``repro_torch.obs`` JSONL exporter composes with
    it).  Accepts a path (parent dirs created, file truncated — or
    appended with ``mode="a"``, the checkpoint-resume path) or an open
    text handle (left open on ``close`` — the caller owns it).

    ``fsync_every`` (crash-safe streaming, docs/robustness.md): every
    N lines the file is fsync'd to disk, bounding how much history a
    server crash can lose to N-1 lines.  Default 0 = flush-only
    (today's behavior; the OS decides when bytes hit the platter)."""

    def __init__(self, path_or_file: Union[str, os.PathLike, IO[str]],
                 *, fsync_every: int = 0, mode: str = "w"):
        if mode not in ("w", "a"):
            raise ValueError(f"mode must be 'w' or 'a', got {mode!r}")
        if hasattr(path_or_file, "write"):
            self._f: Optional[IO[str]] = path_or_file
            self._owns = False
            self.path = getattr(path_or_file, "name", None)
        else:
            self.path = os.fspath(path_or_file)
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._f = open(self.path, mode)
            self._owns = True
        self.fsync_every = int(fsync_every)
        self._since_sync = 0
        self.records = 0
        self.traces = 0

    def _emit(self, obj: dict) -> None:
        if self._f is None:
            raise ValueError("history sink is closed")
        # allow_nan=False is the backstop: sanitize() already mapped
        # non-finite values to None, so a raise here means a new
        # unsanitized type snuck in — fail loudly, never write NaN
        self._f.write(json.dumps(sanitize(obj), allow_nan=False) + "\n")
        self._f.flush()
        if self.fsync_every > 0:
            self._since_sync += 1
            if self._since_sync >= self.fsync_every:
                try:
                    os.fsync(self._f.fileno())
                except (OSError, AttributeError, ValueError):
                    pass               # in-memory handles have no fileno
                self._since_sync = 0

    def write(self, record) -> None:
        """Stream one ``RoundRecord`` (any NamedTuple with ``_asdict``,
        or a plain dict)."""
        fields = record._asdict() if hasattr(record, "_asdict") \
            else dict(record)
        self._emit({"kind": "round", **fields})
        self.records += 1

    def write_trace(self, event) -> None:
        """Stream one systime trace event (a plain tuple)."""
        self._emit({"kind": "trace", "event": list(event)})
        self.traces += 1

    def emit(self, kind: str, **fields) -> None:
        """Stream one arbitrary tagged line (``{"kind": kind, ...}``) —
        the composition point for telemetry exporters."""
        self._emit({"kind": kind, **fields})

    def flush(self) -> None:
        """Flush the underlying file (each line already flushes; this
        is the explicit completion hook the engines call)."""
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None and self._owns:
            self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
