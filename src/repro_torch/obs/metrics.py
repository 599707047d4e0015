"""Process-local metrics registry: counters, gauges, histograms (port of
``repro.obs.metrics``, a copy).

The catalog of what the instrumented subsystems actually record — codec
encode ratios and error-feedback residual norms, ``PrefixCache``
buffer/advance/re-buffer counts and buffered bytes, deadline misses and
the staleness distribution, ``SpillStore`` hot-set hits/evictions — is
documented in docs/observability.md §Metrics catalog.  The robustness
layer (docs/robustness.md) adds: ``faults_injected{kind=}`` /
``fault_retries{kind=}`` / ``client_failures`` (injector + retry
policy), ``retry_backoff_s`` (histogram of per-retry backoff),
``quarantined_updates{reason=}`` / ``aggregate_nonfinite_dropped``
(update validation at the two defense lines), ``cohort_shortfall``
(sync clients lost for good after retries), and
``checkpoints_written`` / ``checkpoints_resumed``.

Design points:

* A metric is identified by ``(name, sorted label items)``; the first
  ``counter``/``gauge``/``histogram`` call creates it, later calls with
  the same identity return the same object (Prometheus semantics).
  Labels are plain keyword strings — keep cardinality simulation-sized
  (per-client labels are fine for cohorts, not for populations).
* Everything is plain python floats/ints — recording never touches a
  tensor, so instrumentation cannot perturb a run (asserted bitwise in
  tests/test_torch_obs.py).
* ``snapshot()`` returns a JSON-able list of dicts — the one shape the
  JSONL and Prometheus exporters (:mod:`repro_torch.obs.export`) both
  consume.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

#: Default histogram buckets: log-spaced from 1ms-ish to ~100s, suited
#: to the seconds/ratios the instrumented sites observe.  Sites with
#: integer-valued observations (staleness) pass their own buckets at
#: first creation.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


@dataclasses.dataclass
class Counter:
    """Monotone accumulator (``inc`` only)."""
    name: str
    labels: Tuple[Tuple[str, str], ...]
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({amount}))")
        self.value += amount


@dataclasses.dataclass
class Gauge:
    """Last-write-wins sample (``set``/``add``)."""
    name: str
    labels: Tuple[Tuple[str, str], ...]
    value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def add(self, amount: float) -> None:
        self.value += amount


class Histogram:
    """Cumulative-bucket histogram plus running count/sum/min/max —
    enough for distributions (staleness, encode ratios, group-update
    seconds) without keeping raw samples."""

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.labels = labels
        bs = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        self.buckets = bs
        self.bucket_counts = [0] * (len(bs) + 1)   # +1 = +Inf overflow
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def cumulative(self) -> List[int]:
        """Prometheus-style cumulative counts, one per ``le`` bucket
        plus the trailing +Inf bucket (== ``count``)."""
        out, acc = [], 0
        for c in self.bucket_counts:
            acc += c
            out.append(acc)
        return out


class MetricsRegistry:
    """One process-local registry per :class:`repro_torch.obs.Obs` bundle."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}

    def reset(self) -> None:
        """Drop every metric — back-to-back runs sharing one capture
        call ``Obs.reset()`` between them so counters don't accumulate
        stale state across runs (tests/test_torch_obs.py)."""
        self._metrics.clear()

    def _get(self, cls, name: str, labels: Dict[str, Any], **kw):
        key = (name, _label_key(labels))
        metric = self._metrics.get(key)
        if metric is None:
            metric = cls(name, key[1], **kw)
            self._metrics[key] = metric
        elif not isinstance(metric, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(metric).__name__}, not {cls.__name__}")
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    # -------------------------------------------------------------- views
    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def value(self, name: str, default=None, **labels):
        """Convenience reader for tests/reports: the counter/gauge value
        (or the histogram itself) registered under this identity."""
        metric = self._metrics.get((name, _label_key(labels)))
        if metric is None:
            return default
        return metric if isinstance(metric, Histogram) else metric.value

    def snapshot(self) -> List[dict]:
        """JSON-able dump of every metric, sorted by (name, labels) so
        snapshots diff cleanly across runs."""
        out = []
        for (name, labels), m in sorted(self._metrics.items()):
            entry: dict = {"name": name, "labels": dict(labels)}
            if isinstance(m, Counter):
                entry.update(type="counter", value=m.value)
            elif isinstance(m, Gauge):
                entry.update(type="gauge", value=m.value)
            else:
                entry.update(
                    type="histogram", count=m.count, sum=m.total,
                    min=None if m.count == 0 else m.vmin,
                    max=None if m.count == 0 else m.vmax,
                    buckets=list(m.buckets), cumulative=m.cumulative())
            out.append(entry)
        return out
