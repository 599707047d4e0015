"""Reading a traced window: ``torch.profiler`` with CPU and CUDA activity.

From the profiler's raw events this keeps the device's operations
(kernels, copies, fills) with their times and correlation ids, the
host's launch calls (CUDA runtime events) with their threads, and the
host's operator spans.  Per-layer metric readers ask it for:

* device time of the kernels whose names match a pattern, and how many
  launches;
* device time of the kernels launched inside host spans of a given name
  (an autograd node's ``evaluate_function`` on the backward thread): a
  launch belongs to the span of its thread that encloses it;
* the device's busy seconds (the union of every device operation) and
  the idle gaps between, each named by the innermost host span that was
  open in its middle.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple


class DeviceOp(NamedTuple):
    name: str
    start: int        # ns
    end: int
    corr: int


class HostSpan(NamedTuple):
    name: str
    start: int
    end: int
    thread: int


class Trace:
    def __init__(self, device_ops: List[DeviceOp], launches: Dict[int, tuple],
                 spans: List[HostSpan], window: Tuple[int, int],
                 window_s: Optional[float] = None):
        self.device_ops = device_ops
        self.launches = launches          # correlation -> (thread, start)
        self.spans = spans
        self.window = window              # ns, the traced window
        self._window_s = window_s
        self._by_thread: Optional[dict] = None

    @classmethod
    def from_profiler(cls, prof, window_span: Optional[str] = None,
                      wall_s: Optional[float] = None) -> "Trace":
        """The trace of ``prof``.  Its window is the host span named
        ``window_span`` (which closes after the device has finished), or,
        for a trace of device activity alone, the extent of the device's
        operations, ``wall_s`` long on the host's clock."""
        from torch.autograd import DeviceType
        device_ops, launches, spans = [], {}, []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                # a host range's shadow on the device timeline is no
                # device operation
                if e.is_user_annotation() or e.name().startswith("fedbench."):
                    continue
                device_ops.append(DeviceOp(e.name(), e.start_ns(),
                                           e.end_ns(), e.correlation_id()))
                continue
            name = e.name()
            if name.startswith("cu"):           # a CUDA runtime call
                launches[e.correlation_id()] = (e.start_thread_id(),
                                                e.start_ns())
            else:
                spans.append(HostSpan(name, e.start_ns(), e.end_ns(),
                                      e.start_thread_id()))
        device_ops.sort(key=lambda o: o.start)
        if window_span is not None:
            window = next((s.start, s.end) for s in spans
                          if s.name == window_span)
        else:
            window = (min(o.start for o in device_ops),
                      max(o.end for o in device_ops))
        return cls(device_ops, launches, spans, window, wall_s)

    # ------------------------------------------------------------ kernels
    def kernel_time(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels matching
        ``pattern`` (a regular expression, searched in the name)."""
        rx = re.compile(pattern)
        ops = [o for o in self.device_ops if rx.search(o.name)]
        return sum(o.end - o.start for o in ops) / 1e9, len(ops)

    def time_under(self, span_name: str) -> Tuple[float, int]:
        """(device seconds, operations) of the device operations launched
        while a host span whose name contains ``span_name`` was open on
        the launching thread."""
        per_thread = defaultdict(list)
        for s in self.spans:
            if span_name in s.name:
                per_thread[s.thread].append((s.start, s.end))
        for v in per_thread.values():
            v.sort()
        total, n = 0, 0
        for o in self.device_ops:
            launch = self.launches.get(o.corr)
            if launch is None:
                continue
            ivs = per_thread.get(launch[0])
            if not ivs:
                continue
            i = bisect.bisect_right(ivs, (launch[1], float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= launch[1] <= ivs[i][1]:
                total += o.end - o.start
                n += 1
        return total / 1e9, n

    # ----------------------------------------------------- busy and idle
    def busy_intervals(self) -> List[Tuple[int, int]]:
        lo_w, hi_w = self.window
        out: List[List[int]] = []
        for o in self.device_ops:
            a, b = max(o.start, lo_w), min(o.end, hi_w)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def window_s(self) -> float:
        if self._window_s is not None:
            return self._window_s
        return (self.window[1] - self.window[0]) / 1e9

    def top_device_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(int)
        for o in self.device_ops:
            by[o.name] += o.end - o.start
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v / 1e9] for k, v in top]

    def _innermost(self, t: int) -> str:
        """The innermost host span open at ``t``, on any thread."""
        if self._by_thread is None:
            self._by_thread = defaultdict(list)
            for s in self.spans:
                self._by_thread[s.thread].append(s)
            for v in self._by_thread.values():
                v.sort(key=lambda s: s.start)
        best = None
        for v in self._by_thread.values():
            i = _last_start_before(v, t)
            # walk back to the latest-starting span still open at t
            for j in range(i, max(-1, i - 20000), -1):
                if v[j].end >= t:
                    if best is None or v[j].start > best.start:
                        best = v[j]
                    break
        return best.name if best is not None else "(no host span)"

    def idle_gaps(self, n: int = 10, examine: int = 200) -> List[list]:
        """The idle gaps of the device in the window, summed by what the
        host was doing in each (the ``examine`` longest gaps), the ``n``
        largest sums."""
        busy = self.busy_intervals()
        lo_w, hi_w = self.window
        edges = [lo_w] + [x for ab in busy for x in ab] + [hi_w]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        by = defaultdict(int)
        for length, a, b in gaps[:examine]:
            by[self._innermost((a + b) // 2)] += length
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v / 1e9] for k, v in top]


def _last_start_before(spans: List[HostSpan], t: int) -> int:
    lo, hi = 0, len(spans)
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid].start <= t:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."
