"""Event-driven virtual clock (port of ``repro.fl.systime.clock``, a
copy).

The unit of progress in the systime subsystem is an *event* (a client
finishing its upload), not a barrier round: the :class:`EventLoop` keeps
a heap of scheduled events and advances ``now`` monotonically as they
pop.  Ties break on insertion order (a monotone sequence number), so a
run's event order — and therefore everything downstream of the shared
rng stream — is fully deterministic for a given seed.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, List, Optional


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    client: int = dataclasses.field(compare=False, default=-1)
    payload: Any = dataclasses.field(compare=False, default=None)


class EventLoop:
    """Min-heap of :class:`Event` with a monotone ``now``."""

    def __init__(self):
        self._heap: List[Event] = []
        self._seq = 0
        self.now = 0.0

    def __len__(self) -> int:
        return len(self._heap)

    def schedule(self, delay: float, kind: str, *, client: int = -1,
                 payload: Any = None) -> Event:
        """Schedule ``kind`` at ``now + delay`` (delay >= 0)."""
        if delay < 0:
            raise ValueError(f"cannot schedule into the past: {delay}")
        ev = Event(self.now + delay, self._seq, kind, client, payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def pop(self) -> Event:
        """Pop the earliest event and advance ``now`` to its time."""
        if not self._heap:
            raise IndexError("pop from an empty EventLoop")
        ev = heapq.heappop(self._heap)
        self.now = ev.time
        return ev

    def advance(self, delay: float) -> float:
        """Advance ``now`` by ``delay`` without an event (sync barriers)."""
        if delay < 0:
            raise ValueError(f"cannot advance backwards: {delay}")
        self.now += delay
        return self.now
