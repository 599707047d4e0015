"""Time a call on the card with CUDA events.

Used by ``chip_smoke.py`` and ``repro_torch.kernels.variants``; it needs a
CUDA device.
"""
from __future__ import annotations

import time

import torch


def time_ms(fn, iters: int, warmup: int = 2, fill: bool = False) -> float:
    """ms per call of ``fn`` over ``iters`` calls in a row.  With ``fill``
    the card first sleeps for twice the host's time to enqueue them, so
    that they run back to back on the card: the device time, without the
    host's per-call cost (Python, argument checks, the launch), which sets
    the plain back-to-back figure of a short kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if fill:   # ~2e9 cycles a second; the sleep ends before `start`
        torch.cuda._sleep(int(min(2 * host * iters * 2e9, 2e9)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
