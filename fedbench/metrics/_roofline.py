"""A kernel's share of its roofline: the least time of its launches
(each call's operations at ``counts.PEAK_FLOPS`` or bytes at
``counts.PEAK_BYTES``, whichever is longer, times the calls) over their
device time, in percent, in the round traced on the device alone.  A
call is counted by the launches of the kernel's first ``__global__``;
its device time is every ``__global__`` of the kernel."""


def share(run, key: str, calls_pattern: str, time_pattern: str):
    if run.trace is None or key not in run.calls:
        return None
    _, calls = run.trace.kernel_time(calls_pattern)
    seconds, _ = run.trace.kernel_time(time_pattern)
    if not calls or seconds <= 0:
        return None
    return 100.0 * calls * run.calls[key].bound_s() / seconds
