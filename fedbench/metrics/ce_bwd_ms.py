"""``ce_bwd_ms``: device milliseconds a round of the head's plain
backward (``kernels/ops.py``'s ``cross_entropy_bwd``): the device
operations launched while the autograd node
``ChunkedCrossEntropyBackward`` ran, on its thread, in the round traced
on the host and the device."""

NODE = "ChunkedCrossEntropyBackward"


def read(run):
    if run.host_trace is None:
        return None
    s, n = run.host_trace.time_under(NODE)
    return 1e3 * s if n else None
