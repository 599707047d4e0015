"""``scan_bwd_ms``: device milliseconds a round of the Mamba2 scan's
plain backward (``kernels/ops.py``'s chunked recompute): the device
operations launched while the autograd node ``Mamba2ScanBackward`` ran,
on its thread, in the round traced on the host and the device."""

NODE = "Mamba2ScanBackward"


def read(run):
    if run.host_trace is None:
        return None
    s, n = run.host_trace.time_under(NODE)
    return 1e3 * s if n else None
