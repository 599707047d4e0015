"""``gemm_ms``: device milliseconds a round in cuBLAS / CUTLASS matrix
products (the models' fp32 projections and the plain backwards'
products), by kernel name, in the round traced on the device alone."""

PATTERN = r"(?i)gemm|gemv|cutlass|xmma"


def read(run):
    if run.trace is None:
        return None
    s, n = run.trace.kernel_time(PATTERN)
    return 1e3 * s if n else None
