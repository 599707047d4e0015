"""``aggregate_ms``: device milliseconds a round of the server's
aggregate (``strategy.aggregate``, ``core/aggregation.py``'s FedAvg),
between CUDA events recorded around each call in the timed round
after the window."""


def read(run):
    ms = run.timers.aggregate_ms() if run.timers is not None else []
    return sum(ms) / len(ms) if ms else None
