"""``client_update_ms``: milliseconds of one client's depth-wise update
(``strategy.client_update``: ``core/blockwise.py``'s block loop, prefix
cache and SGD), on the host clock closed by a synchronise on both sides,
the mean over the client updates of the timed round after the window."""


def read(run):
    s = run.timers.client_s if run.timers is not None else []
    return 1e3 * sum(s) / len(s) if s else None
