"""``mfu``: the window's useful FLOPs (``counts.round_flops`` a round,
times its whole rounds) over its seconds at ``counts.PEAK_FLOPS``, in
percent: the whole round's share of the card's fp32-accurate peak.  A
traced run's window is neither timed nor profiled: those rounds follow
it."""

from fedbench import counts


def read(run):
    if run.window_s <= 0:
        return None
    return 100.0 * run.round_flops * run.rounds / (run.window_s
                                                   * counts.PEAK_FLOPS)
