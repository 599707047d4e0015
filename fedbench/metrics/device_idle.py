"""``device_idle``: the share of a round in which no operation ran on
the card (1 - the union of device activity over the round's length on
the host clock), in percent, in the round traced on the device alone."""


def read(run):
    if run.trace is None or run.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
