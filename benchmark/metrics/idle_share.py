"""``idle_share``: the share of the traced window in which no operation
ran on the device, ``1 - busy / window`` (busy: the union of the
profiler's device intervals)."""


def read(run):
    if run.trace is None or run.window_s <= 0.0:
        return None
    return 1.0 - run.busy_s / run.window_s
