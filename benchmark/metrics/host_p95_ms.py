"""``host_p95_ms``: the 95th percentile of the wall times of all the
window's solves, read in the traced run of a cell whose tail the host
paces (the device idle most of the window)."""

from benchmark import stats


def read(run):
    return stats.percentile_ms([s["seconds"] for s in run.solves], 95)
