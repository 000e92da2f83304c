"""``solve_p95_ms``: the 95th percentile of the wall times of all the
window's solves (host clock)."""

from benchmark import stats


def read(run):
    return stats.percentile_ms([s["seconds"] for s in run.solves], 95)
