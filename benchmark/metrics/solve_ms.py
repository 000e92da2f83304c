"""``solve_ms``: the window's wall time over the solves it completed, each
from the call of ``Operator.solve`` to the returned ``Solution`` (host
clock)."""

from benchmark import stats


def read(run):
    return stats.mean_ms(run.window_s, len(run.solves))
