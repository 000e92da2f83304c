"""``solution_ms``: the mean duration of the program's ``solution.build``
span a solve, in ms: the trajectory's host copy into the returned
``Solution`` (and the freeing of the host intermediate it copied from).
Nothing where the program records no spans."""

from benchmark import spans


def read(run):
    found = spans.analysis(run)
    if found is None or not found.total_ns("solution.build"):
        return None
    return found.total_ns("solution.build") / 1e6 / found.solves
