"""``parareal_iterations``: the mean over the window's solves of the
iterations the Parareal schedule ran (``PararealOperator.last_iterations``,
a counter of the program)."""


def read(run):
    counts = [s["iterations"] for s in run.solves if "iterations" in s]
    if not counts:
        return None
    return sum(counts) / len(counts)
