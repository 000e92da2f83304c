"""``jacobi_sweeps``: the mean over the window's solves of the
Navier-Stokes kernel's Jacobi sweeps a solve (the wrapper's ``sweeps``
counter, summed over the solve's states)."""


def read(run):
    counts = [s["sweeps"] for s in run.solves if "sweeps" in s]
    if not counts:
        return None
    return sum(counts) / len(counts)
