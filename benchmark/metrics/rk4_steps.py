"""``rk4_steps``: the mean over the window's solves of the RK4 steps the
fused kernels ran (the program's ``rk4_state_steps`` counter, states
times steps a call, summed over each solve's spans). Nothing where no
span of the window counted any."""

from benchmark import spans


def read(run):
    found = spans.analysis(run)
    if found is None or found.steps is None:
        return None
    return found.steps / found.solves
