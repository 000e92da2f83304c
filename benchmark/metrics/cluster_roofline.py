"""``cluster_roofline``: the least time of the cluster-resident mode's work
(``ops/fused_system.py`` ``cluster_system_rk4_trajectory``) over the mode
kernel's device time in the trace, summed over the window's solves, in %.

The work is the wave system's (``u_t = v``, ``v_t = c^2 lap(u)``) on the
configuration's grid, two components a cell: the RK4 steps the window's
solves counted (the program's ``rk4_state_steps``, states times steps),
each step's frame written once, and each launch's inputs read once (the
state, and a float value and a byte mask a value of the Dirichlet grids),
against the operations of those steps. ``roofline.bound`` takes the larger
of the bytes over the memory rate and the operations over the float32
rate.

The mode runs the same kernel template as the one-CTA K5
(``fused_system_rk4_kernel``, ``csrc/system_2d_resident.cuh``), and the
two cannot be told apart by name in the trace; so there is nothing to read
unless the window launched the mode's trajectory and launched no K5
trajectory (the traffic's ``path`` names both). Nothing either where the
trace lists no event of the kernel, or where no span of the window counted
a step (a program without the counter).
"""

from benchmark import roofline, spans, trace
from benchmark.reference.grid2d import axis_vertices

MODE = "pararealml_tpu_torch.ops.fused_system.cluster_system_rk4_trajectory"
ONE_CTA = "pararealml_tpu_torch.ops.fused_system.fused_system_rk4_trajectory"
KERNEL = "fused_system_rk4_kernel"

COMPONENTS = 2
# float32 operations one RK4 step of the wave functor (csrc/system_2d.cuh
# Wave2D, under the resident template's stages) does per grid cell: four
# right-hand sides of a Laplacian (2 x centre, three operations an axis,
# their sum: 8) times c^2 (1), u' = v taking none: 4 x 9 = 36; and per
# component the stage updates, y + h/2 k (2), acc + 2 k and y + h/2 k
# (4), acc + 2 k and y + h k (4), and y + h/6 (acc + k) (3): 2 x 13 = 26
WAVE_FLOPS_PER_CELL_STEP = 62


def mode_bound(cells: int, launches: int, state_steps: int):
    """(bound_ms, bound_by) of ``launches`` trajectory launches of one
    state each that ran ``state_steps`` steps in all, on a grid of
    ``cells`` cells."""
    values = COMPONENTS * cells
    read = launches * (4 * values + 5 * values)
    written = 4 * values * state_steps
    return roofline.bound(
        read + written, WAVE_FLOPS_PER_CELL_STEP * cells * state_steps
    )


def read(run):
    launches = run.launches.get(MODE, 0)
    if run.trace is None or not launches or run.launches.get(ONE_CTA, 1):
        return None
    found = spans.analysis(run)
    if found is None or not found.steps:
        return None
    kernel_s = trace.kernel_seconds(run.trace, KERNEL)
    if kernel_s <= 0.0:
        return None
    mesh = run.config["mesh"]
    cells = 1
    for interval, d_x in zip(mesh["x_intervals"], mesh["d_x"]):
        cells *= axis_vertices(interval, d_x).size
    bound_ms, _ = mode_bound(cells, launches, found.steps)
    return 100.0 * bound_ms * 1e-3 / kernel_s
