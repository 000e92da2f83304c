"""``ns_roofline``: the least time of the Navier-Stokes kernel's work (the
copied ``navier_stokes_bound``, with the Jacobi sweeps each solve's input
needed) over the kernel's device time in the trace, summed over the
window's solves, in %. Nothing where the trace lists no event of the
kernel."""

from benchmark import roofline, trace
from benchmark.reference.grid2d import axis_vertices

KERNEL = "fused_navier_stokes_rk4_kernel"


def read(run):
    sweeps = [s["sweeps"] for s in run.solves if "sweeps" in s]
    if run.trace is None or not sweeps or len(sweeps) != len(run.solves):
        return None
    kernel_s = trace.kernel_seconds(run.trace, KERNEL)
    if kernel_s <= 0.0:
        return None
    mesh = run.config["mesh"]
    cells = 1
    for interval, d_x in zip(mesh["x_intervals"], mesh["d_x"]):
        cells *= axis_vertices(interval, d_x).size
    t_0, t_1 = run.config["t_interval"]
    steps = int(round((t_1 - t_0) / run.config["fine"]["d_t"]))
    bound_ms = sum(
        roofline.navier_stokes_bound(cells, 1, steps, n, True)[0]
        for n in sweeps
    )
    return 100.0 * bound_ms * 1e-3 / kernel_s
