"""``k1_roofline``: the least time of the solves' stencil work (the copied
``stencil_bound``: the configuration's cells times its fine steps, one
trajectory a solve, bounded by bytes) over the solves' device time other
than copies, in %. Nothing where K1 (``fused_diffusion_rk4_trajectory``)
did not run in the window."""

from benchmark import roofline, trace
from benchmark.reference.grid2d import axis_vertices

K1 = "pararealml_tpu_torch.ops.fused_diffusion.fused_diffusion_rk4_trajectory"


def read(run):
    if run.trace is None or not run.launches.get(K1) or not run.solves:
        return None
    mesh = run.config["mesh"]
    cells = 1
    for interval, d_x in zip(mesh["x_intervals"], mesh["d_x"]):
        cells *= axis_vertices(interval, d_x).size
    t_0, t_1 = run.config["t_interval"]
    steps = int(round((t_1 - t_0) / run.config["fine"]["d_t"]))
    bound_ms, _ = roofline.stencil_bound(
        "diffusion", 1, steps, cells, 1, trajectory=True
    )
    compute_s = trace.device_seconds(run.trace)
    if compute_s <= 0.0:
        return None
    return 100.0 * bound_ms * 1e-3 * len(run.solves) / compute_s
