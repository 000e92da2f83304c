"""The least time the card could take for a kernel's work: the table of
peaks and the operation and byte counts of the port's stencil kernels.

Copied from ``chip_smoke.py`` (``PEAK_BYTES_PER_S``, ``PEAK_FP32_FLOPS``,
``FLOPS_PER_CELL_STEP``, ``NS_FLOPS_PER_CELL_*``, ``bound``,
``stencil_bound`` and ``navier_stokes_bound``), so that the yardstick
lives with the benchmark. Each input is counted as read once and each
output as written once; where the work depends on the data (the Jacobi
sweeps), the sweeps these inputs needed are counted.
"""

from __future__ import annotations

from typing import Tuple

# the card's published peaks (NVIDIA H100 SXM data sheet, at the 700 W
# power limit): HBM bytes per second and float32 operations per second
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# float32 operations one RK4 step does per grid cell, counted from the
# kernels' arithmetic: diffusion (K1-K3) evaluates a 10-operation
# right-hand side and 5 stage updates per stage
FLOPS_PER_CELL_STEP = {"diffusion": 62}

# the Navier-Stokes kernel: a step's four vorticity right-hand sides (a
# Laplacian and its coefficient 9, two gradient terms 4 each: 17), w's 13
# stage updates and the two velocities (5): 4 x 17 + 13 + 5 = 86; a Jacobi
# sweep's Laplacian (8), -w, the difference, the division and the sum
# (4), and the norm's difference, square and sum (3): 15
NS_FLOPS_PER_CELL_STEP = 86
NS_FLOPS_PER_CELL_SWEEP = 15


def bound(bytes_moved: float, flops: float) -> Tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for the
    work, the larger of its bytes over the memory rate and its
    operations over the float32 rate."""
    bytes_ms = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    flops_ms = 1e3 * flops / PEAK_FP32_FLOPS
    if bytes_ms >= flops_ms:
        return bytes_ms, "bytes"
    return flops_ms, "operations"


def stencil_bound(
    family: str,
    batch: int,
    n_steps: int,
    cells: int,
    components: int,
    trajectory: bool,
) -> Tuple[float, str]:
    """The bound of an RK4 stencil kernel: it reads each state and its
    constraint grids once (a float value and a byte mask a cell and
    component) and writes every step or the end state."""
    values = cells * components
    read = 4 * batch * values + 5 * values
    written = 4 * batch * values * (n_steps if trajectory else 1)
    return bound(
        read + written,
        FLOPS_PER_CELL_STEP[family] * batch * n_steps * cells,
    )


def navier_stokes_bound(
    cells: int, batch: int, n_steps: int, sweeps: int, trajectory: bool
) -> Tuple[float, str]:
    """The bound of a Navier-Stokes kernel run: each state and the
    Dirichlet grids (a float value and a byte mask a value) read once,
    every frame or the end state written once, against the operations of
    its steps and of the Jacobi sweeps it counted (``sweeps``, summed over
    the batch)."""
    values = 4 * cells
    read = 4 * batch * values + 5 * values
    written = 4 * batch * values * (n_steps if trajectory else 1)
    flops = cells * (
        NS_FLOPS_PER_CELL_STEP * batch * n_steps
        + NS_FLOPS_PER_CELL_SWEEP * sweeps
    )
    return bound(read + written, flops)
