"""Plain reference of the 2D diffusion configurations: ``y_t = d lap(y)``,
three-point differences, classic RK4 with the Dirichlet values applied to
every stage input and to the step's result, in NumPy.

The initial condition is the pool item's values on the vertices, with
the Dirichlet values applied. A Parareal solve is compared with this fine
solve: it converges to it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from benchmark.reference.grid2d import Grid2D, round_to_bfloat16
from benchmark.reference.grid2d import initial_states as grid_initial_states

COMPONENTS = 1


def initial_states(config: dict, values, items, dtype=np.float64):
    """The initial states ``(B, H, W, 1)`` of the pool items ``items``
    from their initial condition's ``values`` (see
    :func:`benchmark.reference.grid2d.initial_states`)."""
    return grid_initial_states(config, COMPONENTS, values, items, dtype)


def step_function(config: dict, dtype=np.float64):
    """One plain RK4 step ``(B, H, W) -> (B, H, W)`` of the fine solve, in
    ``dtype``."""
    grid = Grid2D(config, COMPONENTS, dtype)
    d = grid.dtype.type(float(config["pde"].get("d", 1.0)))
    h = grid.dtype.type(float(config["fine"]["d_t"]))
    half, sixth = h / 2, h / 6

    def rhs(plane):
        return d * grid.laplacian(plane, 0)

    def D(plane):
        return grid.dirichlet(plane, 0)

    def step(y):
        k1 = rhs(y)
        k2 = rhs(D(y + half * k1))
        k3 = rhs(D(y + half * k2))
        k4 = rhs(D(y + h * k3))
        return D(y + sixth * (k1 + 2 * k2 + 2 * k3 + k4))

    return step


def trajectory(
    config: dict,
    y_0: np.ndarray,
    dtype=np.float64,
    storage: Optional[str] = None,
):
    """The fine solve's frames ``(B, steps, H, W, 1)`` from ``y_0``, in
    ``dtype``; with ``storage="bfloat16"`` the state is rounded to
    bfloat16 after every step (the lower-precision control). Returns the
    frames and an empty dictionary (no solver counts).

    The step is affine in the state (every stage and the Dirichlet values
    are), so it is taken as ``y S^T + q``, the matrix ``S`` and offset
    ``q`` that one plain step gives on the unit states and on zero: the
    same step, in one product instead of some sixty small operations."""
    dtype = np.dtype(dtype)
    t_0, t_1 = config["t_interval"]
    steps = int(round((t_1 - t_0) / float(config["fine"]["d_t"])))
    batch, height, width = y_0.shape[:3]
    cells = height * width
    step = step_function(config, dtype)
    probes = np.concatenate(
        [np.eye(cells, dtype=dtype), np.zeros((1, cells), dtype)]
    ).reshape(cells + 1, height, width)
    images = step(probes).reshape(cells + 1, cells)
    offset = images[-1].copy()
    matrix_t = images[:-1] - offset
    y = y_0.reshape(batch, cells).astype(dtype)
    frames = np.empty((batch, steps, cells), dtype)
    for k in range(steps):
        y = y @ matrix_t
        y += offset
        if storage == "bfloat16":
            y = round_to_bfloat16(y).astype(dtype)
        frames[:, k] = y
    return frames.reshape(batch, steps, height, width, 1), {}
