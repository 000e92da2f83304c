"""Plain reference of the 2D wave configurations in first-order form, state
``(u, v)``: ``u_t = v``, ``v_t = c^2 lap(u)``, three-point differences,
classic RK4 with the Dirichlet values applied to every stage input and to
the step's result, in NumPy.

The initial condition is the pool item's values on the vertices, with
the Dirichlet values applied.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from benchmark.reference.grid2d import Grid2D, round_to_bfloat16
from benchmark.reference.grid2d import initial_states as grid_initial_states

COMPONENTS = 2
# the states stepped together: each block's stage arrays stay small, and
# the frames are written into the one output array as they come
BLOCK = 8


def initial_states(config: dict, values, items, dtype=np.float64):
    """The initial states ``(B, H, W, 2)`` of the pool items ``items``
    from their initial condition's ``values`` (see
    :func:`benchmark.reference.grid2d.initial_states`)."""
    return grid_initial_states(config, COMPONENTS, values, items, dtype)


def step_function(config: dict, dtype=np.float64):
    """One plain RK4 step ``(u, v) -> (u, v)`` of ``(B, H, W)`` planes, in
    ``dtype``."""
    grid = Grid2D(config, COMPONENTS, dtype)
    f = grid.dtype.type
    c_squared = f(float(config["pde"].get("c", 1.0)) ** 2)
    h = f(float(config["fine"]["d_t"]))
    half, sixth = h / 2, h / 6

    def rhs(u, v):
        return v, c_squared * grid.laplacian(u, 0)

    def stage(u, v, k, scale):
        return (
            grid.dirichlet(u + scale * k[0], 0),
            grid.dirichlet(v + scale * k[1], 1),
        )

    def step(u, v):
        k1 = rhs(u, v)
        k2 = rhs(*stage(u, v, k1, half))
        k3 = rhs(*stage(u, v, k2, half))
        k4 = rhs(*stage(u, v, k3, h))
        combined = tuple(
            a + 2 * b + 2 * c + d for a, b, c, d in zip(k1, k2, k3, k4)
        )
        return stage(u, v, combined, sixth)

    return step


def trajectory(
    config: dict,
    y_0: np.ndarray,
    dtype=np.float64,
    storage: Optional[str] = None,
):
    """The solve's frames ``(B, steps, H, W, 2)`` from ``y_0``, in
    ``dtype``; with ``storage="bfloat16"`` the state is rounded to
    bfloat16 after every step (the lower-precision control). Returns the
    frames and an empty dictionary (no solver counts). The states are
    stepped ``BLOCK`` at a time."""
    dtype = np.dtype(dtype)
    t_0, t_1 = config["t_interval"]
    steps = int(round((t_1 - t_0) / float(config["fine"]["d_t"])))
    step = step_function(config, dtype)
    y_0 = y_0.astype(dtype)
    frames = np.empty((y_0.shape[0], steps) + y_0.shape[1:], dtype)
    for start in range(0, y_0.shape[0], BLOCK):
        block = slice(start, start + BLOCK)
        u, v = y_0[block, ..., 0].copy(), y_0[block, ..., 1].copy()
        for k in range(steps):
            u, v = step(u, v)
            if storage == "bfloat16":
                u = round_to_bfloat16(u).astype(dtype)
                v = round_to_bfloat16(v).astype(dtype)
            frames[block, k, ..., 0] = u
            frames[block, k, ..., 1] = v
    return frames, {}
