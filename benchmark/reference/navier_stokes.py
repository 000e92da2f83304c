"""Plain reference of the 2D Navier-Stokes configurations in vorticity and
stream-function form, state ``(w, psi, u, v)``, in NumPy.

A step, as the upstream library defines its operator (PararealML's
``NavierStokesEquation`` under an FDM RK4 operator):

- the vorticity advances one RK4 step of ``w_t = lap(w) / Re - u w_x0 -
  v w_x1``, the velocities held at their step-initial values (with their
  Dirichlet values from the second stage on);
- the velocities become ``u = d psi / d x1`` and ``v = -d psi / d x0`` of
  the step-initial stream function;
- the stream function solves ``lap(psi) = -w`` (the step-initial ``w``)
  by Jacobi sweeps ``psi + (lap(psi) + w) / (2 / dx0^2 + 2 / dx1^2)``,
  warm-started from ``psi`` with its Dirichlet values, each sweep
  followed by them, until the 2-norm of a sweep's update (summed in
  float64) is at most ``tol`` or ``max_iterations`` sweeps have run, at
  least one.

The initial condition is the pool item's values on the vertices (the
fluid at rest plus the item's vortices), with the Dirichlet values
applied.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from benchmark.reference.grid2d import Grid2D, round_to_bfloat16
from benchmark.reference.grid2d import initial_states as grid_initial_states

COMPONENTS = 4


def initial_states(config: dict, values, items, dtype=np.float64):
    """The initial states ``(B, H, W, 4)`` of the pool items ``items``
    from their initial condition's ``values`` (see
    :func:`benchmark.reference.grid2d.initial_states`)."""
    return grid_initial_states(config, COMPONENTS, values, items, dtype)


def trajectory(
    config: dict,
    y_0: np.ndarray,
    dtype=np.float64,
    storage: Optional[str] = None,
):
    """The solve's frames ``(B, steps, H, W, 4)`` from ``y_0``, in
    ``dtype``; with ``storage="bfloat16"`` the state is rounded to
    bfloat16 after every step (the lower-precision control). Returns the
    frames and ``{"sweeps": (B,) int64}``, each state's Jacobi sweeps over
    the solve."""
    grid = Grid2D(config, COMPONENTS, dtype)
    t_0, t_1 = config["t_interval"]
    d_t = float(config["fine"]["d_t"])
    steps = int(round((t_1 - t_0) / d_t))
    solver = config["anti_laplacian"]
    tol, max_iterations = float(solver["tol"]), int(solver["max_iterations"])
    f = grid.dtype.type
    h, nu = f(d_t), f(1.0 / float(config["pde"]["re"]))
    half, sixth = h / 2, h / 6
    denominator = f(2.0 / grid.d_x[0] ** 2 + 2.0 / grid.d_x[1] ** 2)

    def D(plane, comp):
        return grid.dirichlet(plane, comp)

    def vorticity_rhs(w, u, v):
        lap, g0, g1 = grid.laplacian_and_gradients(w, 0)
        lap *= nu
        lap -= u * g0
        lap -= v * g1
        return lap

    def stream_function(psi, rhs):
        """Each state's Jacobi solve on its own, ``psi`` ``(B, H, W)``."""
        sweeps = np.zeros(psi.shape[0], np.int64)
        for b in range(psi.shape[0]):
            state, source = psi[b: b + 1], rhs[b: b + 1]
            while True:
                new = grid.laplacian(state, 1)
                new -= source
                new /= denominator
                new += state
                D(new, 1)
                update = new.astype(np.float64, copy=False) - state
                sweeps[b] += 1
                state = new
                norm = np.sqrt(np.vdot(update, update))
                if norm <= tol or sweeps[b] >= max_iterations:
                    break
            psi[b] = state[0]
        return psi, sweeps

    y = y_0.astype(grid.dtype)
    w, psi, u, v = (y[..., comp] for comp in range(COMPONENTS))
    frames = np.empty((y.shape[0], steps) + y.shape[1:], grid.dtype)
    sweeps = np.zeros(y.shape[0], np.int64)
    for k in range(steps):
        u_d, v_d = D(u, 2), D(v, 3)
        k1 = vorticity_rhs(w, u, v)
        k2 = vorticity_rhs(D(w + half * k1, 0), u_d, v_d)
        k3 = vorticity_rhs(D(w + half * k2, 0), u_d, v_d)
        k4 = vorticity_rhs(D(w + h * k3, 0), u_d, v_d)
        w_next = D(w + sixth * (k1 + 2 * k2 + 2 * k3 + k4), 0)
        g0, g1 = grid.gradients(psi, 1)
        u, v = D(g1, 2), D(-g0, 3)
        psi, step_sweeps = stream_function(D(psi, 1).copy(), -w)
        sweeps += step_sweeps
        w = w_next
        if storage == "bfloat16":
            w, psi, u, v = (
                round_to_bfloat16(p).astype(grid.dtype)
                for p in (w, psi, u, v)
            )
        frames[:, k, ..., 0] = w
        frames[:, k, ..., 1] = psi
        frames[:, k, ..., 2] = u
        frames[:, k, ..., 3] = v
    return frames, {"sweeps": sweeps}
