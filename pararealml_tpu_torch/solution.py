"""Solutions of initial value problems.

Capability match for PararealML's solution.py:25-336: holds
the discrete trajectory, supports spatial interpolation, orientation
resampling and cross-solution differencing at matching time points.
Trajectories live as host NumPy arrays (solvers transfer their device
output once). Plot generation is not ported yet (ROADMAP.md, Queue 1,
slice 8).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from pararealml_tpu_torch.initial_value_problem import InitialValueProblem


class Diffs(NamedTuple):
    """Differences between solutions at time points matching across all of
    them."""

    matching_time_points: np.ndarray
    differences: Sequence[np.ndarray]


class Solution:
    """A discrete solution of an IVP."""

    def __init__(
        self, ivp: InitialValueProblem,
        t_coordinates: np.ndarray, discrete_y: np.ndarray,
        vertex_oriented: Optional[bool] = None,
        d_t: Optional[float] = None,
    ):
        times = np.asarray(t_coordinates, dtype=float)
        trajectory = np.asarray(discrete_y, dtype=float)

        if times.ndim != 1:
            raise ValueError(
                f"t coordinates must be one-dimensional, got {times.ndim} "
                "dimensions"
            )
        if not times.size:
            raise ValueError("at least one t coordinate is required")
        problem = ivp.constrained_problem
        if problem.differential_equation.x_dimension \
                and vertex_oriented is None:
            raise ValueError(
                "PDE solutions require an explicit vertex orientation"
            )
        expected = (times.size,) + tuple(problem.y_shape(vertex_oriented))
        if trajectory.shape != expected:
            raise ValueError(
                f"solution shape {trajectory.shape} does not match the "
                f"expected {expected}"
            )

        self._problem = ivp
        self._times = times.copy()
        self._trajectory = trajectory.copy()
        self._on_vertices = vertex_oriented
        self._times.setflags(write=False)

        if d_t is None:
            d_t = float(times[1] - times[0]) if times.size > 1 else 0.0
        self._step = d_t

    @property
    def initial_value_problem(self) -> InitialValueProblem:
        """The solved IVP."""
        return self._problem

    @property
    def vertex_oriented(self) -> Optional[bool]:
        """Whether the solution is vertex or cell oriented (None for
        ODEs)."""
        return self._on_vertices

    @property
    def d_t(self) -> float:
        """The temporal step size of the solution."""
        return self._step

    @property
    def t_coordinates(self) -> np.ndarray:
        """The time coordinates of the solution."""
        return self._times

    def y(
        self, x: Optional[np.ndarray] = None,
        interpolation_method: str = "linear",
    ) -> np.ndarray:
        """The solution interpolated at spatial coordinates ``x`` at every
        time step.

        The interpolation is one multilinear gather over the whole
        trajectory (see
        :func:`pararealml_tpu_torch.interpolation.grid_interpolate`)
        rather than a SciPy call per query.
        """
        problem = self._problem.constrained_problem
        if not problem.differential_equation.x_dimension:
            return self._trajectory.copy()

        from pararealml_tpu_torch.interpolation import grid_interpolate

        # carry the time axis through the blend as a trailing value
        # axis so one gather resamples the entire trajectory
        trajectory_last = np.moveaxis(self._trajectory, 0, -1)
        interpolated = grid_interpolate(
            torch.as_tensor(np.ascontiguousarray(trajectory_last)),
            problem.mesh.axis_coordinates(self._on_vertices),
            torch.as_tensor(np.asarray(x)),
            method=interpolation_method,
        )
        return np.ascontiguousarray(
            np.moveaxis(interpolated.numpy(), -1, 0)
        )

    def discrete_y(
        self, vertex_oriented: Optional[bool] = None,
        interpolation_method: str = "linear",
    ) -> np.ndarray:
        """The discrete solution resampled to the requested orientation."""
        if vertex_oriented is None:
            vertex_oriented = self._on_vertices

        problem = self._problem.constrained_problem
        same_grid = (
            vertex_oriented == self._on_vertices
            or not problem.differential_equation.x_dimension
        )
        if same_grid:
            return self._trajectory.copy()

        resampled = self.y(
            problem.mesh.all_index_coordinates(vertex_oriented),
            interpolation_method,
        )
        constraints = problem.static_y_vertex_constraints
        if vertex_oriented and constraints is not None:
            resampled = constraints.apply(
                torch.as_tensor(resampled)
            ).numpy()
        return resampled

    def diff(
        self, solutions: Sequence["Solution"], atol: float = 1e-8
    ) -> Diffs:
        """Differences between this solution and the provided ones at every
        time point present (within ``atol``) in all of them."""
        if not solutions:
            raise ValueError("at least one solution to diff against is "
                             "required")

        all_time_points = [self._times] + [
            s.t_coordinates for s in solutions
        ]
        all_time_steps = [self._step] + [s.d_t for s in solutions]
        other_ys = [s.discrete_y(self._on_vertices) for s in solutions]

        sparsest = int(np.argmin([len(tp) for tp in all_time_points]))

        matching_times: List[float] = []
        all_diffs: List[List[np.ndarray]] = [[] for _ in solutions]

        for i, t in enumerate(all_time_points[sparsest]):
            indices = []
            for j, time_points in enumerate(all_time_points):
                if j == sparsest:
                    indices.append(i)
                    continue
                idx = int(round((t - time_points[0]) / all_time_steps[j]))
                if 0 <= idx < len(time_points) and np.isclose(
                    t, time_points[idx], atol=atol, rtol=0.0
                ):
                    indices.append(idx)
                else:
                    break
            else:
                matching_times.append(t)
                for j, y_other in enumerate(other_ys):
                    all_diffs[j].append(
                        y_other[indices[j + 1]]
                        - self._trajectory[indices[0]]
                    )

        return Diffs(
            np.array(matching_times),
            [np.array(d) for d in all_diffs],
        )

    def generate_plots(self, **kwargs):
        """Plot generation (numpy and matplotlib only in the JAX package)
        is not ported yet."""
        raise NotImplementedError(
            "Solution.generate_plots is not ported to PyTorch yet "
            "(ROADMAP.md, Queue 1, slice 8: the surface)"
        )
