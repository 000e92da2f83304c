"""Initial conditions.

Capability match for PararealML's initial_condition.py:18-405:
discrete, constant, continuous, Gaussian, and marginal-Beta-product initial
conditions, with orientation resampling and automatic application of static
y constraints for vertex-oriented data. Resampling between orientations is
a multilinear gather (:mod:`pararealml_tpu_torch.interpolation`); solvers
receive plain arrays.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import beta as beta_dist
from scipy.stats import multivariate_normal
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.mesh import to_cartesian_coordinates

VectorizedInitialConditionFunction = Callable[
    [Optional[np.ndarray]], np.ndarray
]


class InitialCondition:
    """Base class for initial conditions."""

    def y_0(self, x: Optional[np.ndarray]) -> np.ndarray:
        """The initial value of y at the points ``x`` (``None`` for
        ODEs)."""
        raise NotImplementedError

    def discrete_y_0(
        self, vertex_oriented: Optional[bool] = None,
    ) -> np.ndarray:
        """The initial values discretized on the vertices or cell centers
        of the mesh."""
        raise NotImplementedError


def _constrain_vertex_values(
    problem: ConstrainedProblem, values: np.ndarray
) -> np.ndarray:
    constraint = problem.static_y_vertex_constraints
    if constraint is None:
        return values
    return constraint.apply(torch.as_tensor(values)).numpy()


class DiscreteInitialCondition(InitialCondition):
    """An initial condition given by an array over the mesh points."""

    def __init__(
        self, cp: ConstrainedProblem, y_0: np.ndarray,
        vertex_oriented: Optional[bool] = None,
        interpolation_method: str = "linear",
    ):
        if cp.differential_equation.x_dimension \
                and vertex_oriented is None:
            message = (
                "PDE initial conditions require an explicit vertex "
                "orientation"
            )
            raise ValueError(message)
        values = np.asarray(y_0, dtype=float)
        expected = cp.y_shape(vertex_oriented)
        if values.shape != expected:
            message = (
                f"initial value array of shape {values.shape} does not "
                f"fit the problem's {expected} grid"
            )
            raise ValueError(message)

        self._problem = cp
        self._on_vertices = vertex_oriented
        self._method = interpolation_method
        values = values.copy()
        if vertex_oriented:
            values = _constrain_vertex_values(cp, values)
        self._values = values

    def y_0(self, x: Optional[np.ndarray]) -> np.ndarray:
        if not self._problem.differential_equation.x_dimension:
            return self._values.copy()

        from pararealml_tpu_torch.interpolation import grid_interpolate

        return grid_interpolate(
            torch.as_tensor(self._values),
            self._problem.mesh.axis_coordinates(self._on_vertices),
            torch.as_tensor(np.asarray(x)),
            method=self._method,
        ).numpy()

    def discrete_y_0(
        self, vertex_oriented: Optional[bool] = None,
    ) -> np.ndarray:
        if vertex_oriented is None:
            vertex_oriented = self._on_vertices
        same_grid = (
            vertex_oriented == self._on_vertices
            or not self._problem.differential_equation.x_dimension
        )
        if same_grid:
            return self._values.copy()

        resampled = self.y_0(
            self._problem.mesh.all_index_coordinates(vertex_oriented)
        )
        if vertex_oriented:
            resampled = _constrain_vertex_values(self._problem, resampled)
        return resampled


class ConstantInitialCondition(DiscreteInitialCondition):
    """An initial condition constant in space per y component."""

    def __init__(
        self, cp: ConstrainedProblem, constant_y_0s: Sequence[float]
    ):
        n_components = cp.differential_equation.y_dimension
        if len(constant_y_0s) != n_components:
            message = (
                f"one constant is needed per y component "
                f"({n_components}), got {len(constant_y_0s)}"
            )
            raise ValueError(message)
        values = np.broadcast_to(
            np.array(constant_y_0s, dtype=float), cp.y_shape(True)
        ).copy()
        super().__init__(cp, values, True)


class ContinuousInitialCondition(InitialCondition):
    """An initial condition defined by a vectorized function of x."""

    def __init__(
        self, cp: ConstrainedProblem,
        y_0_func: VectorizedInitialConditionFunction,
        multipliers: Optional[Sequence[float]] = None,
    ):
        n_components = cp.differential_equation.y_dimension
        if multipliers is None:
            self._multipliers = np.ones(n_components)
        else:
            if len(multipliers) != n_components:
                message = (
                    f"one multiplier is needed per y component "
                    f"({n_components}), got {len(multipliers)}"
                )
                raise ValueError(message)
            self._multipliers = np.array(multipliers, dtype=float)

        self._problem = cp
        self._function = y_0_func
        self._vertex_values = self._discretize(True)
        self._cell_values = self._discretize(False)

    def y_0(self, x: Optional[np.ndarray]) -> np.ndarray:
        return np.multiply(self._function(x), self._multipliers)

    def discrete_y_0(
        self, vertex_oriented: Optional[bool] = None,
    ) -> np.ndarray:
        if vertex_oriented:
            return self._vertex_values.copy()
        return self._cell_values.copy()

    def _discretize(self, vertex_oriented: bool) -> np.ndarray:
        problem = self._problem
        equation = problem.differential_equation
        if not equation.x_dimension:
            values = np.asarray(self.y_0(None), dtype=float)
            if values.shape != problem.y_shape():
                message = (
                    f"the initial condition function returned shape "
                    f"{values.shape} instead of {problem.y_shape()}"
                )
                raise ValueError(message)
            return values

        points = problem.mesh.all_index_coordinates(
            vertex_oriented, flatten=True
        )
        values = np.asarray(self.y_0(points), dtype=float)
        flat_shape = (len(points), equation.y_dimension)
        if values.shape != flat_shape:
            message = (
                f"the initial condition function returned shape "
                f"{values.shape} instead of {flat_shape}"
            )
            raise ValueError(message)
        values = values.reshape(problem.y_shape(vertex_oriented))
        if vertex_oriented:
            values = _constrain_vertex_values(problem, values)
        return values

    def _to_cartesian(self, x: np.ndarray) -> np.ndarray:
        cartesian = to_cartesian_coordinates(
            [column for column in x.T],
            self._problem.mesh.coordinate_system_type,
        )
        return np.stack(cartesian, axis=-1)


class GaussianInitialCondition(ContinuousInitialCondition):
    """An initial condition given by multivariate Gaussian PDFs, one per y
    component, evaluated in Cartesian coordinates."""

    def __init__(
        self, cp: ConstrainedProblem,
        means_and_covs: Sequence[Tuple[np.ndarray, np.ndarray]],
        multipliers: Optional[Sequence[float]] = None,
    ):
        equation = cp.differential_equation
        x_dim = equation.x_dimension
        if not x_dim:
            message = (
                "Gaussian initial conditions are only defined for PDEs"
            )
            raise ValueError(message)
        if len(means_and_covs) != equation.y_dimension:
            message = (
                f"one (mean, covariance) pair is needed per y component "
                f"({equation.y_dimension}), got {len(means_and_covs)}"
            )
            raise ValueError(message)
        for mean, cov in means_and_covs:
            if mean.shape != (x_dim,):
                message = (
                    f"mean of shape {mean.shape} does not fit the "
                    f"{x_dim}-dimensional domain"
                )
                raise ValueError(message)
            if cov.shape != (x_dim, x_dim):
                message = (
                    f"covariance of shape {cov.shape} does not fit the "
                    f"{x_dim}-dimensional domain"
                )
                raise ValueError(message)

        self._means_and_covs = deepcopy(means_and_covs)
        super().__init__(cp, self._gaussian_y_0, multipliers)

    def _gaussian_y_0(self, x: np.ndarray) -> np.ndarray:
        cartesian_x = self._to_cartesian(x)
        columns = [
            multivariate_normal.pdf(cartesian_x, mean=mean, cov=cov)
            for mean, cov in self._means_and_covs
        ]
        return np.stack(columns, axis=-1)


class MarginalBetaProductInitialCondition(ContinuousInitialCondition):
    """An initial condition given per y component by the product of
    per-axis Beta PDFs evaluated in Cartesian coordinates."""

    def __init__(
        self, cp: ConstrainedProblem,
        all_alphas_and_betas: Sequence[Sequence[Tuple[float, float]]],
        multipliers: Optional[Sequence[float]] = None,
    ):
        equation = cp.differential_equation
        if len(all_alphas_and_betas) != equation.y_dimension:
            message = (
                f"one (alpha, beta) parameter sequence is needed per y "
                f"component ({equation.y_dimension}), got "
                f"{len(all_alphas_and_betas)}"
            )
            raise ValueError(message)
        if any(
            len(params) != equation.x_dimension
            for params in all_alphas_and_betas
        ):
            message = (
                f"each (alpha, beta) parameter sequence needs one entry "
                f"per spatial axis ({equation.x_dimension})"
            )
            raise ValueError(message)

        self._all_alphas_and_betas = deepcopy(all_alphas_and_betas)
        super().__init__(cp, self._beta_y_0, multipliers)

    def _beta_y_0(self, x: np.ndarray) -> np.ndarray:
        cartesian_x = self._to_cartesian(x)
        columns = []
        for params in self._all_alphas_and_betas:
            pdfs = [
                beta_dist.pdf(cartesian_x[:, i], a, b)
                for i, (a, b) in enumerate(params)
            ]
            columns.append(np.prod(pdfs, axis=0))
        return np.stack(columns, axis=-1)


def vectorize_ic_function(
    ic_function: Callable[[Optional[Sequence[float]]], Sequence[float]]
) -> VectorizedInitialConditionFunction:
    """Lifts a single-point initial condition function to operate on an
    array of points."""

    def vectorized(x: Optional[np.ndarray]) -> np.ndarray:
        if x is None:
            return np.array(ic_function(None))
        return np.array([ic_function(point) for point in x])

    return vectorized
