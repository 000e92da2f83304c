"""Boundary conditions.

Capability match for PararealML's boundary_condition.py:11-287.
Boundary condition functions are host-side (NumPy) callables evaluated on
boundary coordinate arrays; they return NaN for components they leave
unconstrained. The solvers never call these in their step loops — the
:class:`~pararealml_tpu_torch.constrained_problem.ConstrainedProblem`
evaluates them up front and converts the results into dense constraint
tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

VectorizedBoundaryConditionFunction = Callable[
    [np.ndarray, Optional[float]], np.ndarray
]


class BoundaryCondition:
    """Base class for conditions imposed on one boundary of the domain."""

    def __init__(
        self, has_y_condition: bool, has_d_y_condition: bool, is_static: bool
    ):
        self._has_y_condition = has_y_condition
        self._has_d_y_condition = has_d_y_condition
        self._is_static = is_static

    @property
    def has_y_condition(self) -> bool:
        """Whether the condition restricts the value of y."""
        return self._has_y_condition

    @property
    def has_d_y_condition(self) -> bool:
        """Whether the condition restricts the normal derivative of y."""
        return self._has_d_y_condition

    @property
    def is_static(self) -> bool:
        """Whether the condition is time independent."""
        return self._is_static

    def y_condition(self, x: np.ndarray, t: Optional[float]) -> np.ndarray:
        """The constrained values of y at the boundary points ``x``
        (NaN where unconstrained), shape ``(n, y_dimension)``."""
        raise RuntimeError("this condition does not constrain y")

    def d_y_condition(self, x: np.ndarray, t: Optional[float]) -> np.ndarray:
        """The constrained values of the normal derivative of y at the
        boundary points ``x`` (NaN where unconstrained)."""
        raise RuntimeError(
            "this condition does not constrain the normal derivative of y"
        )


class DirichletBoundaryCondition(BoundaryCondition):
    """A condition on the value of y along the boundary."""

    def __init__(
        self,
        y_condition: VectorizedBoundaryConditionFunction,
        is_static: bool = False,
    ):
        super().__init__(True, False, is_static)
        self._y_condition_fn = y_condition

    def y_condition(self, x: np.ndarray, t: Optional[float]) -> np.ndarray:
        return self._y_condition_fn(x, t)


class NeumannBoundaryCondition(BoundaryCondition):
    """A condition on the boundary-normal derivative of y."""

    def __init__(
        self,
        d_y_condition: VectorizedBoundaryConditionFunction,
        is_static: bool = False,
    ):
        super().__init__(False, True, is_static)
        self._d_y_condition_fn = d_y_condition

    def d_y_condition(self, x: np.ndarray, t: Optional[float]) -> np.ndarray:
        return self._d_y_condition_fn(x, t)


class CauchyBoundaryCondition(BoundaryCondition):
    """Simultaneous Dirichlet and Neumann conditions."""

    def __init__(
        self,
        y_condition: VectorizedBoundaryConditionFunction,
        d_y_condition: VectorizedBoundaryConditionFunction,
        is_static: bool = False,
    ):
        super().__init__(True, True, is_static)
        self._y_condition_fn = y_condition
        self._d_y_condition_fn = d_y_condition

    def y_condition(self, x: np.ndarray, t: Optional[float]) -> np.ndarray:
        return self._y_condition_fn(x, t)

    def d_y_condition(self, x: np.ndarray, t: Optional[float]) -> np.ndarray:
        return self._d_y_condition_fn(x, t)


class ConstantBoundaryCondition(BoundaryCondition):
    """Space- and time-independent constant conditions per y component
    (``None`` entries leave the component unconstrained)."""

    def __init__(
        self,
        constant_y_conditions: Optional[Sequence[Optional[float]]],
        constant_d_y_conditions: Optional[Sequence[Optional[float]]],
    ):
        if constant_y_conditions is None and constant_d_y_conditions is None:
            raise ValueError(
                "at least one type of constant conditions must not be None"
            )
        super().__init__(
            constant_y_conditions is not None,
            constant_d_y_conditions is not None,
            True,
        )
        self._constant_y_conditions = constant_y_conditions
        self._constant_d_y_conditions = constant_d_y_conditions

    @staticmethod
    def _tile(conditions, n: int) -> np.ndarray:
        row = np.array(
            [np.nan if c is None else c for c in conditions], dtype=float
        )
        return np.tile(row, (n, 1))

    def y_condition(self, x: np.ndarray, t: Optional[float]) -> np.ndarray:
        if not self._constant_y_conditions:
            raise RuntimeError("no boundary conditions defined on y")
        return self._tile(self._constant_y_conditions, len(x))

    def d_y_condition(self, x: np.ndarray, t: Optional[float]) -> np.ndarray:
        if not self._constant_d_y_conditions:
            raise RuntimeError(
                "no boundary conditions defined on the normal derivative "
                "of y"
            )
        return self._tile(self._constant_d_y_conditions, len(x))


class ConstantValueBoundaryCondition(ConstantBoundaryCondition):
    """Constant Dirichlet conditions per y component."""

    def __init__(self, constant_y_conditions: Sequence[Optional[float]]):
        super().__init__(constant_y_conditions, None)


class ConstantFluxBoundaryCondition(ConstantBoundaryCondition):
    """Constant Neumann conditions per y component."""

    def __init__(self, constant_d_y_conditions: Sequence[Optional[float]]):
        super().__init__(None, constant_d_y_conditions)


def vectorize_bc_function(
    bc_function: Callable[
        [Sequence[float], Optional[float]], Sequence[Optional[float]]
    ]
) -> VectorizedBoundaryConditionFunction:
    """Lifts a single-point boundary condition function to operate on an
    array of points (``None`` return entries become NaN)."""

    def vectorized(x: np.ndarray, t: Optional[float]) -> np.ndarray:
        rows = [
            [np.nan if v is None else v for v in bc_function(point, t)]
            for point in x
        ]
        return np.array(rows, dtype=float)

    return vectorized
