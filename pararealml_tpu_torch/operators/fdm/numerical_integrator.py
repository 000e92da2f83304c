"""Time integration for the FDM operator.

Port of the JAX package's ``operators/fdm/numerical_integrator.py``
(capability match for PararealML's operators/fdm/
numerical_integrator.py:10-270): forward Euler, explicit midpoint and
RK4. Both callbacks are parameterized by the stage offset fraction (0.0,
0.5 or 1.0 of ``d_t``) — ``d_y_over_d_t(offset, y)`` and
``y_constraint_function(offset) -> Optional[Constraint]`` — as in the
JAX package.

Not ported yet (ROADMAP.md, Queue 1, slice 6): the implicit backward
Euler and Crank-Nicolson methods.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pararealml_tpu_torch.constraint import (
    Constraint,
    apply_constraints_along_last_axis,
)

DYOverDTFunction = Callable[[float, torch.Tensor], torch.Tensor]
YConstraintFunction = Callable[[float], Optional[Constraint]]


class NumericalIntegrator:
    """Base class for single-step time integrators."""

    def integral(
        self,
        y: torch.Tensor,
        d_t: float,
        d_y_over_d_t: DYOverDTFunction,
        y_constraint_function: YConstraintFunction,
    ) -> torch.Tensor:
        """Estimates y at the next time point.

        :param y: the current state
        :param d_t: the step size
        :param d_y_over_d_t: ``(offset, y) -> dy/dt`` evaluated at the
            stage time ``t + offset * d_t``
        :param y_constraint_function: ``offset -> Optional[Constraint]``
            returning the solution constraints at the stage time
        :return: the estimate of y at the next time point
        """
        raise NotImplementedError


class ForwardEulerMethod(NumericalIntegrator):
    """The explicit first-order forward Euler method."""

    def integral(self, y, d_t, d_y_over_d_t, y_constraint_function):
        return apply_constraints_along_last_axis(
            y_constraint_function(1.0), y + d_t * d_y_over_d_t(0.0, y)
        )


class ExplicitMidpointMethod(NumericalIntegrator):
    """The explicit second-order midpoint method."""

    def integral(self, y, d_t, d_y_over_d_t, y_constraint_function):
        y_half = apply_constraints_along_last_axis(
            y_constraint_function(0.5),
            y + (d_t / 2.0) * d_y_over_d_t(0.0, y),
        )
        return apply_constraints_along_last_axis(
            y_constraint_function(1.0),
            y + d_t * d_y_over_d_t(0.5, y_half),
        )


class RK4(NumericalIntegrator):
    """The classic explicit fourth-order Runge-Kutta method with
    constraints applied at every stage."""

    def integral(self, y, d_t, d_y_over_d_t, y_constraint_function):
        half_constraint = y_constraint_function(0.5)
        full_constraint = y_constraint_function(1.0)

        k1 = d_t * d_y_over_d_t(0.0, y)
        k2 = d_t * d_y_over_d_t(
            0.5,
            apply_constraints_along_last_axis(half_constraint, y + k1 / 2.0),
        )
        k3 = d_t * d_y_over_d_t(
            0.5,
            apply_constraints_along_last_axis(half_constraint, y + k2 / 2.0),
        )
        k4 = d_t * d_y_over_d_t(
            1.0,
            apply_constraints_along_last_axis(full_constraint, y + k3),
        )
        return apply_constraints_along_last_axis(
            full_constraint,
            y + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0,
        )


class ImplicitMethod(NumericalIntegrator):
    """Base class for implicit methods (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported to PyTorch yet "
            "(ROADMAP.md, Queue 1, slice 6)"
        )


class BackwardEulerMethod(ImplicitMethod):
    """The implicit first-order backward Euler method (not ported
    yet)."""


class CrankNicolsonMethod(ImplicitMethod):
    """The weighted Crank-Nicolson IMEX method (not ported yet)."""
