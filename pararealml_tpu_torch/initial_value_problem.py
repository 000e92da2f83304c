"""Initial value problems.

Capability match for PararealML's initial_value_problem.py.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.initial_condition import InitialCondition

TemporalDomainInterval = Tuple[float, float]


class InitialValueProblem:
    """A constrained problem over a time interval with an initial
    condition and an optional exact solution."""

    def __init__(
        self,
        cp: ConstrainedProblem,
        t_interval: TemporalDomainInterval,
        initial_condition: InitialCondition,
        exact_y: Optional[
            Callable[
                ["InitialValueProblem", float, Optional[np.ndarray]],
                np.ndarray,
            ]
        ] = None,
    ):
        if t_interval[0] > t_interval[1]:
            raise ValueError(
                f"lower bound of time interval ({t_interval[0]}) cannot be "
                f"greater than its upper bound ({t_interval[1]})"
            )

        self._cp = cp
        self._t_interval = (float(t_interval[0]), float(t_interval[1]))
        self._initial_condition = initial_condition
        self._exact_y = exact_y

    @property
    def constrained_problem(self) -> ConstrainedProblem:
        """The constrained problem the IVP is based on."""
        return self._cp

    @property
    def t_interval(self) -> TemporalDomainInterval:
        """The bounds of the temporal domain."""
        return self._t_interval

    @property
    def initial_condition(self) -> InitialCondition:
        """The initial condition."""
        return self._initial_condition

    @property
    def has_exact_solution(self) -> bool:
        """Whether an analytic solution is available."""
        return self._exact_y is not None

    def exact_y(
        self, t: float, x: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """The exact value of y(t, x) if an analytic solution was
        provided."""
        if not self.has_exact_solution:
            raise RuntimeError(
                "exact solution of initial value problem undefined"
            )
        return self._exact_y(self, t, x)
