"""The solver-operator interface.

Port of the JAX package's ``operator.py``: the :class:`Operator` base
class, ``discretize_time_domain``, and :class:`TorchOperator`, the
counterpart of the JAX package's ``JaxOperator`` contract. Operators that
expose their solve as a function from the initial state to the full
trajectory (and, optionally, to the end state only) let the Parareal
operator compose fine and coarse solvers with slices batched along a
leading tensor axis.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.initial_value_problem import (
    InitialValueProblem,
    TemporalDomainInterval,
)
from pararealml_tpu_torch.solution import Solution


class Operator:
    """Base class for solvers of initial value problems over a time
    interval with a fixed output step size.

    ``dtype`` and ``device`` select where :meth:`solve` places the
    initial state (``None`` means torch's defaults); functions that take
    a state tensor follow the state's device.
    """

    def __init__(
        self,
        d_t: float,
        vertex_oriented: Optional[bool],
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        if d_t <= 0.0:
            raise ValueError("time step size must be greater than 0")
        self._d_t = d_t
        self._vertex_oriented = vertex_oriented
        self._device = device
        self._dtype = dtype

    @property
    def d_t(self) -> float:
        """The temporal step size of the operator."""
        return self._d_t

    @property
    def vertex_oriented(self) -> Optional[bool]:
        """Whether solutions are evaluated at mesh vertices or cell
        centers (None for pure ODE solvers)."""
        return self._vertex_oriented

    @property
    def device(self) -> torch.device:
        """The device :meth:`solve` places the initial state on."""
        if self._device is None:
            return torch.get_default_device()
        return torch.device(self._device)

    @property
    def dtype(self) -> torch.dtype:
        """The floating-point type of the solver state."""
        if self._dtype is None:
            return torch.get_default_dtype()
        return self._dtype

    def solve(
        self, ivp: InitialValueProblem, parallel_enabled: bool = True
    ) -> Solution:
        """Solves the IVP and returns its :class:`Solution`."""
        raise NotImplementedError


class TorchOperator(Operator):
    """An operator whose solve is expressible as a function from the
    initial state to the full trajectory.

    This is the contract that lets the Parareal operator compose fine and
    coarse solvers over a batch of time slices.
    """

    def trajectory_function(
        self,
        cp,
        t_interval: TemporalDomainInterval,
        allow_fused: bool = True,
        time_parallel: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> Tuple[Callable[..., torch.Tensor], np.ndarray]:
        """Returns ``(fn, t_coordinates)`` where ``fn(y_0, t_0)`` maps
        the initial state (``y_shape``, optionally with leading batch
        axes) and the interval start time to the trajectory of shape
        ``batch + (len(t_coordinates),) + y_shape``.

        ``t_coordinates`` are the output times relative to
        ``t_interval[0]`` (excluding the initial time).

        The function carries tags callers dispatch on: ``vmappable``
        (any leading batch axes are mapped elementwise on the generic
        path), ``fused`` (a hand-written kernel runs it),
        ``end_function`` and ``affine_slice_map`` (affine propagators).

        :param allow_fused: whether hand-written kernels may be used
        :param time_parallel: whether the caller is a parallel-in-time
            composition (Parareal), in which case the operator may use
            trajectory formulations that are parallel across time steps
            (affine propagator matmuls,
            :mod:`pararealml_tpu_torch.ops.linear_propagator`)
        :param dtype: the state's floating-point type (defaults to the
            operator's); it selects between the generic path and the
            float32 kernels
        :param device: where constant tensors the function holds (such
            as propagator matrices) are built (defaults to the
            operator's); a state on another device wins, and the
            constants follow it
        """
        raise NotImplementedError


def discretize_time_domain(
    t: TemporalDomainInterval, d_t: float
) -> np.ndarray:
    """Discretizes a time interval into whole steps of size ``d_t``
    (rounding the step count), returning ``steps + 1`` points."""
    t_0 = float(t[0])
    steps = int(round((t[1] - t_0) / d_t))
    return np.linspace(t_0, t_0 + steps * d_t, steps + 1)
