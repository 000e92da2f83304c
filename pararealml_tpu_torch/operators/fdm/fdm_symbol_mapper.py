"""FDM symbol mapping to stencil operations on tensors.

Capability match for PararealML's operators/fdm/
fdm_symbol_mapper.py:13-158, ported from the JAX package's version. The
map argument carries the time, the state grid (optionally with leading
batch axes), and the *already selected* per-axis derivative boundary
constraint tensors for the current integration stage; every map function
slices the state and the constraints down to the referenced y components
and calls the differentiator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pararealml_tpu_torch.constrained_problem import (
    BoundaryConstraintPair,
    ConstrainedProblem,
)
from pararealml_tpu_torch.differential_equation import LHS
from pararealml_tpu_torch.operators.fdm.numerical_differentiator import (
    NumericalDifferentiator,
    slice_all_constraint_pairs,
)
from pararealml_tpu_torch.operators.symbol_mapper import SymbolMapper


class FDMSymbolMapArg(NamedTuple):
    """The argument to the FDM map functions."""

    t: Union[float, torch.Tensor]
    y: torch.Tensor
    d_y_boundary_constraints: Optional[
        Tuple[Optional[BoundaryConstraintPair], ...]
    ]


class FDMSymbolMapper(SymbolMapper):
    """Maps symbols to stencil operations over the state grid."""

    def __init__(
        self,
        cp: ConstrainedProblem,
        differentiator: NumericalDifferentiator,
    ):
        super().__init__(cp.differential_equation)
        self._differentiator = differentiator
        self._mesh = cp.mesh

    def _component_slice(self, y_indices, indices_contiguous):
        if indices_contiguous:
            return slice(y_indices[0], y_indices[-1] + 1)
        return list(y_indices)

    def t_map_function(self):
        return lambda arg: arg.t

    def y_map_function(self, y_ind: int):
        return lambda arg: arg.y[..., y_ind: y_ind + 1]

    def x_map_function(self, x_axis: int):
        return lambda arg: self._differentiator._grid(
            self._mesh, x_axis, arg.y
        )

    def y_gradient_map_function(self, y_ind: int, x_axis: int):
        component = slice(y_ind, y_ind + 1)
        return lambda arg: self._differentiator.gradient(
            arg.y[..., component],
            self._mesh,
            x_axis,
            slice_all_constraint_pairs(
                arg.d_y_boundary_constraints, component
            ),
        )

    def y_hessian_map_function(
        self, y_ind: int, x_axis1: int, x_axis2: int
    ):
        component = slice(y_ind, y_ind + 1)
        return lambda arg: self._differentiator.hessian(
            arg.y[..., component],
            self._mesh,
            x_axis1,
            x_axis2,
            slice_all_constraint_pairs(
                arg.d_y_boundary_constraints, component
            ),
        )

    def y_divergence_map_function(
        self,
        y_indices: Sequence[int],
        indices_contiguous: Union[bool, np.bool_],
    ):
        components = self._component_slice(y_indices, indices_contiguous)
        return lambda arg: self._differentiator.divergence(
            arg.y[..., components],
            self._mesh,
            slice_all_constraint_pairs(
                arg.d_y_boundary_constraints, components
            ),
        )

    def y_curl_map_function(
        self,
        y_indices: Sequence[int],
        indices_contiguous: Union[bool, np.bool_],
        curl_ind: int,
    ):
        components = self._component_slice(y_indices, indices_contiguous)
        return lambda arg: self._differentiator.curl(
            arg.y[..., components],
            self._mesh,
            curl_ind,
            slice_all_constraint_pairs(
                arg.d_y_boundary_constraints, components
            ),
        )

    def y_laplacian_map_function(self, y_ind: int):
        component = slice(y_ind, y_ind + 1)
        return lambda arg: self._differentiator.laplacian(
            arg.y[..., component],
            self._mesh,
            slice_all_constraint_pairs(
                arg.d_y_boundary_constraints, component
            ),
        )

    def y_vector_laplacian_map_function(
        self,
        y_indices: Sequence[int],
        indices_contiguous: Union[bool, np.bool_],
        vector_laplacian_ind: int,
    ):
        components = self._component_slice(y_indices, indices_contiguous)
        return lambda arg: self._differentiator.vector_laplacian(
            arg.y[..., components],
            self._mesh,
            vector_laplacian_ind,
            slice_all_constraint_pairs(
                arg.d_y_boundary_constraints, components
            ),
        )

    def map_concatenated(
        self, arg: FDMSymbolMapArg, lhs_type: LHS
    ) -> torch.Tensor:
        """Evaluates the (LHS-filtered) right-hand sides and concatenates
        them along the component axis, broadcasting scalars (e.g. pure
        functions of t) to the grid shape."""
        values = self.map(arg, lhs_type)
        target_shape = tuple(arg.y.shape[:-1]) + (1,)
        values = [
            torch.as_tensor(
                v, dtype=arg.y.dtype, device=arg.y.device
            ).expand(target_shape)
            for v in values
        ]
        return torch.cat(values, dim=-1)
