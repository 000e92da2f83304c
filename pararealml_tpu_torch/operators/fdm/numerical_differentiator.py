"""Finite-difference spatial differentiation on tensors.

Port of the JAX package's ``operators/fdm/numerical_differentiator.py``
(capability match for PararealML's operators/fdm/
numerical_differentiator.py:14-1242) for Cartesian meshes: three-point
central differences with constraint-aware boundary handling and the
Cartesian vector calculus (gradient, Hessian, divergence, curl, scalar
and vector Laplacian).

Every operation is a pure function of dense tensors. The spatial axes
are addressed from the end of the state (``(..., *grid, y_dimension)``),
so any leading batch axes — Parareal's time slices, the affine
propagator's basis probe — ride through unchanged. Halos come from
concatenation, and Neumann ghost vertices are synthesized with masked
selects from dense :class:`~pararealml_tpu_torch.constraint.Constraint`
tensors.

Not ported yet (ROADMAP.md, Queue 1, slice 6): the curvilinear (polar,
cylindrical, spherical) metric terms, the five-point method and the
Jacobi and BiCGStab anti-Laplacians.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pararealml_tpu_torch.constrained_problem import BoundaryConstraintPair
from pararealml_tpu_torch.constraint import Constraint
from pararealml_tpu_torch.mesh import CoordinateSystem, Mesh

# Per-axis sequence of optional lower/upper constraint pairs on the
# derivative of y normal to the boundaries of that axis.
DerivativeBoundaryConstraints = Sequence[Optional[BoundaryConstraintPair]]

_NOT_PORTED_SLICE = "ROADMAP.md, Queue 1, slice 6"


def _dim(x_axis: int, x_dimension: int) -> int:
    """The tensor dimension of spatial axis ``x_axis``, counted from the
    end of a ``(..., *grid, y_dimension)`` state."""
    return x_axis - x_dimension - 1


def _face(y: torch.Tensor, dim: int, side: int) -> torch.Tensor:
    """The one-thick boundary slab of ``y`` along ``dim`` (side 0 =
    lower, 1 = upper)."""
    return y.narrow(dim, 0 if side == 0 else y.shape[dim] - 1, 1)


def _inner_adjacent(y: torch.Tensor, dim: int, side: int) -> torch.Tensor:
    """The slab one vertex inward from the boundary along ``dim``."""
    return y.narrow(dim, 1 if side == 0 else y.shape[dim] - 2, 1)


def _set_face(
    y: torch.Tensor, dim: int, side: int, new_face: torch.Tensor
) -> torch.Tensor:
    """Returns ``y`` with its boundary slab along ``dim`` replaced."""
    rest = y.narrow(dim, 1 if side == 0 else 0, y.shape[dim] - 1)
    parts = [new_face, rest] if side == 0 else [rest, new_face]
    return torch.cat(parts, dim=dim)


def _shifted(
    y_ext: torch.Tensor, dim: int, offset: int, length: int
) -> torch.Tensor:
    """A length-``length`` window of the halo-extended tensor starting at
    ``offset`` along ``dim``."""
    return y_ext.narrow(dim, offset, length)


def slice_constraint(
    constraint: Optional[Constraint], component_slice
) -> Optional[Constraint]:
    """Slices a constraint's trailing (y component) axis."""
    if constraint is None:
        return None
    return Constraint(
        constraint.values[..., component_slice],
        constraint.mask[..., component_slice],
    )


def slice_constraint_pair(
    pair: Optional[BoundaryConstraintPair], component_slice
) -> Optional[BoundaryConstraintPair]:
    """Slices both sides of a boundary constraint pair along the y
    component axis."""
    if pair is None:
        return None
    return BoundaryConstraintPair(
        slice_constraint(pair.lower, component_slice),
        slice_constraint(pair.upper, component_slice),
    )


def slice_all_constraint_pairs(
    pairs: Optional[DerivativeBoundaryConstraints], component_slice
) -> Optional[Tuple[Optional[BoundaryConstraintPair], ...]]:
    """Slices every per-axis pair along the y component axis."""
    if pairs is None:
        return None
    return tuple(
        slice_constraint_pair(p, component_slice) for p in pairs
    )


def _require_cartesian(mesh: Mesh):
    if mesh.coordinate_system_type != CoordinateSystem.CARTESIAN:
        raise NotImplementedError(
            "curvilinear differential operators "
            f"({mesh.coordinate_system_type.name.lower()} meshes) are not "
            f"ported to PyTorch yet ({_NOT_PORTED_SLICE})"
        )


class NumericalDifferentiator:
    """Base class holding the vector calculus, expressed through the two
    stencil primitives ``_derivative`` and ``_second_derivative`` that
    subclasses implement."""

    def __init__(
        self,
        tol: float = 1e-3,
        max_iterations: int = 100_000,
        anti_laplacian_method: str = "jacobi",
    ):
        """
        :param tol: anti-Laplacian stopping tolerance (kept for
            signature parity; the anti-Laplacian is not ported yet)
        :param max_iterations: anti-Laplacian iteration cap (likewise)
        :param anti_laplacian_method: ``"jacobi"`` or ``"bicgstab"``
            (likewise)
        """
        if tol < 0.0:
            raise ValueError("tolerance must be non-negative")
        if anti_laplacian_method not in ("jacobi", "bicgstab"):
            raise ValueError(
                "anti-Laplacian method must be 'jacobi' or 'bicgstab' "
                f"but got {anti_laplacian_method!r}"
            )
        self._tol = tol
        self._max_iterations = max_iterations
        self._anti_laplacian_method = anti_laplacian_method

    @property
    def anti_laplacian_method(self) -> str:
        """The configured anti-Laplacian solver scheme."""
        return self._anti_laplacian_method

    # -- primitives implemented by subclasses ------------------------------

    def _derivative(
        self,
        y: torch.Tensor,
        d_x: float,
        dim: int,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> torch.Tensor:
        """The first derivative of y along tensor dimension ``dim`` at
        every vertex, with optional constraint overrides at the two
        boundaries."""
        raise NotImplementedError

    def _second_derivative(
        self,
        y: torch.Tensor,
        d_x1: float,
        d_x2: float,
        dim1: int,
        dim2: int,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> torch.Tensor:
        """The second derivative of y along the two dimensions, using the
        first dimension's derivative boundary constraints to synthesize
        halos."""
        raise NotImplementedError

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _normalize_constraints(
        constraints: Optional[DerivativeBoundaryConstraints],
        x_dimension: int,
    ) -> Tuple[Optional[BoundaryConstraintPair], ...]:
        if constraints is None:
            return (None,) * x_dimension
        if len(constraints) != x_dimension:
            raise ValueError(
                "expected derivative boundary constraints for "
                f"{x_dimension} axes but got {len(constraints)}"
            )
        return tuple(constraints)

    @staticmethod
    def _check_shape(y: torch.Tensor, mesh: Mesh, name: str = "y"):
        grid_shape = tuple(y.shape[-(mesh.dimensions + 1): -1])
        if y.ndim < mesh.dimensions + 1 or grid_shape != tuple(
            mesh.vertices_shape
        ):
            raise ValueError(
                f"{name} shape up to second to last axis {grid_shape} "
                f"must match mesh vertices shape {mesh.vertices_shape}"
            )

    @staticmethod
    def _check_vector_field(y: torch.Tensor, mesh: Mesh):
        NumericalDifferentiator._check_shape(y, mesh)
        if y.shape[-1] != mesh.dimensions:
            raise ValueError(
                f"y value vector length ({y.shape[-1]}) must match number "
                f"of x dimensions ({mesh.dimensions})"
            )

    @staticmethod
    def _grid(mesh: Mesh, axis: int, like: torch.Tensor) -> torch.Tensor:
        """The vertex coordinate grid of ``axis`` with a trailing
        component axis, in the dtype and on the device of ``like``."""
        return mesh.device_coordinate_grids(
            True, like.dtype, like.device
        )[axis][..., None]

    # -- public vector calculus --------------------------------------------

    def gradient(
        self,
        y: torch.Tensor,
        mesh: Mesh,
        x_axis: int,
        derivative_boundary_constraints=None,
    ) -> torch.Tensor:
        """One column of the Jacobian of y."""
        self._check_shape(y, mesh)
        if not 0 <= x_axis < mesh.dimensions:
            raise ValueError(
                f"x-axis ({x_axis}) must be non-negative and less than "
                f"number of x dimensions ({mesh.dimensions})"
            )
        _require_cartesian(mesh)
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )
        return self._derivative(
            y,
            mesh.d_x[x_axis],
            _dim(x_axis, mesh.dimensions),
            bcs[x_axis],
        )

    def hessian(
        self,
        y: torch.Tensor,
        mesh: Mesh,
        x_axis1: int,
        x_axis2: int,
        derivative_boundary_constraints=None,
    ) -> torch.Tensor:
        """One component of the Hessian of y."""
        self._check_shape(y, mesh)
        if not (
            0 <= x_axis1 < mesh.dimensions
            and 0 <= x_axis2 < mesh.dimensions
        ):
            raise ValueError(
                f"both first x-axis ({x_axis1}) and second x-axis "
                f"({x_axis2}) must be non-negative and less than number "
                f"of x dimensions ({mesh.dimensions})"
            )
        _require_cartesian(mesh)
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )
        return self._second_derivative(
            y,
            mesh.d_x[x_axis1],
            mesh.d_x[x_axis2],
            _dim(x_axis1, mesh.dimensions),
            _dim(x_axis2, mesh.dimensions),
            bcs[x_axis1],
        )

    def divergence(
        self,
        y: torch.Tensor,
        mesh: Mesh,
        derivative_boundary_constraints=None,
    ) -> torch.Tensor:
        """The divergence of the vector field y."""
        self._check_vector_field(y, mesh)
        _require_cartesian(mesh)
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )
        return sum(
            self._component_derivative(y, mesh, bcs, i, i)
            for i in range(mesh.dimensions)
        )

    def curl(
        self,
        y: torch.Tensor,
        mesh: Mesh,
        curl_ind: int = 0,
        derivative_boundary_constraints=None,
    ) -> torch.Tensor:
        """The ``curl_ind``-th component of the curl of the vector field
        y (scalar in 2D)."""
        self._check_vector_field(y, mesh)
        if not 2 <= mesh.dimensions <= 3:
            raise ValueError(
                f"number of x dimensions ({mesh.dimensions}) must be 2 "
                "or 3"
            )
        if mesh.dimensions == 2 and curl_ind != 0:
            raise ValueError(
                f"curl index ({curl_ind}) must be 0 for 2D curl"
            )
        if not 0 <= curl_ind < mesh.dimensions:
            raise ValueError(
                f"curl index ({curl_ind}) must be non-negative and less "
                f"than number of x dimensions ({mesh.dimensions})"
            )
        _require_cartesian(mesh)
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )

        def d(comp: int, axis: int) -> torch.Tensor:
            return self._component_derivative(y, mesh, bcs, comp, axis)

        if mesh.dimensions == 2 or curl_ind == 2:
            return d(1, 0) - d(0, 1)
        if curl_ind == 0:
            return d(2, 1) - d(1, 2)
        return d(0, 2) - d(2, 0)

    def laplacian(
        self,
        y: torch.Tensor,
        mesh: Mesh,
        derivative_boundary_constraints=None,
    ) -> torch.Tensor:
        """The element-wise scalar Laplacian of y."""
        self._check_shape(y, mesh)
        _require_cartesian(mesh)
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )
        return sum(
            self._second_derivative(
                y,
                mesh.d_x[axis],
                mesh.d_x[axis],
                _dim(axis, mesh.dimensions),
                _dim(axis, mesh.dimensions),
                bcs[axis],
            )
            for axis in range(mesh.dimensions)
        )

    def vector_laplacian(
        self,
        y: torch.Tensor,
        mesh: Mesh,
        vector_laplacian_ind: int,
        derivative_boundary_constraints=None,
    ) -> torch.Tensor:
        """One component of the vector Laplacian of the vector field y
        (the component's scalar Laplacian on Cartesian meshes)."""
        self._check_vector_field(y, mesh)
        if not 0 <= vector_laplacian_ind < mesh.dimensions:
            raise ValueError(
                f"vector Laplacian index ({vector_laplacian_ind}) must "
                "be non-negative and less than number of x dimensions "
                f"({mesh.dimensions})"
            )
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )
        component_slice = slice(
            vector_laplacian_ind, vector_laplacian_ind + 1
        )
        return self.laplacian(
            y[..., component_slice],
            mesh,
            slice_all_constraint_pairs(bcs, component_slice),
        )

    def anti_laplacian(self, laplacian, mesh, y_constraints, *args, **kw):
        """Inverts the scalar Laplacian (not ported yet)."""
        raise NotImplementedError(
            "the anti-Laplacian (Jacobi and BiCGStab) is not ported to "
            f"PyTorch yet ({_NOT_PORTED_SLICE})"
        )

    def _component_derivative(self, y, mesh, bcs, comp: int, axis: int):
        return self._derivative(
            y[..., comp: comp + 1],
            mesh.d_x[axis],
            _dim(axis, mesh.dimensions),
            slice_constraint_pair(bcs[axis], slice(comp, comp + 1)),
        )


class ThreePointCentralDifferenceMethod(NumericalDifferentiator):
    """Second-order three-point central differences.

    Interior vertices use the standard central stencil; boundary
    vertices use zero halos (first derivative) or Neumann-synthesized
    ghost vertices (second derivative), with optional constraint
    overrides on the boundary derivative values — the reference's
    discretization (numerical_differentiator.py:999-1242), expressed as
    pure selects.
    """

    def _derivative(
        self,
        y: torch.Tensor,
        d_x: float,
        dim: int,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> torch.Tensor:
        n = y.shape[dim]
        if n <= 2:
            raise ValueError(
                f"y must contain at least 3 points along dimension {dim}"
            )

        halo = torch.zeros_like(_face(y, dim, 0))
        y_ext = torch.cat([halo, y, halo], dim=dim)

        derivative = (
            _shifted(y_ext, dim, 2, n) - _shifted(y_ext, dim, 0, n)
        ) / (2.0 * d_x)

        if constraint_pair is not None:
            for side, constraint in enumerate(constraint_pair):
                if constraint is None:
                    continue
                face = _face(derivative, dim, side)
                derivative = _set_face(
                    derivative, dim, side, constraint.apply(face)
                )
        return derivative

    def _second_derivative(
        self,
        y: torch.Tensor,
        d_x1: float,
        d_x2: float,
        dim1: int,
        dim2: int,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> torch.Tensor:
        if dim1 != dim2:
            first = self._derivative(y, d_x1, dim1, constraint_pair)
            return self._derivative(first, d_x2, dim2, None)

        n = y.shape[dim1]
        if n <= 2:
            raise ValueError(
                f"y must contain at least 3 points along dimension {dim1}"
            )
        y_ext = self._extend_with_halos(y, dim1, d_x1, constraint_pair)
        y_prev = _shifted(y_ext, dim1, 0, n)
        y_curr = _shifted(y_ext, dim1, 1, n)
        y_next = _shifted(y_ext, dim1, 2, n)
        return (y_next - 2.0 * y_curr + y_prev) / (d_x1 * d_x2)

    @staticmethod
    def _extend_with_halos(
        y: torch.Tensor,
        dim: int,
        d_x: float,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> torch.Tensor:
        """Appends ghost vertices along ``dim``.

        Where a derivative boundary constraint exists, the ghost value is
        the one-inward vertex value offset by ``±2·d_x`` times the
        constrained normal derivative (so the central difference at the
        boundary reproduces the Neumann condition); elsewhere it is zero.
        """
        lower_adjacent = _inner_adjacent(y, dim, 0)
        upper_adjacent = _inner_adjacent(y, dim, 1)
        lower_halo = torch.zeros_like(lower_adjacent)
        upper_halo = torch.zeros_like(upper_adjacent)

        if constraint_pair is not None:
            if constraint_pair.lower is not None:
                lower_halo = constraint_pair.lower.multiply_and_add(
                    lower_adjacent, -2.0 * d_x, lower_halo
                )
            if constraint_pair.upper is not None:
                upper_halo = constraint_pair.upper.multiply_and_add(
                    upper_adjacent, 2.0 * d_x, upper_halo
                )

        return torch.cat([lower_halo, y, upper_halo], dim=dim)


class FivePointCentralDifferenceMethod(NumericalDifferentiator):
    """Fourth-order five-point central differences (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the five-point central difference method is not ported to "
            f"PyTorch yet ({_NOT_PORTED_SLICE})"
        )
