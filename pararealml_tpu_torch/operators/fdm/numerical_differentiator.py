"""Finite-difference spatial differentiation on tensors.

Port of the JAX package's ``operators/fdm/numerical_differentiator.py``
(capability match for PararealML's operators/fdm/
numerical_differentiator.py:14-1242): three-point central differences
with constraint-aware boundary handling and the vector calculus
(gradient, Hessian, divergence, curl, scalar and vector Laplacian) in
Cartesian, polar, cylindrical and spherical coordinates, with the JAX
package's metric terms term for term and in its evaluation order. The
metric terms divide by the mesh's vertex coordinate grids (the radii
``linspace(r_low, r_high, n)``), not by radii rebuilt from ``d_x``.

Every operation is a pure function of dense tensors. The spatial axes
are addressed from the end of the state (``(..., *grid, y_dimension)``),
so any leading batch axes — Parareal's time slices, the affine
propagator's basis probe — ride through unchanged. Halos come from
concatenation, and Neumann ghost vertices are synthesized with masked
selects from dense :class:`~pararealml_tpu_torch.constraint.Constraint`
tensors.

The anti-Laplacian inverts the scalar Laplacian with the JAX package's
Jacobi sweeps (Cartesian, polar, cylindrical and spherical) or with a
BiCGStab of the port's own that follows the recurrences and the stopping
rule of ``jax.scipy.sparse.linalg.bicgstab``.

Not ported yet (ROADMAP.md, Queue 1, slice 6f): the five-point method.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from pararealml_tpu_torch.constrained_problem import BoundaryConstraintPair
from pararealml_tpu_torch.constraint import Constraint
from pararealml_tpu_torch.mesh import CoordinateSystem, Mesh

# Per-axis sequence of optional lower/upper constraint pairs on the
# derivative of y normal to the boundaries of that axis.
DerivativeBoundaryConstraints = Sequence[Optional[BoundaryConstraintPair]]

# Jacobi sweeps run between two reads of the stopping flag on the host. A
# state whose update norm reached the tolerance is frozen for the rest of
# the chunk, so the result is the JAX package's while loop's; the chunk
# only bounds the sweeps computed and thrown away (at most 7 a solve) and
# the host syncs (one per 8 sweeps).
JACOBI_CHUNK = 8


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
    """Slices a constraint's trailing (y component) axis (memoized on the
    constraint: a step loop slices a static constraint once)."""
    if constraint is None:
        return None
    return constraint.components(component_slice)


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


class NumericalDifferentiator:
    """Base class holding the coordinate-system-aware vector calculus,
    expressed through the two stencil primitives ``_derivative`` and
    ``_second_derivative`` that subclasses implement."""

    def __init__(
        self,
        tol: float = 1e-3,
        max_iterations: int = 100_000,
        anti_laplacian_method: str = "jacobi",
    ):
        """
        :param tol: the anti-Laplacian's stopping tolerance on the 2-norm
            of the Jacobi update (for BiCGStab, of the residual, which is
            the same quantity)
        :param max_iterations: the most Jacobi sweeps (BiCGStab
            iterations) of one anti-Laplacian solve
        :param anti_laplacian_method: ``"jacobi"`` or ``"bicgstab"``
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
        """One column of the Jacobian of y, with the coordinate system's
        metric scaling applied."""
        self._check_shape(y, mesh)
        if not 0 <= x_axis < mesh.dimensions:
            raise ValueError(
                f"x-axis ({x_axis}) must be non-negative and less than "
                f"number of x dimensions ({mesh.dimensions})"
            )
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )
        derivative = self._derivative(
            y,
            mesh.d_x[x_axis],
            _dim(x_axis, mesh.dimensions),
            bcs[x_axis],
        )

        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN or x_axis == 0:
            return derivative
        r = self._grid(mesh, 0, y)
        if cs == CoordinateSystem.SPHERICAL:
            if x_axis == 1:
                return derivative / (r * torch.sin(self._grid(mesh, 2, y)))
            return derivative / r
        # polar / cylindrical
        if x_axis == 1:
            return derivative / r
        return derivative

    def hessian(
        self,
        y: torch.Tensor,
        mesh: Mesh,
        x_axis1: int,
        x_axis2: int,
        derivative_boundary_constraints=None,
    ) -> torch.Tensor:
        """One component of the Hessian of y including all curvilinear
        metric terms."""
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
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )
        d2 = self._second_derivative(
            y,
            mesh.d_x[x_axis1],
            mesh.d_x[x_axis2],
            _dim(x_axis1, mesh.dimensions),
            _dim(x_axis2, mesh.dimensions),
            bcs[x_axis1],
        )
        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN:
            return d2

        def d1(axis: int) -> torch.Tensor:
            return self._derivative(
                y, mesh.d_x[axis], _dim(axis, mesh.dimensions), bcs[axis]
            )

        r = self._grid(mesh, 0, y)
        axes = (x_axis1, x_axis2)

        if cs == CoordinateSystem.SPHERICAL:
            phi = self._grid(mesh, 2, y)
            sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
            if axes == (0, 0):
                return d2
            if axes == (1, 1):
                return (
                    d1(0)
                    + (d2 / sin_phi + cos_phi * d1(2)) / (r * sin_phi)
                ) / r
            if axes == (2, 2):
                return (d2 / r + d1(0)) / r
            if 0 in axes and 1 in axes:
                return (d2 - d1(1) / r) / (r * sin_phi)
            if 0 in axes and 2 in axes:
                return (d2 - d1(2) / r) / r
            # mixed theta-phi
            return (sin_phi * d2 - cos_phi * d1(1)) / (r * sin_phi) ** 2

        # polar / cylindrical
        if 1 not in axes:
            return d2
        if axes == (1, 1):
            return (d2 / r + d1(0)) / r
        if 0 in axes:
            return (d2 - d1(1) / r) / r
        # mixed theta-z (cylindrical)
        return d2 / r

    def divergence(
        self,
        y: torch.Tensor,
        mesh: Mesh,
        derivative_boundary_constraints=None,
    ) -> torch.Tensor:
        """The divergence of the vector field y."""
        self._check_vector_field(y, mesh)
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )

        def d(comp: int, axis: int) -> torch.Tensor:
            return self._component_derivative(y, mesh, bcs, comp, axis)

        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN:
            return sum(d(i, i) for i in range(mesh.dimensions))

        r = self._grid(mesh, 0, y)
        y_r = y[..., :1]
        if cs == CoordinateSystem.SPHERICAL:
            phi = self._grid(mesh, 2, y)
            sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
            y_phi = y[..., 2:]
            return d(0, 0) + (
                d(2, 2) + 2.0 * y_r + (d(1, 1) + cos_phi * y_phi) / sin_phi
            ) / r

        div = d(0, 0) + (y_r + d(1, 1)) / r
        if cs == CoordinateSystem.POLAR:
            return div
        return div + d(2, 2)

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
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )

        def d(comp: int, axis: int) -> torch.Tensor:
            return self._component_derivative(y, mesh, bcs, comp, axis)

        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN:
            if mesh.dimensions == 2 or curl_ind == 2:
                return d(1, 0) - d(0, 1)
            if curl_ind == 0:
                return d(2, 1) - d(1, 2)
            return d(0, 2) - d(2, 0)

        r = self._grid(mesh, 0, y)
        y_theta = y[..., 1:2]
        if cs == CoordinateSystem.SPHERICAL:
            y_phi = y[..., 2:]
            phi = self._grid(mesh, 2, y)
            sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
            if curl_ind == 0:
                return (
                    d(1, 2) + (cos_phi * y_theta - d(2, 1)) / sin_phi
                ) / r
            if curl_ind == 1:
                return d(2, 0) + (y_phi - d(0, 2)) / r
            return -d(1, 0) + (d(0, 1) / sin_phi - y_theta) / r

        # polar / cylindrical
        if cs == CoordinateSystem.POLAR or curl_ind == 2:
            return d(1, 0) + (y_theta - d(0, 1)) / r
        if curl_ind == 0:
            return d(2, 1) / r - d(1, 2)
        return d(0, 2) - d(2, 0)

    def laplacian(
        self,
        y: torch.Tensor,
        mesh: Mesh,
        derivative_boundary_constraints=None,
    ) -> torch.Tensor:
        """The element-wise scalar Laplacian of y."""
        self._check_shape(y, mesh)
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )

        def d1(axis: int) -> torch.Tensor:
            return self._derivative(
                y, mesh.d_x[axis], _dim(axis, mesh.dimensions), bcs[axis]
            )

        def d2(axis: int) -> torch.Tensor:
            dim = _dim(axis, mesh.dimensions)
            return self._second_derivative(
                y, mesh.d_x[axis], mesh.d_x[axis], dim, dim, bcs[axis]
            )

        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN:
            return sum(d2(axis) for axis in range(mesh.dimensions))

        r = self._grid(mesh, 0, y)
        if cs == CoordinateSystem.SPHERICAL:
            phi = self._grid(mesh, 2, y)
            sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
            return (
                d2(0)
                + (
                    2.0 * d1(0)
                    + (
                        d2(2)
                        + (cos_phi * d1(2) + d2(1) / sin_phi) / sin_phi
                    )
                    / r
                )
                / r
            )

        laplacian = d2(0) + (d2(1) / r + d1(0)) / r
        if cs == CoordinateSystem.POLAR:
            return laplacian
        return laplacian + d2(2)

    def vector_laplacian(
        self,
        y: torch.Tensor,
        mesh: Mesh,
        vector_laplacian_ind: int,
        derivative_boundary_constraints=None,
    ) -> torch.Tensor:
        """One component of the vector Laplacian of the vector field y.

        In spherical coordinates the components are assigned as the JAX
        package assigns them (r, azimuthal theta, polar phi at indices 0,
        1, 2), not with the cyclic shift of PararealML's own
        (numerical_differentiator.py:773-841 there)."""
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
        ind = vector_laplacian_ind
        component_slice = slice(ind, ind + 1)
        laplacian = self.laplacian(
            y[..., component_slice],
            mesh,
            slice_all_constraint_pairs(bcs, component_slice),
        )

        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN:
            return laplacian

        def d(comp: int, axis: int) -> torch.Tensor:
            return self._component_derivative(y, mesh, bcs, comp, axis)

        r = self._grid(mesh, 0, y)
        r_sqr = r**2
        y_r = y[..., :1]
        y_theta = y[..., 1:2]

        if cs == CoordinateSystem.SPHERICAL:
            phi = self._grid(mesh, 2, y)
            sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
            y_phi = y[..., 2:]
            if ind == 0:
                return laplacian - 2.0 * (
                    y_r + d(2, 2) + (cos_phi * y_phi + d(1, 1)) / sin_phi
                ) / r_sqr
            if ind == 1:
                return laplacian + 2.0 * (
                    d(0, 1) + (cos_phi * d(2, 1) - y_theta / 2.0) / sin_phi
                ) / (sin_phi * r_sqr)
            return laplacian + 2.0 * (
                d(0, 2) - (y_phi / 2.0 + cos_phi * d(1, 1)) / sin_phi**2
            ) / r_sqr

        # polar / cylindrical
        if ind == 0:
            return laplacian - (y_r + 2.0 * d(1, 1)) / r_sqr
        if ind == 1:
            return laplacian - (y_theta - 2.0 * d(0, 1)) / r_sqr
        return laplacian

    def anti_laplacian(
        self,
        laplacian: torch.Tensor,
        mesh: Mesh,
        y_constraints: Optional[Constraint],
        derivative_boundary_constraints=None,
        y_init: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Inverts the scalar Laplacian with Jacobi sweeps (or BiCGStab).

        Starts from zeros, or from ``y_init``, with the y constraints
        applied, and sweeps until the 2-norm of the update is at most
        ``tol`` or ``max_iterations`` sweeps have run; it always runs at
        least one (the initial update norm is infinite), as the JAX
        package's ``lax.while_loop`` does. Leading batch axes are solved
        independently, each with its own norm and stopping point, as the
        JAX package's loop under ``vmap`` (see :func:`jacobi`).
        """
        self._check_shape(laplacian, mesh, "Laplacian")
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )

        if y_init is None:
            y = torch.zeros_like(laplacian)
        else:
            if y_init.shape != laplacian.shape:
                raise ValueError(
                    f"y_init shape {tuple(y_init.shape)} must match "
                    f"Laplacian shape {tuple(laplacian.shape)}"
                )
            y = y_init
        if y_constraints is not None:
            y = y_constraints.apply(y)

        # the grid and component axes; any before them are batch axes
        first = laplacian.ndim - mesh.dimensions - 1
        dims = tuple(range(first, laplacian.ndim))
        if self._anti_laplacian_method == "bicgstab":
            return self._anti_laplacian_bicgstab(
                y, laplacian, mesh, bcs, y_constraints, dims
            )

        def sweep(v):
            v_new = self._next_anti_laplacian_estimate(v, laplacian, mesh, bcs)
            if y_constraints is not None:
                v_new = y_constraints.apply(v_new)
            return v_new

        return jacobi(sweep, y, self._tol, self._max_iterations, dims)[0]

    def _anti_laplacian_bicgstab(
        self,
        y_0: torch.Tensor,
        laplacian: torch.Tensor,
        mesh: Mesh,
        bcs: Tuple[Optional[BoundaryConstraintPair], ...],
        y_constraints: Optional[Constraint],
        dims: Tuple[int, ...],
    ) -> torch.Tensor:
        """Solves the Jacobi fixed-point equation with BiCGStab.

        The converged Jacobi state satisfies ``y = C(S(y))``, with ``S``
        one sweep and ``C`` the y constraints. The sweep is affine in
        ``y`` (``S(v) = B v + S(0)``), so that fixed point is the linear
        system ``v - notmask * (S(v) - S(0)) = where(mask, values,
        S(0))``: the diagonally preconditioned Poisson system with the
        Dirichlet rows pinned. Its residual at a mask-respecting iterate
        is the Jacobi update, and the solve stops when the residual's
        2-norm reaches ``tol`` (an absolute tolerance), as the JAX
        package's ``jax.scipy.sparse.linalg.bicgstab(..., tol=0,
        atol=tol)`` does.
        """

        def sweep(v):
            return self._next_anti_laplacian_estimate(v, laplacian, mesh, bcs)

        offset = sweep(torch.zeros_like(laplacian))
        if y_constraints is None:

            def matvec(v):
                return v - (sweep(v) - offset)

            b = offset
        else:
            values, mask = y_constraints.tensors_like(laplacian)

            def matvec(v):
                return v - torch.where(mask, 0.0, sweep(v) - offset)

            b = torch.where(mask, values, offset)

        return bicgstab(
            matvec, b, y_0, self._tol, self._max_iterations, dims
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
    pure selects. Its Jacobi sweep inverts the same Laplacian, with the
    same ghost vertices.
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

    def _next_anti_laplacian_estimate(
        self,
        y_hat: torch.Tensor,
        laplacian: torch.Tensor,
        mesh: Mesh,
        constraints,
    ) -> torch.Tensor:
        """One Jacobi sweep of the three-point Laplacian (with its metric
        terms in polar, cylindrical and spherical coordinates), in the
        JAX package's order of operations."""
        if min(y_hat.shape[-(mesh.dimensions + 1): -1]) <= 2:
            raise ValueError(
                "y must contain at least 3 points along all x axes"
            )

        cs = mesh.coordinate_system_type
        d_x_sqr = [d**2 for d in mesh.d_x]
        r = r_sqr = phi = sin_phi = r_sqr_sin_phi_sqr = None
        if cs != CoordinateSystem.CARTESIAN:
            r = self._grid(mesh, 0, y_hat)
            r_sqr = r**2
            if cs == CoordinateSystem.SPHERICAL:
                phi = self._grid(mesh, 2, y_hat)
                sin_phi = torch.sin(phi)
                r_sqr_sin_phi_sqr = r_sqr * sin_phi**2

        numerator = -laplacian
        for axis, d_x in enumerate(mesh.d_x):
            dim = _dim(axis, mesh.dimensions)
            n = y_hat.shape[dim]
            y_ext = self._extend_with_halos(y_hat, dim, d_x, constraints[axis])
            y_prev = _shifted(y_ext, dim, 0, n)
            y_next = _shifted(y_ext, dim, 2, n)
            neighbor_sum = (y_prev + y_next) / d_x_sqr[axis]

            if cs == CoordinateSystem.CARTESIAN:
                numerator = numerator + neighbor_sum
            elif cs == CoordinateSystem.SPHERICAL:
                if axis == 0:
                    numerator = numerator + (
                        neighbor_sum + (y_next - y_prev) / (d_x * r)
                    )
                elif axis == 1:
                    numerator = numerator + neighbor_sum / r_sqr_sin_phi_sqr
                else:
                    numerator = numerator + (
                        neighbor_sum
                        + torch.cos(phi)
                        * (y_next - y_prev)
                        / (2.0 * d_x * sin_phi)
                    ) / r_sqr
            else:  # polar / cylindrical
                if axis == 0:
                    numerator = numerator + (
                        neighbor_sum + (y_next - y_prev) / (2.0 * d_x * r)
                    )
                elif axis == 1:
                    numerator = numerator + neighbor_sum / r_sqr
                else:
                    numerator = numerator + neighbor_sum

        if cs == CoordinateSystem.CARTESIAN:
            denominator = sum(2.0 / d for d in d_x_sqr)
        elif cs == CoordinateSystem.SPHERICAL:
            denominator = (
                2.0 / d_x_sqr[0]
                + 2.0 / (d_x_sqr[1] * r_sqr_sin_phi_sqr)
                + 2.0 / (d_x_sqr[2] * r_sqr)
            )
        else:
            denominator = 2.0 / d_x_sqr[0] + 2.0 / (d_x_sqr[1] * r_sqr)
            if cs == CoordinateSystem.CYLINDRICAL:
                denominator = denominator + 2.0 / d_x_sqr[2]

        return numerator / denominator

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
            "PyTorch yet (ROADMAP.md, Queue 1, slice 6f)"
        )


def jacobi(
    sweep: Callable[[torch.Tensor], torch.Tensor],
    y: torch.Tensor,
    tol: float,
    max_iterations: int,
    dims: Tuple[int, ...],
    norm_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Applies ``sweep`` until the 2-norm of a sweep's update (over
    ``dims``, in ``norm_dtype`` or the state's) is at most ``tol`` or
    ``max_iterations`` sweeps have run, at least once: the JAX package's
    ``lax.while_loop`` of the anti-Laplacian. The axes before ``dims`` are
    independent states, each with its own norm and stopping point (JAX's
    loop under ``vmap``). The host reads the stopping flag once every
    :data:`JACOBI_CHUNK` sweeps; in between, a state whose norm reached
    ``tol`` is frozen (``torch.where``), so the result is the while
    loop's. Returns the states and each state's number of sweeps."""
    lead = tuple(y.shape[: dims[0]])
    diff = torch.full(lead, math.inf, dtype=norm_dtype or y.dtype,
                      device=y.device)
    sweeps = torch.zeros(lead, dtype=torch.int64, device=y.device)
    done = 0
    while done < max_iterations:
        chunk = min(JACOBI_CHUNK, max_iterations - done)
        for _ in range(chunk):
            active = diff > tol
            y_new = sweep(y)
            update_norm = torch.linalg.vector_norm(
                y_new - y, dim=dims, dtype=norm_dtype
            )
            y = torch.where(_expand(active, dims), y_new, y)
            diff = torch.where(active, update_norm, diff)
            sweeps = sweeps + active.to(torch.int64)
        done += chunk
        if not bool((diff > tol).any()):
            break
    return y, sweeps


def _expand(per_state: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """A per-state tensor (the batch axes only) with ones appended for
    the ``dims`` it was reduced over, to broadcast against the states."""
    return per_state.reshape(tuple(per_state.shape) + (1,) * len(dims))


def bicgstab(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    atol: float,
    maxiter: int,
    dims: Tuple[int, ...],
) -> torch.Tensor:
    """BiCGStab for ``matvec(x) = b`` without a preconditioner, with the
    recurrences, the early exit, the breakdown rules and the stopping rule
    of ``jax.scipy.sparse.linalg.bicgstab(..., tol=0, atol=atol,
    maxiter=maxiter)``: it iterates while the squared 2-norm of the
    residual exceeds ``atol**2`` (in ``b``'s dtype), fewer than
    ``maxiter`` iterations have run and no breakdown occurred. The axes
    before ``dims`` are a batch of independent systems, each with its own
    scalars and stopping point, as JAX's loop under ``vmap``; a finished
    system keeps its state (``torch.where``). The host reads the stopping
    flag once an iteration."""

    def dot(u, v):
        return (u * v).sum(dim=dims)

    atol2 = torch.tensor(atol, dtype=b.dtype).square()
    lead = tuple(b.shape[: dims[0]])
    r = b - matvec(x0)
    x, rhat, p, q = x0, r, r, r
    alpha = omega = rho = torch.ones(lead, dtype=b.dtype, device=b.device)
    k = torch.zeros(lead, dtype=torch.int64, device=b.device)
    while True:
        active = (dot(r, r) > atol2) & (k < maxiter) & (k >= 0)
        if not bool(active.any()):
            return x
        rho_ = dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + _expand(beta, dims) * (p - _expand(omega, dims) * q)
        q_ = matvec(p_)
        alpha_ = rho_ / dot(rhat, q_)
        s = r - _expand(alpha_, dims) * q_
        exit_early = _expand(dot(s, s) < atol2, dims)
        t = matvec(s)
        omega_ = dot(t, s) / dot(t, t)
        alpha_p = _expand(alpha_, dims) * p_
        x_ = torch.where(
            exit_early, x + alpha_p, x + (alpha_p + _expand(omega_, dims) * s)
        )
        r_ = torch.where(exit_early, s, s - _expand(omega_, dims) * t)
        k_ = torch.where((omega_ == 0) | (alpha_ == 0), -11, k + 1)
        k_ = torch.where(rho_ == 0, -10, k_)
        expanded = _expand(active, dims)
        x = torch.where(expanded, x_, x)
        r = torch.where(expanded, r_, r)
        p = torch.where(expanded, p_, p)
        q = torch.where(expanded, q_, q)
        alpha = torch.where(active, alpha_, alpha)
        omega = torch.where(active, omega_, omega)
        rho = torch.where(active, rho_, rho)
        k = torch.where(active, k_, k)
