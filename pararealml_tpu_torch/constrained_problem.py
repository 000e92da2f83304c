"""Differential equations constrained in space by a mesh and boundary
conditions.

Capability match for PararealML's constrained_problem.py:16-476
as the JAX package structures it: every boundary face carries a single
dense :class:`~pararealml_tpu_torch.constraint.Constraint` spanning all y
components (NaN-masked evaluation collapses into the mask), organised into
the :class:`BoundaryConstraints` structure the solvers consume directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from pararealml_tpu_torch.boundary_condition import BoundaryCondition
from pararealml_tpu_torch.constraint import Constraint
from pararealml_tpu_torch.differential_equation import DifferentialEquation
from pararealml_tpu_torch.mesh import Mesh

BoundaryConditionPair = Tuple[BoundaryCondition, BoundaryCondition]


class BoundaryConstraintPair(NamedTuple):
    """Constraints on the lower and upper boundary face of one axis.

    Each side is a dense :class:`Constraint` with shape
    ``grid_shape_with_axis_collapsed_to_1 + (y_dimension,)`` or ``None``
    when that side imposes nothing (or is dynamic and not yet evaluated).
    """

    lower: Optional[Constraint]
    upper: Optional[Constraint]


class BoundaryConstraints(NamedTuple):
    """Per-axis boundary constraints on y and on its normal derivative."""

    y: Tuple[BoundaryConstraintPair, ...]
    d_y: Tuple[BoundaryConstraintPair, ...]


class ConstrainedProblem:
    """A differential equation plus, for PDEs, a mesh and per-axis boundary
    condition pairs; precomputes all static constraint tensors."""

    def __init__(
        self,
        diff_eq: DifferentialEquation,
        mesh: Optional[Mesh] = None,
        boundary_conditions: Optional[Sequence[BoundaryConditionPair]] = None,
    ):
        self._diff_eq = diff_eq

        if not diff_eq.x_dimension:
            self._mesh = None
            self._boundary_conditions = None
            self._y_vertices_shape = (diff_eq.y_dimension,)
            self._y_cells_shape = (diff_eq.y_dimension,)
            self._are_all_bcs_static = False
            self._are_there_bcs_on_y = False
            self._boundary_vertex_constraints = None
            self._boundary_cell_constraints = None
            self._y_vertex_constraints = None
            return

        if mesh is None:
            raise ValueError("mesh cannot be None for PDEs")
        if mesh.dimensions != diff_eq.x_dimension:
            raise ValueError(
                f"mesh dimensions ({mesh.dimensions}) must match "
                "differential equation spatial dimensions "
                f"({diff_eq.x_dimension})"
            )
        if boundary_conditions is None:
            raise ValueError("boundary conditions cannot be None for PDEs")
        if len(boundary_conditions) != diff_eq.x_dimension:
            raise ValueError(
                "number of boundary condition pairs "
                f"({len(boundary_conditions)}) must match differential "
                f"equation spatial dimensions ({diff_eq.x_dimension})"
            )

        self._mesh = mesh
        self._boundary_conditions = tuple(boundary_conditions)
        self._y_vertices_shape = mesh.vertices_shape + (diff_eq.y_dimension,)
        self._y_cells_shape = mesh.cells_shape + (diff_eq.y_dimension,)

        self._are_all_bcs_static = all(
            lo.is_static and hi.is_static
            for (lo, hi) in self._boundary_conditions
        )
        self._are_there_bcs_on_y = any(
            lo.has_y_condition or hi.has_y_condition
            for (lo, hi) in self._boundary_conditions
        )

        self._boundary_vertex_constraints = self.create_boundary_constraints(
            True
        )
        self._boundary_cell_constraints = self.create_boundary_constraints(
            False
        )
        self._y_vertex_constraints = self.create_y_vertex_constraints(
            self._boundary_vertex_constraints.y
        )

    # -- properties -------------------------------------------------------

    @property
    def differential_equation(self) -> DifferentialEquation:
        """The differential equation."""
        return self._diff_eq

    @property
    def mesh(self) -> Optional[Mesh]:
        """The mesh (None for ODEs)."""
        return self._mesh

    @property
    def boundary_conditions(
        self,
    ) -> Optional[Tuple[BoundaryConditionPair, ...]]:
        """The per-axis boundary condition pairs (None for ODEs)."""
        return self._boundary_conditions

    @property
    def y_vertices_shape(self) -> Tuple[int, ...]:
        """The shape of the vertex-oriented solution array."""
        return self._y_vertices_shape

    @property
    def y_cells_shape(self) -> Tuple[int, ...]:
        """The shape of the cell-oriented solution array."""
        return self._y_cells_shape

    @property
    def are_all_boundary_conditions_static(self) -> bool:
        """Whether every boundary condition is time independent."""
        return self._are_all_bcs_static

    @property
    def are_there_boundary_conditions_on_y(self) -> bool:
        """Whether any boundary condition constrains the value of y."""
        return self._are_there_bcs_on_y

    @property
    def static_boundary_vertex_constraints(
        self,
    ) -> Optional[BoundaryConstraints]:
        """Static per-axis boundary constraints evaluated on boundary
        vertices (dynamic sides are None; None altogether for ODEs)."""
        return self._boundary_vertex_constraints

    @property
    def static_boundary_cell_constraints(
        self,
    ) -> Optional[BoundaryConstraints]:
        """Static per-axis boundary constraints evaluated on the exterior
        faces of the boundary cells."""
        return self._boundary_cell_constraints

    @property
    def static_y_vertex_constraints(self) -> Optional[Constraint]:
        """A single dense constraint on y over the full vertex grid,
        combining every static Dirichlet-type condition (None for ODEs or
        when no static y conditions exist)."""
        return self._y_vertex_constraints

    # -- API --------------------------------------------------------------

    def y_shape(
        self, vertex_oriented: Optional[bool] = None
    ) -> Tuple[int, ...]:
        """The shape of the discretized solution array."""
        return (
            self._y_vertices_shape if vertex_oriented else self._y_cells_shape
        )

    def static_boundary_constraints(
        self, vertex_oriented: bool
    ) -> Optional[BoundaryConstraints]:
        """The static boundary constraints for the given orientation."""
        return (
            self._boundary_vertex_constraints
            if vertex_oriented
            else self._boundary_cell_constraints
        )

    def create_boundary_constraints(
        self, vertex_oriented: bool, t: Optional[float] = None
    ) -> Optional[BoundaryConstraints]:
        """Evaluates the boundary conditions into dense constraint tensors.

        Static conditions are evaluated with ``t=None`` and cached; dynamic
        conditions are evaluated only when ``t`` is provided, otherwise
        their side is ``None`` in the result.
        """
        if not self._diff_eq.x_dimension:
            return None

        y_pairs = []
        d_y_pairs = []
        for axis, bc_pair in enumerate(self._boundary_conditions):
            y_sides = []
            d_y_sides = []
            for side, bc in enumerate(bc_pair):
                if not bc.is_static and t is None:
                    y_sides.append(None)
                    d_y_sides.append(None)
                    continue

                cached = self._cached_static_side(
                    bc, vertex_oriented, axis, side
                )
                if cached is not None:
                    y_sides.append(cached[0])
                    d_y_sides.append(cached[1])
                    continue

                x = self._boundary_face_coordinates(
                    vertex_oriented, axis, side
                )
                t_arg = None if bc.is_static else t
                y_sides.append(
                    self._evaluate_condition(
                        bc.has_y_condition, bc.y_condition, x, t_arg, axis
                    )
                )
                d_y_sides.append(
                    self._evaluate_condition(
                        bc.has_d_y_condition,
                        bc.d_y_condition,
                        x,
                        t_arg,
                        axis,
                    )
                )

            y_pairs.append(BoundaryConstraintPair(*y_sides))
            d_y_pairs.append(BoundaryConstraintPair(*d_y_sides))

        return BoundaryConstraints(tuple(y_pairs), tuple(d_y_pairs))

    def create_y_vertex_constraints(
        self,
        y_boundary_constraints: Optional[
            Sequence[BoundaryConstraintPair]
        ],
    ) -> Optional[Constraint]:
        """Combines per-axis boundary constraints on y into one dense
        constraint over the full vertex grid (later axes take precedence on
        shared edges/corners, matching the reference's application order,
        constrained_problem.py:262-301)."""
        if not self._diff_eq.x_dimension or y_boundary_constraints is None:
            return None

        full = np.full(self._y_vertices_shape, np.nan)
        any_set = False
        for axis, pair in enumerate(y_boundary_constraints):
            for side, constraint in enumerate(pair):
                if constraint is None:
                    continue
                any_set = True
                sl = [slice(None)] * len(self._y_vertices_shape)
                sl[axis] = slice(-1, None) if side else slice(0, 1)
                mask = np.asarray(constraint.mask)
                values = np.asarray(constraint.values)
                region = full[tuple(sl)]
                full[tuple(sl)] = np.where(mask, values, region)

        if not any_set:
            return None
        return Constraint.from_nan_masked(full)

    # -- helpers ----------------------------------------------------------

    def _cached_static_side(self, bc, vertex_oriented, axis, side):
        """Returns the precomputed (y, d_y) constraints for a static side
        if construction-time caches exist."""
        if not bc.is_static:
            return None
        cache = getattr(
            self,
            "_boundary_vertex_constraints"
            if vertex_oriented
            else "_boundary_cell_constraints",
            None,
        )
        if cache is None:
            return None
        return (cache.y[axis][side], cache.d_y[axis][side])

    def _boundary_face_coordinates(
        self, vertex_oriented: bool, axis: int, side: int
    ) -> np.ndarray:
        """The coordinates of the points on one boundary face, keeping the
        grid shape with the axis collapsed to size 1; the axis coordinate
        is pinned to the actual domain bound (relevant for cell
        orientation, whose points sit half a step inward)."""
        coords = np.copy(
            self.mesh.all_index_coordinates(vertex_oriented)
        )
        sl = [slice(None)] * coords.ndim
        sl[axis] = slice(-1, None) if side else slice(0, 1)
        face = np.copy(coords[tuple(sl)])
        face[..., axis] = self.mesh.vertex_axis_coordinates[axis][
            -1 if side else 0
        ]
        return face

    def _evaluate_condition(
        self, has_condition, condition_fn, face_coords, t, axis
    ) -> Optional[Constraint]:
        """Evaluates a boundary condition function over a face and wraps
        the NaN-masked result in a dense Constraint."""
        if not has_condition:
            return None

        y_dim = self._diff_eq.y_dimension
        flat_x = face_coords.reshape(-1, self._diff_eq.x_dimension)
        values = condition_fn(flat_x, t)
        values = np.asarray(values, dtype=float)
        if values.shape != (len(flat_x), y_dim):
            raise ValueError(
                "expected boundary condition function output shape to be "
                f"{(len(flat_x), y_dim)} but got {values.shape}"
            )
        face_values = values.reshape(face_coords.shape[:-1] + (y_dim,))
        return Constraint.from_nan_masked(face_values)
