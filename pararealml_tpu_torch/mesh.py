"""Spatial meshes in Cartesian and curvilinear coordinate systems.

Capability match for the reference's ``Mesh`` (see
PararealML's mesh.py:20-628): uniform hyper-rectangular grids
with vertex/cell-center orientations in Cartesian, polar, cylindrical and
spherical coordinates, plus coordinate conversion and unit-vector helpers.

Host-side geometry (shapes, axis coordinates, measures) is plain NumPy;
the coordinate grids the solvers need on the device are exposed as cached
tensors via :meth:`Mesh.device_coordinate_grids`.
"""

from __future__ import annotations

import math
from enum import Enum
from typing import Sequence, Tuple, TypeVar

import numpy as np
import torch

SpatialDomainInterval = Tuple[float, float]


class CoordinateSystem(Enum):
    """The supported coordinate system types."""

    CARTESIAN = 0
    POLAR = 1
    CYLINDRICAL = 2
    SPHERICAL = 3


_CURVILINEAR_DIMS = {
    CoordinateSystem.POLAR: 2,
    CoordinateSystem.CYLINDRICAL: 3,
    CoordinateSystem.SPHERICAL: 3,
}


class Mesh:
    """A uniform hyper-grid over a spatial domain.

    The grid can be viewed vertex-oriented (points on interval bounds
    inclusive) or cell-oriented (points at cell centers); solvers in this
    framework are vertex-oriented, cell orientation exists for data layout
    interoperability and resampling.
    """

    def __init__(
        self,
        x_intervals: Sequence[SpatialDomainInterval],
        d_x: Sequence[float],
        coordinate_system_type: CoordinateSystem = CoordinateSystem.CARTESIAN,
    ):
        if len(x_intervals) == 0:
            raise ValueError(
                "number of spatial domain intervals must be greater than 0"
            )
        if len(x_intervals) != len(d_x):
            raise ValueError(
                f"number of spatial domain intervals ({len(x_intervals)}) "
                f"must match number of spatial step sizes ({len(d_x)})"
            )
        for (lo, hi) in x_intervals:
            if hi <= lo:
                raise ValueError(
                    "upper bound of every spatial domain interval must be "
                    "greater than its lower bound"
                )
        if min(d_x) <= 0.0:
            raise ValueError("all spatial step sizes must be greater than 0")

        self._x_intervals = tuple(
            (float(lo), float(hi)) for (lo, hi) in x_intervals
        )
        self._d_x = tuple(float(d) for d in d_x)
        self._coordinate_system_type = coordinate_system_type
        self._dimensions = len(self._x_intervals)

        self._validate_curvilinear_domain()

        self._vertices_shape = self._grid_shape(vertex_oriented=True)
        self._cells_shape = self._grid_shape(vertex_oriented=False)
        self._vertex_axis_coordinates = self._axis_coordinates_for(True)
        self._cell_center_axis_coordinates = self._axis_coordinates_for(False)
        self._vertex_coordinate_grids = self._coordinate_grids_for(True)
        self._cell_center_coordinate_grids = self._coordinate_grids_for(False)
        self._volume = self._domain_volume()
        self._boundary_sizes = self._domain_boundary_sizes()
        self._device_grid_cache = {}

    # -- validation -------------------------------------------------------

    def _validate_curvilinear_domain(self):
        cs = self._coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN:
            return

        expected_dims = _CURVILINEAR_DIMS[cs]
        if self._dimensions != expected_dims:
            raise ValueError(
                f"number of dimensions ({self._dimensions}) of "
                f"{cs.name.lower()} mesh must be {expected_dims}"
            )

        r_lo = self._x_intervals[0][0]
        if r_lo < 0.0:
            raise ValueError(
                f"lower bound of r interval ({r_lo}) must be non-negative"
            )
        theta_lo, theta_hi = self._x_intervals[1]
        if theta_lo < 0.0 or theta_hi > 2.0 * math.pi:
            raise ValueError(
                f"theta interval [{theta_lo}, {theta_hi}] must lie within "
                "[0, 2*pi]"
            )
        if cs == CoordinateSystem.SPHERICAL:
            phi_lo, phi_hi = self._x_intervals[2]
            if phi_lo < 0.0 or phi_hi > math.pi:
                raise ValueError(
                    f"phi interval [{phi_lo}, {phi_hi}] must lie within "
                    "[0, pi]"
                )

    # -- basic properties -------------------------------------------------

    @property
    def x_intervals(self) -> Sequence[SpatialDomainInterval]:
        """The bounds of each axis of the spatial domain."""
        return self._x_intervals

    @property
    def d_x(self) -> Sequence[float]:
        """The step size along each axis."""
        return self._d_x

    @property
    def coordinate_system_type(self) -> CoordinateSystem:
        """The coordinate system the domain is defined in."""
        return self._coordinate_system_type

    @property
    def dimensions(self) -> int:
        """The number of spatial dimensions."""
        return self._dimensions

    @property
    def volume(self) -> float:
        """The volume of the spatial domain."""
        return self._volume

    @property
    def boundary_sizes(self) -> Sequence[Tuple[float, float]]:
        """The measures of the lower/upper boundary of each axis."""
        return self._boundary_sizes

    @property
    def vertices_shape(self) -> Tuple[int, ...]:
        """The shape of the vertex grid."""
        return self._vertices_shape

    @property
    def cells_shape(self) -> Tuple[int, ...]:
        """The shape of the cell-center grid."""
        return self._cells_shape

    @property
    def vertex_axis_coordinates(self) -> Tuple[np.ndarray, ...]:
        """Per-axis coordinates of the vertices."""
        return self._vertex_axis_coordinates

    @property
    def cell_center_axis_coordinates(self) -> Tuple[np.ndarray, ...]:
        """Per-axis coordinates of the cell centers."""
        return self._cell_center_axis_coordinates

    @property
    def vertex_coordinate_grids(self) -> Tuple[np.ndarray, ...]:
        """Per-axis full coordinate grids over the vertices."""
        return self._vertex_coordinate_grids

    @property
    def cell_center_coordinate_grids(self) -> Tuple[np.ndarray, ...]:
        """Per-axis full coordinate grids over the cell centers."""
        return self._cell_center_coordinate_grids

    # -- orientation-parameterized accessors ------------------------------

    def shape(self, vertex_oriented: bool) -> Tuple[int, ...]:
        """The grid shape for the requested orientation."""
        return self._vertices_shape if vertex_oriented else self._cells_shape

    def axis_coordinates(
        self, vertex_oriented: bool
    ) -> Tuple[np.ndarray, ...]:
        """Per-axis point coordinates for the requested orientation."""
        return (
            self._vertex_axis_coordinates
            if vertex_oriented
            else self._cell_center_axis_coordinates
        )

    def coordinate_grids(
        self, vertex_oriented: bool
    ) -> Tuple[np.ndarray, ...]:
        """Full per-axis coordinate grids for the requested orientation."""
        return (
            self._vertex_coordinate_grids
            if vertex_oriented
            else self._cell_center_coordinate_grids
        )

    def cartesian_coordinate_grids(
        self, vertex_oriented: bool
    ) -> Tuple[np.ndarray, ...]:
        """Coordinate grids converted to Cartesian coordinates."""
        return tuple(
            to_cartesian_coordinates(
                self.coordinate_grids(vertex_oriented),
                self._coordinate_system_type,
            )
        )

    def all_index_coordinates(
        self, vertex_oriented: bool, flatten: bool = False
    ) -> np.ndarray:
        """An array of the coordinates of every grid point, either shaped
        like the grid with a trailing coordinate axis or flattened to 2D.
        """
        stacked = np.stack(self.coordinate_grids(vertex_oriented), axis=-1)
        return stacked.reshape(-1, self._dimensions) if flatten else stacked

    def unit_vector_grids(
        self, vertex_oriented: bool
    ) -> Tuple[np.ndarray, ...]:
        """Grids of the coordinate system's orthonormal unit vectors
        expressed in Cartesian coordinates at every grid point.
        """
        grids = self.coordinate_grids(vertex_oriented)
        return tuple(
            np.stack(vec, axis=-1)
            for vec in unit_vectors_at(grids, self._coordinate_system_type)
        )

    def device_coordinate_grids(
        self,
        vertex_oriented: bool,
        dtype: torch.dtype = torch.float64,
        device=None,
    ) -> Tuple[torch.Tensor, ...]:
        """The coordinate grids as tensors of the given dtype on the given
        device, cached per orientation, dtype and device.

        Solvers use these for coordinate-dependent right-hand sides."""
        key = (bool(vertex_oriented), dtype, torch.device(device or "cpu"))
        if key not in self._device_grid_cache:
            self._device_grid_cache[key] = tuple(
                torch.tensor(g, dtype=dtype, device=key[2])
                for g in self.coordinate_grids(vertex_oriented)
            )
        return self._device_grid_cache[key]

    # -- construction helpers ---------------------------------------------

    def _grid_shape(self, vertex_oriented: bool) -> Tuple[int, ...]:
        return tuple(
            round((hi - lo) / d) + (1 if vertex_oriented else 0)
            for (lo, hi), d in zip(self._x_intervals, self._d_x)
        )

    def _axis_coordinates_for(
        self, vertex_oriented: bool
    ) -> Tuple[np.ndarray, ...]:
        shape = self.shape(vertex_oriented)
        coords = []
        for (lo, hi), d, n in zip(self._x_intervals, self._d_x, shape):
            if not vertex_oriented:
                lo, hi = lo + d / 2.0, hi - d / 2.0
            axis = np.linspace(lo, hi, n)
            axis.setflags(write=False)
            coords.append(axis)
        return tuple(coords)

    def _coordinate_grids_for(
        self, vertex_oriented: bool
    ) -> Tuple[np.ndarray, ...]:
        grids = np.meshgrid(
            *self.axis_coordinates(vertex_oriented), indexing="ij"
        )
        for g in grids:
            g.setflags(write=False)
        return tuple(grids)

    def _domain_volume(self) -> float:
        cs = self._coordinate_system_type
        spans = [hi - lo for (lo, hi) in self._x_intervals]

        if cs == CoordinateSystem.CARTESIAN:
            return float(np.prod(spans))

        r_lo, r_hi = self._x_intervals[0]
        theta_span = spans[1]
        if cs == CoordinateSystem.SPHERICAL:
            phi_lo, phi_hi = self._x_intervals[2]
            return (
                (r_hi**3 - r_lo**3)
                / 3.0
                * theta_span
                * (math.cos(phi_lo) - math.cos(phi_hi))
            )

        annulus_area = 0.5 * (r_hi**2 - r_lo**2) * theta_span
        if cs == CoordinateSystem.POLAR:
            return annulus_area
        return annulus_area * spans[2]

    def _domain_boundary_sizes(self) -> Tuple[Tuple[float, float], ...]:
        cs = self._coordinate_system_type
        spans = [hi - lo for (lo, hi) in self._x_intervals]

        if cs == CoordinateSystem.CARTESIAN:
            total = float(np.prod(spans))
            return tuple((total / s, total / s) for s in spans)

        r_lo, r_hi = self._x_intervals[0]
        theta_span = spans[1]

        if cs == CoordinateSystem.SPHERICAL:
            phi_lo, phi_hi = self._x_intervals[2]
            cos_span = math.cos(phi_lo) - math.cos(phi_hi)
            half_r_sqr_span = 0.5 * (r_hi**2 - r_lo**2)
            return (
                (
                    r_lo**2 * theta_span * cos_span,
                    r_hi**2 * theta_span * cos_span,
                ),
                (half_r_sqr_span * spans[2],) * 2,
                (
                    half_r_sqr_span * theta_span * math.sin(phi_lo),
                    half_r_sqr_span * theta_span * math.sin(phi_hi),
                ),
            )

        r_faces = (r_lo * theta_span, r_hi * theta_span)
        theta_faces = (r_hi - r_lo,) * 2
        if cs == CoordinateSystem.POLAR:
            return (r_faces, theta_faces)

        z_span = spans[2]
        return (
            (r_faces[0] * z_span, r_faces[1] * z_span),
            (theta_faces[0] * z_span,) * 2,
            (0.5 * (r_hi**2 - r_lo**2) * theta_span,) * 2,
        )


Coordinate = TypeVar("Coordinate", float, np.ndarray)
Coordinates = Sequence[Coordinate]


def unit_vectors_at(
    x: Coordinates, coordinate_system_type: CoordinateSystem
) -> Sequence[Coordinates]:
    """The orthonormal unit vectors of the coordinate system at ``x``,
    expressed in Cartesian components (one sequence per unit vector).
    """
    cs = coordinate_system_type

    if cs == CoordinateSystem.CARTESIAN:
        n = len(x)
        zeros = [np.zeros_like(c) for c in x]
        ones = [np.ones_like(c) for c in x]
        return [
            [ones[i] if j == i else zeros[j] for j in range(n)]
            for i in range(n)
        ]

    sin_t, cos_t = np.sin(x[1]), np.cos(x[1])

    if cs == CoordinateSystem.POLAR:
        return [[cos_t, sin_t], [-sin_t, cos_t]]

    if cs == CoordinateSystem.CYLINDRICAL:
        zero = np.zeros_like(x[1])
        one = np.ones_like(x[1])
        return [
            [cos_t, sin_t, zero],
            [-sin_t, cos_t, zero],
            [zero, zero, one],
        ]

    if cs == CoordinateSystem.SPHERICAL:
        zero = np.zeros_like(x[1])
        sin_p, cos_p = np.sin(x[2]), np.cos(x[2])
        return [
            [sin_p * cos_t, sin_p * sin_t, cos_p],
            [-sin_t, cos_t, zero],
            [cos_p * cos_t, cos_p * sin_t, -sin_p],
        ]

    raise ValueError(f"unsupported coordinate system type ({cs.name})")


def to_cartesian_coordinates(
    x: Coordinates, from_coordinate_system_type: CoordinateSystem
) -> Coordinates:
    """Converts coordinates from the given system to Cartesian."""
    cs = from_coordinate_system_type
    if cs == CoordinateSystem.CARTESIAN:
        return x
    if cs == CoordinateSystem.POLAR:
        return [x[0] * np.cos(x[1]), x[0] * np.sin(x[1])]
    if cs == CoordinateSystem.CYLINDRICAL:
        return [x[0] * np.cos(x[1]), x[0] * np.sin(x[1]), x[2]]
    if cs == CoordinateSystem.SPHERICAL:
        sin_p = np.sin(x[2])
        return [
            x[0] * sin_p * np.cos(x[1]),
            x[0] * sin_p * np.sin(x[1]),
            x[0] * np.cos(x[2]),
        ]
    raise ValueError(f"unsupported coordinate system type ({cs.name})")


def from_cartesian_coordinates(
    x: Coordinates, to_coordinate_system_type: CoordinateSystem
) -> Coordinates:
    """Converts Cartesian coordinates to the given system."""
    cs = to_coordinate_system_type
    if cs == CoordinateSystem.CARTESIAN:
        return x
    if cs == CoordinateSystem.POLAR:
        return [np.hypot(x[0], x[1]), np.arctan2(x[1], x[0])]
    if cs == CoordinateSystem.CYLINDRICAL:
        return [np.hypot(x[0], x[1]), np.arctan2(x[1], x[0]), x[2]]
    if cs == CoordinateSystem.SPHERICAL:
        r_xy = np.hypot(x[0], x[1])
        return [
            np.sqrt(x[0] ** 2 + x[1] ** 2 + x[2] ** 2),
            np.arctan2(x[1], x[0]),
            np.arctan2(r_xy, x[2]),
        ]
    raise ValueError(f"unsupported coordinate system type ({cs.name})")
