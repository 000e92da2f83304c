"""Plain NumPy three-point stencils on a 2D Cartesian vertex grid.

Written from the equations and from a configuration file of
``benchmark/configs/``: vertices ``linspace(low, high, n)`` on each axis;
Dirichlet conditions override the state on their faces (a later axis wins
on shared corners, a ``null`` component leaves the state free); Neumann
conditions give a ghost vertex beyond their face, ``y[1] - 2 dx g`` below
and ``y[-2] + 2 dx g`` above; a face with no Neumann condition on a
component has a zero ghost there. The gradient across a Neumann face is
its prescribed value. Everything runs in the dtype it is given, over a
leading batch of independent states.

This module imports NumPy alone: nothing of the program under test.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def axis_vertices(interval: Sequence[float], d_x: float) -> np.ndarray:
    """The vertex coordinates of one axis."""
    low, high = (float(v) for v in interval)
    count = int(round((high - low) / d_x)) + 1
    return np.linspace(low, high, count)


class Grid2D:
    """The vertex grid and boundary data of a 2D configuration with
    ``components`` state components, in ``dtype``."""

    def __init__(self, config: dict, components: int, dtype=np.float64):
        mesh = config["mesh"]
        self.dtype = np.dtype(dtype)
        self.n = components
        self.x0 = axis_vertices(mesh["x_intervals"][0], mesh["d_x"][0])
        self.x1 = axis_vertices(mesh["x_intervals"][1], mesh["d_x"][1])
        self.height, self.width = self.x0.size, self.x1.size
        self.d_x = (float(mesh["d_x"][0]), float(mesh["d_x"][1]))
        shape = (components, self.height, self.width)
        self.dirichlet_mask = np.zeros(shape, bool)
        self.dirichlet_values = np.zeros(shape)
        # Neumann derivative per (axis, side, component); None: no ghost
        self.neumann: List[List[List[Optional[float]]]] = [
            [[None] * components for _ in range(2)] for _ in range(2)
        ]
        for axis, pair in enumerate(config["boundary_conditions"]):
            for side, condition in enumerate(pair):
                values = condition["values"]
                if len(values) != components:
                    raise ValueError(
                        f"boundary condition {condition} has "
                        f"{len(values)} values for {components} components"
                    )
                for comp, value in enumerate(values):
                    if value is None:
                        continue
                    if condition["kind"] == "dirichlet":
                        face = self._face(axis, side)
                        self.dirichlet_mask[comp][face] = True
                        self.dirichlet_values[comp][face] = value
                    elif condition["kind"] == "neumann":
                        self.neumann[axis][side][comp] = float(value)
                    else:
                        raise ValueError(
                            f"unknown boundary condition {condition['kind']}"
                        )
        self.dirichlet_values = self.dirichlet_values.astype(self.dtype)
        self._buffers = {}

    @staticmethod
    def _face(axis: int, side: int):
        index = 0 if side == 0 else -1
        return (index, slice(None)) if axis == 0 else (slice(None), index)

    def coordinates(self) -> np.ndarray:
        """Every vertex's (x0, x1), shape ``(H, W, 2)``."""
        return np.stack(np.meshgrid(self.x0, self.x1, indexing="ij"), -1)

    def dirichlet(self, plane: np.ndarray, comp: int) -> np.ndarray:
        """``plane`` ``(B, H, W)`` with component ``comp``'s Dirichlet
        values written on its faces, in place."""
        mask = self.dirichlet_mask[comp]
        if mask.any():
            np.copyto(plane, self.dirichlet_values[comp], where=mask)
        return plane

    def padded(self, plane: np.ndarray, comp: int) -> np.ndarray:
        """``plane`` ``(B, H, W)`` with a ghost ring ``(B, H + 2, W + 2)``:
        Neumann ghosts on faces with a derivative condition, zeros
        elsewhere (the corners are never read). The array is a buffer
        kept for the shape and component: read it before the next call."""
        batch, height, width = plane.shape
        out = self._buffers.get((plane.shape, comp))
        if out is None:
            out = np.zeros((batch, height + 2, width + 2), self.dtype)
            self._buffers[(plane.shape, comp)] = out
        out[:, 1:-1, 1:-1] = plane
        two_dx0, two_dx1 = 2.0 * self.d_x[0], 2.0 * self.d_x[1]
        for side, (ghost, inner, sign) in enumerate(
            ((0, 1, -1.0), (-1, -2, 1.0))
        ):
            value = self.neumann[0][side][comp]
            if value is not None:
                np.add(
                    plane[:, inner, :], sign * two_dx0 * value,
                    out=out[:, ghost, 1:-1],
                )
            value = self.neumann[1][side][comp]
            if value is not None:
                np.add(
                    plane[:, :, inner], sign * two_dx1 * value,
                    out=out[:, 1:-1, ghost],
                )
        return out

    def laplacian(self, plane: np.ndarray, comp: int) -> np.ndarray:
        """The three-point Laplacian of ``plane`` ``(B, H, W)``."""
        return self._laplacian(self.padded(plane, comp), plane)

    def _laplacian(self, p: np.ndarray, plane: np.ndarray) -> np.ndarray:
        inv0, inv1 = 1.0 / self.d_x[0] ** 2, 1.0 / self.d_x[1] ** 2
        out = np.add(p[:, :-2, 1:-1], p[:, 2:, 1:-1])
        out *= inv0
        across = np.add(p[:, 1:-1, :-2], p[:, 1:-1, 2:])
        across *= inv1
        out += across
        out -= (2.0 * (inv0 + inv1)) * plane
        return out

    def laplacian_and_gradients(self, plane: np.ndarray, comp: int):
        """The Laplacian and the central differences along both axes of
        ``plane``; across a Neumann face, a difference is its prescribed
        derivative."""
        p = self.padded(plane, comp)
        lap = self._laplacian(p, plane)
        g0 = np.subtract(p[:, 2:, 1:-1], p[:, :-2, 1:-1])
        g0 *= 1.0 / (2.0 * self.d_x[0])
        g1 = np.subtract(p[:, 1:-1, 2:], p[:, 1:-1, :-2])
        g1 *= 1.0 / (2.0 * self.d_x[1])
        for axis, g in ((0, g0), (1, g1)):
            for side in (0, 1):
                value = self.neumann[axis][side][comp]
                if value is not None:
                    g[(slice(None),) + self._face(axis, side)] = value
        return lap, g0, g1

    def gradients(self, plane: np.ndarray, comp: int):
        """The central differences of ``plane`` along both axes (see
        :meth:`laplacian_and_gradients`)."""
        return self.laplacian_and_gradients(plane, comp)[1:]


def initial_states(config: dict, components: int, values, items, dtype):
    """The initial states ``(B, H, W, components)`` of the pool items
    ``items``: ``values(config, item, points)``, each item's state
    ``(N, components)`` at the vertices ``(N, 2)``, in ``dtype``, with the
    Dirichlet values applied."""
    grid = Grid2D(config, components, dtype)
    points = grid.coordinates().reshape(-1, 2)
    states = np.stack(
        [
            np.asarray(values(config, item, points), np.float64).reshape(
                grid.height, grid.width, components
            )
            for item in items
        ]
    ).astype(grid.dtype)
    for comp in range(components):
        grid.dirichlet(states[..., comp], comp)
    return states


def round_to_bfloat16(values: np.ndarray) -> np.ndarray:
    """``values`` rounded to the nearest bfloat16 (ties to even), returned
    as float32: the storage precision of the lower-precision control."""
    bits = np.ascontiguousarray(values, dtype=np.float32).view(np.uint32)
    rounded = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & (
        np.uint32(0xFFFF0000)
    )
    return rounded.view(np.float32)
