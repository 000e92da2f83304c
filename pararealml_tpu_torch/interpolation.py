"""Rectilinear-grid interpolation on tensors.

Port of the JAX package's ``interpolation.py``: a multilinear
interpolator over the mesh's rectilinear axes, used to resample solutions
and initial conditions between mesh orientations. Query points outside
the grid hull are evaluated by linearly extending the edge cell's
interpolant — the vertex<->cell-center resampling reads a half-cell band
beyond the cell-center hull at every face, so plain clamping would bias
the boundary vertices.

The interpolator is vectorized over arbitrary trailing value axes, so a
whole ``(time, y_dimension)`` trajectory resamples in one gather.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_SUPPORTED_METHODS = ("linear", "nearest")


def _cell_index_and_offset(
    axis: torch.Tensor, queries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each query coordinate, the index of the grid cell whose
    interpolant evaluates it and the query's fractional offset within
    that cell.

    Out-of-hull queries map to the nearest edge cell with an offset
    outside [0, 1], which makes the multilinear blend extrapolate."""
    point_count = axis.shape[0]
    if point_count < 2:
        # a degenerate single-point axis contributes nothing to the
        # blend; pin every query to that point
        return (
            torch.zeros(
                queries.shape, dtype=torch.long, device=queries.device
            ),
            torch.zeros_like(queries),
        )
    cell = torch.clamp(
        torch.searchsorted(axis, queries, right=True) - 1,
        0,
        point_count - 2,
    )
    lower = axis[cell]
    return cell, (queries - lower) / (axis[cell + 1] - lower)


def grid_interpolate(
    values: torch.Tensor,
    axis_points: Sequence[np.ndarray],
    x: torch.Tensor,
    method: str = "linear",
) -> torch.Tensor:
    """Interpolates grid-sampled values at arbitrary query points.

    :param values: tensor whose leading ``len(axis_points)`` axes span
        the grid; any trailing axes are carried through the blend.
    :param axis_points: one strictly increasing 1D coordinate array per
        grid axis.
    :param x: query points of shape ``(..., len(axis_points))``.
    :param method: ``"linear"`` (multilinear, linearly extrapolating
        outside the hull) or ``"nearest"``.
    :return: tensor of shape ``x.shape[:-1] + values.shape[d:]``.
    """
    if method not in _SUPPORTED_METHODS:
        raise ValueError(
            f"unsupported interpolation method '{method}'; supported "
            f"methods are {_SUPPORTED_METHODS}"
        )
    dimensions = len(axis_points)
    if x.shape[-1] != dimensions:
        raise ValueError(
            f"query point dimensionality ({x.shape[-1]}) must match the "
            f"number of grid axes ({dimensions})"
        )
    queries = x.reshape(-1, dimensions)
    trailing_shape = tuple(values.shape[dimensions:])
    table = values.reshape(tuple(values.shape[:dimensions]) + (-1,))

    cells = []
    offsets = []
    for axis_index in range(dimensions):
        axis = torch.tensor(
            np.asarray(axis_points[axis_index]),
            dtype=table.dtype,
            device=table.device,
        )
        cell, offset = _cell_index_and_offset(
            axis, queries[:, axis_index].to(table.dtype).contiguous()
        )
        if method == "nearest":
            cell = cell + (offset > 0.5).to(cell.dtype)
            offset = torch.zeros_like(offset)
        cells.append(cell)
        offsets.append(offset)

    output_shape = tuple(x.shape[:-1]) + trailing_shape
    if method == "nearest":
        return table[tuple(cells)].reshape(output_shape)

    # multilinear blend: accumulate the 2^d cell corners, each weighted
    # by the product of per-axis offsets (or their complements)
    accumulated = torch.zeros(
        (queries.shape[0], table.shape[-1]),
        dtype=table.dtype,
        device=table.device,
    )
    for corner in range(2**dimensions):
        corner_index = []
        weight = torch.ones(
            (queries.shape[0],), dtype=table.dtype, device=table.device
        )
        for axis_index in range(dimensions):
            takes_upper = (corner >> axis_index) & 1
            corner_index.append(cells[axis_index] + takes_upper)
            weight = weight * (
                offsets[axis_index]
                if takes_upper
                else 1.0 - offsets[axis_index]
            )
        accumulated = accumulated + (
            table[tuple(corner_index)] * weight[:, None]
        )
    return accumulated.reshape(output_shape)
