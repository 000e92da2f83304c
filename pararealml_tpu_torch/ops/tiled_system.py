"""Tiled RK4 trajectory kernel for 2D systems past one CTA (K8).

Port of the JAX package's ``ops/tiled_system.py``. The Pallas TPU kernel
there streams row tiles of all ``n`` component planes of a state that
lives in device memory through one core, recomputing 8-row halos, for
the wave, Burgers, shallow-water and Cahn-Hilliard systems whose grids
the whole-grid kernel (K5) cannot hold. Its counterpart for Hopper is a
hand-written CUDA kernel, ``csrc/tiled_system.cu`` (see its header for
the design), launched once per RK4 step: a grid of thread blocks covers
every state of a batch with 2D tiles, each block loads its tile of all n
planes with a halo into shared memory (4 cells for RK4, 1 for
Cahn-Hilliard), runs the step there and writes its part of the step's
frame, which is also the state the next step starts from. The equation
functors are K5's (``csrc/system_2d.cuh``).

Each step computes what the JAX kernel computes, in the same order: the
step factories of :mod:`pararealml_tpu_torch.ops.fused_system` over the
tiled helpers, whose Laplacian sums the two axis terms before adding the
Neumann ghost rows and then the ghost columns (K5 adds each axis's ghost
term before the sum), with cells outside the grid at zero and the
Dirichlet override applied as face vectors, rows then columns. So K8 and
K5 agree to float32 rounding, not bit for bit.

Polar meshes: the JAX package has no tiled polar kernel. It runs its
polar K5 up to its VMEM cap (51 x 201 x 2 for the polar wave example), so
the port carries polar K5 past one CTA on K8 with K5's helpers: the
per-row 1 / r metric terms and K5's order of operations (each axis's
ghost added first). Polar K8 is bit for bit with polar K5 where the
Dirichlet faces coincide.

``storage_dtype=torch.bfloat16`` keeps the frames, and so the state
carried from step to step, in bfloat16 (rounded once a step, to nearest
even, as the JAX kernel's tiles are on store) while all arithmetic stays
float32; the trajectory is returned in the stored dtype.

``tiled_system_rk4_trajectory`` launches the kernel for a CUDA tensor and
runs ``tiled_system_rk4_trajectory_reference``, the plain PyTorch version,
for a CPU tensor. On a CUDA tensor the kernel runs or the wrapper raises;
a grid without a tile plan raises before any launch. ``launches`` counts
the wrapper's kernel runs (one per trajectory; each runs one CUDA launch
per step).

``tiled_system_rk4_end`` (plain version ``tiled_system_rk4_end_reference``)
is the end mode: the same kernel, one launch a step, stepping between two
float32 ``(B, H, W, n)`` state buffers instead of storing frames, every
state of a batch in the launch's third grid dimension. It carries the
JAX package's K5 end (single or batched) and its packed K4 ends past
the cluster-resident mode's grids: ``build_fused_system_rk4_end`` takes
it there, and so do ``FDMOperator.ends_function`` and Parareal's fine
ends (one state per time slice) and single-state coarse ends.

The tile plan is the port's own (:func:`make_system_tile_plan`): 2D tiles
taken by grid size, halo and ``n`` from a table of the tilings measured
fastest on the card (polar grids too: the polar wave example's 51 x 201
measured fastest on the same tiles), with no cap on the grid's height or
width and no sublane alignment. For RK4 (halo 4) it picks 12 x 32 cells
of shared memory (4 x 24 advanced) at 101² x 2 (130 blocks), at 101 x 51
x 3 (78 blocks) and at the polar 51 x 201 x 2 (117 blocks), and 32 x 96
(24 x 88 advanced) at 641² x 2 (216 blocks); for Cahn-Hilliard (halo 1)
8 x 32 (6 x 30 advanced) at 101² x 2 (68 blocks).

Applicability (:func:`tiled_system_applicable`): a grid with a tile plan
whose Dirichlet constraints lie on its faces, for any of the four
families, that the cluster-resident mode does not take
(:func:`pararealml_tpu_torch.ops.fused_system.cluster_system_applicable`:
the grids a thread block cluster holds within the JAX package's VMEM
cap, the 2D examples' among them, run there in one launch a solve); the
JAX package sends shallow water past VMEM to its generic path on a TPU
v5e timing, the port sends it to K8 (ROADMAP.md, Queue 3).
The coordinate system is gated by
:func:`pararealml_tpu_torch.ops.fused_system.fused_system_step_applicable`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.differential_equation import (
    CahnHilliardEquation,
    NavierStokesEquation,
)
from pararealml_tpu_torch.ops.fused_system import (
    MAX_SHARED_MEMORY_BYTES,
    _dirichlet_grids,
    _ghost_faces,
    _Helpers,
    _step_reference,
    _SystemKernelConfig,
    cluster_system_applicable,
    states,
)
from pararealml_tpu_torch.ops.tiled_diffusion import dirichlet_is_face_only

_DTYPES = (torch.float32, torch.bfloat16)
# one RK4 step's four chained radius-1 stencils reach 4 cells; the
# Cahn-Hilliard step's single radius-1 dependence reaches 1
RK4_HALO = 4
CAHN_HILLIARD_HALO = 1
# The tiles of the plan, halo included, by halo and components: for each
# grid side measured (square grids), the rows and columns of the fastest
# of 50-60 tilings there (tools/k8_tile_sweep.py, on an NVIDIA H100 80GB
# HBM3 at 700 W). A grid takes the entry whose side is nearest to its
# own (the square root of its cells) on a log scale. Polar grids take the
# same rows: the sweep's polar wave case at the example's 51 x 201 (side
# 101) ran fastest of 55 tilings on the 101 row's 12 x 32 (6.614 us a
# step; 16 x 32 6.641).
_MEASURED_TILES = {
    (RK4_HALO, 2): (
        (101, 12, 32),
        (201, 16, 32),
        (321, 16, 64),
        (641, 32, 96),
        (1025, 32, 96),
    ),
    (RK4_HALO, 3): (
        (101, 12, 32),
        (201, 16, 64),
        (321, 20, 96),
        (641, 32, 96),
        (1025, 32, 96),
    ),
    (CAHN_HILLIARD_HALO, 2): (
        (101, 8, 32),
        (201, 8, 32),
        (321, 16, 32),
        (641, 32, 64),
        (1025, 12, 96),
    ),
}


class SystemTilePlan(NamedTuple):
    """How blocks of ``rows x cols`` shared-memory cells, of which a ring
    of ``halo`` cells is halo, cover an H x W grid of n-component
    states."""

    height: int
    width: int
    n_components: int
    halo: int
    rows: int
    cols: int

    @property
    def tile_h(self) -> int:
        return self.rows - 2 * self.halo

    @property
    def tile_w(self) -> int:
        return self.cols - 2 * self.halo

    @property
    def n_tiles_h(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def n_tiles_w(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def blocks(self) -> int:
        return self.n_tiles_h * self.n_tiles_w

    @property
    def shared_bytes(self) -> int:
        """The state, two stage buffers and the RK4 accumulator: four
        float planes a component."""
        return 16 * self.n_components * self.rows * self.cols

    @property
    def starts_h(self) -> Tuple[int, ...]:
        """Each tile row's first grid row: the last is clamped inside the
        grid and overlaps its neighbour."""
        last = max(self.height - self.tile_h, 0)
        return tuple(
            min(t * self.tile_h, last) for t in range(self.n_tiles_h)
        )

    @property
    def starts_w(self) -> Tuple[int, ...]:
        last = max(self.width - self.tile_w, 0)
        return tuple(
            min(t * self.tile_w, last) for t in range(self.n_tiles_w)
        )


def make_system_tile_plan(
    height: int, width: int, n_components: int, halo: int = RK4_HALO
) -> Optional[SystemTilePlan]:
    """Plans the 2D tiling of an H x W grid of n-component states with a
    halo of ``halo`` cells from ``_MEASURED_TILES``, or returns None for a
    grid under 3 x 3 or a halo and component count the table does not
    hold (no family of the kernel has them)."""
    entries = _MEASURED_TILES.get((halo, n_components))
    if entries is None or min(height, width) < 3:
        return None
    side = math.sqrt(height * width)
    _, rows, cols = min(
        entries, key=lambda entry: abs(math.log(side / entry[0]))
    )
    return SystemTilePlan(height, width, n_components, halo, rows, cols)


def _halo(diff_eq) -> int:
    return (
        CAHN_HILLIARD_HALO
        if isinstance(diff_eq, CahnHilliardEquation)
        else RK4_HALO
    )


def tiled_system_applicable(cp: ConstrainedProblem) -> bool:
    """Whether the tiled system kernel takes this (already
    type/BC/integrator-gated) problem's grid: one the cluster-resident
    mode does not take
    (:func:`pararealml_tpu_torch.ops.fused_system.cluster_system_applicable`:
    past the JAX package's VMEM cap, or past the mode's range), with a
    tile plan and its Dirichlet constraints on its faces."""
    diff_eq = cp.differential_equation
    if isinstance(diff_eq, NavierStokesEquation) or cluster_system_applicable(
        cp
    ):
        return False
    return (
        make_system_tile_plan(
            *cp.mesh.vertices_shape, diff_eq.y_dimension, _halo(diff_eq)
        )
        is not None
        and dirichlet_is_face_only(cp)
    )


def _component_face_tensors(
    cp: ConstrainedProblem, n: int
) -> Dict[str, np.ndarray]:
    """Per-component face vectors, unpadded, in K8's argument order:
    Dirichlet and Neumann-ghost rows ``(2 faces, n, W)`` and columns
    ``(2 faces, n, H)``, the lower face first, values zeroed where the
    mask is unset and kept float64 (the JAX package's
    ``_component_face_tensors`` without the TPU padding and per-tile
    slicing). The ghost vectors are the ones K5 reads."""
    dir_mask, dir_vals = _dirichlet_grids(cp, n)  # (n, H, W)
    ghost = _ghost_faces(cp, n)
    return dict(
        dir_row_mask=np.stack([dir_mask[:, 0, :], dir_mask[:, -1, :]]),
        dir_row_vals=np.stack([dir_vals[:, 0, :], dir_vals[:, -1, :]]),
        ghost_row_mask=ghost["ghost_row_mask"],
        ghost_row_vals=ghost["ghost_row_vals"],
        dir_col_mask=np.stack([dir_mask[:, :, 0], dir_mask[:, :, -1]]),
        dir_col_vals=np.stack([dir_vals[:, :, 0], dir_vals[:, :, -1]]),
        ghost_col_mask=ghost["ghost_col_mask"],
        ghost_col_vals=ghost["ghost_col_vals"],
    )


class _TiledSystemConfig(_SystemKernelConfig):
    """K5's configuration with K8's face vectors in place of K5's
    Dirichlet grids, and the tile plan."""

    def __init__(self, cp: ConstrainedProblem, d_t: float):
        super().__init__(cp, d_t)
        self.halo = _halo(cp.differential_equation)
        self.plan = make_system_tile_plan(
            self.height, self.width, self.n, self.halo
        )

    def _constraint_arrays(self, cp: ConstrainedProblem):
        return _component_face_tensors(cp, self.n)


# -- plain PyTorch version ----------------------------------------------------


def _tiled_step_reference(
    state: torch.Tensor,
    cfg: _TiledSystemConfig,
    faces: Tuple[torch.Tensor, ...],
) -> torch.Tensor:
    """One K8 step over ``(..., H, W, n)`` float32 states: the tiled
    helpers' Laplacian (on a polar mesh K5's helpers with 1 / r) and the
    Dirichlet face vectors, rows then columns (``make_dirichlet`` of the
    JAX kernel). Out-of-grid neighbours read as zero."""
    height, width = cfg.height, cfg.width
    drm, drv, grm, grv, dcm, dcv, gcm, gcv = faces[:8]
    if cfg.polar:
        helpers = _Helpers(cfg, (grm, grv, gcm, gcv), inv_r=faces[8])
    else:
        helpers = _Helpers(cfg, (grm, grv, gcm, gcv), sum_then_ghost=True)

    def dirichlet(comp, plane):
        plane = torch.cat(
            [
                torch.where(drm[0, comp], drv[0, comp], plane[..., 0, :])[
                    ..., None, :
                ],
                plane[..., 1: height - 1, :],
                torch.where(
                    drm[1, comp], drv[1, comp], plane[..., height - 1, :]
                )[..., None, :],
            ],
            dim=-2,
        )
        return torch.cat(
            [
                torch.where(dcm[0, comp], dcv[0, comp], plane[..., :, 0])[
                    ..., :, None
                ],
                plane[..., :, 1: width - 1],
                torch.where(
                    dcm[1, comp], dcv[1, comp], plane[..., :, width - 1]
                )[..., :, None],
            ],
            dim=-1,
        )

    return _step_reference(state, cfg, helpers, dirichlet)


def _check_storage_dtype(storage_dtype) -> torch.dtype:
    storage_dtype = storage_dtype or torch.float32
    if storage_dtype not in _DTYPES:
        raise ValueError(
            f"storage_dtype must be float32 or bfloat16, got {storage_dtype}"
        )
    return storage_dtype


def tiled_system_rk4_trajectory_reference(
    y: torch.Tensor,
    cfg: _TiledSystemConfig,
    n_steps: int,
    storage_dtype=None,
) -> torch.Tensor:
    """Plain version of K8: ``(..., H, W, n) -> (..., n_steps, H, W, n)``
    in ``storage_dtype`` (``y``'s dtype when None), the arithmetic in
    ``y``'s dtype. The initial state and every frame, which is the state
    the next step starts from, are rounded to the stored dtype once."""
    if storage_dtype is None:
        storage_dtype = y.dtype
    else:
        storage_dtype = _check_storage_dtype(storage_dtype)
    faces = cfg.constants(y.device, y.dtype)
    out = torch.empty(
        tuple(y.shape[:-3]) + (n_steps,) + tuple(y.shape[-3:]),
        dtype=storage_dtype,
        device=y.device,
    )
    stored = y.to(storage_dtype)
    for k in range(n_steps):
        state = _tiled_step_reference(stored.to(y.dtype), cfg, faces)
        stored = state.to(storage_dtype)
        out[..., k, :, :, :] = stored
    return out


def tiled_system_rk4_end_reference(
    y: torch.Tensor, cfg: _TiledSystemConfig, n_steps: int
) -> torch.Tensor:
    """Plain version of K8's end mode: ``(..., H, W, n) -> (..., H, W,
    n)``, every step in ``y``'s dtype and only the end state kept."""
    faces = cfg.constants(y.device, y.dtype)
    state = y
    for _ in range(n_steps):
        state = _tiled_step_reference(state, cfg, faces)
    return state


# -- kernel wrappers ----------------------------------------------------------


def _configure(library: ctypes.CDLL):
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    library.tiled_system_rk4.argtypes = (
        [c_int, c_int, c_void_p, c_void_p]
        + [c_int] * 8
        + [ctypes.c_size_t]
        + [c_void_p] * 9
        + [ctypes.POINTER(ctypes.c_float), c_void_p]
    )
    library.tiled_system_rk4.restype = c_int
    library.tiled_system_rk4_end.argtypes = (
        [c_int, c_int, c_void_p, c_void_p, c_void_p]
        + [c_int] * 7
        + [ctypes.c_size_t]
        + [c_void_p] * 9
        + [ctypes.POINTER(ctypes.c_float), c_void_p]
    )
    library.tiled_system_rk4_end.restype = c_int
    library.tiled_system_error_string.argtypes = [c_int]
    library.tiled_system_error_string.restype = ctypes.c_char_p


def load_kernels() -> ctypes.CDLL:
    """The built and loaded kernel library (compiled on first use)."""
    from pararealml_tpu_torch.ops.cuda_library import load_library

    library = load_library("tiled_system")
    if not getattr(library, "_signatures_set", False):
        _configure(library)
        library._signatures_set = True
    return library


def _checked_plan(
    cfg: _TiledSystemConfig, plan: Optional[SystemTilePlan]
) -> SystemTilePlan:
    """``plan`` (the configuration's own when None), or a ValueError, on
    any device and before any launch, when there is none or it does not
    fit the problem (another grid, a halo too narrow for the equation,
    too much shared memory)."""
    plan = cfg.plan if plan is None else plan
    if plan is None:
        raise ValueError("grid outside the tiled kernel's range")
    if (
        plan.halo < cfg.halo
        or (plan.height, plan.width, plan.n_components)
        != (cfg.height, cfg.width, cfg.n)
        or plan.shared_bytes > MAX_SHARED_MEMORY_BYTES
    ):
        raise ValueError(
            f"tile plan {plan} does not fit this {cfg.height} x {cfg.width} "
            f"x {cfg.n} problem (halo {cfg.halo} needed)"
        )
    return plan


def _raise_on_error(library: ctypes.CDLL, error: int, plan: SystemTilePlan):
    if error != 0:
        message = library.tiled_system_error_string(error).decode()
        raise RuntimeError(
            f"tiled system kernel launch failed with {plan.rows} x "
            f"{plan.cols} tiles of {plan.shared_bytes} bytes of shared "
            f"memory: {message} ({error})"
        )


def tiled_system_rk4_trajectory(
    y: torch.Tensor,
    cfg: _TiledSystemConfig,
    n_steps: int,
    storage_dtype=None,
    plan: Optional[SystemTilePlan] = None,
) -> torch.Tensor:
    """K8: ``n_steps`` RK4 steps storing every step, ``(H, W, n) ->
    (n_steps, H, W, n)`` or ``(B, H, W, n) -> (B, n_steps, H, W, n)`` in
    ``storage_dtype``: one CUDA launch per step over every tile of every
    state. ``plan`` overrides the tile plan (to exercise other tilings on
    a small grid). It raises, on any device and before any launch, when
    there is no plan or the plan does not fit the problem (another grid,
    a halo too narrow for the equation, too much shared memory)."""
    cfg.check_state(y)
    storage_dtype = _check_storage_dtype(storage_dtype)
    plan = _checked_plan(cfg, plan)
    if y.device.type == "cpu":
        return tiled_system_rk4_trajectory_reference(
            y, cfg, n_steps, storage_dtype
        )
    library = load_kernels()
    constants = cfg.constants(y.device)
    batch = y.reshape((-1,) + cfg.state_shape)
    out = torch.empty(
        (batch.shape[0], n_steps) + cfg.state_shape,
        dtype=storage_dtype,
        device=y.device,
    )
    # the ctypes launch targets the current device: make it y's
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        error = library.tiled_system_rk4(
            cfg.equation,
            int(cfg.polar),
            batch.data_ptr(),
            out.data_ptr(),
            batch.shape[0],
            cfg.height,
            cfg.width,
            n_steps,
            int(storage_dtype == torch.bfloat16),
            plan.rows,
            plan.cols,
            plan.halo,
            plan.shared_bytes,
            *(c.data_ptr() for c in constants[:8]),
            constants[8].data_ptr() if cfg.polar else None,
            cfg.coefficient_array(),
            stream,
        )
    _raise_on_error(library, error, plan)
    tiled_system_rk4_trajectory.launches += 1
    return out if y.ndim == 4 else out[0]


def tiled_system_rk4_end(
    y: torch.Tensor,
    cfg: _TiledSystemConfig,
    n_steps: int,
    plan: Optional[SystemTilePlan] = None,
) -> torch.Tensor:
    """K8's end mode: ``n_steps`` RK4 steps returning the end state only,
    ``(H, W, n) -> (H, W, n)`` or ``(B, H, W, n) -> (B, H, W, n)``, in
    float32: the trajectory's kernel, one CUDA launch per step over every
    tile of every state, stepping between two float32 state buffers
    instead of storing frames. ``plan`` overrides the tile plan; a grid
    without one, or a plan that does not fit, raises before any launch."""
    cfg.check_state(y)
    plan = _checked_plan(cfg, plan)
    if y.device.type == "cpu":
        return tiled_system_rk4_end_reference(y, cfg, n_steps)
    library = load_kernels()
    constants = cfg.constants(y.device)
    batch = y.reshape((-1,) + cfg.state_shape)
    out = torch.empty_like(batch)
    scratch = torch.empty_like(batch) if n_steps > 1 else None
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        error = library.tiled_system_rk4_end(
            cfg.equation,
            int(cfg.polar),
            batch.data_ptr(),
            out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            batch.shape[0],
            cfg.height,
            cfg.width,
            n_steps,
            plan.rows,
            plan.cols,
            plan.halo,
            plan.shared_bytes,
            *(c.data_ptr() for c in constants[:8]),
            constants[8].data_ptr() if cfg.polar else None,
            cfg.coefficient_array(),
            stream,
        )
    _raise_on_error(library, error, plan)
    tiled_system_rk4_end.launches += 1
    return out.reshape(y.shape)


tiled_system_rk4_trajectory.launches = 0
tiled_system_rk4_end.launches = 0


# -- build function mirroring the JAX package's API -------------------------


def _tiled_config(cp: ConstrainedProblem, d_t: float) -> _TiledSystemConfig:
    """K8's configuration for ``cp``, or a ValueError where K8 does not
    cover it (Navier-Stokes, a grid without a tile plan, interior
    Dirichlet constraints)."""
    diff_eq = cp.differential_equation
    if isinstance(diff_eq, NavierStokesEquation):
        raise ValueError(
            "the Navier-Stokes stream-function solve iterates over the "
            "whole grid and cannot be row-tiled"
        )
    height, width = cp.mesh.vertices_shape
    if (
        make_system_tile_plan(
            height, width, diff_eq.y_dimension, _halo(diff_eq)
        )
        is None
    ):
        raise ValueError("grid outside the tiled kernel's range")
    if not dirichlet_is_face_only(cp):
        raise ValueError(
            "the tiled kernel represents Dirichlet constraints as face "
            "vectors; interior static y constraints are not supported"
        )
    return _TiledSystemConfig(cp, d_t)


def build_tiled_system_rk4_trajectory(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    storage_dtype=None,
):
    """Builds ``trajectory(y) -> ys`` computing ``n_steps`` fused RK4
    system steps through K8: ``(..., H, W, n) -> (..., n_steps, H, W, n)``
    in ``storage_dtype``, one launch sequence over every leading index.
    Matches :func:`pararealml_tpu_torch.ops.fused_system.
    build_fused_system_rk4_trajectory`'s K5 to float32 rounding (on a
    polar mesh bit for bit).

    ``storage_dtype`` selects the precision of the stored trajectory and
    of the state carried from step to step (``torch.float32`` by default;
    ``torch.bfloat16`` halves the kernel's traffic while all stencil
    arithmetic stays float32: tiles convert on load and round once per
    step on store)."""
    storage_dtype = _check_storage_dtype(storage_dtype)
    cfg = _tiled_config(cp, d_t)

    def trajectory(y: torch.Tensor) -> torch.Tensor:
        lead, batch = states(y, cfg)
        out = tiled_system_rk4_trajectory(batch, cfg, n_steps, storage_dtype)
        return out.reshape(lead + (n_steps,) + cfg.state_shape)

    return trajectory


def build_tiled_system_rk4_end(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    batch: Optional[int] = None,
):
    """Builds ``end(y) -> y_final`` advancing ``n_steps`` fused RK4 system
    steps through K8's end mode and returning only the final state, in
    float32: with ``batch=B`` it maps ``(B, H, W, n) -> (B, H, W, n)``,
    every state in one launch a step (Parareal's fine ends, one state per
    time slice); otherwise one ``(H, W, n)`` state. Raises ValueError
    where K8 does not cover the problem, as the trajectory builder does.
    The storage dtype knobs do not reach it: the JAX package's ends are
    float32 on both sides of its VMEM cap (its K5 end below it, its
    generic loop past it)."""
    cfg = _tiled_config(cp, d_t)
    expected_lead = () if batch is None else (batch,)

    def end(y: torch.Tensor) -> torch.Tensor:
        lead, states_ = states(y, cfg)
        if lead != expected_lead:
            raise ValueError(
                f"expected leading shape {expected_lead}, got {lead}"
            )
        return tiled_system_rk4_end(states_, cfg, n_steps).reshape(y.shape)

    return end
