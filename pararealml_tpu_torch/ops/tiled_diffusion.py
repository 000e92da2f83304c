"""Tiled RK4 trajectory kernel for large-grid 2D diffusion problems (K6).

Port of the JAX package's ``ops/tiled_diffusion.py``. The Pallas TPU
kernel there streams row tiles of a state that lives in device memory
through one core. Its counterpart for Hopper is a hand-written CUDA
kernel, ``csrc/tiled_diffusion.cu``, launched once per residency: a grid
of thread blocks covers the state with 2D tiles, each block loads its
tile with a ``4 * temporal_block``-cell halo into shared memory, advances
it ``temporal_block`` RK4 steps there (the halo shrinks by one ring per
stage) and writes its part of every step's frame of the trajectory.

Each step is the **Horner form of RK4**: for the affine semi-discrete
system (diffusion and convection with static boundary conditions), classic
RK4 with per-stage Dirichlet stamping equals the nested evaluation
``t <- D(y + (d_t / k) * rhs(t))`` for ``k = 4, 3, 2, 1``, which needs no
``k1..k4`` temporaries. The stage coefficient and the diffusion coefficient
are folded into the stencil taps on the host, each rounded once to
float32; boundary conditions are face vectors. The evaluation order is the
JAX kernel's, term for term, so the kernel agrees with the whole-grid
classic-RK4 kernel of :mod:`pararealml_tpu_torch.ops.fused_diffusion` to
float32 rounding, not bit for bit.

``storage_dtype=torch.bfloat16`` keeps the state that is carried from one
residency to the next in bfloat16 (rounded once per residency, to nearest
even) while all arithmetic stays float32; ``traj_dtype`` selects the
precision of the stored frames independently (it needs
``temporal_block >= 2``, as in the JAX package). The trajectory is
returned in ``traj_dtype``.

The module also holds what the resident kernel
(:mod:`pararealml_tpu_torch.ops.resident_diffusion`, K7) shares with this
one: the face vectors, the per-stage coefficients and the plain PyTorch
Horner step.

``tiled_diffusion_rk4_trajectory`` launches the kernel for a CUDA tensor
and runs ``tiled_diffusion_rk4_trajectory_reference``, the plain PyTorch
version with the kernel's evaluation order, for a CPU tensor. On a CUDA
tensor the kernel runs or the wrapper raises. ``launches`` counts the
wrapper's kernel runs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.differential_equation import (
    ConvectionDiffusionEquation,
)

# the shared-memory tile of one thread block, halo included: three float
# buffers of this size (96 KB) let two blocks share an SM
_TILE_ROWS = 64
_TILE_COLS = 128

_DTYPES = (torch.float32, torch.bfloat16)


class _TilePlan(NamedTuple):
    halo: int
    tile_h: int
    tile_w: int
    n_tiles_h: int
    n_tiles_w: int
    smem_rows: int
    smem_cols: int

    @property
    def shared_bytes(self) -> int:
        return 3 * 4 * self.smem_rows * self.smem_cols


def make_tile_plan(
    height: int,
    width: int,
    temporal_block: int = 1,
    tile_rows: int = _TILE_ROWS,
    tile_cols: int = _TILE_COLS,
) -> Optional[_TilePlan]:
    """Plans the 2D tiling of a grid, or returns None when the temporal
    block's halo leaves no worthwhile tile.

    A block's shared-memory tile is ``tile_rows x tile_cols`` cells, of
    which a ring of ``4 * temporal_block`` cells on every side is halo
    (one RK4 step's four chained stencil stages need 4) and the rest is
    the tile the block advances. The plan is feasible while the tile is
    at least as tall and as wide as its halo, which bounds the redundant
    halo work. Unlike the JAX package's row-tile plan there is no cap on
    the grid's height or width: tiles are 2D and their count is the
    launch grid, so any grid of at least 3 x 3 vertices plans at
    ``temporal_block=1``."""
    temporal_block = int(temporal_block)
    if temporal_block < 1 or min(height, width) < 3:
        return None
    halo = 4 * temporal_block
    tile_h = tile_rows - 2 * halo
    tile_w = tile_cols - 2 * halo
    if tile_h < halo or tile_w < halo:
        return None
    return _TilePlan(
        halo=halo,
        tile_h=tile_h,
        tile_w=tile_w,
        n_tiles_h=-(-height // tile_h),
        n_tiles_w=-(-width // tile_w),
        smem_rows=tile_rows,
        smem_cols=tile_cols,
    )


def pick_temporal_block(n_steps: int, requested: int) -> int:
    """Largest valid temporal block <= ``requested``: even and dividing
    ``n_steps``; 1 when no such block exists."""
    for k in range(min(int(requested), n_steps), 1, -1):
        if k % 2 == 0 and n_steps % k == 0:
            return k
    return 1


def takes_streaming_path(cp) -> bool:
    """Whether the fused-diffusion dispatch routes this problem's grid
    to the tiled kernel (too big for both the one-block and the resident
    kernels) — the only path that consumes ``temporal_block`` and
    ``traj_dtype``."""
    from pararealml_tpu_torch.ops.fused_diffusion import fits_one_block
    from pararealml_tpu_torch.ops.resident_diffusion import (
        make_resident_plan,
    )

    shape = cp.mesh.vertices_shape
    return not fits_one_block(*shape) and make_resident_plan(*shape) is None


def resolve_temporal_block(
    cp,
    n_steps: int,
    requested: int,
    storage_dtype=None,
    traj_dtype=None,
) -> int:
    """The temporal block the kernel dispatch will actually run.

    :func:`pick_temporal_block` filters only on parity and divisibility;
    when the grid takes the tiled path, a large block also widens every
    tile's halo (``4 * block`` cells on each side), which can leave
    :func:`make_tile_plan` without a feasible tile. This resolver steps
    the block down through the valid divisors until the plan is feasible,
    settling on 1 when no divisor qualifies. Grids that do not stream
    (the one-block and resident kernels ignore the block) keep the
    parity/divisibility pick. The dtypes do not change the port's plan;
    they are accepted for parity with the JAX package's signature."""
    if not takes_streaming_path(cp):
        return pick_temporal_block(n_steps, requested)
    height, width = cp.mesh.vertices_shape
    for k in range(min(int(requested), n_steps), 1, -1):
        if (
            k % 2 == 0
            and n_steps % k == 0
            and make_tile_plan(height, width, k) is not None
        ):
            return k
    return 1


def _static_dirichlet(cp: ConstrainedProblem):
    """The dense ``(mask, values)`` grids of the static y constraints,
    values zeroed where the mask is unset."""
    height, width = cp.mesh.vertices_shape
    constraint = cp.static_y_vertex_constraints
    if constraint is None:
        return np.zeros((height, width), bool), np.zeros((height, width))
    mask = np.asarray(constraint.mask).reshape(height, width)
    values = np.asarray(constraint.values).reshape(height, width)
    return mask, np.where(mask, values, 0.0)


def dirichlet_is_face_only(cp: ConstrainedProblem) -> bool:
    """Whether all static y constraints lie on the grid faces (always
    the case for constraints created from boundary conditions; a
    necessary condition for the face-vector representation)."""
    constraint = cp.static_y_vertex_constraints
    if constraint is None:
        return True
    mask = np.asarray(constraint.mask).reshape(
        tuple(cp.mesh.vertices_shape) + (-1,)
    )
    return not mask[1:-1, 1:-1].any()


def _face_tensors(cp: ConstrainedProblem) -> Dict[str, object]:
    """Extracts the per-face Dirichlet and Neumann-ghost vectors: row
    vectors are ``(2, W)`` (the lower then the upper face of axis 0),
    column vectors ``(2, H)``, values premasked; plus whether the ghost
    columns fold into the stencil taps."""
    from pararealml_tpu_torch.ops.fused_diffusion import _face_vectors

    height, width = cp.mesh.vertices_shape
    dir_mask, dir_vals = _static_dirichlet(cp)

    d_y = cp.static_boundary_vertex_constraints.d_y
    (g_row_lo_m, g_row_lo_v), (g_row_hi_m, g_row_hi_v) = _face_vectors(
        d_y[0], width
    )
    (g_col_lo_m, g_col_lo_v), (g_col_hi_m, g_col_hi_v) = _face_vectors(
        d_y[1], height
    )

    # Foldability of the ghost-column fixes into the stencil taps: when
    # both column faces are zero-flux with masks covering every row that
    # is not fully rebuilt by a Dirichlet row stamp, the mirror ghost at
    # a boundary column equals the inward neighbour, so the whole
    # per-stage fix collapses to doubling that neighbour's tap (rows the
    # condition exempts are overwritten by the row stamp either way).
    # The fold changes the arithmetic, so it is part of the result.
    full_dir_rows = set()
    if dir_mask[0, :].all():
        full_dir_rows.add(0)
    if dir_mask[-1, :].all():
        full_dir_rows.add(height - 1)
    interior_rows = np.asarray(
        [r for r in range(height) if r not in full_dir_rows], int
    )
    ghost_col_foldable = bool(
        not g_col_lo_v[interior_rows].any()
        and not g_col_hi_v[interior_rows].any()
        and g_col_lo_m[interior_rows].all()
        and g_col_hi_m[interior_rows].all()
    )

    def stack(lo, hi, dtype):
        return np.stack([lo, hi]).astype(dtype)

    f32 = np.float32
    return dict(
        ghost_col_foldable=ghost_col_foldable,
        dir_row_mask=stack(dir_mask[0], dir_mask[-1], bool),
        dir_row_vals=stack(dir_vals[0], dir_vals[-1], f32),
        dir_col_mask=stack(dir_mask[:, 0], dir_mask[:, -1], bool),
        dir_col_vals=stack(
            dir_vals[:, 0] * dir_mask[:, 0],
            dir_vals[:, -1] * dir_mask[:, -1],
            f32,
        ),
        ghost_row_mask=stack(g_row_lo_m, g_row_hi_m, bool),
        ghost_row_vals=stack(g_row_lo_v, g_row_hi_v, f32),
        ghost_col_mask=stack(g_col_lo_m, g_col_hi_m, bool),
        ghost_col_vals=stack(
            g_col_lo_v * g_col_lo_m, g_col_hi_v * g_col_hi_m, f32
        ),
    )


# the kernels read the face vectors from two flat tensors in this order
_FACE_NAMES = ("dir_row", "ghost_row", "dir_col", "ghost_col")


class _StageCoefficients(NamedTuple):
    """One Horner stage's float32 constants: the stencil taps with the
    stage and diffusion coefficients folded in, and the convection
    factors."""

    a0: float
    a1: float
    a_center: float
    cv0: float
    cv1: float
    flux0: float
    flux1: float


class _HornerConfig:
    """Static configuration of the Horner-form kernels for one problem:
    grid geometry, the per-stage coefficients and the face vectors
    (copied to each device a state arrives on, once).

    ``resident`` selects how the coefficients are rounded: the tiled
    kernel of the JAX package builds them from float32 inverse spacings
    and float32 stage coefficients, its resident kernel from unrounded
    float64 ones. Each is kept as its module has it, so the two kernels
    agree to float32 rounding, not bit for bit."""

    def __init__(
        self,
        cp: ConstrainedProblem,
        d_t: float,
        diffusion_coefficient: Optional[float] = None,
        resident: bool = False,
    ):
        diff_eq = cp.differential_equation
        mesh = cp.mesh
        self.height, self.width = mesh.vertices_shape
        d_x0, d_x1 = mesh.d_x
        if diffusion_coefficient is None:
            diffusion_coefficient = diff_eq._d
        d = float(diffusion_coefficient)
        if isinstance(diff_eq, ConvectionDiffusionEquation):
            velocity = tuple(float(v) for v in diff_eq._velocity)
        else:
            velocity = (0.0, 0.0)
        self.has_convection = any(v != 0.0 for v in velocity)

        f32 = np.float32
        stages = []
        if resident:
            inv_dx0_sqr = 1.0 / float(d_x0) ** 2
            inv_dx1_sqr = 1.0 / float(d_x1) ** 2
            inv_two_dx0 = 1.0 / (2.0 * float(d_x0))
            inv_two_dx1 = 1.0 / (2.0 * float(d_x1))
            for k in (4.0, 3.0, 2.0, 1.0):
                c = float(d_t) / k
                stages.append(
                    _StageCoefficients(
                        a0=f32(c * d * inv_dx0_sqr),
                        a1=f32(c * d * inv_dx1_sqr),
                        a_center=f32(
                            -2.0 * c * d * (inv_dx0_sqr + inv_dx1_sqr)
                        ),
                        cv0=f32(-c * velocity[0] * inv_two_dx0),
                        cv1=f32(-c * velocity[1] * inv_two_dx1),
                        flux0=f32(-c * velocity[0]),
                        flux1=f32(-c * velocity[1]),
                    )
                )
        else:
            inv_dx0_sqr = f32(1.0 / float(d_x0) ** 2)
            inv_dx1_sqr = f32(1.0 / float(d_x1) ** 2)
            center_tap = f32(-2.0 * (inv_dx0_sqr + inv_dx1_sqr))
            inv_two_dx0 = f32(1.0 / (2.0 * float(d_x0)))
            inv_two_dx1 = f32(1.0 / (2.0 * float(d_x1)))
            for k in (4.0, 3.0, 2.0, 1.0):
                c = float(f32(float(d_t) / k))
                stages.append(
                    _StageCoefficients(
                        a0=f32(c * d * float(inv_dx0_sqr)),
                        a1=f32(c * d * float(inv_dx1_sqr)),
                        a_center=f32(c * d * float(center_tap)),
                        cv0=f32(-c * velocity[0] * inv_two_dx0),
                        cv1=f32(-c * velocity[1] * inv_two_dx1),
                        flux0=f32(-c * velocity[0]),
                        flux1=f32(-c * velocity[1]),
                    )
                )
        self.stages: Tuple[_StageCoefficients, ...] = tuple(
            _StageCoefficients(*(float(v) for v in stage)) for stage in stages
        )
        # square cells take the single-sum branch, decided on the
        # rounded taps as in the JAX kernels
        self.square = tuple(stage.a0 == stage.a1 for stage in self.stages)
        self.two_dx0 = float(f32(2.0 * float(d_x0)))
        self.two_dx1 = float(f32(2.0 * float(d_x1)))

        faces = _face_tensors(cp)
        self.fold_cols = bool(
            faces["ghost_col_mask"].any() and faces["ghost_col_foldable"]
        )
        # constraints inside the grid: the dense Dirichlet grid, which the
        # resident kernel applies after every stage (the tiled kernel
        # refuses them)
        self.interior_dirichlet = not dirichlet_is_face_only(cp)
        if self.interior_dirichlet:
            mask, values = _static_dirichlet(cp)
            faces["interior_mask"] = mask.astype(bool)
            faces["interior_vals"] = values.astype(np.float32)
        self._host_faces = faces
        self._constants: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        self._interior: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        self._faces: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    @property
    def flops_per_cell_step(self) -> int:
        """Float32 operations of one RK4 step per cell, counted from the
        four Horner stages away from the faces: the Laplacian (6
        operations on square cells, 7 otherwise), the stage update (1)
        and, with convection, two central differences and their two
        additions (6)."""
        per_stage = [
            (6 if square else 7) + 1 + (6 if self.has_convection else 0)
            for square in self.square
        ]
        return sum(per_stage)

    def coefficient_array(self):
        """The kernels' coefficient argument: 4 x (a0, a1, a_center,
        cv0, cv1, flux0, flux1), then the doubled spacings, as C
        floats."""
        flat = [v for stage in self.stages for v in stage]
        flat += [self.two_dx0, self.two_dx1]
        return (ctypes.c_float * len(flat))(*flat)

    def interior(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The dense Dirichlet grid on ``device`` as the resident kernel
        reads it, an ``(H, W)`` byte mask and float32 values, or ``()``
        where every constraint lies on a face."""
        if not self.interior_dirichlet:
            return ()
        grid = self._interior.get(device)
        if grid is None:
            grid = (
                torch.as_tensor(
                    self._host_faces["interior_mask"].astype(np.uint8)
                ).to(device),
                torch.as_tensor(self._host_faces["interior_vals"]).to(device),
            )
            self._interior[device] = grid
        return grid

    def faces(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The face vectors (and the dense Dirichlet grid where
        constraints lie inside the grid) on ``device`` for the plain
        version."""
        faces = self._faces.get(device)
        if faces is None:
            faces = {
                name: torch.as_tensor(value).to(device)
                for name, value in self._host_faces.items()
                if name != "ghost_col_foldable"
            }
            self._faces[device] = faces
        return faces

    def constants(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The face vectors on ``device`` as the kernels read them: one
        flat byte tensor of masks and one flat float tensor of values,
        each ``dir_row (2W) | ghost_row (2W) | dir_col (2H) | ghost_col
        (2H)``."""
        constants = self._constants.get(device)
        if constants is None:
            masks = np.concatenate(
                [
                    self._host_faces[f"{name}_mask"].reshape(-1)
                    for name in _FACE_NAMES
                ]
            ).astype(np.uint8)
            values = np.concatenate(
                [
                    self._host_faces[f"{name}_vals"].reshape(-1)
                    for name in _FACE_NAMES
                ]
            ).astype(np.float32)
            constants = (
                torch.as_tensor(masks).to(device).contiguous(),
                torch.as_tensor(values).to(device).contiguous(),
            )
            self._constants[device] = constants
        return constants

    def check_state(self, y: torch.Tensor):
        """Raises unless ``y`` is a contiguous float32 ``(H, W)`` or
        ``(B, H, W)`` tensor on the CPU or a CUDA device."""
        if y.dtype != torch.float32:
            raise TypeError(
                f"the Horner-form diffusion kernels take float32, got "
                f"{y.dtype}"
            )
        if y.ndim not in (2, 3) or tuple(y.shape[-2:]) != (
            self.height,
            self.width,
        ):
            raise ValueError(
                f"expected a state of shape (H, W) or (B, H, W) with "
                f"(H, W) = {(self.height, self.width)}, got "
                f"{tuple(y.shape)}"
            )
        if y.ndim == 3 and y.shape[0] == 0:
            raise ValueError("the batch of states is empty")
        if not y.is_contiguous():
            raise ValueError("the state must be contiguous")
        if y.device.type not in ("cpu", "cuda"):
            raise ValueError(
                f"unsupported device {y.device} (expected cpu or cuda)"
            )


# -- plain PyTorch versions -------------------------------------------------


def _horner_step_reference(
    y: torch.Tensor, cfg: _HornerConfig, faces: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """One Horner-form RK4 step over ``(..., H, W)`` float32 states, in
    the kernels' (and the JAX kernels' ``one_step``) evaluation order.
    Out-of-grid neighbours read as zero. Where ``faces`` holds the dense
    Dirichlet grid (constraints inside the grid; the resident kernel),
    it overrides every constrained cell after each stage, where the
    whole-grid kernel K1 applies its grid."""
    height, width = cfg.height, cfg.width
    drm, drv = faces["dir_row_mask"], faces["dir_row_vals"]
    dcm, dcv = faces["dir_col_mask"], faces["dir_col_vals"]
    grm, grv = faces["ghost_row_mask"], faces["ghost_row_vals"]
    gcm, gcv = faces["ghost_col_mask"], faces["ghost_col_vals"]

    def set_rows(grid, top, bottom):
        return torch.cat(
            [top[..., None, :], grid[..., 1: height - 1, :],
             bottom[..., None, :]],
            dim=-2,
        )

    def set_cols(grid, first, last):
        return torch.cat(
            [first[..., :, None], grid[..., :, 1: width - 1],
             last[..., :, None]],
            dim=-1,
        )

    def clamp(s):
        s = set_rows(
            s,
            torch.where(drm[0], drv[0], s[..., 0, :]),
            torch.where(drm[1], drv[1], s[..., height - 1, :]),
        )
        return set_cols(
            s,
            torch.where(dcm[0], dcv[0], s[..., :, 0]),
            torch.where(dcm[1], dcv[1], s[..., :, width - 1]),
        )

    def scaled_update(s, stage, square):
        zero_row = torch.zeros_like(s[..., :1, :])
        zero_col = torch.zeros_like(s[..., :, :1])
        above = torch.cat([zero_row, s[..., :-1, :]], dim=-2)
        below = torch.cat([s[..., 1:, :], zero_row], dim=-2)
        left = torch.cat([zero_col, s[..., :, :-1]], dim=-1)
        right = torch.cat([s[..., :, 1:], zero_col], dim=-1)
        if cfg.fold_cols:
            # zero-flux mirror ghosts folded into the lateral taps
            left_tap = set_cols(
                left, left[..., :, 0], left[..., :, width - 1] * 2.0
            )
            right_tap = set_cols(
                right, right[..., :, 0] * 2.0, right[..., :, width - 1]
            )
        else:
            left_tap, right_tap = left, right
        if square:
            lap = (above + below + left_tap + right_tap) * stage.a0 + (
                s * stage.a_center
            )
        else:
            lap = (
                (above + below) * stage.a0
                + (left_tap + right_tap) * stage.a1
                + s * stage.a_center
            )

        # Neumann ghost rows, added to the boundary rows' Laplacian
        lap = set_rows(
            lap,
            lap[..., 0, :]
            + torch.where(
                grm[0], s[..., 1, :] - cfg.two_dx0 * grv[0], 0.0
            )
            * stage.a0,
            lap[..., height - 1, :]
            + torch.where(
                grm[1], s[..., height - 2, :] + cfg.two_dx0 * grv[1], 0.0
            )
            * stage.a0,
        )
        if not cfg.fold_cols:
            # ghost columns as a fix of the boundary columns
            lap = set_cols(
                lap,
                lap[..., :, 0]
                + torch.where(
                    gcm[0], right[..., :, 0] - cfg.two_dx1 * gcv[0], 0.0
                )
                * stage.a1,
                lap[..., :, width - 1]
                + torch.where(
                    gcm[1],
                    left[..., :, width - 1] + cfg.two_dx1 * gcv[1],
                    0.0,
                )
                * stage.a1,
            )
        update = lap

        if cfg.has_convection:
            gradient_0 = (below - above) * stage.cv0
            gradient_0 = set_rows(
                gradient_0,
                torch.where(
                    grm[0], stage.flux0 * grv[0], gradient_0[..., 0, :]
                ),
                torch.where(
                    grm[1],
                    stage.flux0 * grv[1],
                    gradient_0[..., height - 1, :],
                ),
            )
            gradient_1 = (right - left) * stage.cv1
            if cfg.fold_cols:
                # the boundary-column gradient is the (zero) flux
                gradient_1 = set_cols(
                    gradient_1,
                    gradient_1[..., :, 0] * 0.0,
                    gradient_1[..., :, width - 1] * 0.0,
                )
            else:
                gradient_1 = set_cols(
                    gradient_1,
                    torch.where(
                        gcm[0], stage.flux1 * gcv[0], gradient_1[..., :, 0]
                    ),
                    torch.where(
                        gcm[1],
                        stage.flux1 * gcv[1],
                        gradient_1[..., :, width - 1],
                    ),
                )
            update = update + gradient_0 + gradient_1
        return update

    interior = faces.get("interior_mask")
    t = y
    for stage, square in zip(cfg.stages, cfg.square):
        t = clamp(y + scaled_update(t, stage, square))
        if interior is not None:
            t = torch.where(interior, faces["interior_vals"], t)
    return t


def _check_dtypes(storage_dtype, traj_dtype, temporal_block: int, n_steps):
    """Validates the tiled kernel's options as the JAX package does and
    returns ``(storage_dtype, traj_dtype, temporal_block)`` resolved."""
    storage_dtype = storage_dtype or torch.float32
    traj_dtype = traj_dtype or storage_dtype
    for name, dt in (("storage", storage_dtype), ("traj", traj_dtype)):
        if dt not in _DTYPES:
            raise ValueError(
                f"{name}_dtype must be float32 or bfloat16, got {dt}"
            )
    temporal_block = int(temporal_block)
    if temporal_block < 1:
        raise ValueError("temporal_block must be >= 1")
    if temporal_block > 1:
        if temporal_block % 2:
            raise ValueError("temporal_block must be 1 or even")
        if n_steps % temporal_block:
            raise ValueError(
                f"temporal_block={temporal_block} must divide "
                f"n_steps={n_steps}"
            )
    elif traj_dtype != storage_dtype:
        raise ValueError(
            "split storage/trajectory dtypes require temporal_block "
            ">= 2 (the K=1 pipeline shares one output buffer)"
        )
    return storage_dtype, traj_dtype, temporal_block


def tiled_diffusion_rk4_trajectory_reference(
    y: torch.Tensor,
    cfg: _HornerConfig,
    n_steps: int,
    storage_dtype=None,
    traj_dtype=None,
    temporal_block: int = 1,
) -> torch.Tensor:
    """Plain version of K6: ``(..., H, W) -> (..., n_steps, H, W)`` in
    ``traj_dtype``. The carried state is rounded to ``storage_dtype``
    once per residency (``temporal_block`` chained steps), each frame to
    ``traj_dtype`` once."""
    storage_dtype, traj_dtype, temporal_block = _check_dtypes(
        storage_dtype, traj_dtype, temporal_block, n_steps
    )
    faces = cfg.faces(y.device)
    out = torch.empty(
        tuple(y.shape[:-2]) + (n_steps,) + tuple(y.shape[-2:]),
        dtype=traj_dtype,
        device=y.device,
    )
    stored = y.to(storage_dtype)
    for k in range(n_steps):
        if k % temporal_block == 0:
            state = stored.to(torch.float32)
        state = _horner_step_reference(state, cfg, faces)
        out[..., k, :, :] = state.to(traj_dtype)
        if (k + 1) % temporal_block == 0:
            stored = state.to(storage_dtype)
    return out


# -- kernel wrapper -----------------------------------------------------------


def _configure(library: ctypes.CDLL):
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    # the coefficients (a host array), the two face tensors, the stream
    tail = [ctypes.POINTER(ctypes.c_float), c_void_p, c_void_p, c_void_p]
    library.tiled_diffusion_rk4.argtypes = (
        [c_void_p] * 4 + [c_int] * 11 + tail
    )
    library.tiled_diffusion_rk4.restype = c_int
    library.resident_diffusion_rk4.argtypes = (
        [c_void_p] * 3
        + [c_int] * 13
        + [ctypes.POINTER(ctypes.c_float)]
        + [c_void_p] * 5
    )
    library.resident_diffusion_rk4.restype = c_int
    library.tiled_diffusion_error_string.argtypes = [c_int]
    library.tiled_diffusion_error_string.restype = ctypes.c_char_p


def load_kernels() -> ctypes.CDLL:
    """The built and loaded library of the tiled and the resident kernel
    (compiled on first use)."""
    from pararealml_tpu_torch.ops.cuda_library import load_library

    library = load_library("tiled_diffusion")
    if not getattr(library, "_signatures_set", False):
        _configure(library)
        library._signatures_set = True
    return library


def _raise_on_error(library: ctypes.CDLL, error: int, what: str):
    if error != 0:
        message = library.tiled_diffusion_error_string(error).decode()
        raise RuntimeError(f"{what} launch failed: {message} ({error})")


def tiled_diffusion_rk4_trajectory(
    y: torch.Tensor,
    cfg: _HornerConfig,
    n_steps: int,
    storage_dtype=None,
    traj_dtype=None,
    temporal_block: int = 1,
    plan: Optional[_TilePlan] = None,
) -> torch.Tensor:
    """K6: ``n_steps`` Horner-form RK4 steps storing every step,
    ``(H, W) -> (n_steps, H, W)`` or ``(B, H, W) -> (B, n_steps, H, W)``
    in ``traj_dtype``: one kernel launch per residency of
    ``temporal_block`` steps, one sequence of launches per state.
    ``plan`` overrides the tile plan (to exercise many tiles on a small
    grid)."""
    cfg.check_state(y)
    storage_dtype, traj_dtype, temporal_block = _check_dtypes(
        storage_dtype, traj_dtype, temporal_block, n_steps
    )
    if cfg.interior_dirichlet:
        raise ValueError(
            "the tiled kernel represents Dirichlet constraints as face "
            "vectors; interior static y constraints are not supported"
        )
    if y.device.type == "cpu":
        return tiled_diffusion_rk4_trajectory_reference(
            y, cfg, n_steps, storage_dtype, traj_dtype, temporal_block
        )
    if plan is None:
        plan = make_tile_plan(cfg.height, cfg.width, temporal_block)
    if plan is None or plan.halo != 4 * temporal_block:
        raise ValueError("grid outside the tiled kernel's range")
    library = load_kernels()
    masks, values = cfg.constants(y.device)
    batch = y.reshape(-1, cfg.height, cfg.width)
    out = torch.empty(
        (batch.shape[0], n_steps, cfg.height, cfg.width),
        dtype=traj_dtype,
        device=y.device,
    )
    # frames double as the carried state when both have one dtype;
    # otherwise the state ping-pongs between two buffers of its own
    states = (
        torch.empty(
            (2, cfg.height, cfg.width), dtype=storage_dtype, device=y.device
        )
        if storage_dtype != traj_dtype
        else None
    )
    coefficients = cfg.coefficient_array()
    # the ctypes launch targets the current device: make it y's
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        for b in range(batch.shape[0]):
            error = library.tiled_diffusion_rk4(
                batch[b].data_ptr(),
                out[b].data_ptr(),
                0 if states is None else states[0].data_ptr(),
                0 if states is None else states[1].data_ptr(),
                cfg.height,
                cfg.width,
                n_steps,
                temporal_block,
                int(storage_dtype == torch.bfloat16),
                int(traj_dtype == torch.bfloat16),
                plan.smem_rows,
                plan.smem_cols,
                int(cfg.has_convection),
                int(cfg.fold_cols),
                sum(1 << i for i, square in enumerate(cfg.square) if square),
                coefficients,
                masks.data_ptr(),
                values.data_ptr(),
                stream,
            )
            _raise_on_error(library, error, "tiled diffusion kernel")
    tiled_diffusion_rk4_trajectory.launches += 1
    return out if y.ndim == 3 else out[0]


tiled_diffusion_rk4_trajectory.launches = 0


# -- build function mirroring the JAX package's API -------------------------


def _require_face_only_dirichlet(cp: ConstrainedProblem, kernel: str):
    if not dirichlet_is_face_only(cp):
        raise ValueError(
            f"the {kernel} kernel represents Dirichlet constraints as face "
            "vectors; interior static y constraints are not supported"
        )


def _build_trajectory(cfg: _HornerConfig, n_steps: int, run):
    """``trajectory(y)``: ``(..., H, W, 1) -> (..., n_steps, H, W, 1)``
    over ``run(grids)`` for contiguous ``(B, H, W)`` grids."""
    from pararealml_tpu_torch.ops.fused_diffusion import _grids

    def trajectory(y: torch.Tensor) -> torch.Tensor:
        lead, grids = _grids(y, cfg)
        out = run(grids)
        return out.reshape(lead + (n_steps, cfg.height, cfg.width, 1))

    return trajectory


def build_tiled_diffusion_rk4_trajectory(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    diffusion_coefficient: Optional[float] = None,
    storage_dtype=None,
    traj_dtype=None,
    temporal_block: int = 1,
):
    """Builds ``trajectory(y) -> ys`` computing ``n_steps`` Horner-form
    RK4 diffusion(-convection) steps through K6 on a grid of any size:
    ``(..., H, W, 1) -> (..., n_steps, H, W, 1)`` in ``traj_dtype``.
    Matches :func:`pararealml_tpu_torch.ops.fused_diffusion.
    build_fused_diffusion_rk4_trajectory` to float32 rounding.

    ``storage_dtype`` selects the precision of the state carried between
    residencies (``torch.float32`` by default; ``torch.bfloat16`` halves
    its traffic while all stencil arithmetic stays float32).
    ``traj_dtype`` independently selects the precision of the stored
    frames (defaults to ``storage_dtype``); a frame rounds exactly once.
    ``temporal_block=K`` advances every resident tile K steps per launch
    with a ``4 * K``-cell halo; K must be 1 or even and divide
    ``n_steps``. The per-step arithmetic is identical to ``K=1``: halo
    cells are recomputed instead of reloaded."""
    storage_dtype, traj_dtype, temporal_block = _check_dtypes(
        storage_dtype, traj_dtype, temporal_block, n_steps
    )
    height, width = cp.mesh.vertices_shape
    if make_tile_plan(height, width, temporal_block) is None:
        raise ValueError("grid outside the tiled kernel's range")
    _require_face_only_dirichlet(cp, "tiled")
    cfg = _HornerConfig(cp, d_t, diffusion_coefficient)
    return _build_trajectory(
        cfg,
        n_steps,
        lambda grids: tiled_diffusion_rk4_trajectory(
            grids, cfg, n_steps, storage_dtype, traj_dtype, temporal_block
        ),
    )
