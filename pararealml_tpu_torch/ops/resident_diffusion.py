"""Resident RK4 trajectory kernel for mid-size 2D diffusion grids (K7).

Port of the JAX package's ``ops/resident_diffusion.py``, whose Pallas TPU
kernel keeps the whole state in one core's VMEM for all steps. On Hopper
no single SM holds such a state (641 x 641 float32 is 1.64 MB against
227 KB of shared memory a block), but the card's 132 SMs together do. The
counterpart, in ``csrc/tiled_diffusion.cu``, is one persistent
cooperative kernel: every thread block keeps its 2D tile of the state in
shared memory for all ``n_steps``; every ``steps_per_barrier`` steps it
exchanges a halo of four cells per step with its neighbours through a
small buffer in device memory around one grid-wide barrier, and between
barriers it recomputes the shrinking halo as the tiled kernel does. The
state never round-trips through device memory; the only large traffic is
one frame of the trajectory per step.

The arithmetic is the Horner form of RK4 with face-vector boundary stamps
shared with :mod:`pararealml_tpu_torch.ops.tiled_diffusion` (the
coefficients are rounded as the JAX resident kernel rounds them, from
unrounded float64 factors). ``storage_dtype=torch.bfloat16`` rounds only
the stored frames, to nearest even; the resident state stays float32, so
the bfloat16 error is a single rounding. The trajectory is returned in
``storage_dtype``.

Dirichlet constraints inside the grid (which the tiled kernel K6 refuses)
are a dense mask and value grid that the kernel applies after every
stage, where the whole-grid kernel K1 applies its grid; the face stamps
agree with it where both apply.

``resident_diffusion_rk4_trajectory`` launches the kernel for a CUDA
tensor and runs ``resident_diffusion_rk4_trajectory_reference``, the
plain PyTorch version, for a CPU tensor. On a CUDA tensor the kernel runs
or the wrapper raises. ``launches`` counts the wrapper's kernel runs.

``resident_diffusion_rk4_end`` (plain version
``resident_diffusion_rk4_end_reference``) is the end mode: the same
persistent kernel with no frame stores, which writes the resident tiles
once, after the last step, in float32. It carries the JAX package's end
kernel K2 past one CTA (``build_fused_diffusion_rk4_end``), up to that
package's cap of 504 x 512 padded cells and, as a deliberate difference,
past it as far as the resident plan reaches (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.ops.tiled_diffusion import (
    _DTYPES,
    _build_trajectory,
    _HornerConfig,
    _horner_step_reference,
    _raise_on_error,
    load_kernels,
)

# What the card dictates (NVIDIA H100 SXM): a cooperative launch may hold
# at most one block of this kernel on each of the 132 SMs, and a block at
# most 227 KB of shared memory, in which it keeps three float32 buffers of
# its tile plus a halo ring of 4 cells per step between two barriers.
_MAX_BLOCKS = 132
_MAX_SHARED_MEMORY_BYTES = 227 * 1024
_STEP_HALO = 4
# steps between two grid-wide barriers, where the haloed tiles still fit:
# at 641 x 641 sharing a barrier between two steps pays for the wider
# halo (PERF.md, Findings); sharing it among more gains nothing
_STEPS_PER_BARRIER = 2
# tiles no narrower than a warp and no lower than 8 rows, unless the grid
# is: smaller tiles would be mostly halo
_MIN_TILE_H = 8
_MIN_TILE_W = 32


class _ResidentPlan(NamedTuple):
    n_tiles_h: int
    n_tiles_w: int
    tile_h: int
    tile_w: int
    steps_per_barrier: int = 1

    @property
    def halo(self) -> int:
        return _STEP_HALO * self.steps_per_barrier

    @property
    def shared_bytes(self) -> int:
        rows = self.tile_h + 2 * self.halo
        cols = self.tile_w + 2 * self.halo
        return 3 * 4 * rows * cols


def make_resident_plan(
    height: int, width: int, steps_per_barrier: Optional[int] = None
) -> Optional[_ResidentPlan]:
    """Splits the grid into at most 132 tiles, one per thread block, or
    returns None when no such split fits a block's shared memory.

    With ``steps_per_barrier=None`` the plan shares one grid-wide barrier
    between two steps where such a split fits, else it takes one barrier a
    step. Among the splits that fit, it takes the one with the smallest
    haloed tile (the work of one block per stage), preferring wider
    tiles, then fewer blocks, on a tie. The
    resident range this gives covers square grids up to about 1,500 x
    1,500 (641 x 641 and 1,281 x 1,281 plan, 2,049 x 2,049 does not); the
    JAX package's cap of 2M padded cells is a VMEM budget and does not
    apply."""
    if min(height, width) < 3:
        return None
    if steps_per_barrier is None:
        for steps in range(_STEPS_PER_BARRIER, 0, -1):
            plan = make_resident_plan(height, width, steps)
            if plan is not None:
                return plan
        return None
    best, best_key = None, None
    for n_h in range(1, min(_MAX_BLOCKS, max(1, height // _MIN_TILE_H)) + 1):
        tile_h = -(-height // n_h)
        max_n_w = min(_MAX_BLOCKS // n_h, max(1, width // _MIN_TILE_W))
        for n_w in range(1, max_n_w + 1):
            tile_w = -(-width // n_w)
            plan = _ResidentPlan(
                # the split may leave whole tiles empty: drop them
                n_tiles_h=-(-height // tile_h),
                n_tiles_w=-(-width // tile_w),
                tile_h=tile_h,
                tile_w=tile_w,
                steps_per_barrier=steps_per_barrier,
            )
            if plan.shared_bytes > _MAX_SHARED_MEMORY_BYTES:
                continue
            key = (plan.shared_bytes, -tile_w, n_h * n_w)
            if best_key is None or key < best_key:
                best, best_key = plan, key
    return best


def _check_storage_dtype(storage_dtype):
    storage_dtype = storage_dtype or torch.float32
    if storage_dtype not in _DTYPES:
        raise ValueError(
            f"storage_dtype must be float32 or bfloat16, got {storage_dtype}"
        )
    return storage_dtype


def resident_diffusion_rk4_trajectory_reference(
    y: torch.Tensor, cfg: _HornerConfig, n_steps: int, storage_dtype=None
) -> torch.Tensor:
    """Plain version of K7: ``(..., H, W) -> (..., n_steps, H, W)`` in
    ``storage_dtype``; the state stays float32 and each frame rounds
    once."""
    storage_dtype = _check_storage_dtype(storage_dtype)
    faces = cfg.faces(y.device)
    out = torch.empty(
        tuple(y.shape[:-2]) + (n_steps,) + tuple(y.shape[-2:]),
        dtype=storage_dtype,
        device=y.device,
    )
    state = y
    for k in range(n_steps):
        state = _horner_step_reference(state, cfg, faces)
        out[..., k, :, :] = state.to(storage_dtype)
    return out


def resident_diffusion_rk4_end_reference(
    y: torch.Tensor, cfg: _HornerConfig, n_steps: int
) -> torch.Tensor:
    """Plain version of K7's end mode: ``(..., H, W) -> (..., H, W)``,
    the end state only."""
    faces = cfg.faces(y.device)
    state = y
    for _ in range(n_steps):
        state = _horner_step_reference(state, cfg, faces)
    return state


def _run(
    batch: torch.Tensor,
    out: torch.Tensor,
    cfg: _HornerConfig,
    n_steps: int,
    write_trajectory: bool,
    plan: Optional[_ResidentPlan],
):
    """One cooperative launch per state of the contiguous ``(B, H, W)``
    float32 CUDA ``batch``, into ``out`` (``(B, n_steps, H, W)`` frames of
    its dtype, or the ``(B, H, W)`` float32 end states)."""
    if plan is None:
        plan = make_resident_plan(cfg.height, cfg.width)
    if plan is None:
        raise ValueError("grid outside the resident kernel's range")
    library = load_kernels()
    masks, values = cfg.constants(batch.device)
    interior = cfg.interior(batch.device)
    # the halo exchange: two float32 grids of which only the cells within
    # a halo's width of a tile's edge are ever written or read
    exchange = torch.empty(
        (2, cfg.height, cfg.width), dtype=torch.float32, device=batch.device
    )
    coefficients = cfg.coefficient_array()
    # the ctypes launch targets the current device: make it the batch's
    with torch.cuda.device(batch.device):
        stream = torch.cuda.current_stream(batch.device).cuda_stream
        for b in range(batch.shape[0]):
            error = library.resident_diffusion_rk4(
                batch[b].data_ptr(),
                out[b].data_ptr(),
                exchange.data_ptr(),
                cfg.height,
                cfg.width,
                n_steps,
                int(write_trajectory),
                int(out.dtype == torch.bfloat16),
                plan.n_tiles_h,
                plan.n_tiles_w,
                plan.tile_h,
                plan.tile_w,
                plan.steps_per_barrier,
                int(cfg.has_convection),
                int(cfg.fold_cols),
                sum(1 << i for i, square in enumerate(cfg.square) if square),
                coefficients,
                masks.data_ptr(),
                values.data_ptr(),
                *(
                    (grid.data_ptr() for grid in interior)
                    if interior
                    else (None, None)
                ),
                stream,
            )
            _raise_on_error(library, error, "resident diffusion kernel")


def resident_diffusion_rk4_trajectory(
    y: torch.Tensor,
    cfg: _HornerConfig,
    n_steps: int,
    storage_dtype=None,
    plan: Optional[_ResidentPlan] = None,
) -> torch.Tensor:
    """K7: ``n_steps`` Horner-form RK4 steps storing every step,
    ``(H, W) -> (n_steps, H, W)`` or ``(B, H, W) -> (B, n_steps, H, W)``
    in ``storage_dtype``: one persistent cooperative kernel per state.
    ``plan`` overrides the tile plan (to exercise other splits)."""
    cfg.check_state(y)
    storage_dtype = _check_storage_dtype(storage_dtype)
    if y.device.type == "cpu":
        return resident_diffusion_rk4_trajectory_reference(
            y, cfg, n_steps, storage_dtype
        )
    batch = y.reshape(-1, cfg.height, cfg.width)
    out = torch.empty(
        (batch.shape[0], n_steps, cfg.height, cfg.width),
        dtype=storage_dtype,
        device=y.device,
    )
    _run(batch, out, cfg, n_steps, True, plan)
    resident_diffusion_rk4_trajectory.launches += 1
    return out if y.ndim == 3 else out[0]


def resident_diffusion_rk4_end(
    y: torch.Tensor,
    cfg: _HornerConfig,
    n_steps: int,
    plan: Optional[_ResidentPlan] = None,
) -> torch.Tensor:
    """K7's end mode: ``n_steps`` Horner-form RK4 steps returning the end
    state only, ``(H, W) -> (H, W)`` or ``(B, H, W) -> (B, H, W)`` in
    float32: the trajectory's persistent cooperative kernel, one launch
    per state, with no frame stored and the resident tiles written once,
    after the last step. ``plan`` overrides the tile plan."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return resident_diffusion_rk4_end_reference(y, cfg, n_steps)
    batch = y.reshape(-1, cfg.height, cfg.width)
    out = torch.empty_like(batch)
    _run(batch, out, cfg, n_steps, False, plan)
    resident_diffusion_rk4_end.launches += 1
    return out.reshape(y.shape)


resident_diffusion_rk4_trajectory.launches = 0
resident_diffusion_rk4_end.launches = 0


def _resident_config(cp, d_t, diffusion_coefficient) -> _HornerConfig:
    if make_resident_plan(*cp.mesh.vertices_shape) is None:
        raise ValueError("grid outside the resident kernel's range")
    return _HornerConfig(cp, d_t, diffusion_coefficient, resident=True)


def build_resident_diffusion_rk4_trajectory(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    diffusion_coefficient: Optional[float] = None,
    storage_dtype=None,
):
    """Builds ``trajectory(y) -> ys`` computing ``n_steps`` Horner-form
    RK4 diffusion(-convection) steps through K7, with the state resident
    in the card's shared memory and one frame written per step:
    ``(..., H, W, 1) -> (..., n_steps, H, W, 1)`` in ``storage_dtype``.

    Matches the tiled kernel's numerics (the same Horner evaluation order
    and boundary stamps) and, with Dirichlet constraints inside the grid,
    applies them after every stage as the whole-grid kernel K1 does.
    Raises ValueError when the grid is outside the resident range."""
    storage_dtype = _check_storage_dtype(storage_dtype)
    cfg = _resident_config(cp, d_t, diffusion_coefficient)
    return _build_trajectory(
        cfg,
        n_steps,
        lambda grids: resident_diffusion_rk4_trajectory(
            grids, cfg, n_steps, storage_dtype
        ),
    )


def build_resident_diffusion_rk4_end(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    diffusion_coefficient: Optional[float] = None,
    batch: Optional[int] = None,
):
    """Builds ``end(y) -> y_final`` advancing ``n_steps`` Horner-form RK4
    steps through K7's end mode and returning only the final state, in
    float32: with ``batch=B`` it maps ``(B, H, W, 1) -> (B, H, W, 1)``
    (one launch per state), otherwise one ``(H, W, 1)`` state. Raises
    ValueError when the grid is outside the resident range."""
    from pararealml_tpu_torch.ops.fused_diffusion import _grids

    cfg = _resident_config(cp, d_t, diffusion_coefficient)
    expected_lead = () if batch is None else (batch,)

    def end(y: torch.Tensor) -> torch.Tensor:
        lead, grids = _grids(y, cfg)
        if lead != expected_lead:
            raise ValueError(
                f"expected leading shape {expected_lead}, got {lead}"
            )
        return resident_diffusion_rk4_end(grids, cfg, n_steps).reshape(
            y.shape
        )

    return end
