"""Fused RK4 kernels for 2D diffusion-family problems.

Port of the JAX package's ``ops/fused_diffusion.py``. The three Pallas
TPU kernels there — the trajectory (K1), the end state (K2, single or
batched over Parareal's slices) and the single step (K3) — become one
pair of hand-written CUDA kernel templates for Hopper,
``csrc/fused_diffusion.cu`` (see its header for the design). One CTA
keeps one state on-chip for all steps, so an RK4 solve reads the state
once and writes either every step or the end state. How the CTA holds the
grid is a :class:`K1Plan` (a layout, its threads and the instance's cells
a thread) that :func:`make_k1_plan` reads from a table measured on the
card (``_MEASURED_PLANS``, ``tools/k1_plan_sweep.py``).

Each kernel has a wrapper and a plain PyTorch version beside it:

- ``fused_diffusion_rk4_trajectory`` (K1),
  ``fused_diffusion_rk4_end`` (K2) and ``fused_diffusion_rk4_step``
  (K3) check their input, and launch the kernel for a CUDA tensor or run
  the plain version for a CPU tensor. There is no fallback: on a CUDA
  tensor the kernel runs or the wrapper raises. Each counts its kernel
  launches in a plain integer attribute, ``launches``.
- ``fused_diffusion_rk4_{trajectory,end,step}_reference`` are the plain
  versions, with the kernel's evaluation order. They run on any device.

Applicability (:func:`fused_diffusion_step_applicable`): a
single-component 2D Cartesian ``DiffusionEquation`` or
``ConvectionDiffusionEquation`` problem with static boundary conditions,
solved with RK4, in float32. A grid whose kernel working set fits the
227 KB of shared memory one CTA can hold (about 100 x 100) takes K1-K3.
A larger one takes the Horner-form kernels: the resident kernel
(:mod:`pararealml_tpu_torch.ops.resident_diffusion`, K7) where its plan
exists, Dirichlet constraints inside the grid included, for the
trajectory and, through its end mode, the end state; else the tiled
kernel (:mod:`pararealml_tpu_torch.ops.tiled_diffusion`, K6) for the
trajectory where the Dirichlet constraints lie on the faces, and the
generic carry-only loop for the end state, as the JAX package's ends
past its VMEM cap of 504 x 512 padded cells. Below that cap the JAX
package runs K1/K2, so K7 carries them past one CTA; past it, K7's end
mode and its interior constraints are the port's own (ROADMAP.md,
Queue 3).

``kernel_storage_dtype``, ``kernel_traj_dtype`` and
``kernel_temporal_block`` take effect where the JAX package's do: past
that cap (:func:`past_reference_vmem`). Below it the JAX package runs its
whole-grid kernel K1, which ignores them, so the port's K7 runs there with
float32 frames.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.differential_equation import (
    ConvectionDiffusionEquation,
    DiffusionEquation,
)
from pararealml_tpu_torch.mesh import CoordinateSystem
from pararealml_tpu_torch.utils import tracing

# the dynamic shared memory one CTA can opt into on Hopper (232,448 B)
MAX_SHARED_MEMORY_BYTES = 227 * 1024
# the JAX package's VMEM cap for its whole-grid diffusion kernels (K1-K3),
# in padded cells (its ops/fused_diffusion.py _MAX_VMEM_CELLS): not a limit
# of the card, but where the JAX package starts to honour the storage,
# frame and temporal-block knobs
REFERENCE_MAX_VMEM_CELLS = 504 * 512


def padded_cells(height: int, width: int) -> int:
    """The cells of an H x W grid padded to the TPU's (8, 128) tiles, as
    the JAX package counts them for its VMEM caps."""
    return (-(-height // 8) * 8) * (-(-width // 128) * 128)


def past_reference_vmem(cp: ConstrainedProblem) -> bool:
    """Whether the JAX package takes its large-grid diffusion kernels
    (resident or tiled, which honour the storage knobs) for this
    problem's grid, rather than its whole-grid kernel K1."""
    return padded_cells(*cp.mesh.vertices_shape) > REFERENCE_MAX_VMEM_CELLS


def shared_memory_bytes(height: int, width: int) -> int:
    """The kernel's shared-memory working set for an H x W grid: five
    float grids (state, two stage buffers, the RK4 accumulator and the
    Dirichlet values), the float ghost vectors and the byte masks. Must
    match ``fused_diffusion_shared_bytes`` in the CUDA source."""
    cells = height * width
    faces = 2 * (height + width)
    return 4 * (5 * cells + faces) + cells + faces


def fused_diffusion_step_applicable(
    cp: ConstrainedProblem,
    integrator,
    dtype: Optional[torch.dtype] = None,
) -> bool:
    """Whether the fused kernels reproduce the generic path for this
    problem (and, when ``dtype`` is given, for states of that dtype: the
    kernels are float32 only)."""
    from pararealml_tpu_torch.operators.fdm.numerical_integrator import RK4

    diff_eq = cp.differential_equation
    # exact-type check: a user subclass may override the symbolic
    # equation system (e.g. add a reaction term) that the fused kernel
    # would silently ignore
    if not (
        (dtype is None or dtype == torch.float32)
        and type(diff_eq) in (DiffusionEquation, ConvectionDiffusionEquation)
        and isinstance(integrator, RK4)
        and diff_eq.x_dimension == 2
        and diff_eq.y_dimension == 1
        and cp.mesh is not None
        and cp.mesh.coordinate_system_type == CoordinateSystem.CARTESIAN
        and cp.are_all_boundary_conditions_static
    ):
        return False
    height, width = cp.mesh.vertices_shape
    if min(height, width) < 3:
        return False
    if fits_one_block(height, width):
        return True

    from pararealml_tpu_torch.ops.resident_diffusion import (
        make_resident_plan,
    )
    from pararealml_tpu_torch.ops.tiled_diffusion import (
        dirichlet_is_face_only,
        make_tile_plan,
    )

    # the resident kernel takes interior Dirichlet constraints, the tiled
    # one does not
    return make_resident_plan(height, width) is not None or (
        make_tile_plan(height, width) is not None
        and dirichlet_is_face_only(cp)
    )


def fits_one_block(height: int, width: int) -> bool:
    """Whether K1-K3's working set for an H x W grid fits one CTA's
    shared memory; larger grids take the resident or the tiled
    trajectory kernel."""
    return shared_memory_bytes(height, width) <= MAX_SHARED_MEMORY_BYTES


# -- plans ---------------------------------------------------------------

_MAX_THREADS = 1024
# the cells layout's instances (cells a thread): csrc/fused_diffusion.cu
# cells_instance builds the same; each holds 1,024 threads without a
# spill (ptxas on sm_90a: 36-64 registers a thread, tools/k1_plan_sweep.py
# prints the card's counts; tests/test_torch_fused_diffusion.py keeps them)
CELLS_INSTANCES = (1, 2, 4, 8, 11)
# the strips layout: a warp a row, a lane a column
STRIPS_MAX_WIDTH = 32
_LAYOUTS = {"cells": 0, "strips": 1}


class K1Plan(NamedTuple):
    """How one CTA holds an H x W grid (csrc/fused_diffusion.cu):

    - ``cells``: ``threads`` threads, each owning up to ``cells`` cells
      (an instance of :data:`CELLS_INSTANCES`) of the interior-first
      order in registers, the stage input in two shared-memory buffers;
    - ``strips``: ``threads / 32 = H`` warps, each a row, each lane a
      column of it (W <= 32), everything in registers but each row's
      copy in a shared-memory halo buffer.

    The plan owns the launch's layout: the kernel takes its threads,
    instance and shared-memory bytes as they are."""

    layout: str
    threads: int
    cells: int = 0

    def shared_bytes(self, height: int, width: int) -> int:
        """Its dynamic shared memory on an H x W grid; must match
        ``fused_diffusion_plan_shared_bytes`` in the CUDA source."""
        if self.layout == "cells":
            return 4 * (4 * height * width + 4 * width)
        return 4 * 2 * 32 * height

    def covers(self, height: int, width: int) -> bool:
        """Whether the plan is a valid launch for an H x W grid (the CUDA
        source's checks)."""
        if not (
            32 <= self.threads <= _MAX_THREADS
            and self.threads % 32 == 0
            and self.shared_bytes(height, width) <= MAX_SHARED_MEMORY_BYTES
            and min(height, width) >= 3
        ):
            return False
        if self.layout == "cells":
            return (
                self.cells in CELLS_INSTANCES
                and self.threads * self.cells >= height * width
                and height * width < 0x3FFF
            )
        return (
            self.layout == "strips"
            and self.threads == 32 * height
            and width <= STRIPS_MAX_WIDTH
        )

    def __str__(self) -> str:
        if self.layout == "cells":
            return f"cells: {self.threads} threads x {self.cells}"
        return f"strips: {self.threads // 32} rows"


def cells_plan(height: int, width: int, threads: int) -> Optional[K1Plan]:
    """The cells layout on ``threads`` threads with the fewest cells a
    thread of an instance that covers the grid, or None."""
    need = -(-height * width // threads)
    for cells in CELLS_INSTANCES:
        if cells >= need:
            plan = K1Plan("cells", threads, cells=cells)
            return plan if plan.covers(height, width) else None
    return None


def strips_plan(height: int, width: int) -> Optional[K1Plan]:
    """The strips layout for an H x W grid, or None past 32 x 32."""
    plan = K1Plan("strips", 32 * height)
    return plan if plan.covers(height, width) else None


def k1_plans(height: int, width: int) -> Iterator[K1Plan]:
    """Every plan of the kernel's instances for an H x W grid that
    covers it: the cells layout at each thread count of whole warps, and
    the strips layout."""
    for warps in range(1, _MAX_THREADS // 32 + 1):
        plan = cells_plan(height, width, 32 * warps)
        if plan is not None:
            yield plan
    plan = strips_plan(height, width)
    if plan is not None:
        yield plan


# The plan that won tools/k1_plan_sweep.py's turns by (height, width,
# batched): a single-state trajectory of 2,000 steps or, batched, the
# B = 8 end of one Parareal iteration's fine ends (5,000 steps). In the
# comments, µs a step as the mean (least-most) of six turns in one call,
# with the runner-up; NVIDIA H100 80GB HBM3 at 700 W.
_MEASURED_PLANS: Dict[Tuple[int, int, bool], K1Plan] = {
    # the flagship's 21 x 21: 0.863 (0.850-0.883); cells 608 x 1 0.984
    (21, 21, False): K1Plan("strips", 672),
    # its B = 8 fine ends: 0.774 (0.771-0.780); cells 480 x 1 0.781,
    # strips 0.819 (0.817-0.820)
    (21, 21, True): K1Plan("cells", 448, cells=1),
    # the convection problem's 17 x 17: 0.843 (0.817-0.852); 352 x 1
    # 0.849 (0.830-0.861), strips 0.945
    (17, 17, False): K1Plan("cells", 320, cells=1),
    # 1.177 (1.169-1.191); 704 x 1 1.189
    (17, 40, False): K1Plan("cells", 800, cells=1),
    # 0.429 (0.412-0.468); cells 32 x 1 0.927
    (3, 3, False): K1Plan("strips", 96),
    # 2.786 (2.766-2.796); 896 x 4 2.797 (2.770-2.814), behind in the
    # turns of an earlier call too
    (51, 51, False): K1Plan("cells", 928, cells=4),
    # the largest square the gate admits: 8.952 (8.922-8.985); 1,024 x
    # 11 9.157
    (104, 104, False): K1Plan("cells", 992, cells=11),
}


def make_k1_plan(height: int, width: int, batch: int = 1) -> Optional[K1Plan]:
    """Plans K1-K3 for a batch of ``batch`` H x W grids (one CTA a
    state), or returns None for a grid that :func:`fits_one_block` does
    not admit. A grid of the measured table (``_MEASURED_PLANS``) takes
    its entry; another takes the layout of the entry nearest in cells
    (of the same batch class): strips where they cover the grid, else
    the cells layout with the entry's cells a thread (one for a strips
    entry), on as few threads as that takes."""
    if min(height, width) < 3 or not fits_one_block(height, width):
        return None
    batched = batch > 1
    entry = _MEASURED_PLANS.get((height, width, batched))
    if entry is not None:
        return entry
    cells = height * width
    _, nearest = min(
        _MEASURED_PLANS.items(),
        key=lambda item: (
            item[0][2] != batched,
            abs(math.log(cells / (item[0][0] * item[0][1]))),
        ),
    )
    target = 1
    if nearest.layout == "strips":
        plan = strips_plan(height, width)
        if plan is not None:
            return plan
    else:
        target = nearest.cells
    per_thread = -(-cells // target)
    for threads in range(
        min(_MAX_THREADS, 32 * -(-per_thread // 32)), _MAX_THREADS + 1, 32
    ):
        plan = cells_plan(height, width, threads)
        if plan is not None:
            return plan
    return None


def ownership(plan: K1Plan, height: int, width: int):
    """A plain model of which thread owns which cells on ``plan``, as the
    kernel deals them: a dict from (thread, slot) to the cell (i, j) it
    owns, and for the strips layout each band's rows and the rows its
    halos hold (the row above and the row below the band, None past the
    grid)."""
    owners = {}
    halos = []
    if plan.layout == "cells":
        interior_width = width - 2
        interior = (height - 2) * interior_width
        faces = (
            [(0, j) for j in range(width)]
            + [(height - 1, j) for j in range(width)]
            + [(i, 0) for i in range(1, height - 1)]
            + [(i, width - 1) for i in range(1, height - 1)]
        )
        for thread in range(plan.threads):
            for slot in range(plan.cells):
                q = thread + slot * plan.threads
                if q >= height * width:
                    continue
                if q < interior:
                    cell = (1 + q // interior_width, 1 + q % interior_width)
                else:
                    cell = faces[q - interior]
                owners[(thread, slot)] = cell
        return owners, halos
    for band in range(plan.threads // 32):
        halos.append(
            (
                (band, band + 1),
                band - 1 if band > 0 else None,
                band + 1 if band < height - 1 else None,
            )
        )
        for lane in range(min(32, width)):
            owners[(32 * band + lane, 0)] = (band, lane)
    return owners, halos


def _face_vectors(pair, length: int):
    """Extracts the dense (mask, values) vectors of both sides of a
    boundary constraint pair (zero-mask when a side is None)."""
    sides = []
    for side_constraint in (
        (pair.lower, pair.upper) if pair else (None, None)
    ):
        if side_constraint is None:
            sides.append(
                (np.zeros(length, bool), np.zeros(length, np.float64))
            )
        else:
            mask = side_constraint.mask.numpy().reshape(length)
            values = side_constraint.values.numpy().reshape(length)
            sides.append((mask, values))
    return sides


def _constraint_tensors(cp: ConstrainedProblem) -> Dict[str, torch.Tensor]:
    """Extracts the dense static constraint tensors the kernels need
    (the JAX package's ``_constraint_tensors``, as CPU tensors)."""
    height, width = cp.mesh.vertices_shape

    if cp.static_y_vertex_constraints is not None:
        dir_mask = cp.static_y_vertex_constraints.mask.numpy().reshape(
            height, width
        )
        dir_vals = cp.static_y_vertex_constraints.values.numpy().reshape(
            height, width
        )
    else:
        dir_mask = np.zeros((height, width), bool)
        dir_vals = np.zeros((height, width))

    d_y = cp.static_boundary_vertex_constraints.d_y
    (row_lo_mask, row_lo_vals), (row_hi_mask, row_hi_vals) = _face_vectors(
        d_y[0], width
    )
    (col_lo_mask, col_lo_vals), (col_hi_mask, col_hi_vals) = _face_vectors(
        d_y[1], height
    )

    def floats(array):
        return torch.as_tensor(np.asarray(array, np.float32))

    def masks(array):
        return torch.as_tensor(np.asarray(array, bool))

    return dict(
        dir_mask=masks(dir_mask),
        dir_vals=floats(dir_vals),
        ghost_row_mask=masks(np.stack([row_lo_mask, row_hi_mask])),
        ghost_row_vals=floats(np.stack([row_lo_vals, row_hi_vals])),
        ghost_col_mask=masks(np.stack([col_lo_mask, col_hi_mask])),
        ghost_col_vals=floats(np.stack([col_lo_vals, col_hi_vals])),
    )


_CONSTANT_NAMES = (
    "dir_mask",
    "dir_vals",
    "ghost_row_mask",
    "ghost_row_vals",
    "ghost_col_mask",
    "ghost_col_vals",
)


class _KernelConfig:
    """Static configuration of the fused kernels for one problem: grid
    geometry, coefficients, and the constraint tensors (copied to each
    device a state arrives on, once)."""

    def __init__(
        self,
        cp: ConstrainedProblem,
        d_t: float,
        diffusion_coefficient: Optional[float] = None,
    ):
        diff_eq = cp.differential_equation
        mesh = cp.mesh
        self.height, self.width = mesh.vertices_shape
        d_x0, d_x1 = mesh.d_x
        if diffusion_coefficient is None:
            diffusion_coefficient = diff_eq._d
        self.d = float(diffusion_coefficient)
        if isinstance(diff_eq, ConvectionDiffusionEquation):
            self.velocity = tuple(float(v) for v in diff_eq._velocity)
        else:
            self.velocity = (0.0, 0.0)
        self.has_convection = any(v != 0.0 for v in self.velocity)
        self.d_t = float(d_t)
        self.inv_dx0_sqr = 1.0 / float(d_x0) ** 2
        self.inv_dx1_sqr = 1.0 / float(d_x1) ** 2
        self.inv_two_dx0 = 1.0 / (2.0 * float(d_x0))
        self.inv_two_dx1 = 1.0 / (2.0 * float(d_x1))
        self.two_dx0 = 2.0 * float(d_x0)
        self.two_dx1 = 2.0 * float(d_x1)
        self._host_constants = _constraint_tensors(cp)
        self._constants: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        self._plans: Dict[bool, Optional[K1Plan]] = {}
        self._arguments: Dict[K1Plan, Tuple[int, ...]] = {}

    def constants(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The six constraint tensors on ``device``, in kernel argument
        order."""
        constants = self._constants.get(device)
        if constants is None:
            constants = tuple(
                self._host_constants[name].to(device).contiguous()
                for name in _CONSTANT_NAMES
            )
            self._constants[device] = constants
        return constants

    def plan(self, batch: int) -> Optional[K1Plan]:
        """The plan the wrappers launch for a batch of ``batch`` states
        (:func:`make_k1_plan`, cached by batch class)."""
        batched = batch > 1
        if batched not in self._plans:
            self._plans[batched] = make_k1_plan(self.height, self.width, batch)
        return self._plans[batched]

    def launch_arguments(self, plan: K1Plan) -> Tuple[int, ...]:
        """The kernel's plan arguments (layout, threads, cells a thread,
        shared bytes) for ``plan``, worked out once a plan."""
        arguments = self._arguments.get(plan)
        if arguments is None:
            arguments = (
                _LAYOUTS[plan.layout],
                plan.threads,
                plan.cells,
                plan.shared_bytes(self.height, self.width),
            )
            self._arguments[plan] = arguments
        return arguments

    def check_state(self, y: torch.Tensor):
        """Raises unless ``y`` is a contiguous float32 ``(H, W)`` or
        ``(B, H, W)`` tensor on the CPU or a CUDA device."""
        if y.dtype != torch.float32:
            raise TypeError(
                f"the fused diffusion kernels take float32, got {y.dtype}"
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


def _rk4_reference(
    state: torch.Tensor, cfg: _KernelConfig, constants
) -> torch.Tensor:
    """One RK4 step over ``(..., H, W)`` states, in the kernel's (and the
    JAX package's ``_KernelConfig.make_rk4``) evaluation order."""
    dir_mask, dir_vals, grm, grv, gcm, gcv = constants
    height, width = cfg.height, cfg.width

    def apply_dirichlet(s):
        return torch.where(dir_mask, dir_vals, s)

    def rhs(s):
        zero_row = torch.zeros_like(s[..., :1, :])
        zero_col = torch.zeros_like(s[..., :, :1])
        above = torch.cat([zero_row, s[..., :-1, :]], dim=-2)
        below = torch.cat([s[..., 1:, :], zero_row], dim=-2)
        left = torch.cat([zero_col, s[..., :, :-1]], dim=-1)
        right = torch.cat([s[..., :, 1:], zero_col], dim=-1)
        lap = (above - 2.0 * s + below) * cfg.inv_dx0_sqr + (
            left - 2.0 * s + right
        ) * cfg.inv_dx1_sqr

        # Neumann ghost contributions as single-row, then single-column
        # corrections (zero where the face has no derivative constraint)
        ghost_top = torch.where(
            grm[0], s[..., 1, :] - cfg.two_dx0 * grv[0], 0.0
        )
        ghost_bottom = torch.where(
            grm[1], s[..., height - 2, :] + cfg.two_dx0 * grv[1], 0.0
        )
        lap = torch.cat(
            [
                lap[..., :1, :] + ghost_top[..., None, :] * cfg.inv_dx0_sqr,
                lap[..., 1: height - 1, :],
                lap[..., height - 1:, :]
                + ghost_bottom[..., None, :] * cfg.inv_dx0_sqr,
            ],
            dim=-2,
        )
        ghost_left = torch.where(
            gcm[0], s[..., :, 1] - cfg.two_dx1 * gcv[0], 0.0
        )
        ghost_right = torch.where(
            gcm[1], s[..., :, width - 2] + cfg.two_dx1 * gcv[1], 0.0
        )
        lap = torch.cat(
            [
                lap[..., :, :1] + ghost_left[..., :, None] * cfg.inv_dx1_sqr,
                lap[..., :, 1: width - 1],
                lap[..., :, width - 1:]
                + ghost_right[..., :, None] * cfg.inv_dx1_sqr,
            ],
            dim=-1,
        )
        value = cfg.d * lap

        if cfg.has_convection:
            # central first derivatives with the generic path's
            # semantics: zero halos, boundary values overridden by the
            # constrained normal derivative where one exists
            gradient_0 = (below - above) * cfg.inv_two_dx0
            gradient_0 = torch.cat(
                [
                    torch.where(grm[0], grv[0], gradient_0[..., 0, :])[
                        ..., None, :
                    ],
                    gradient_0[..., 1: height - 1, :],
                    torch.where(
                        grm[1], grv[1], gradient_0[..., height - 1, :]
                    )[..., None, :],
                ],
                dim=-2,
            )
            gradient_1 = (right - left) * cfg.inv_two_dx1
            gradient_1 = torch.cat(
                [
                    torch.where(gcm[0], gcv[0], gradient_1[..., :, 0])[
                        ..., :, None
                    ],
                    gradient_1[..., :, 1: width - 1],
                    torch.where(
                        gcm[1], gcv[1], gradient_1[..., :, width - 1]
                    )[..., :, None],
                ],
                dim=-1,
            )
            value = (
                value
                - cfg.velocity[0] * gradient_0
                - cfg.velocity[1] * gradient_1
            )
        return value

    k1 = cfg.d_t * rhs(state)
    k2 = cfg.d_t * rhs(apply_dirichlet(state + 0.5 * k1))
    k3 = cfg.d_t * rhs(apply_dirichlet(state + 0.5 * k2))
    k4 = cfg.d_t * rhs(apply_dirichlet(state + k3))
    return apply_dirichlet(state + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0)


def fused_diffusion_rk4_trajectory_reference(
    y: torch.Tensor, cfg: _KernelConfig, n_steps: int
) -> torch.Tensor:
    """Plain version of K1: ``(..., H, W) -> (..., n_steps, H, W)``."""
    constants = cfg.constants(y.device)
    out = y.new_empty(tuple(y.shape[:-2]) + (n_steps,) + tuple(y.shape[-2:]))
    state = y
    for k in range(n_steps):
        state = _rk4_reference(state, cfg, constants)
        out[..., k, :, :] = state
    return out


def fused_diffusion_rk4_end_reference(
    y: torch.Tensor, cfg: _KernelConfig, n_steps: int
) -> torch.Tensor:
    """Plain version of K2: ``(..., H, W) -> (..., H, W)``."""
    constants = cfg.constants(y.device)
    state = y
    for _ in range(n_steps):
        state = _rk4_reference(state, cfg, constants)
    return state


def fused_diffusion_rk4_step_reference(
    y: torch.Tensor, cfg: _KernelConfig
) -> torch.Tensor:
    """Plain version of K3: one step, ``(..., H, W) -> (..., H, W)``."""
    return _rk4_reference(y, cfg, cfg.constants(y.device))


# -- kernel wrappers ----------------------------------------------------------


def _configure(library: ctypes.CDLL):
    c_int, c_float, c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    library.fused_diffusion_rk4.argtypes = (
        [c_void_p, c_void_p]
        + [c_int] * 10
        + [c_void_p] * 6
        + [c_float] * 10
        + [c_void_p, c_int, c_void_p]
    )
    library.fused_diffusion_rk4.restype = c_int
    library.fused_diffusion_error_string.argtypes = [c_int]
    library.fused_diffusion_error_string.restype = ctypes.c_char_p
    library.fused_diffusion_plan_shared_bytes.argtypes = [c_int] * 3
    library.fused_diffusion_plan_shared_bytes.restype = ctypes.c_size_t
    library.fused_diffusion_instance_attributes.argtypes = [c_int] * 3 + [
        ctypes.POINTER(c_int)
    ] * 3
    library.fused_diffusion_instance_attributes.restype = c_int


def load_kernels() -> ctypes.CDLL:
    """The built and loaded kernel library (compiled on first use)."""
    from pararealml_tpu_torch.ops.cuda_library import load_library

    library = load_library("fused_diffusion")
    if not getattr(library, "_signatures_set", False):
        _configure(library)
        # the plans size the kernel's shared memory in Python; the kernel
        # carves it in C: both must agree, for every table plan and every
        # plan on a few grids
        shapes = [(3, 3), (21, 21), (17, 40), (32, 32), (104, 104)]
        checks = [
            (plan, key[0], key[1]) for key, plan in _MEASURED_PLANS.items()
        ]
        for height, width in shapes:
            checks += [
                (plan, height, width) for plan in k1_plans(height, width)
            ]
        for plan, height, width in checks:
            if library.fused_diffusion_plan_shared_bytes(
                _LAYOUTS[plan.layout], height, width
            ) != plan.shared_bytes(height, width):
                raise RuntimeError(
                    f"K1Plan.shared_bytes disagrees with the kernel's "
                    f"fused_diffusion_plan_shared_bytes for {plan} on "
                    f"{height} x {width}"
                )
        library._signatures_set = True
    return library


def instance_attributes(
    layout: str, cells: int, has_convection: bool
) -> Tuple[int, int, int]:
    """(registers a thread, spill bytes a thread, most threads a block)
    of a built instance (``cells`` a thread; ignored for the strips
    layout), as the card reports them."""
    library = load_kernels()
    values = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int()]
    error = library.fused_diffusion_instance_attributes(
        _LAYOUTS[layout],
        cells,
        int(has_convection),
        *(ctypes.byref(value) for value in values),
    )
    if error != 0:
        message = library.fused_diffusion_error_string(error).decode()
        raise RuntimeError(f"no such K1 instance: {message} ({error})")
    return tuple(value.value for value in values)


def _launch(
    y: torch.Tensor,
    out: torch.Tensor,
    cfg: _KernelConfig,
    n_steps: int,
    write_trajectory: bool,
    plan: Optional[K1Plan] = None,
    progress=None,
):
    """Launches the kernel on ``y``'s device and its current stream for a
    contiguous ``(B, H, W)`` float32 CUDA state on ``plan`` (by default
    the config's plan for the batch; a given plan the wrapper has checked
    to cover the grid) and raises if the launch is refused: the CUDA side
    checks the plan again and refuses one it cannot place before any
    launch. A trajectory of one state publishes its finished frames to
    ``progress`` (an ``operator.FrameProgress``) where one is given."""
    word, chunk = None, 0
    if progress is not None:
        word, chunk = progress.launch_arguments(y.shape[0])
    if plan is None:
        plan = cfg.plan(y.shape[0])
    if plan is None:
        raise RuntimeError(
            f"fused diffusion kernel launch failed: no plan for "
            f"{cfg.height} x {cfg.width}"
        )
    arguments = cfg.launch_arguments(plan)
    library = load_kernels()
    constants = cfg.constants(y.device)
    if any(t.device != y.device for t in (out,) + constants):
        raise ValueError(
            f"the output and constraint tensors must be on {y.device}"
        )
    # the ctypes launch targets the current device: make it y's
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        error = library.fused_diffusion_rk4(
            y.data_ptr(),
            out.data_ptr(),
            y.shape[0],
            cfg.height,
            cfg.width,
            n_steps,
            int(write_trajectory),
            int(cfg.has_convection),
            *arguments,
            *(c.data_ptr() for c in constants),
            cfg.d,
            cfg.d_t,
            cfg.inv_dx0_sqr,
            cfg.inv_dx1_sqr,
            cfg.inv_two_dx0,
            cfg.inv_two_dx1,
            cfg.two_dx0,
            cfg.two_dx1,
            cfg.velocity[0],
            cfg.velocity[1],
            word,
            chunk,
            stream,
        )
    if error != 0:
        message = library.fused_diffusion_error_string(error).decode()
        raise RuntimeError(
            f"fused diffusion kernel launch failed on {plan}: {message} "
            f"({error})"
        )


def _check_plan(cfg: _KernelConfig, plan: Optional[K1Plan]):
    """Raises for a given plan that does not cover the config's grid, on
    any device (the CPU runs no plan, but refuses the same ones)."""
    if plan is not None and not plan.covers(cfg.height, cfg.width):
        raise ValueError(
            f"{plan} does not cover a {cfg.height} x {cfg.width} grid"
        )


def _count_steps(y: torch.Tensor, cfg: _KernelConfig, n_steps: int):
    """Adds the RK4 steps of a call, its states times ``n_steps``, to the
    innermost span's ``rk4_state_steps``."""
    tracing.count(
        "rk4_state_steps", y.numel() // (cfg.height * cfg.width) * n_steps
    )


def fused_diffusion_rk4_trajectory(
    y: torch.Tensor,
    cfg: _KernelConfig,
    n_steps: int,
    plan: Optional[K1Plan] = None,
    progress=None,
) -> torch.Tensor:
    """K1: ``n_steps`` fused RK4 steps storing every step,
    ``(H, W) -> (n_steps, H, W)`` or ``(B, H, W) -> (B, n_steps, H, W)``
    (one CTA per state, on ``plan`` or the config's). A trajectory of one
    state publishes its finished frames to ``progress`` (an
    ``operator.FrameProgress``) while the kernel runs; the plain version
    publishes them all when it returns."""
    cfg.check_state(y)
    _check_plan(cfg, plan)
    batch = y.reshape(-1, cfg.height, cfg.width)
    if y.device.type == "cpu":
        out = fused_diffusion_rk4_trajectory_reference(y, cfg, n_steps)
        _count_steps(y, cfg, n_steps)
        if progress is not None:
            progress.publish_all(batch.shape[0], n_steps)
        return out
    out = torch.empty(
        (batch.shape[0], n_steps, cfg.height, cfg.width),
        dtype=torch.float32,
        device=y.device,
    )
    _launch(batch, out, cfg, n_steps, True, plan, progress)
    fused_diffusion_rk4_trajectory.launches += 1
    _count_steps(y, cfg, n_steps)
    return out if y.ndim == 3 else out[0]


def fused_diffusion_rk4_end(
    y: torch.Tensor,
    cfg: _KernelConfig,
    n_steps: int,
    plan: Optional[K1Plan] = None,
) -> torch.Tensor:
    """K2: ``n_steps`` fused RK4 steps returning the end state only,
    ``(H, W) -> (H, W)`` or ``(B, H, W) -> (B, H, W)`` (one CTA per
    state, on ``plan`` or the config's)."""
    cfg.check_state(y)
    _check_plan(cfg, plan)
    if y.device.type == "cpu":
        out = fused_diffusion_rk4_end_reference(y, cfg, n_steps)
        _count_steps(y, cfg, n_steps)
        return out
    batch = y.reshape(-1, cfg.height, cfg.width)
    out = torch.empty_like(batch)
    _launch(batch, out, cfg, n_steps, False, plan)
    fused_diffusion_rk4_end.launches += 1
    _count_steps(y, cfg, n_steps)
    return out.reshape(y.shape)


def fused_diffusion_rk4_step(
    y: torch.Tensor, cfg: _KernelConfig, plan: Optional[K1Plan] = None
) -> torch.Tensor:
    """K3: one fused RK4 step (the K1 kernel with ``n_steps = 1``),
    ``(H, W) -> (H, W)`` or ``(B, H, W) -> (B, H, W)``, on ``plan`` or
    the config's."""
    cfg.check_state(y)
    _check_plan(cfg, plan)
    if y.device.type == "cpu":
        out = fused_diffusion_rk4_step_reference(y, cfg)
        _count_steps(y, cfg, 1)
        return out
    batch = y.reshape(-1, cfg.height, cfg.width)
    out = torch.empty(
        (batch.shape[0], 1, cfg.height, cfg.width),
        dtype=torch.float32,
        device=y.device,
    )
    _launch(batch, out, cfg, 1, True, plan)
    fused_diffusion_rk4_step.launches += 1
    _count_steps(y, cfg, 1)
    return out.reshape(y.shape)


fused_diffusion_rk4_trajectory.launches = 0
fused_diffusion_rk4_end.launches = 0
fused_diffusion_rk4_step.launches = 0


# -- builders mirroring the JAX package's API -------------------------------


def _grids(y: torch.Tensor, cfg: _KernelConfig):
    """``(..., H, W, 1)`` -> (leading shape, contiguous ``(B, H, W)``).
    The dtype is kept: the kernel wrappers raise on anything but
    float32."""
    lead = tuple(y.shape[:-3])
    if tuple(y.shape[-3:]) != (cfg.height, cfg.width, 1):
        raise ValueError(
            f"expected a state of shape (..., {cfg.height}, {cfg.width}, 1)"
            f", got {tuple(y.shape)}"
        )
    grids = y.reshape(-1, cfg.height, cfg.width)
    return lead, grids.contiguous()


def build_fused_diffusion_rk4_trajectory(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    diffusion_coefficient: Optional[float] = None,
    storage_dtype=None,
    traj_dtype=None,
    temporal_block: int = 1,
):
    """Builds ``trajectory(y) -> ys`` computing ``n_steps`` fused RK4
    steps: ``(..., H, W, 1) -> (..., n_steps, H, W, 1)``.

    A grid that fits one CTA's shared memory runs K1, one CTA per
    leading index; its function, tagged ``publishes``, also takes the
    ``progress=`` of one state (``operator.FrameProgress``). A larger
    grid runs the resident kernel (K7) where its plan exists (Dirichlet
    constraints inside the grid included), else the tiled kernel (K6),
    one launch sequence per leading index.

    ``storage_dtype`` selects the precision of the stored trajectory and,
    on the tiled path, of the carried state; ``traj_dtype`` and
    ``temporal_block`` tune the tiled path the same way (frame precision
    and RK4 steps per tile residency). The resident kernel ignores the
    last two, K1 all three, and all three take effect only past the JAX
    package's VMEM cap (:func:`past_reference_vmem`), as there."""
    height, width = cp.mesh.vertices_shape
    if not past_reference_vmem(cp):
        storage_dtype = traj_dtype = None
        temporal_block = 1
    if not fits_one_block(height, width):
        from pararealml_tpu_torch.ops.resident_diffusion import (
            build_resident_diffusion_rk4_trajectory,
            make_resident_plan,
        )
        from pararealml_tpu_torch.ops.tiled_diffusion import (
            build_tiled_diffusion_rk4_trajectory,
        )

        if make_resident_plan(height, width) is not None:
            return build_resident_diffusion_rk4_trajectory(
                cp,
                d_t,
                n_steps,
                diffusion_coefficient=diffusion_coefficient,
                storage_dtype=storage_dtype,
            )
        return build_tiled_diffusion_rk4_trajectory(
            cp,
            d_t,
            n_steps,
            diffusion_coefficient=diffusion_coefficient,
            storage_dtype=storage_dtype,
            traj_dtype=traj_dtype,
            temporal_block=temporal_block,
        )
    cfg = _KernelConfig(cp, d_t, diffusion_coefficient)

    def trajectory(y: torch.Tensor, progress=None) -> torch.Tensor:
        lead, grids = _grids(y, cfg)
        publishing = {} if progress is None else {"progress": progress}
        out = fused_diffusion_rk4_trajectory(grids, cfg, n_steps, **publishing)
        return out.reshape(lead + (n_steps, cfg.height, cfg.width, 1))

    # K1 publishes the finished frames of one state to ``progress``
    trajectory.publishes = True
    return trajectory


def build_fused_diffusion_rk4_end(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    diffusion_coefficient: Optional[float] = None,
    batch: Optional[int] = None,
):
    """Builds ``end(y) -> y_final`` advancing ``n_steps`` fused RK4 steps
    and returning ONLY the final state: through K2 where the grid fits one
    CTA's shared memory, else through the resident kernel's end mode
    (K7, ``build_resident_diffusion_rk4_end``) where its plan exists, else
    ``None`` (callers take the generic carry-only loop, as the JAX package
    does past its VMEM cap).

    With ``batch=B``, ``end`` maps ``(B, H, W, 1) -> (B, H, W, 1)``, one
    CTA (K7: one launch) per slice; otherwise it maps one ``(H, W, 1)``
    state."""
    height, width = cp.mesh.vertices_shape
    if not fits_one_block(height, width):
        from pararealml_tpu_torch.ops.resident_diffusion import (
            build_resident_diffusion_rk4_end,
            make_resident_plan,
        )

        if make_resident_plan(height, width) is None:
            return None
        return build_resident_diffusion_rk4_end(
            cp, d_t, n_steps, diffusion_coefficient, batch
        )
    cfg = _KernelConfig(cp, d_t, diffusion_coefficient)
    expected_lead = () if batch is None else (batch,)

    def end(y: torch.Tensor) -> torch.Tensor:
        lead, grids = _grids(y, cfg)
        if lead != expected_lead:
            raise ValueError(
                f"expected leading shape {expected_lead}, got {lead}"
            )
        out = fused_diffusion_rk4_end(grids, cfg, n_steps)
        return out.reshape(y.shape)

    return end


def build_fused_diffusion_rk4_step(
    cp: ConstrainedProblem,
    d_t: float,
    diffusion_coefficient: Optional[float] = None,
):
    """Builds ``step(y) -> y_next`` computing one fused RK4 step,
    ``(..., H, W, 1) -> (..., H, W, 1)``: through K3 on a grid that fits
    one CTA, else as the one-step trajectory of the resident or the
    tiled kernel."""
    if not fits_one_block(*cp.mesh.vertices_shape):
        trajectory = build_fused_diffusion_rk4_trajectory(
            cp, d_t, 1, diffusion_coefficient=diffusion_coefficient
        )

        def single_step(y: torch.Tensor) -> torch.Tensor:
            return trajectory(y)[..., 0, :, :, :]

        return single_step
    cfg = _KernelConfig(cp, d_t, diffusion_coefficient)

    def step(y: torch.Tensor) -> torch.Tensor:
        _, grids = _grids(y, cfg)
        out = fused_diffusion_rk4_step(grids, cfg)
        return out.reshape(y.shape)

    return step
