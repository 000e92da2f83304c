"""Fused RK4 kernels for multi-component 2D systems (K5).

Port of the JAX package's ``ops/fused_system.py`` for the wave, viscous
Burgers, shallow-water and Cahn-Hilliard systems on Cartesian and polar
meshes and the vorticity-stream-function Navier-Stokes system on
Cartesian meshes. For the first four, its three Pallas TPU kernels — the
trajectory, the end state (single or batched) and the single step —
become launches of one hand-written CUDA kernel template for Hopper,
``csrc/fused_system.cu`` (see its header for the design), which the
batched kernels of ``ops/packed_system.py`` (K4) launch too. One CTA, or
a thread block cluster of up to 8 (:func:`k5_cluster_size`), keeps one
state on-chip for all steps, each thread owning fixed cells with their
state in registers, so a solve reads the state once and writes either
every step or the end state. The equation functors live in
``csrc/system_2d.cuh``, shared with the tiled kernel K8
(``ops/tiled_system.py``).

Past one CTA the same kernel template (``csrc/system_2d_resident.cuh``)
runs as the cluster-resident mode (``csrc/cluster_system.cu``): one
thread block cluster of up to 16 blocks a state, all steps in one
launch, planned by :func:`make_cluster_plan` from a table measured on
the card. It takes every grid within the JAX package's VMEM cap (where
that package runs its K5) that a cluster holds
(:func:`cluster_system_applicable`): the 2D examples' 101 x 101, 101 x
51 and polar 51 x 201, interior Dirichlet constraints included. It
computes what K5 computes, so its plain versions are K5's. Grids past
it take K8.

Each kernel has a wrapper and a plain PyTorch version beside it:

- ``fused_system_rk4_trajectory``, ``fused_system_rk4_end`` and
  ``fused_system_rk4_step`` check their input, and launch the kernel for
  a CUDA tensor or run the plain version for a CPU tensor. There is no
  fallback: on a CUDA tensor the kernel runs or the wrapper raises. Each
  counts its kernel launches in a plain integer attribute, ``launches``.
- ``fused_system_rk4_{trajectory,end,step}_reference`` are the plain
  versions, following the JAX package's ``_make_rhs_builder``,
  ``_make_step_factory`` and ``_StencilHelpers`` term for term, the polar
  metric terms included. They run on any device and in any floating-point
  type.

States use the JAX package's layout: ``(H, W, n)``, or ``(B, H, W, n)``
for a batch (one CTA per state).

Applicability (:func:`fused_system_step_applicable` and the per-family
gates): one of the four exact equation types on a 2D Cartesian or polar
mesh with static boundary conditions, solved with RK4, in float32. A polar
mesh is admitted as the JAX package's ``_system_applicable`` admits it:
away from the origin (``r_low > 0``) and within the JAX package's VMEM cap
(:func:`fits_reference_vmem`); past that cap it takes the generic path,
as there. Where the grid's working set fits the 227 KB of shared memory
one CTA can hold (about 74² for two components, 60² for three), the
trajectory, end and step take K5; past that, the cluster-resident mode
within the JAX package's VMEM cap and the mode's range (about 176² for
two components), Cartesian and polar, and past those K8 (the end its end
mode) where the Dirichlet constraints lie on the grid's faces.

The Navier-Stokes family (:func:`fused_navier_stokes_step_applicable`)
runs its own kernel, ``csrc/fused_navier_stokes.cu`` through
:mod:`pararealml_tpu_torch.ops.fused_navier_stokes`: one thread block
cluster per state with the stream function's Jacobi solve inside. Its
plain step, :func:`_navier_stokes_step_reference`, is here beside the
other families'. The JAX package admits it on Cartesian meshes within its
VMEM cap; the port also needs the grid to fit the largest cluster (up to
186 x 186 for a square grid), and takes the generic path past it
(ROADMAP.md, Queue 3).

``kernel_storage_dtype`` takes effect where the JAX package's does: past
its VMEM cap. Below it the JAX package runs K5, which ignores the knob,
and so do K5 and the cluster-resident mode (and K8 past the mode's
range), which store float32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.differential_equation import (
    BurgersEquation,
    CahnHilliardEquation,
    NavierStokesEquation,
    ShallowWaterEquation,
    WaveEquation,
)
from pararealml_tpu_torch.mesh import CoordinateSystem
from pararealml_tpu_torch.operators.fdm.numerical_differentiator import (
    jacobi,
)
from pararealml_tpu_torch.ops.fused_diffusion import padded_cells

# the dynamic shared memory one CTA can opt into on Hopper (232,448 B)
MAX_SHARED_MEMORY_BYTES = 227 * 1024
# the JAX package's VMEM budget for its whole-grid system kernel K5, in
# padded cells times live planes (its ops/fused_system.py _fits_vmem): not
# a limit of the card, but where the JAX package's dispatch changes (polar
# grids past it take the generic path, Cartesian ones the tiled kernel,
# which honours kernel_storage_dtype)
REFERENCE_VMEM_BUDGET_CELLS = 3_000_000

# the kernel templates' equation functors, by equation type (the numbers
# of EquationId in csrc/system_2d.cuh; Navier-Stokes, last, has a kernel of
# its own, csrc/fused_navier_stokes.cu)
_EQUATION_TYPES = (
    WaveEquation,
    BurgersEquation,
    ShallowWaterEquation,
    CahnHilliardEquation,
    NavierStokesEquation,
)
_EQUATION_IDS = {equation: i for i, equation in enumerate(_EQUATION_TYPES)}


def shared_memory_bytes(
    height: int, width: int, n_components: int, polar: bool = False
) -> int:
    """The working set of K5's first design for an H x W grid of
    n-component states: five sets of n float planes (state, two stage
    buffers, the RK4 accumulator and the Dirichlet values), the float
    Neumann face vectors, on a polar grid the H floats of 1 / r, and the
    byte masks. It fixes K5's range (:func:`fits_one_block`), which the
    redesign (two sets of planes, the rest in registers) kept."""
    values = height * width * n_components
    faces = 2 * n_components * (height + width)
    rows = height if polar else 0
    return 4 * (5 * values + faces + rows) + values + faces


def _is_polar(cp: ConstrainedProblem) -> bool:
    return cp.mesh.coordinate_system_type == CoordinateSystem.POLAR


def fits_one_block(cp: ConstrainedProblem) -> bool:
    """Whether the problem's grid fits one CTA's shared memory (K5, K4)."""
    height, width = cp.mesh.vertices_shape
    n = cp.differential_equation.y_dimension
    return (
        shared_memory_bytes(height, width, n, _is_polar(cp))
        <= MAX_SHARED_MEMORY_BYTES
    )


def fits_reference_vmem(cp: ConstrainedProblem) -> bool:
    """Whether the JAX package runs its whole-grid system kernel (K5) on
    this problem's grid (its ``_fits_vmem``)."""
    n = cp.differential_equation.y_dimension
    return padded_cells(*cp.mesh.vertices_shape) <= (
        REFERENCE_VMEM_BUDGET_CELLS // (7 * n + 4)
    )


def _system_applicable(
    cp: ConstrainedProblem,
    integrator,
    equation_type,
    dtype: Optional[torch.dtype] = None,
) -> bool:
    from pararealml_tpu_torch.operators.fdm.numerical_integrator import RK4

    diff_eq = cp.differential_equation
    # exact-type check: a user subclass may override the symbolic
    # equation system that the fused kernel would silently ignore
    if not (
        (dtype is None or dtype == torch.float32)
        and type(diff_eq) is equation_type
        and isinstance(integrator, RK4)
        and diff_eq.x_dimension == 2
        and cp.mesh is not None
        and cp.are_all_boundary_conditions_static
        and min(cp.mesh.vertices_shape) >= 3
    ):
        return False
    coordinate_system = cp.mesh.coordinate_system_type
    if equation_type is NavierStokesEquation:
        # the JAX package's gate (Cartesian, within its VMEM cap: its
        # tiled kernel refuses the family) and one of the port's own: the
        # grid fits the largest thread block cluster
        from pararealml_tpu_torch.ops.fused_navier_stokes import (
            make_cluster_plan_2d,
        )

        return (
            coordinate_system == CoordinateSystem.CARTESIAN
            and fits_reference_vmem(cp)
            and make_cluster_plan_2d(*cp.mesh.vertices_shape) is not None
        )
    if coordinate_system == CoordinateSystem.POLAR:
        # the JAX package's polar branch: away from the origin (1 / r is
        # infinite on an r = 0 row) and within its VMEM cap (no tiled
        # polar kernel there)
        if not (
            float(cp.mesh.x_intervals[0][0]) > 0.0
            and fits_reference_vmem(cp)
        ):
            return False
    elif coordinate_system != CoordinateSystem.CARTESIAN:
        return False
    if fits_one_block(cp) or cluster_system_applicable(cp):
        return True
    # past the cluster-resident mode: the tiled kernel (K8)
    from pararealml_tpu_torch.ops.tiled_system import tiled_system_applicable

    return tiled_system_applicable(cp)


def fused_wave_step_applicable(cp, integrator, dtype=None) -> bool:
    """Whether the fused wave kernels reproduce the generic path for this
    problem (and, when ``dtype`` is given, for states of that dtype)."""
    return _system_applicable(cp, integrator, WaveEquation, dtype)


def fused_burgers_step_applicable(cp, integrator, dtype=None) -> bool:
    """Whether the fused Burgers kernels reproduce the generic path for
    this problem (and, when ``dtype`` is given, for states of that
    dtype)."""
    return _system_applicable(cp, integrator, BurgersEquation, dtype)


def fused_shallow_water_step_applicable(cp, integrator, dtype=None) -> bool:
    """Whether the fused shallow-water kernels reproduce the generic path
    for this problem (and, when ``dtype`` is given, for states of that
    dtype)."""
    return _system_applicable(cp, integrator, ShallowWaterEquation, dtype)


def fused_cahn_hilliard_step_applicable(cp, integrator, dtype=None) -> bool:
    """Whether the fused Cahn-Hilliard kernels reproduce the generic path
    for this problem (and, when ``dtype`` is given, for states of that
    dtype)."""
    return _system_applicable(cp, integrator, CahnHilliardEquation, dtype)


def fused_navier_stokes_step_applicable(cp, integrator, dtype=None) -> bool:
    """Whether the fused Navier-Stokes kernel reproduces the generic path
    for this problem (and, when ``dtype`` is given, for states of that
    dtype)."""
    return _system_applicable(cp, integrator, NavierStokesEquation, dtype)


def fused_system_step_applicable(
    cp: ConstrainedProblem,
    integrator,
    dtype: Optional[torch.dtype] = None,
) -> bool:
    """Whether any fused system kernel (K5 on one CTA, K8 past it, the
    Navier-Stokes cluster kernel) reproduces the generic path for this
    problem (and, when ``dtype`` is given, for states of that dtype: the
    kernels are float32 only)."""
    return any(
        _system_applicable(cp, integrator, equation_type, dtype)
        for equation_type in _EQUATION_TYPES
    )


def _dirichlet_grids(
    cp: ConstrainedProblem, n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The static Dirichlet mask and values as ``(n, H, W)`` grids, the
    values zeroed where the mask is unset and kept float64."""
    height, width = cp.mesh.vertices_shape
    if cp.static_y_vertex_constraints is None:
        return (
            np.zeros((n, height, width), bool),
            np.zeros((n, height, width)),
        )
    mask = cp.static_y_vertex_constraints.mask.numpy().reshape(
        height, width, n
    )
    values = cp.static_y_vertex_constraints.values.numpy().reshape(
        height, width, n
    )
    values = np.where(mask, values, 0.0).astype(np.float64)
    return np.moveaxis(mask, -1, 0), np.moveaxis(values, -1, 0)


def _ghost_faces(cp: ConstrainedProblem, n: int) -> Dict[str, np.ndarray]:
    """The static Neumann face vectors, one per component: ghost rows
    ``(2 faces, n, W)`` and columns ``(2 faces, n, H)``, the lower face
    first, values zeroed where the mask is unset and kept float64 (they
    take the state's dtype on the device). Both system kernels read
    them."""
    height, width = cp.mesh.vertices_shape

    def face_vectors(pair, length):
        """(2 sides, n components, length) mask and value arrays."""
        masks = np.zeros((2, n, length), bool)
        values = np.zeros((2, n, length))
        for side_index, side in enumerate(
            (pair.lower, pair.upper) if pair else (None, None)
        ):
            if side is None:
                continue
            masks[side_index] = np.moveaxis(
                side.mask.numpy().reshape(length, n), -1, 0
            )
            values[side_index] = np.moveaxis(
                side.values.numpy().reshape(length, n), -1, 0
            )
        return masks, np.where(masks, values, 0.0)

    d_y = cp.static_boundary_vertex_constraints.d_y
    ghost_row_mask, ghost_row_vals = face_vectors(d_y[0], width)
    ghost_col_mask, ghost_col_vals = face_vectors(d_y[1], height)
    return dict(
        ghost_row_mask=ghost_row_mask,
        ghost_row_vals=ghost_row_vals,
        ghost_col_mask=ghost_col_mask,
        ghost_col_vals=ghost_col_vals,
    )


class _SystemKernelConfig:
    """Static configuration of the fused system kernels for one problem:
    grid geometry, the equation and its coefficients, the RK4 step's
    float32 constants, the Navier-Stokes stream function's Jacobi
    settings, and the constraint tensors and, on a polar mesh, the
    per-row 1 / r (made for each device and dtype a state arrives in,
    once)."""

    def __init__(
        self,
        cp: ConstrainedProblem,
        d_t: float,
        anti_laplacian_tol: float = 1e-3,
        anti_laplacian_max_iterations: int = 100_000,
    ):
        diff_eq = cp.differential_equation
        if type(diff_eq) not in _EQUATION_IDS:
            raise ValueError(
                f"no fused 2D system kernel for {type(diff_eq).__name__}"
            )
        mesh = cp.mesh
        if diff_eq.x_dimension != 2 or mesh is None or (
            mesh.coordinate_system_type
            not in (CoordinateSystem.CARTESIAN, CoordinateSystem.POLAR)
        ):
            raise ValueError(
                "the fused 2D system kernels take 2D Cartesian and polar "
                "meshes only"
            )
        self.equation_type = type(diff_eq)
        self.equation = _EQUATION_IDS[self.equation_type]
        self.n = diff_eq.y_dimension
        self.height, self.width = mesh.vertices_shape
        d_x0, d_x1 = mesh.d_x
        # the JAX package computes these in float64 on the host and the
        # kernel rounds them to float32, as the plain version's Python
        # scalars are rounded
        self.gamma = 0.0
        self.depth = self.drag = self.coriolis = self.gravity = 0.0
        if self.equation_type is WaveEquation:
            self.coefficient = float(diff_eq._c) ** 2
        elif self.equation_type is BurgersEquation:
            self.coefficient = 1.0 / float(diff_eq._re)
        elif self.equation_type is NavierStokesEquation:
            self.coefficient = 1.0 / float(diff_eq._re)
        elif self.equation_type is ShallowWaterEquation:
            self.coefficient = float(diff_eq._v)
            self.depth = float(diff_eq._h)
            self.drag = float(diff_eq._b)
            self.coriolis = float(diff_eq._f)
            self.gravity = float(diff_eq._g)
        else:
            self.coefficient = float(diff_eq._d)
            self.gamma = float(diff_eq._gamma)
        self.d_t = float(d_t)
        self.half_d_t = 0.5 * self.d_t
        self.sixth_d_t = self.d_t / 6.0
        self.inv_dx0_sqr = 1.0 / float(d_x0) ** 2
        self.inv_dx1_sqr = 1.0 / float(d_x1) ** 2
        self.inv_two_dx0 = 1.0 / (2.0 * float(d_x0))
        self.inv_two_dx1 = 1.0 / (2.0 * float(d_x1))
        self.two_dx0 = 2.0 * float(d_x0)
        self.two_dx1 = 2.0 * float(d_x1)
        # Navier-Stokes: the Jacobi update psi + (lap(psi) - rhs) /
        # denominator, whose fixed point solves lap(psi) = rhs, and its
        # stopping rule
        self.denominator = 2.0 / float(d_x0) ** 2 + 2.0 / float(d_x1) ** 2
        self.tol = float(anti_laplacian_tol)
        self.max_iterations = int(anti_laplacian_max_iterations)
        # the polar metric divides by the mesh's vertex radii, the
        # linspace(r_low, r_high, H) of the generic path, whose spacing
        # differs from d_x0 where d_x0 does not divide the interval
        self.polar = mesh.coordinate_system_type == CoordinateSystem.POLAR
        r_low, r_high = (float(r) for r in mesh.x_intervals[0])
        self.r_low = r_low
        self.r_spacing = (
            (r_high - r_low) / (self.height - 1) if self.height > 1 else 0.0
        )
        self._host_constants = {
            name: torch.as_tensor(value)
            for name, value in self._constraint_arrays(cp).items()
        }
        self._constants: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
        # the card's count of the cluster-resident mode's clusters it
        # holds at once, by (cluster size, cells a thread, trajectory)
        self._active_clusters: Dict[tuple, int] = {}

    def _constraint_arrays(self, cp: ConstrainedProblem):
        """The constraint arrays in kernel argument order: K5's Dirichlet
        grids ``(n, H, W)`` and the ghost face vectors (the JAX package's
        ``_component_constraint_tensors``)."""
        dir_mask, dir_vals = _dirichlet_grids(cp, self.n)
        return dict(
            dir_mask=dir_mask, dir_vals=dir_vals, **_ghost_faces(cp, self.n)
        )

    @property
    def state_shape(self) -> Tuple[int, int, int]:
        return (self.height, self.width, self.n)

    def coefficient_array(self):
        """The kernels' coefficient argument as C floats, in the order of
        ``make_params`` in ``csrc/system_2d.cuh``."""
        values = (
            self.half_d_t,
            self.d_t,
            self.sixth_d_t,
            self.coefficient,
            self.gamma,
            self.depth,
            self.drag,
            self.coriolis,
            self.gravity,
            self.inv_dx0_sqr,
            self.inv_dx1_sqr,
            self.inv_two_dx0,
            self.inv_two_dx1,
            self.two_dx0,
            self.two_dx1,
        )
        return (ctypes.c_float * len(values))(*values)

    def inv_r(self, dtype: torch.dtype) -> torch.Tensor:
        """1 / r of each of the H rows as the JAX kernel computes it, ``1 /
        (r_low + r_spacing i)`` rounded in ``dtype`` after each operation
        (in float32 bit for bit with its interpret mode), on the CPU."""
        rows = torch.arange(self.height, dtype=dtype)
        r_low, r_spacing = (
            torch.tensor(value, dtype=dtype)
            for value in (self.r_low, self.r_spacing)
        )
        # a correctly rounded division, computed on the CPU for every
        # device
        return torch.reciprocal(r_low + r_spacing * rows)

    def constants(
        self, device: torch.device, dtype: torch.dtype = torch.float32
    ) -> Tuple[torch.Tensor, ...]:
        """The constraint tensors on ``device`` in kernel argument order,
        masks as bool and values in ``dtype``, then on a polar mesh the H
        values of 1 / r in ``dtype``."""
        key = (device, dtype)
        constants = self._constants.get(key)
        if constants is None:
            constants = tuple(
                value.to(
                    device=device,
                    dtype=torch.bool if name.endswith("mask") else dtype,
                ).contiguous()
                for name, value in self._host_constants.items()
            )
            if self.polar:
                constants += (self.inv_r(dtype).to(device),)
            self._constants[key] = constants
        return constants

    def check_state(self, y: torch.Tensor, batched: bool = False):
        """Raises unless ``y`` is a contiguous float32 ``(H, W, n)`` or
        ``(B, H, W, n)`` tensor (only the latter when ``batched``) on
        the CPU or a CUDA device."""
        if y.dtype != torch.float32:
            raise TypeError(
                f"the fused system kernels take float32, got {y.dtype}"
            )
        ranks = (4,) if batched else (3, 4)
        if y.ndim not in ranks or tuple(y.shape[-3:]) != self.state_shape:
            expected = (
                "(B, H, W, n)" if batched else "(H, W, n) or (B, H, W, n)"
            )
            raise ValueError(
                f"expected a state of shape {expected} with (H, W, n) = "
                f"{self.state_shape}, got {tuple(y.shape)}"
            )
        if y.ndim == 4 and y.shape[0] == 0:
            raise ValueError("the batch of states is empty")
        if not y.is_contiguous():
            raise ValueError("the state must be contiguous")
        if y.device.type not in ("cpu", "cuda"):
            raise ValueError(
                f"unsupported device {y.device} (expected cpu or cuda)"
            )


# -- plain PyTorch versions -------------------------------------------------


class _Helpers:
    """``_StencilHelpers`` of the JAX package (unpadded) over ``(..., H,
    W)`` component planes, with its polar metric terms where ``inv_r``
    (the ``(H,)`` values of 1 / r) is given; with ``sum_then_ghost``
    (Cartesian only), the Laplacian of its ``_TiledStencilHelpers`` (the
    two axis terms summed, then the ghost rows, then the ghost columns
    added). ``faces`` are the Neumann ghost row mask and values ``(2, n,
    W)`` and ghost column mask and values ``(2, n, H)``."""

    def __init__(
        self,
        cfg: _SystemKernelConfig,
        faces,
        sum_then_ghost=False,
        inv_r: Optional[torch.Tensor] = None,
    ):
        self._cfg = cfg
        self._grm, self._grv, self._gcm, self._gcv = faces
        self._sum_then_ghost = sum_then_ghost
        # a column, to scale each row of a plane
        self._inv_r = None if inv_r is None else inv_r[:, None]
        self._shift_cache = {}

    def _shifts(self, state):
        # laplacian and both gradients of one plane share its shifts
        cached = self._shift_cache.get(id(state))
        if cached is not None and cached[0] is state:
            return cached[1]
        zero_row = torch.zeros_like(state[..., :1, :])
        zero_col = torch.zeros_like(state[..., :, :1])
        shifts = (
            torch.cat([zero_row, state[..., :-1, :]], dim=-2),
            torch.cat([state[..., 1:, :], zero_row], dim=-2),
            torch.cat([zero_col, state[..., :, :-1]], dim=-1),
            torch.cat([state[..., :, 1:], zero_col], dim=-1),
        )
        self._shift_cache[id(state)] = (state, shifts)
        return shifts

    def _ghost_rows(self, comp, state):
        """The masked ghost rows of the two axis-0 faces times 1 / dx0²."""
        cfg = self._cfg
        top = torch.where(
            self._grm[0, comp],
            state[..., 1, :] - cfg.two_dx0 * self._grv[0, comp],
            0.0,
        )
        bottom = torch.where(
            self._grm[1, comp],
            state[..., cfg.height - 2, :] + cfg.two_dx0 * self._grv[1, comp],
            0.0,
        )
        return top * cfg.inv_dx0_sqr, bottom * cfg.inv_dx0_sqr

    def _ghost_cols(self, comp, state):
        """The masked ghost columns of the two axis-1 faces times 1 /
        dx1²."""
        cfg = self._cfg
        left = torch.where(
            self._gcm[0, comp],
            state[..., :, 1] - cfg.two_dx1 * self._gcv[0, comp],
            0.0,
        )
        right = torch.where(
            self._gcm[1, comp],
            state[..., :, cfg.width - 2] + cfg.two_dx1 * self._gcv[1, comp],
            0.0,
        )
        return left * cfg.inv_dx1_sqr, right * cfg.inv_dx1_sqr

    def _add_rows(self, grid, top, bottom):
        height = self._cfg.height
        return torch.cat(
            [
                grid[..., :1, :] + top[..., None, :],
                grid[..., 1: height - 1, :],
                grid[..., height - 1:, :] + bottom[..., None, :],
            ],
            dim=-2,
        )

    def _add_cols(self, grid, left, right):
        width = self._cfg.width
        return torch.cat(
            [
                grid[..., :, :1] + left[..., :, None],
                grid[..., :, 1: width - 1],
                grid[..., :, width - 1:] + right[..., :, None],
            ],
            dim=-1,
        )

    def laplacian(self, comp, state):
        cfg = self._cfg
        above, below, left, right = self._shifts(state)
        d2_0 = (above - 2.0 * state + below) * cfg.inv_dx0_sqr
        d2_1 = (left - 2.0 * state + right) * cfg.inv_dx1_sqr
        if self._sum_then_ghost:
            lap = self._add_rows(d2_0 + d2_1, *self._ghost_rows(comp, state))
            return self._add_cols(lap, *self._ghost_cols(comp, state))
        d2_0 = self._add_rows(d2_0, *self._ghost_rows(comp, state))
        d2_1 = self._add_cols(d2_1, *self._ghost_cols(comp, state))
        if self._inv_r is None:
            return d2_0 + d2_1
        # polar: d2/dr2 + (d2/dtheta2 / r + d/dr) / r in the generic
        # operator's evaluation order
        inv_r = self._inv_r
        return d2_0 + (d2_1 * inv_r + self.gradient_0(comp, state)) * inv_r

    def gradient_0(self, comp, state):
        height = self._cfg.height
        above, below, _, _ = self._shifts(state)
        gradient = (below - above) * self._cfg.inv_two_dx0
        return torch.cat(
            [
                torch.where(
                    self._grm[0, comp], self._grv[0, comp], gradient[..., 0, :]
                )[..., None, :],
                gradient[..., 1: height - 1, :],
                torch.where(
                    self._grm[1, comp],
                    self._grv[1, comp],
                    gradient[..., height - 1, :],
                )[..., None, :],
            ],
            dim=-2,
        )

    def gradient_1(self, comp, state):
        """The column derivative, times 1 / r on a polar mesh."""
        width = self._cfg.width
        _, _, left, right = self._shifts(state)
        gradient = (right - left) * self._cfg.inv_two_dx1
        gradient = torch.cat(
            [
                torch.where(
                    self._gcm[0, comp], self._gcv[0, comp], gradient[..., :, 0]
                )[..., :, None],
                gradient[..., :, 1: width - 1],
                torch.where(
                    self._gcm[1, comp],
                    self._gcv[1, comp],
                    gradient[..., :, width - 1],
                )[..., :, None],
            ],
            dim=-1,
        )
        return gradient if self._inv_r is None else gradient * self._inv_r

    def over_r(self, plane):
        """``plane / r`` (polar): the shallow-water divergence's u / r."""
        return plane * self._inv_r


def _rhs(cfg: _SystemKernelConfig, helpers: _Helpers, y):
    """The JAX package's ``_make_rhs_builder`` over a tuple of component
    planes (wave, Burgers and shallow water; the helpers carry the polar
    metric, and the shallow-water divergence gains u / r)."""
    if cfg.equation_type is WaveEquation:
        return (y[1], cfg.coefficient * helpers.laplacian(0, y[0]))
    if cfg.equation_type is BurgersEquation:
        return tuple(
            cfg.coefficient * helpers.laplacian(comp, plane)
            - y[0] * helpers.gradient_0(comp, plane)
            - y[1] * helpers.gradient_1(comp, plane)
            for comp, plane in enumerate(y)
        )
    eta, u, w = y
    d_eta_0 = helpers.gradient_0(0, eta)
    d_eta_1 = helpers.gradient_1(0, eta)
    d_u_0 = helpers.gradient_0(1, u)
    d_u_1 = helpers.gradient_1(1, u)
    d_w_0 = helpers.gradient_0(2, w)
    d_w_1 = helpers.gradient_1(2, w)
    div = d_u_0 + d_w_1
    if cfg.polar:
        div = div + helpers.over_r(u)
    r_eta = (
        -cfg.depth * div
        - eta * d_u_0
        - u * d_eta_0
        - eta * d_w_1
        - w * d_eta_1
    )
    r_u = (
        cfg.coefficient * helpers.laplacian(1, u)
        - u * d_u_0
        - w * d_u_1
        - cfg.gravity * d_eta_0
        - cfg.drag * u
        + cfg.coriolis * w
    )
    r_w = (
        cfg.coefficient * helpers.laplacian(2, w)
        - u * d_w_0
        - w * d_w_1
        - cfg.gravity * d_eta_1
        - cfg.drag * w
        - cfg.coriolis * u
    )
    return (r_eta, r_u, r_w)


def _step_reference(
    state: torch.Tensor, cfg: _SystemKernelConfig, helpers: _Helpers, dirichlet
) -> torch.Tensor:
    """One step over ``(..., H, W, n)`` states in the evaluation order of
    the kernels and of the JAX package's step factories; ``dirichlet(comp,
    plane)`` is the Dirichlet override of one component."""
    y = tuple(state[..., comp] for comp in range(cfg.n))
    if cfg.equation_type is CahnHilliardEquation:
        # RK4 on y0' = d lap(y1) with y1 held through the stages (so k2 =
        # k3 = k4), then y1 assigned from the step-initial y0
        y0, y1 = y
        k1 = cfg.coefficient * helpers.laplacian(1, y1)
        k_rest = cfg.coefficient * helpers.laplacian(1, dirichlet(1, y1))
        y0_next = dirichlet(0, y0 + cfg.sixth_d_t * (k1 + 5.0 * k_rest))
        y1_next = dirichlet(
            1, (y0 * y0) * y0 - y0 - cfg.gamma * helpers.laplacian(0, y0)
        )
        return torch.stack((y0_next, y1_next), dim=-1)

    def rhs(planes):
        return _rhs(cfg, helpers, planes)

    def stage(k, scale):
        return tuple(
            dirichlet(comp, plane + scale * k_plane)
            for comp, (plane, k_plane) in enumerate(zip(y, k))
        )

    k1 = rhs(y)
    k2 = rhs(stage(k1, cfg.half_d_t))
    k3 = rhs(stage(k2, cfg.half_d_t))
    k4 = rhs(stage(k3, cfg.d_t))
    combined = tuple(
        k1_p + 2.0 * k2_p + 2.0 * k3_p + k4_p
        for k1_p, k2_p, k3_p, k4_p in zip(k1, k2, k3, k4)
    )
    return torch.stack(stage(combined, cfg.sixth_d_t), dim=-1)


def _navier_stokes_step_reference(
    state: torch.Tensor, cfg: _SystemKernelConfig, constants
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Navier-Stokes step over ``(..., H, W, 4)`` states (w, psi, u,
    v), the JAX package's Navier-Stokes branch of ``_make_step_factory``
    term for term: RK4 on the vorticity, ``w' = nu lap(w) - u d0(w) - v
    d1(w)``, with the velocities held through the stages (their Dirichlet
    values from the second stage on); the velocities from the
    step-initial stream function, ``u = d1(psi)``, ``v = -d0(psi)``; and
    the stream function solved from ``lap(psi') = -w`` by Jacobi sweeps
    ``psi + (lap(psi) + w) / denominator``, warm-started from ``psi``.

    Each state sweeps until the 2-norm of its update is at most
    ``cfg.tol`` or ``cfg.max_iterations`` sweeps have run, at least once.
    One deliberate difference from the JAX kernel: the sum of squares is
    accumulated in float64 (exact squares of float32 updates), so that
    the CUDA kernel, which sums in another order, takes the same branch
    (ROADMAP.md, Queue 3). Returns the next states and each state's
    number of sweeps (int64, the leading shape)."""
    dir_mask, dir_vals = constants[0], constants[1]
    faces = constants[2:6]

    def helpers():
        # one set per plane evaluated: the helpers memoize shifts by plane
        return _Helpers(cfg, faces)

    def dirichlet(comp, plane):
        return torch.where(dir_mask[comp], dir_vals[comp], plane)

    w, psi, u, v = (state[..., comp] for comp in range(4))

    def vorticity_rhs(w_, u_, v_):
        h = helpers()
        return (
            cfg.coefficient * h.laplacian(0, w_)
            - u_ * h.gradient_0(0, w_)
            - v_ * h.gradient_1(0, w_)
        )

    u_d = dirichlet(2, u)
    v_d = dirichlet(3, v)
    k1 = vorticity_rhs(w, u, v)
    k2 = vorticity_rhs(dirichlet(0, w + cfg.half_d_t * k1), u_d, v_d)
    k3 = vorticity_rhs(dirichlet(0, w + cfg.half_d_t * k2), u_d, v_d)
    k4 = vorticity_rhs(dirichlet(0, w + cfg.d_t * k3), u_d, v_d)
    w_next = dirichlet(
        0, w + cfg.sixth_d_t * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    )
    h = helpers()
    u_next = dirichlet(2, h.gradient_1(1, psi))
    v_next = dirichlet(3, -h.gradient_0(1, psi))

    rhs = -w
    # a tensor, so that the division is exact on the card too (PyTorch's
    # CUDA division by a host scalar multiplies by its reciprocal), as the
    # kernel's and the JAX kernel's are
    denominator = torch.tensor(
        cfg.denominator, dtype=state.dtype, device=state.device
    )

    def sweep(psi_):
        update = (helpers().laplacian(1, psi_) - rhs) / denominator
        return dirichlet(1, psi_ + update)

    psi, sweeps = jacobi(
        sweep,
        dirichlet(1, psi),
        cfg.tol,
        cfg.max_iterations,
        (-2, -1),
        torch.float64,
    )
    return torch.stack((w_next, psi, u_next, v_next), dim=-1), sweeps


def _k5_step_reference(
    state: torch.Tensor, cfg: _SystemKernelConfig, constants
) -> torch.Tensor:
    """One K5 step: the whole-grid helpers and the dense Dirichlet
    grids."""
    dir_mask, dir_vals = constants[0], constants[1]
    helpers = _Helpers(
        cfg, constants[2:6], inv_r=constants[6] if cfg.polar else None
    )

    def dirichlet(comp, plane):
        return torch.where(dir_mask[comp], dir_vals[comp], plane)

    return _step_reference(state, cfg, helpers, dirichlet)


def fused_system_rk4_trajectory_reference(
    y: torch.Tensor, cfg: _SystemKernelConfig, n_steps: int
) -> torch.Tensor:
    """Plain version of the K5 trajectory: ``(..., H, W, n) -> (...,
    n_steps, H, W, n)``."""
    constants = cfg.constants(y.device, y.dtype)
    out = y.new_empty(tuple(y.shape[:-3]) + (n_steps,) + tuple(y.shape[-3:]))
    state = y
    for k in range(n_steps):
        state = _k5_step_reference(state, cfg, constants)
        out[..., k, :, :, :] = state
    return out


def fused_system_rk4_end_reference(
    y: torch.Tensor, cfg: _SystemKernelConfig, n_steps: int
) -> torch.Tensor:
    """Plain version of the K5 end state: ``(..., H, W, n) -> (..., H, W,
    n)``."""
    constants = cfg.constants(y.device, y.dtype)
    state = y
    for _ in range(n_steps):
        state = _k5_step_reference(state, cfg, constants)
    return state


def fused_system_rk4_step_reference(
    y: torch.Tensor, cfg: _SystemKernelConfig
) -> torch.Tensor:
    """Plain version of the K5 step: ``(..., H, W, n) -> (..., H, W,
    n)``."""
    return _k5_step_reference(y, cfg, cfg.constants(y.device, y.dtype))


# -- kernel wrappers ----------------------------------------------------------


def _configure(library: ctypes.CDLL):
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    library.fused_system_rk4.argtypes = (
        [c_int, c_int, c_void_p, c_void_p]
        + [c_int] * 7
        + [c_void_p] * 7
        + [ctypes.POINTER(ctypes.c_float), c_void_p]
    )
    library.fused_system_rk4.restype = c_int
    library.fused_system_error_string.argtypes = [c_int]
    library.fused_system_error_string.restype = ctypes.c_char_p


def load_kernels() -> ctypes.CDLL:
    """The built and loaded kernel library (compiled on first use)."""
    from pararealml_tpu_torch.ops.cuda_library import load_library

    library = load_library("fused_system")
    if not getattr(library, "_signatures_set", False):
        _configure(library)
        library._signatures_set = True
    return library


# the most cells a K5 block holds (two a thread of 1,024), and the most
# that one block a state runs fastest with (one cell a thread, 128
# registers each); past it the largest cluster ran fastest (chip_smoke.py's
# K5 timings, NVIDIA H100 80GB HBM3 at 700 W: 36 x 51 x 3 polar shallow
# water 7.1 us a step on 8 blocks, 8.3 on 4, 9.6 on 2; 41 x 41 x 2
# Cahn-Hilliard 2.34 on 4 against 2.44 on one; 21 x 23 x 3 shallow water
# 6.1 on one against 7.9 on 2)
_MAX_BLOCK_CELLS = 2048
_ONE_BLOCK_CELLS = 512
# the card's multiprocessors: a batch of states whose blocks exceed them
# runs in more than one wave
_MULTIPROCESSORS = 132
def _block_cells(height: int, width: int, cluster_size: int) -> Optional[int]:
    """The cells of the largest block of a K5 cluster of ``cluster_size``
    blocks splitting an H x W grid's rows, or None where a block of the
    split would hold no row."""
    slab = -(-height // cluster_size)
    if (cluster_size - 1) * slab >= height:
        return None
    return slab * width


def k5_cluster_size(
    cfg: _SystemKernelConfig, batch: int = 1, one_block: bool = False
) -> int:
    """The blocks of the thread block cluster K5 splits each state of a
    batch over: one where a block holds the grid in at most 512 cells,
    else the most (up to 8) that split its rows, but no more than keep
    the batch's blocks within the card's 132 multiprocessors; with
    ``one_block`` (K4's batches, which measured fastest on one block a
    state) the fewest. Never fewer than the fewest whose blocks hold at
    most 2,048 cells, the kernel's limit."""
    sizes = []
    for cluster_size in (1, 2, 4, 8):
        cells = _block_cells(cfg.height, cfg.width, cluster_size)
        if cells is not None and cells <= _MAX_BLOCK_CELLS:
            sizes.append(cluster_size)
    if not sizes:
        raise ValueError(
            f"a {cfg.height} x {cfg.width} grid is past the kernel's range"
        )
    if one_block or cfg.height * cfg.width <= _ONE_BLOCK_CELLS:
        return sizes[0]
    chosen = sizes[-1]
    while chosen > sizes[0] and batch * chosen > _MULTIPROCESSORS:
        chosen = sizes[sizes.index(chosen) - 1]
    return chosen


def launch(
    y: torch.Tensor,
    out: torch.Tensor,
    cfg: _SystemKernelConfig,
    n_steps: int,
    write_trajectory: bool,
    cluster_size: Optional[int] = None,
):
    """Launches the kernel on ``y``'s device and its current stream for a
    contiguous ``(B, H, W, n)`` float32 CUDA state (one CTA per state, or
    with ``cluster_size`` 2, 4 or 8 one thread block cluster splitting
    each state's rows; :func:`k5_cluster_size`'s when None) and raises if
    the grid is past the kernel's range or the launch is refused. A
    trajectory's frames are stored in ``out``'s dtype, float32 or
    bfloat16. The wrappers here and in ``ops/packed_system.py`` call it
    and count their launches."""
    if (
        shared_memory_bytes(cfg.height, cfg.width, cfg.n, cfg.polar)
        > MAX_SHARED_MEMORY_BYTES
    ):
        raise ValueError(
            f"a {cfg.height} x {cfg.width} grid of {cfg.n}-component "
            "states is past the one-CTA kernel's range"
        )
    frame_bfloat16 = out.dtype == torch.bfloat16
    if out.dtype not in (torch.float32, torch.bfloat16) or (
        frame_bfloat16 and not write_trajectory
    ):
        raise TypeError(f"unsupported output dtype {out.dtype}")
    if cluster_size is None:
        cluster_size = k5_cluster_size(cfg, y.shape[0])
    library = load_kernels()
    constants = cfg.constants(y.device)
    if any(t.device != y.device for t in (out,) + constants):
        raise ValueError(
            f"the output and constraint tensors must be on {y.device}"
        )
    inv_r = constants[6].data_ptr() if cfg.polar else None
    coefficients = cfg.coefficient_array()
    # the ctypes launch targets the current device: make it y's
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        error = library.fused_system_rk4(
            cfg.equation,
            int(cfg.polar),
            y.data_ptr(),
            out.data_ptr(),
            y.shape[0],
            cfg.height,
            cfg.width,
            n_steps,
            int(write_trajectory),
            int(frame_bfloat16),
            cluster_size,
            *(c.data_ptr() for c in constants[:6]),
            inv_r,
            coefficients,
            stream,
        )
    if error != 0:
        message = library.fused_system_error_string(error).decode()
        raise RuntimeError(
            f"fused system kernel launch failed: {message} ({error})"
        )


def trajectory_buffer(
    batch: torch.Tensor, cfg, n_steps: int, dtype: torch.dtype = torch.float32
):
    """An uninitialized ``(B, n_steps, H, W, n)`` output of frames in
    ``dtype``."""
    return torch.empty(
        (batch.shape[0], n_steps) + cfg.state_shape,
        dtype=dtype,
        device=batch.device,
    )


def fused_system_rk4_trajectory(
    y: torch.Tensor, cfg: _SystemKernelConfig, n_steps: int
) -> torch.Tensor:
    """K5 trajectory: ``n_steps`` fused RK4 steps storing every step,
    ``(H, W, n) -> (n_steps, H, W, n)`` or ``(B, H, W, n) -> (B,
    n_steps, H, W, n)`` (one CTA per state)."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_system_rk4_trajectory_reference(y, cfg, n_steps)
    batch = y.reshape((-1,) + cfg.state_shape)
    out = trajectory_buffer(batch, cfg, n_steps)
    launch(batch, out, cfg, n_steps, write_trajectory=True)
    fused_system_rk4_trajectory.launches += 1
    return out if y.ndim == 4 else out[0]


def fused_system_rk4_end(
    y: torch.Tensor, cfg: _SystemKernelConfig, n_steps: int
) -> torch.Tensor:
    """K5 end: ``n_steps`` fused RK4 steps returning the end state only,
    ``(H, W, n) -> (H, W, n)`` or ``(B, H, W, n) -> (B, H, W, n)`` (one
    CTA per state)."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_system_rk4_end_reference(y, cfg, n_steps)
    batch = y.reshape((-1,) + cfg.state_shape)
    out = torch.empty_like(batch)
    launch(batch, out, cfg, n_steps, write_trajectory=False)
    fused_system_rk4_end.launches += 1
    return out.reshape(y.shape)


def fused_system_rk4_step(
    y: torch.Tensor, cfg: _SystemKernelConfig
) -> torch.Tensor:
    """K5 step: one fused RK4 step (the trajectory kernel with ``n_steps
    = 1``), ``(H, W, n) -> (H, W, n)`` or ``(B, H, W, n) -> (B, H, W,
    n)``."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_system_rk4_step_reference(y, cfg)
    batch = y.reshape((-1,) + cfg.state_shape)
    out = trajectory_buffer(batch, cfg, 1)
    launch(batch, out, cfg, 1, write_trajectory=True)
    fused_system_rk4_step.launches += 1
    return out.reshape(y.shape)


fused_system_rk4_trajectory.launches = 0
fused_system_rk4_end.launches = 0
fused_system_rk4_step.launches = 0


# -- the cluster-resident mode ------------------------------------------------

# The mode's range: clusters of up to 16 blocks (past 8 a non-portable
# size), each block at most 512 threads of up to 4 cells, or 1,024 of
# one (csrc/cluster_system.cu)
MAX_CLUSTER_SIZE = 16
CLUSTER_MAX_BLOCK_CELLS = 2048
_CLUSTER_THREADS = 512
_ONE_CELL_THREADS = 1024
_CLUSTER_CELLS = (1, 2, 4)
# the shared memory a block can opt into (MAX_SHARED_MEMORY_BYTES, which
# also gates K5's first design's working set)
_BLOCK_SHARED_BYTES = 227 * 1024
# The plan's table, by components, step kind ("rk4", or "cahn-hilliard"
# for its two-stage step) and polar grid: for each grid measured, its
# rows, columns, and the cluster size and cells a thread that ran its
# solve fastest (tools/cluster_plan_sweep.py, 1,000 steps, every plan of
# the instances, on an NVIDIA H100 80GB HBM3 at 700 W). A grid takes the
# entry of its kind (Cartesian where its polar kind has none) whose cell
# count is nearest its own on a log scale: the largest valid size up to
# the entry's, with the entry's cells a thread where they fit.
_MEASURED_CLUSTERS = {
    # the wave example: 4.473 us a step (16 x 2: 4.727; 12 x 2: 4.605)
    (2, "rk4", False): ((101, 101, 16, 1),),
    # the shallow-water example: 7.106 us (16 x 2: 8.154)
    (3, "rk4", False): ((101, 51, 16, 1),),
    # the Cahn-Hilliard example: 2.569 us (16 x 2: 2.672)
    (2, "cahn-hilliard", False): ((101, 101, 16, 1),),
    # the polar wave example: 4.799 us (16 x 1: 4.864)
    (2, "rk4", True): ((51, 201, 16, 2),),
}
# How many clusters of each size the card holds at once
# (cudaOccupancyMaxActiveClusters on the wave and shallow-water examples'
# kernels, tools/cluster_plan_sweep.py, NVIDIA H100 80GB HBM3), for blocks
# of more than 256 threads (one a multiprocessor: 128 registers a thread)
# and of at most 256 (two): what the plan assumes where no card is asked
# (the CPU); on the card the wrappers ask the card itself.
_MEASURED_ACTIVE_CLUSTERS = {
    False: {
        3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9, 10: 7,
        11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7,
    },
    True: {
        6: 39, 7: 32, 8: 30, 9: 37, 10: 30, 11: 16, 12: 16, 13: 14,
        14: 14, 15: 14, 16: 14,
    },
}


class ClusterPlan(NamedTuple):
    """How a cluster of ``cluster_size`` blocks splits the rows of an H x
    W grid of n-component states (as evenly as they divide), each thread
    owning up to ``cells`` cells of its block."""

    height: int
    width: int
    n_components: int
    polar: bool
    cluster_size: int
    cells: int

    @property
    def slab_rows(self) -> int:
        """The rows of the largest block."""
        return -(-self.height // self.cluster_size)

    @property
    def block_rows(self) -> Tuple[int, ...]:
        base, extra = divmod(self.height, self.cluster_size)
        return tuple(
            base + (rank < extra) for rank in range(self.cluster_size)
        )

    @property
    def block_cells(self) -> int:
        return self.slab_rows * self.width

    @property
    def threads(self) -> int:
        """The block's threads: its cells over ``cells``, in whole
        warps."""
        per_thread = -(-self.block_cells // self.cells)
        return 32 * -(-per_thread // 32)

    @property
    def shared_bytes(self) -> int:
        """Two sets of n float planes of the largest slab and its two halo
        rows, the float Neumann face vectors, on a polar grid 1 / r, and
        the byte masks (``shared_bytes_of`` in the kernel's header)."""
        faces = 2 * self.n_components * (self.height + self.width)
        planes = 2 * self.n_components * (self.slab_rows + 2) * self.width
        rows = self.height if self.polar else 0
        return 4 * (planes + faces + rows) + faces

    @property
    def fits(self) -> bool:
        """Whether the mode's instances take the plan: at most
        ``MAX_CLUSTER_SIZE`` blocks, each with a row, at most
        ``CLUSTER_MAX_BLOCK_CELLS`` cells in at most 1,024 threads of one
        cell or 512 of two or four, and its planes in one block's shared
        memory."""
        return (
            1 <= self.cluster_size <= min(MAX_CLUSTER_SIZE, self.height)
            and self.cells in _CLUSTER_CELLS
            and self.block_cells <= CLUSTER_MAX_BLOCK_CELLS
            and self.threads
            <= (_ONE_CELL_THREADS if self.cells == 1 else _CLUSTER_THREADS)
            and self.shared_bytes <= _BLOCK_SHARED_BYTES
        )


def _measured_active_clusters(plan: "ClusterPlan") -> int:
    return _MEASURED_ACTIVE_CLUSTERS[plan.threads <= 256].get(
        plan.cluster_size, 0
    )


def make_cluster_plan(
    height: int,
    width: int,
    n_components: int,
    polar: bool = False,
    step: str = "rk4",
    batch: int = 1,
    active_clusters=None,
) -> Optional[ClusterPlan]:
    """Plans the cluster-resident mode for a batch of ``batch`` H x W
    grids of n-component states, or returns None past the mode's range
    (no cluster of up to 16 blocks holds the grid). The size is the
    largest valid one up to the measured table's entry for the grid
    (``_MEASURED_CLUSTERS``) at which the card holds every state's
    cluster at once (``active_clusters(plan)``, by default the measured
    counts of ``_MEASURED_ACTIVE_CLUSTERS``), each thread owning the
    entry's cells where that plan fits and is held at once, else the
    fewest cells that are; where no size is, the smallest valid size
    (the batch runs in waves)."""
    if min(height, width) < 3:
        return None
    plans = [
        plan
        for plan in (
            ClusterPlan(height, width, n_components, polar, size, cells)
            for size in range(1, MAX_CLUSTER_SIZE + 1)
            for cells in _CLUSTER_CELLS
        )
        if plan.fits
    ]
    if not plans:
        return None
    entries = (
        _MEASURED_CLUSTERS.get((n_components, step, polar))
        or _MEASURED_CLUSTERS.get((n_components, step, False))
        or ((height, width, MAX_CLUSTER_SIZE, 1),)
    )
    cells = height * width
    _, _, preferred, preferred_cells = min(
        entries,
        key=lambda entry: abs(math.log(cells / (entry[0] * entry[1]))),
    )
    smallest = plans[0].cluster_size
    within = [
        plan
        for plan in plans
        if plan.cluster_size <= max(preferred, smallest)
    ]
    if active_clusters is None:
        active_clusters = _measured_active_clusters
    for plan in sorted(
        within,
        key=lambda plan: (
            -plan.cluster_size,
            plan.cells != preferred_cells,
            plan.cells,
        ),
    ):
        if active_clusters(plan) >= batch:
            return plan
    return within[0]


def _step_kind(cp_or_cfg) -> str:
    equation_type = (
        cp_or_cfg.equation_type
        if isinstance(cp_or_cfg, _SystemKernelConfig)
        else type(cp_or_cfg.differential_equation)
    )
    return "cahn-hilliard" if equation_type is CahnHilliardEquation else "rk4"


def cluster_system_applicable(cp: ConstrainedProblem) -> bool:
    """Whether the cluster-resident mode takes this (already
    type/BC/integrator-gated) 2D problem: past one CTA, within the JAX
    package's VMEM cap (where its K5 runs, interior Dirichlet constraints
    included) and within the mode's range. The JAX package's dispatch on
    its K5's grids, as far as a cluster reaches; past it K8."""
    if fits_one_block(cp) or not fits_reference_vmem(cp):
        return False
    if isinstance(cp.differential_equation, NavierStokesEquation):
        return False
    height, width = cp.mesh.vertices_shape
    return (
        make_cluster_plan(
            height,
            width,
            cp.differential_equation.y_dimension,
            _is_polar(cp),
            _step_kind(cp),
        )
        is not None
    )


def _configure_cluster(library: ctypes.CDLL):
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    library.cluster_system_rk4.argtypes = (
        [c_int, c_int, c_void_p, c_void_p]
        + [c_int] * 8
        + [c_void_p] * 7
        + [ctypes.POINTER(ctypes.c_float), c_void_p]
    )
    library.cluster_system_rk4.restype = c_int
    library.cluster_system_max_active_clusters.argtypes = [c_int] * 7 + [
        ctypes.POINTER(c_int)
    ]
    library.cluster_system_max_active_clusters.restype = c_int
    library.cluster_system_error_string.argtypes = [c_int]
    library.cluster_system_error_string.restype = ctypes.c_char_p


def load_cluster_kernels() -> ctypes.CDLL:
    """The built and loaded library of the cluster-resident mode
    (compiled on first use)."""
    from pararealml_tpu_torch.ops.cuda_library import load_library

    library = load_library("cluster_system")
    if not getattr(library, "_signatures_set", False):
        _configure_cluster(library)
        library._signatures_set = True
    return library


def _raise_cluster_error(library: ctypes.CDLL, error: int, plan):
    if error != 0:
        message = library.cluster_system_error_string(error).decode()
        raise RuntimeError(
            f"cluster system kernel launch failed on a cluster of "
            f"{plan.cluster_size} blocks of {plan.threads} threads, "
            f"{plan.cells} cells a thread: {message} ({error})"
        )


def card_active_clusters(cfg: _SystemKernelConfig, write_trajectory: bool):
    """``active_clusters(plan)`` for :func:`make_cluster_plan` from the
    card: how many clusters of the plan's kernel it holds at once
    (``cudaOccupancyMaxActiveClusters``), cached on ``cfg``."""
    library = load_cluster_kernels()
    cache = cfg._active_clusters

    def active_clusters(plan: ClusterPlan) -> int:
        key = (plan.cluster_size, plan.cells, write_trajectory)
        if key not in cache:
            count = ctypes.c_int(0)
            error = library.cluster_system_max_active_clusters(
                cfg.equation,
                int(cfg.polar),
                cfg.height,
                cfg.width,
                int(write_trajectory),
                plan.cluster_size,
                plan.cells,
                ctypes.byref(count),
            )
            _raise_cluster_error(library, error, plan)
            cache[key] = count.value
        return cache[key]

    return active_clusters


def cluster_plan(
    cfg: _SystemKernelConfig,
    batch: int = 1,
    plan: Optional[ClusterPlan] = None,
    active_clusters=None,
) -> ClusterPlan:
    """``plan`` (:func:`make_cluster_plan`'s for ``cfg`` and ``batch``
    when None), or a ValueError, on any device and before any launch,
    when the grid is past the mode's range or the plan does not fit the
    problem."""
    if plan is None:
        plan = make_cluster_plan(
            cfg.height,
            cfg.width,
            cfg.n,
            cfg.polar,
            _step_kind(cfg),
            batch,
            active_clusters,
        )
        if plan is None:
            raise ValueError(
                f"a {cfg.height} x {cfg.width} grid of {cfg.n}-component "
                "states is past the cluster-resident mode's range"
            )
    if (
        plan.height,
        plan.width,
        plan.n_components,
        plan.polar,
    ) != (cfg.height, cfg.width, cfg.n, cfg.polar) or not plan.fits:
        raise ValueError(
            f"cluster plan {plan} does not fit this {cfg.height} x "
            f"{cfg.width} x {cfg.n} problem or the mode's instances"
        )
    return plan


def launch_cluster(
    y: torch.Tensor,
    out: torch.Tensor,
    cfg: _SystemKernelConfig,
    n_steps: int,
    write_trajectory: bool,
    plan: Optional[ClusterPlan] = None,
) -> ClusterPlan:
    """Launches the cluster-resident mode on ``y``'s device and its
    current stream for a contiguous ``(B, H, W, n)`` float32 CUDA state,
    one cluster a state on ``plan`` (the plan the card's occupancy gives
    for the batch when None), and raises if the launch is refused (a
    cluster the card cannot place is refused before it starts). A
    trajectory's frames are stored in ``out``'s dtype, float32 or
    bfloat16. Returns the plan."""
    frame_bfloat16 = out.dtype == torch.bfloat16
    if out.dtype not in (torch.float32, torch.bfloat16) or (
        frame_bfloat16 and not write_trajectory
    ):
        raise TypeError(f"unsupported output dtype {out.dtype}")
    library = load_cluster_kernels()
    if plan is None:
        plan = cluster_plan(
            cfg, y.shape[0], None, card_active_clusters(cfg, write_trajectory)
        )
    constants = cfg.constants(y.device)
    if any(t.device != y.device for t in (out,) + constants):
        raise ValueError(
            f"the output and constraint tensors must be on {y.device}"
        )
    inv_r = constants[6].data_ptr() if cfg.polar else None
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        error = library.cluster_system_rk4(
            cfg.equation,
            int(cfg.polar),
            y.data_ptr(),
            out.data_ptr(),
            y.shape[0],
            cfg.height,
            cfg.width,
            n_steps,
            int(write_trajectory),
            int(frame_bfloat16),
            plan.cluster_size,
            plan.cells,
            *(c.data_ptr() for c in constants[:6]),
            inv_r,
            cfg.coefficient_array(),
            stream,
        )
    _raise_cluster_error(library, error, plan)
    return plan


def cluster_system_rk4_trajectory_reference(
    y: torch.Tensor,
    cfg: _SystemKernelConfig,
    n_steps: int,
    frame_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of the mode's trajectory: K5's, its frames rounded
    to ``frame_dtype`` (float32 or bfloat16, as K4's snapshots)."""
    frames = fused_system_rk4_trajectory_reference(y, cfg, n_steps)
    return frames if frame_dtype == frames.dtype else frames.to(frame_dtype)


def cluster_system_rk4_trajectory(
    y: torch.Tensor,
    cfg: _SystemKernelConfig,
    n_steps: int,
    frame_dtype: torch.dtype = torch.float32,
    plan: Optional[ClusterPlan] = None,
) -> torch.Tensor:
    """The cluster-resident mode's trajectory: ``n_steps`` RK4 steps in
    one launch, one cluster a state, storing every step, ``(H, W, n) ->
    (n_steps, H, W, n)`` or ``(B, H, W, n) -> (B, n_steps, H, W, n)``,
    the frames in ``frame_dtype`` (float32, or bfloat16 rounded over the
    float32 state carried). ``plan`` overrides the cluster plan (to
    exercise other cluster sizes); a grid past the mode's range, or a
    plan that does not fit, raises on any device before any launch."""
    cfg.check_state(y)
    if frame_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"frame_dtype must be float32 or bfloat16, got {frame_dtype}"
        )
    batch = y.reshape((-1,) + cfg.state_shape)
    if y.device.type == "cpu":
        cluster_plan(cfg, batch.shape[0], plan)
        return cluster_system_rk4_trajectory_reference(
            y, cfg, n_steps, frame_dtype
        )
    if plan is not None:
        cluster_plan(cfg, batch.shape[0], plan)
    out = trajectory_buffer(batch, cfg, n_steps, frame_dtype)
    launch_cluster(batch, out, cfg, n_steps, True, plan)
    cluster_system_rk4_trajectory.launches += 1
    return out if y.ndim == 4 else out[0]


def cluster_system_rk4_end(
    y: torch.Tensor,
    cfg: _SystemKernelConfig,
    n_steps: int,
    plan: Optional[ClusterPlan] = None,
) -> torch.Tensor:
    """The cluster-resident mode's end state: ``n_steps`` RK4 steps in
    one launch, one cluster a state, ``(H, W, n) -> (H, W, n)`` or ``(B,
    H, W, n) -> (B, H, W, n)``, in float32 (plain version: K5's,
    :func:`fused_system_rk4_end_reference`). ``plan`` as for the
    trajectory."""
    cfg.check_state(y)
    batch = y.reshape((-1,) + cfg.state_shape)
    if y.device.type == "cpu":
        cluster_plan(cfg, batch.shape[0], plan)
        return fused_system_rk4_end_reference(y, cfg, n_steps)
    if plan is not None:
        cluster_plan(cfg, batch.shape[0], plan)
    out = torch.empty_like(batch)
    launch_cluster(batch, out, cfg, n_steps, False, plan)
    cluster_system_rk4_end.launches += 1
    return out.reshape(y.shape)


cluster_system_rk4_trajectory.launches = 0
cluster_system_rk4_end.launches = 0


# -- builders mirroring the JAX package's API -------------------------------


def states(y: torch.Tensor, cfg: _SystemKernelConfig):
    """``(..., H, W, n)`` -> (leading shape, contiguous ``(B, H, W,
    n)``). The dtype is kept: the kernel wrappers raise on anything but
    float32."""
    lead = tuple(y.shape[:-3])
    if tuple(y.shape[-3:]) != cfg.state_shape:
        raise ValueError(
            f"expected a state of shape (..., {cfg.height}, {cfg.width}, "
            f"{cfg.n}), got {tuple(y.shape)}"
        )
    return lead, y.reshape((-1,) + cfg.state_shape).contiguous()


def build_fused_system_rk4_trajectory(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    storage_dtype=None,
    anti_laplacian_tol: float = 1e-3,
    anti_laplacian_max_iterations: int = 100_000,
):
    """Builds ``trajectory(y) -> ys`` computing ``n_steps`` fused RK4
    steps, ``(..., H, W, n) -> (..., n_steps, H, W, n)``: through the K5
    trajectory kernel (one CTA per leading index) where the grid fits one
    CTA, through the cluster-resident mode (one cluster per leading
    index, one launch) where :func:`cluster_system_applicable` admits it,
    else through the tiled kernel K8 (``build_tiled_system_rk4_trajectory``
    of :mod:`pararealml_tpu_torch.ops.tiled_system`). A polar grid past
    the JAX package's VMEM cap raises, as the JAX builder does.

    ``storage_dtype`` selects the precision of the stored trajectory and
    of the state carried from step to step, and the trajectory is returned
    in it, past the JAX package's VMEM cap only (:func:`fits_reference_vmem`;
    K8 there, as the JAX package's tiled kernel). Below the cap it is
    ignored, as the JAX package's whole-grid kernel ignores it: K5, the
    mode, or K8 past the mode's range, store float32.

    Navier-Stokes takes its cluster kernel
    (:mod:`pararealml_tpu_torch.ops.fused_navier_stokes`), whose stream
    function's Jacobi solve stops at ``anti_laplacian_tol`` or after
    ``anti_laplacian_max_iterations`` sweeps; the other families ignore
    both."""
    if isinstance(cp.differential_equation, NavierStokesEquation):
        from pararealml_tpu_torch.ops.fused_navier_stokes import (
            build_fused_navier_stokes_rk4_trajectory,
        )

        return build_fused_navier_stokes_rk4_trajectory(
            cp,
            d_t,
            n_steps,
            anti_laplacian_tol,
            anti_laplacian_max_iterations,
        )
    within_reference_vmem = fits_reference_vmem(cp)
    if _is_polar(cp) and not within_reference_vmem:
        raise ValueError(
            "polar grids past the JAX package's VMEM cap take the generic "
            "path (it has no tiled polar kernel to mirror)"
        )
    one_block = fits_one_block(cp)
    if not one_block and not cluster_system_applicable(cp):
        from pararealml_tpu_torch.ops.tiled_system import (
            build_tiled_system_rk4_trajectory,
        )

        return build_tiled_system_rk4_trajectory(
            cp,
            d_t,
            n_steps,
            storage_dtype=None if within_reference_vmem else storage_dtype,
        )
    cfg = _SystemKernelConfig(cp, d_t)

    def trajectory(y: torch.Tensor) -> torch.Tensor:
        lead, batch = states(y, cfg)
        kernel = (
            fused_system_rk4_trajectory
            if one_block
            else cluster_system_rk4_trajectory
        )
        out = kernel(batch, cfg, n_steps)
        return out.reshape(lead + (n_steps,) + cfg.state_shape)

    return trajectory


def build_fused_system_rk4_end(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    batch: Optional[int] = None,
    anti_laplacian_tol: float = 1e-3,
    anti_laplacian_max_iterations: int = 100_000,
):
    """Builds ``end(y) -> y_final`` advancing ``n_steps`` fused RK4 steps
    and returning ONLY the final state: through the K5 end kernel where
    the grid fits one CTA's shared memory, through the cluster-resident
    mode's end where :func:`cluster_system_applicable` admits it, else
    through K8's end mode (``build_tiled_system_rk4_end`` of
    :mod:`pararealml_tpu_torch.ops.tiled_system`, polar grids included)
    where K8 covers the problem, else ``None`` (interior Dirichlet
    constraints past the mode's range; a polar grid past the JAX
    package's VMEM cap).

    With ``batch=B``, ``end`` maps ``(B, H, W, n) -> (B, H, W, n)``, one
    CTA or cluster per state in one launch on K5 and the mode, every
    state in one launch a step on K8; otherwise it maps one ``(H, W, n)``
    state.
    Navier-Stokes takes its cluster kernel, one cluster per state (None
    where the grid fits no cluster), with the two anti-Laplacian
    settings of :func:`build_fused_system_rk4_trajectory`."""
    if isinstance(cp.differential_equation, NavierStokesEquation):
        from pararealml_tpu_torch.ops.fused_navier_stokes import (
            build_fused_navier_stokes_rk4_end,
        )

        return build_fused_navier_stokes_rk4_end(
            cp,
            d_t,
            n_steps,
            batch,
            anti_laplacian_tol,
            anti_laplacian_max_iterations,
        )
    one_block = fits_one_block(cp)
    if not one_block and not cluster_system_applicable(cp):
        from pararealml_tpu_torch.ops.tiled_system import (
            build_tiled_system_rk4_end,
            tiled_system_applicable,
        )

        if (_is_polar(cp) and not fits_reference_vmem(cp)) or (
            not tiled_system_applicable(cp)
        ):
            return None
        return build_tiled_system_rk4_end(cp, d_t, n_steps, batch)
    cfg = _SystemKernelConfig(cp, d_t)
    expected_lead = () if batch is None else (batch,)

    def end(y: torch.Tensor) -> torch.Tensor:
        lead, states_ = states(y, cfg)
        if lead != expected_lead:
            raise ValueError(
                f"expected leading shape {expected_lead}, got {lead}"
            )
        kernel = fused_system_rk4_end if one_block else cluster_system_rk4_end
        out = kernel(states_, cfg, n_steps)
        return out.reshape(y.shape)

    return end


def build_fused_system_rk4_step(
    cp: ConstrainedProblem,
    d_t: float,
    anti_laplacian_tol: float = 1e-3,
    anti_laplacian_max_iterations: int = 100_000,
):
    """Builds ``step(y) -> y_next`` computing one fused RK4 step, ``(...,
    H, W, n) -> (..., H, W, n)``: the K5 step kernel where the grid fits
    one CTA, else the one-step trajectory of the cluster-resident mode or
    K8 (as the JAX package reaches its tiled kernel through the
    trajectory builder), polar grids included; for Navier-Stokes the cluster kernel's step, with the two
    anti-Laplacian settings of :func:`build_fused_system_rk4_trajectory`."""
    if isinstance(cp.differential_equation, NavierStokesEquation):
        from pararealml_tpu_torch.ops.fused_navier_stokes import (
            build_fused_navier_stokes_rk4_step,
        )

        return build_fused_navier_stokes_rk4_step(
            cp, d_t, anti_laplacian_tol, anti_laplacian_max_iterations
        )
    if not fits_one_block(cp):
        trajectory = build_fused_system_rk4_trajectory(cp, d_t, 1)

        def tiled_step(y: torch.Tensor) -> torch.Tensor:
            return trajectory(y).reshape(y.shape)

        return tiled_step
    cfg = _SystemKernelConfig(cp, d_t)

    def step(y: torch.Tensor) -> torch.Tensor:
        _, batch = states(y, cfg)
        out = fused_system_rk4_step(batch, cfg)
        return out.reshape(y.shape)

    return step


# the JAX package's wave-specific aliases
build_fused_wave_rk4_trajectory = build_fused_system_rk4_trajectory
build_fused_wave_rk4_step = build_fused_system_rk4_step
