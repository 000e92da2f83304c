"""Fused RK4 kernels for 3D Cartesian problems (K9): diffusion,
convection-diffusion, wave, Burgers and Cahn-Hilliard.

Port of the JAX package's ``ops/fused_system_3d.py``. Its three Pallas TPU
kernels — the trajectory, the end state (single or batched) and the single
step — become launches of one hand-written CUDA kernel template for
Hopper, ``csrc/fused_system_3d.cu`` (see its header for the design). On
the TPU one core's VMEM held the whole volume; on Hopper one thread block
cluster does: its blocks split the depth axis (axis 0) into slabs, keep
them in shared memory for all steps, and read the planes across a slab
edge from each other's shared memory.

Each kernel has a wrapper and a plain PyTorch version beside it:

- ``fused_system_3d_rk4_trajectory``, ``fused_system_3d_rk4_end`` and
  ``fused_system_3d_rk4_step`` check their input, and launch the kernel for
  a CUDA tensor or run the plain version for a CPU tensor. There is no
  fallback: on a CUDA tensor the kernel runs or the wrapper raises. Each
  counts its kernel launches in a plain integer attribute, ``launches``.
- ``fused_system_3d_rk4_{trajectory,end,step}_reference`` are the plain
  versions, following the JAX package's ``_StencilHelpers3D``,
  ``_make_rhs_builder_3d`` and ``_make_step_factory_3d`` term for term on
  unpadded volumes (an out-of-grid neighbour reads as zero, which is what
  the TPU kernels' zero pads amount to). They run on any device and in any
  floating-point type.

States use the JAX package's layout: ``(D, H, W, n)``, or ``(B, D, H, W,
n)`` for a batch (one cluster per state).

Applicability (:func:`fused_system_3d_step_applicable`): one of the five
exact equation types on a 3D Cartesian mesh with static boundary
conditions, solved with RK4, in float32, on a volume that a cluster of at
most 8 blocks holds (:func:`make_cluster_plan_3d`: about 30^3 for three
components). The JAX package's gate is a VMEM budget instead (about 48^3
for three components); problems between the two take the generic path.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.differential_equation import (
    BurgersEquation,
    CahnHilliardEquation,
    ConvectionDiffusionEquation,
    DiffusionEquation,
    WaveEquation,
)
from pararealml_tpu_torch.mesh import CoordinateSystem

_EQUATION_TYPES_3D = (
    DiffusionEquation,
    ConvectionDiffusionEquation,
    WaveEquation,
    BurgersEquation,
    CahnHilliardEquation,
)
# the kernel template's equation functors, by equation type
_EQUATION_IDS = {equation: i for i, equation in enumerate(_EQUATION_TYPES_3D)}

# the dynamic shared memory one block can opt into on Hopper (232,448 B)
MAX_SHARED_MEMORY_BYTES = 227 * 1024
# the cluster sizes the kernel takes; 8 blocks is the portable limit
CLUSTER_SIZES = (1, 2, 4, 8)


def shared_memory_bytes_3d(
    planes: int, height: int, width: int, n_components: int
) -> int:
    """The kernel's shared-memory working set for a slab of ``planes``
    H x W planes of n-component states: five sets of n float slabs
    (state, two stage buffers, the RK4 accumulator and the Dirichlet
    values) and the Dirichlet byte masks, in the order the CUDA kernel
    carves them; the launch passes it to the kernel."""
    values = planes * height * width * n_components
    return 4 * 5 * values + values


class ClusterPlan3D(NamedTuple):
    """How one cluster holds a D x H x W volume of n-component states:
    block r of ``cluster_size`` keeps planes ``[r D // s, (r + 1) D //
    s)`` of axis 0."""

    cluster_size: int
    depth: int
    height: int
    width: int
    n_components: int

    @property
    def slabs(self) -> List[Tuple[int, int]]:
        """Each block's ``(first plane, end plane)``."""
        size, depth = self.cluster_size, self.depth
        return [
            (rank * depth // size, (rank + 1) * depth // size)
            for rank in range(size)
        ]

    @property
    def slab(self) -> int:
        """The most planes one block holds."""
        return -(-self.depth // self.cluster_size)

    @property
    def shared_bytes(self) -> int:
        return shared_memory_bytes_3d(
            self.slab, self.height, self.width, self.n_components
        )


def cluster_plan_3d(
    depth: int, height: int, width: int, n_components: int, cluster_size: int
) -> ClusterPlan3D:
    """The plan with ``cluster_size`` blocks, whether or not its slabs fit
    a block's shared memory (the kernel's host code refuses those)."""
    if cluster_size not in CLUSTER_SIZES:
        raise ValueError(
            f"cluster_size must be one of {CLUSTER_SIZES}, got {cluster_size}"
        )
    if depth < cluster_size:
        raise ValueError(
            f"a depth of {depth} planes cannot be split among "
            f"{cluster_size} blocks"
        )
    return ClusterPlan3D(cluster_size, depth, height, width, n_components)


def make_cluster_plan_3d(
    depth: int, height: int, width: int, n_components: int
) -> Optional[ClusterPlan3D]:
    """The smallest cluster (1, 2, 4 or 8 blocks, no more blocks than
    planes) whose largest slab fits a block's 227 KB of shared memory, or
    None when none does: at 5n floats and n bytes a cell, 21^3 x 3 takes 4
    blocks (6 planes, 166,698 B each), 31^3 x 2 takes 8 (4 planes,
    161,448 B), and 31^3 x 3 does not fit."""
    if min(depth, height, width) < 2:
        return None
    for size in CLUSTER_SIZES:
        if size > depth:
            break
        plan = ClusterPlan3D(size, depth, height, width, n_components)
        if plan.shared_bytes <= MAX_SHARED_MEMORY_BYTES:
            return plan
    return None


def fused_system_3d_step_applicable(
    cp: ConstrainedProblem,
    integrator,
    dtype: Optional[torch.dtype] = None,
) -> bool:
    """Whether the fused 3D kernels reproduce the generic path for this
    problem (and, when ``dtype`` is given, for states of that dtype: the
    kernels are float32 only)."""
    from pararealml_tpu_torch.operators.fdm.numerical_integrator import RK4

    diff_eq = cp.differential_equation
    # exact-type check: a user subclass may override the symbolic
    # equation system that the fused kernel would silently ignore
    if not (
        (dtype is None or dtype == torch.float32)
        and type(diff_eq) in _EQUATION_IDS
        and isinstance(integrator, RK4)
        and diff_eq.x_dimension == 3
        and cp.mesh is not None
        and cp.mesh.coordinate_system_type == CoordinateSystem.CARTESIAN
        and cp.are_all_boundary_conditions_static
    ):
        return False
    return (
        make_cluster_plan_3d(*cp.mesh.vertices_shape, diff_eq.y_dimension)
        is not None
    )


def _component_constraint_tensors_3d(
    cp: ConstrainedProblem, n: int
) -> Dict[str, np.ndarray]:
    """Dense static constraint arrays, one entry per component: Dirichlet
    volumes ``(n, D, H, W)`` and per-axis Neumann faces ``(2 faces, n,
    *other two axes)`` (the JAX package's
    ``_component_constraint_tensors_3d`` without the TPU padding). Values
    stay float64 here and take the state's dtype on the device."""
    depth, height, width = cp.mesh.vertices_shape

    if cp.static_y_vertex_constraints is not None:
        dir_mask = cp.static_y_vertex_constraints.mask.numpy().reshape(
            depth, height, width, n
        )
        dir_vals = cp.static_y_vertex_constraints.values.numpy().reshape(
            depth, height, width, n
        )
        dir_vals = np.where(dir_mask, dir_vals, 0.0)
    else:
        dir_mask = np.zeros((depth, height, width, n), bool)
        dir_vals = np.zeros((depth, height, width, n))

    def face_tensors(pair, face_shape):
        """(2 sides, n, *face_shape) mask and value arrays."""
        masks = np.zeros((2, n) + face_shape, bool)
        values = np.zeros((2, n) + face_shape)
        for side_index, side in enumerate(
            (pair.lower, pair.upper) if pair else (None, None)
        ):
            if side is None:
                continue
            masks[side_index] = np.moveaxis(
                side.mask.numpy().reshape(face_shape + (n,)), -1, 0
            )
            values[side_index] = np.moveaxis(
                side.values.numpy().reshape(face_shape + (n,)), -1, 0
            )
        return masks, values

    d_y = cp.static_boundary_vertex_constraints.d_y
    constants = dict(
        dir_mask=np.moveaxis(dir_mask, -1, 0),
        dir_vals=np.moveaxis(dir_vals.astype(np.float64), -1, 0),
    )
    for axis, face_shape in enumerate(
        ((height, width), (depth, width), (depth, height))
    ):
        mask, vals = face_tensors(d_y[axis], face_shape)
        constants[f"face_{axis}_mask"] = mask
        constants[f"face_{axis}_vals"] = vals
    return constants


_CONSTANT_NAMES = (
    "dir_mask",
    "dir_vals",
    "face_0_mask",
    "face_0_vals",
    "face_1_mask",
    "face_1_vals",
    "face_2_mask",
    "face_2_vals",
)


class _SystemKernelConfig3D:
    """Static configuration of the fused 3D kernels for one problem:
    volume geometry, the equation and its coefficients, the RK4 step's
    constants, the cluster plan, and the constraint tensors (copied to
    each device and dtype a state arrives in, once)."""

    def __init__(self, cp: ConstrainedProblem, d_t: float):
        diff_eq = cp.differential_equation
        if type(diff_eq) not in _EQUATION_IDS:
            raise ValueError(
                f"no fused 3D kernel for {type(diff_eq).__name__}"
            )
        if diff_eq.x_dimension != 3 or cp.mesh is None:
            raise ValueError("the fused 3D kernels take 3D meshes only")
        self.equation_type = type(diff_eq)
        self.equation = _EQUATION_IDS[self.equation_type]
        self.n = n = diff_eq.y_dimension
        self.depth, self.height, self.width = cp.mesh.vertices_shape
        d_x = tuple(float(v) for v in cp.mesh.d_x)
        # the JAX package computes these in float64 on the host and
        # float32 arithmetic rounds them, as the plain version's Python
        # scalars are rounded and as the kernel receives them
        self.d_t = float(d_t)
        self.half_d_t = 0.5 * self.d_t
        self.sixth_d_t = self.d_t / 6.0
        self.inv_dx_sqr = tuple(1.0 / v**2 for v in d_x)
        self.inv_two_dx = tuple(1.0 / (2.0 * v) for v in d_x)
        self.two_dx = tuple(2.0 * v for v in d_x)
        self.gamma = 0.0
        self.velocity = (0.0, 0.0, 0.0)
        if self.equation_type is WaveEquation:
            self.coefficient = float(diff_eq._c) ** 2
        elif self.equation_type is BurgersEquation:
            self.coefficient = 1.0 / float(diff_eq._re)
        else:
            self.coefficient = float(diff_eq._d)
        if self.equation_type is ConvectionDiffusionEquation:
            self.velocity = tuple(float(v) for v in diff_eq._velocity)
        if self.equation_type is CahnHilliardEquation:
            self.gamma = float(diff_eq._gamma)
        self.velocity_mask = sum(
            1 << axis for axis, v in enumerate(self.velocity) if v != 0.0
        )
        self.plan = make_cluster_plan_3d(
            self.depth, self.height, self.width, n
        )
        self._host_constants = {
            name: torch.as_tensor(value)
            for name, value in _component_constraint_tensors_3d(cp, n).items()
        }
        self._constants: Dict[tuple, Tuple[torch.Tensor, ...]] = {}

    @property
    def state_shape(self) -> Tuple[int, int, int, int]:
        return (self.depth, self.height, self.width, self.n)

    def coefficient_array(self):
        """The kernel's coefficient argument as C floats: d_t / 2, d_t,
        d_t / 6, the coefficient, gamma, then per axis 1 / dx^2, 1 /
        (2 dx), 2 dx and the velocity."""
        values = (
            self.half_d_t,
            self.d_t,
            self.sixth_d_t,
            self.coefficient,
            self.gamma,
            *self.inv_dx_sqr,
            *self.inv_two_dx,
            *self.two_dx,
            *self.velocity,
        )
        return (ctypes.c_float * len(values))(*values)

    def constants(
        self, device: torch.device, dtype: torch.dtype = torch.float32
    ) -> Tuple[torch.Tensor, ...]:
        """The eight constraint tensors on ``device`` in kernel argument
        order: masks as uint8, values in ``dtype``."""
        key = (device, dtype)
        constants = self._constants.get(key)
        if constants is None:
            constants = tuple(
                self._host_constants[name]
                .to(
                    device=device,
                    dtype=torch.uint8 if name.endswith("mask") else dtype,
                )
                .contiguous()
                for name in _CONSTANT_NAMES
            )
            self._constants[key] = constants
        return constants

    def check_state(self, y: torch.Tensor, batched: bool = False):
        """Raises unless ``y`` is a contiguous float32 ``(D, H, W, n)`` or
        ``(B, D, H, W, n)`` tensor (only the latter when ``batched``) on
        the CPU or a CUDA device."""
        if y.dtype != torch.float32:
            raise TypeError(
                f"the fused 3D kernels take float32, got {y.dtype}"
            )
        ranks = (5,) if batched else (4, 5)
        if y.ndim not in ranks or tuple(y.shape[-4:]) != self.state_shape:
            expected = "(B, D, H, W, n)"
            if not batched:
                expected = "(D, H, W, n) or " + expected
            raise ValueError(
                f"expected a state of shape {expected} with (D, H, W, n) = "
                f"{self.state_shape}, got {tuple(y.shape)}"
            )
        if y.ndim == 5 and y.shape[0] == 0:
            raise ValueError("the batch of states is empty")
        if not y.is_contiguous():
            raise ValueError("the state must be contiguous")
        if y.device.type not in ("cpu", "cuda"):
            raise ValueError(
                f"unsupported device {y.device} (expected cpu or cuda)"
            )


# -- plain PyTorch versions -------------------------------------------------


class _Helpers3D:
    """``_StencilHelpers3D`` of the JAX package (unpadded) over ``(..., D,
    H, W)`` component volumes, with float 0/1 face masks blended
    arithmetically as there."""

    def __init__(self, cfg: _SystemKernelConfig3D, faces):
        self._cfg = cfg
        # per axis: (float mask, values), each (2, n, *other two axes)
        self._faces = faces
        self._sizes = (cfg.depth, cfg.height, cfg.width)
        self._shift_cache = {}

    def _shifts(self, state, axis):
        # a component's Laplacian and gradients share its shifts
        key = (id(state), axis)
        cached = self._shift_cache.get(key)
        if cached is not None and cached[0] is state:
            return cached[1]
        dim, size = axis - 3, self._sizes[axis]
        lower = torch.zeros_like(state)
        lower.narrow(dim, 1, size - 1).copy_(state.narrow(dim, 0, size - 1))
        upper = torch.zeros_like(state)
        upper.narrow(dim, 0, size - 1).copy_(state.narrow(dim, 1, size - 1))
        self._shift_cache[key] = (state, (lower, upper))
        return lower, upper

    def laplacian(self, comp, state):
        cfg = self._cfg
        lap = None
        for axis in range(3):
            lower, upper = self._shifts(state, axis)
            term = (lower - 2.0 * state + upper) * cfg.inv_dx_sqr[axis]
            lap = term if lap is None else lap + term
        # Neumann ghost contributions on each axis's two faces:
        # ghost = inner neighbour -/+ 2 dx * the constrained derivative
        for axis in range(3):
            dim, size = axis - 3, self._sizes[axis]
            mask, vals = self._faces[axis]
            ghost_low = mask[0, comp] * (
                state.select(dim, 1) - cfg.two_dx[axis] * vals[0, comp]
            )
            ghost_high = mask[1, comp] * (
                state.select(dim, size - 2) + cfg.two_dx[axis] * vals[1, comp]
            )
            first = lap.select(dim, 0)
            first.copy_(first + ghost_low * cfg.inv_dx_sqr[axis])
            last = lap.select(dim, size - 1)
            last.copy_(last + ghost_high * cfg.inv_dx_sqr[axis])
        return lap

    def gradient(self, axis, comp, state):
        """Central derivative along ``axis`` with zero halos, boundary
        faces replaced by the constrained normal derivative where
        masked."""
        dim, size = axis - 3, self._sizes[axis]
        lower, upper = self._shifts(state, axis)
        gradient = (upper - lower) * self._cfg.inv_two_dx[axis]
        mask, vals = self._faces[axis]
        first = mask[0, comp] * vals[0, comp] + (
            1.0 - mask[0, comp]
        ) * gradient.select(dim, 0)
        last = mask[1, comp] * vals[1, comp] + (
            1.0 - mask[1, comp]
        ) * gradient.select(dim, size - 1)
        gradient.select(dim, 0).copy_(first)
        gradient.select(dim, size - 1).copy_(last)
        return gradient


def _rhs(cfg: _SystemKernelConfig3D, helpers: _Helpers3D, y):
    """The JAX package's ``_make_rhs_builder_3d`` over a tuple of
    component volumes."""
    if cfg.equation_type is ConvectionDiffusionEquation:
        result = cfg.coefficient * helpers.laplacian(0, y[0])
        for axis, v in enumerate(cfg.velocity):
            if v != 0.0:
                result = result - v * helpers.gradient(axis, 0, y[0])
        return (result,)
    if cfg.equation_type is DiffusionEquation:
        return (cfg.coefficient * helpers.laplacian(0, y[0]),)
    if cfg.equation_type is WaveEquation:
        return (y[1], cfg.coefficient * helpers.laplacian(0, y[0]))
    return tuple(
        cfg.coefficient * helpers.laplacian(comp, volume)
        - y[0] * helpers.gradient(0, comp, volume)
        - y[1] * helpers.gradient(1, comp, volume)
        - y[2] * helpers.gradient(2, comp, volume)
        for comp, volume in enumerate(y)
    )


def _step_reference(
    state: torch.Tensor, cfg: _SystemKernelConfig3D, constants
) -> torch.Tensor:
    """One step over ``(..., D, H, W, n)`` states in the evaluation order
    of the kernel and of the JAX package's ``_make_step_factory_3d``."""
    dir_mask, dir_vals = constants[0] != 0, constants[1]
    faces = [
        (constants[2 + 2 * axis].to(state.dtype), constants[3 + 2 * axis])
        for axis in range(3)
    ]
    helpers = _Helpers3D(cfg, faces)

    def dirichlet(comp, volume):
        return torch.where(dir_mask[comp], dir_vals[comp], volume)

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

    def rhs(volumes):
        return _rhs(cfg, helpers, volumes)

    def stage(k, scale):
        return tuple(
            dirichlet(comp, volume + scale * k_volume)
            for comp, (volume, k_volume) in enumerate(zip(y, k))
        )

    k1 = rhs(y)
    k2 = rhs(stage(k1, cfg.half_d_t))
    k3 = rhs(stage(k2, cfg.half_d_t))
    k4 = rhs(stage(k3, cfg.d_t))
    combined = tuple(
        k1_v + 2.0 * k2_v + 2.0 * k3_v + k4_v
        for k1_v, k2_v, k3_v, k4_v in zip(k1, k2, k3, k4)
    )
    return torch.stack(stage(combined, cfg.sixth_d_t), dim=-1)


def fused_system_3d_rk4_trajectory_reference(
    y: torch.Tensor, cfg: _SystemKernelConfig3D, n_steps: int
) -> torch.Tensor:
    """Plain version of the K9 trajectory: ``(..., D, H, W, n) -> (...,
    n_steps, D, H, W, n)``."""
    constants = cfg.constants(y.device, y.dtype)
    out = y.new_empty(tuple(y.shape[:-4]) + (n_steps,) + tuple(y.shape[-4:]))
    state = y
    for k in range(n_steps):
        state = _step_reference(state, cfg, constants)
        out[..., k, :, :, :, :] = state
    return out


def fused_system_3d_rk4_end_reference(
    y: torch.Tensor, cfg: _SystemKernelConfig3D, n_steps: int
) -> torch.Tensor:
    """Plain version of the K9 end state: ``(..., D, H, W, n) -> (..., D,
    H, W, n)``."""
    constants = cfg.constants(y.device, y.dtype)
    state = y
    for _ in range(n_steps):
        state = _step_reference(state, cfg, constants)
    return state


def fused_system_3d_rk4_step_reference(
    y: torch.Tensor, cfg: _SystemKernelConfig3D
) -> torch.Tensor:
    """Plain version of the K9 step: ``(..., D, H, W, n) -> (..., D, H, W,
    n)``."""
    return _step_reference(y, cfg, cfg.constants(y.device, y.dtype))


# -- kernel wrappers ----------------------------------------------------------


def _configure(library: ctypes.CDLL):
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    library.fused_system_3d_rk4.argtypes = (
        [c_int, c_void_p, c_void_p]
        + [c_int] * 8
        + [ctypes.c_size_t]
        + [c_void_p] * 8
        + [ctypes.POINTER(ctypes.c_float), c_int, c_void_p]
    )
    library.fused_system_3d_rk4.restype = c_int
    library.fused_system_3d_error_string.argtypes = [c_int]
    library.fused_system_3d_error_string.restype = ctypes.c_char_p


def load_kernels() -> ctypes.CDLL:
    """The built and loaded kernel library (compiled on first use)."""
    from pararealml_tpu_torch.ops.cuda_library import load_library

    library = load_library("fused_system_3d")
    if not getattr(library, "_signatures_set", False):
        _configure(library)
        library._signatures_set = True
    return library


def _plan(cfg: _SystemKernelConfig3D, cluster_size: Optional[int]):
    if cluster_size is not None:
        return cluster_plan_3d(
            cfg.depth, cfg.height, cfg.width, cfg.n, cluster_size
        )
    if cfg.plan is None:
        raise ValueError(
            f"a {cfg.depth} x {cfg.height} x {cfg.width} volume of "
            f"{cfg.n}-component states does not fit a cluster of 8 blocks"
        )
    return cfg.plan


def launch(
    y: torch.Tensor,
    out: torch.Tensor,
    cfg: _SystemKernelConfig3D,
    n_steps: int,
    write_trajectory: bool,
    cluster_size: Optional[int] = None,
):
    """Launches the kernel on ``y``'s device and its current stream for a
    contiguous ``(B, D, H, W, n)`` float32 CUDA state (one cluster per
    state) and raises if the launch is refused: the volume is outside the
    kernel's range, or the card cannot place one cluster."""
    plan = _plan(cfg, cluster_size)
    library = load_kernels()
    constants = cfg.constants(y.device)
    if any(t.device != y.device for t in (out,) + constants):
        raise ValueError(
            f"the output and constraint tensors must be on {y.device}"
        )
    coefficients = cfg.coefficient_array()
    # the ctypes launch targets the current device: make it y's
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        error = library.fused_system_3d_rk4(
            cfg.equation,
            y.data_ptr(),
            out.data_ptr(),
            y.shape[0],
            cfg.depth,
            cfg.height,
            cfg.width,
            n_steps,
            int(write_trajectory),
            plan.cluster_size,
            plan.slab,
            plan.shared_bytes,
            *(c.data_ptr() for c in constants),
            coefficients,
            cfg.velocity_mask,
            stream,
        )
    if error != 0:
        message = library.fused_system_3d_error_string(error).decode()
        raise RuntimeError(
            f"fused 3D kernel launch failed with a cluster of "
            f"{plan.cluster_size} blocks of {plan.shared_bytes} bytes of "
            f"shared memory: {message} ({error})"
        )


def _trajectory_buffer(batch: torch.Tensor, cfg, n_steps: int):
    return torch.empty(
        (batch.shape[0], n_steps) + cfg.state_shape,
        dtype=torch.float32,
        device=batch.device,
    )


def fused_system_3d_rk4_trajectory(
    y: torch.Tensor,
    cfg: _SystemKernelConfig3D,
    n_steps: int,
    cluster_size: Optional[int] = None,
) -> torch.Tensor:
    """K9 trajectory: ``n_steps`` fused steps storing every step, ``(D, H,
    W, n) -> (n_steps, D, H, W, n)`` or ``(B, D, H, W, n) -> (B, n_steps,
    D, H, W, n)`` (one cluster per state). ``cluster_size`` overrides the
    plan's (to exercise other splits)."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_system_3d_rk4_trajectory_reference(y, cfg, n_steps)
    batch = y.reshape((-1,) + cfg.state_shape)
    out = _trajectory_buffer(batch, cfg, n_steps)
    launch(batch, out, cfg, n_steps, True, cluster_size)
    fused_system_3d_rk4_trajectory.launches += 1
    return out if y.ndim == 5 else out[0]


def fused_system_3d_rk4_end(
    y: torch.Tensor,
    cfg: _SystemKernelConfig3D,
    n_steps: int,
    cluster_size: Optional[int] = None,
) -> torch.Tensor:
    """K9 end: ``n_steps`` fused steps returning the end state only,
    ``(D, H, W, n) -> (D, H, W, n)`` or ``(B, D, H, W, n) -> (B, D, H, W,
    n)`` (one cluster per state)."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_system_3d_rk4_end_reference(y, cfg, n_steps)
    batch = y.reshape((-1,) + cfg.state_shape)
    out = torch.empty_like(batch)
    launch(batch, out, cfg, n_steps, False, cluster_size)
    fused_system_3d_rk4_end.launches += 1
    return out.reshape(y.shape)


def fused_system_3d_rk4_step(
    y: torch.Tensor,
    cfg: _SystemKernelConfig3D,
    cluster_size: Optional[int] = None,
) -> torch.Tensor:
    """K9 step: one fused step (the trajectory kernel with ``n_steps =
    1``), ``(D, H, W, n) -> (D, H, W, n)`` or ``(B, D, H, W, n) -> (B, D,
    H, W, n)``."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_system_3d_rk4_step_reference(y, cfg)
    batch = y.reshape((-1,) + cfg.state_shape)
    out = _trajectory_buffer(batch, cfg, 1)
    launch(batch, out, cfg, 1, True, cluster_size)
    fused_system_3d_rk4_step.launches += 1
    return out.reshape(y.shape)


fused_system_3d_rk4_trajectory.launches = 0
fused_system_3d_rk4_end.launches = 0
fused_system_3d_rk4_step.launches = 0


# -- builders mirroring the JAX package's API -------------------------------


def _states(y: torch.Tensor, cfg: _SystemKernelConfig3D):
    """``(..., D, H, W, n)`` -> (leading shape, contiguous ``(B, D, H, W,
    n)``). The dtype is kept: the kernel wrappers raise on anything but
    float32."""
    lead = tuple(y.shape[:-4])
    if tuple(y.shape[-4:]) != cfg.state_shape:
        raise ValueError(
            f"expected a state of shape (..., {cfg.depth}, {cfg.height}, "
            f"{cfg.width}, {cfg.n}), got {tuple(y.shape)}"
        )
    return lead, y.reshape((-1,) + cfg.state_shape).contiguous()


def build_fused_system_3d_rk4_trajectory(
    cp: ConstrainedProblem, d_t: float, n_steps: int
):
    """Builds ``trajectory(y) -> ys`` computing ``n_steps`` fused steps of
    a 3D problem through the K9 trajectory kernel: ``(..., D, H, W, n) ->
    (..., n_steps, D, H, W, n)``, one cluster per leading index. Raises
    ValueError for other equation types than the five."""
    cfg = _SystemKernelConfig3D(cp, d_t)

    def trajectory(y: torch.Tensor) -> torch.Tensor:
        lead, batch = _states(y, cfg)
        out = fused_system_3d_rk4_trajectory(batch, cfg, n_steps)
        return out.reshape(lead + (n_steps,) + cfg.state_shape)

    return trajectory


def build_fused_system_3d_rk4_end(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    batch: Optional[int] = None,
):
    """Builds ``end(y) -> y_final`` advancing ``n_steps`` fused steps
    through the K9 end kernel and returning ONLY the final state, or
    ``None`` when the volume does not fit a cluster (see
    :func:`make_cluster_plan_3d`).

    With ``batch=B``, ``end`` maps ``(B, D, H, W, n) -> (B, D, H, W, n)``,
    one cluster per state; otherwise it maps one ``(D, H, W, n)`` state."""
    cfg = _SystemKernelConfig3D(cp, d_t)
    if cfg.plan is None:
        return None
    expected_lead = () if batch is None else (batch,)

    def end(y: torch.Tensor) -> torch.Tensor:
        lead, states = _states(y, cfg)
        if lead != expected_lead:
            raise ValueError(
                f"expected leading shape {expected_lead}, got {lead}"
            )
        out = fused_system_3d_rk4_end(states, cfg, n_steps)
        return out.reshape(y.shape)

    return end


def build_fused_system_3d_rk4_step(cp: ConstrainedProblem, d_t: float):
    """Builds ``step(y) -> y_next`` computing one fused step through the K9
    step kernel (the one-step trajectory), ``(..., D, H, W, n) -> (..., D,
    H, W, n)``."""
    cfg = _SystemKernelConfig3D(cp, d_t)

    def step(y: torch.Tensor) -> torch.Tensor:
        _, batch = _states(y, cfg)
        out = fused_system_3d_rk4_step(batch, cfg)
        return out.reshape(y.shape)

    return step
