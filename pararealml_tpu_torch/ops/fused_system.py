"""Fused RK4 kernels for multi-component 2D systems (K5).

Port of the JAX package's ``ops/fused_system.py`` for the viscous Burgers
system on Cartesian meshes. Its three Pallas TPU kernels — the trajectory,
the end state (single or batched) and the single step — become launches
of one hand-written CUDA kernel template for Hopper,
``csrc/fused_system.cu`` (see its header for the design), which the
batched kernels of ``ops/packed_system.py`` (K4) launch too.
One CTA keeps one state on-chip for all steps, so an RK4 solve reads the
state once and writes either every step or the end state.

Each kernel has a wrapper and a plain PyTorch version beside it:

- ``fused_system_rk4_trajectory``, ``fused_system_rk4_end`` and
  ``fused_system_rk4_step`` check their input, and launch the kernel for
  a CUDA tensor or run the plain version for a CPU tensor. There is no
  fallback: on a CUDA tensor the kernel runs or the wrapper raises. Each
  counts its kernel launches in a plain integer attribute, ``launches``.
- ``fused_system_rk4_{trajectory,end,step}_reference`` are the plain
  versions, following the JAX package's ``_make_rhs_builder`` and
  ``_StencilHelpers`` term for term. They run on any device.

States use the JAX package's layout: ``(H, W, n)``, or ``(B, H, W, n)``
for a batch (one CTA per state).

Applicability (:func:`fused_system_step_applicable`): a 2D Cartesian
``BurgersEquation`` problem with static boundary conditions, solved with
RK4, in float32, on a grid whose kernel working set fits the 227 KB of
shared memory one CTA can hold. The JAX package's other families of this
kernel (wave, shallow water, Cahn-Hilliard, Navier-Stokes), its polar
meshes and its beyond-VMEM tiled variant are not ported yet (ROADMAP.md,
Queue 2): those problems take the generic path.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.differential_equation import BurgersEquation
from pararealml_tpu_torch.mesh import CoordinateSystem

# the dynamic shared memory one CTA can opt into on Hopper (232,448 B)
MAX_SHARED_MEMORY_BYTES = 227 * 1024

# the kernel template's equation functors, by equation type
_EQUATION_IDS = {BurgersEquation: 0}


def shared_memory_bytes(height: int, width: int, n_components: int) -> int:
    """The kernel's shared-memory working set for an H x W grid of
    n-component states: five sets of n float planes (state, two stage
    buffers, the RK4 accumulator and the Dirichlet values), the float
    Neumann face vectors and the byte masks. Must match
    ``fused_system_shared_bytes`` in the CUDA source."""
    values = height * width * n_components
    faces = 2 * n_components * (height + width)
    return 4 * (5 * values + faces) + values + faces


def fused_system_step_applicable(
    cp: ConstrainedProblem,
    integrator,
    dtype: Optional[torch.dtype] = None,
) -> bool:
    """Whether the fused system kernels reproduce the generic path for
    this problem (and, when ``dtype`` is given, for states of that
    dtype: the kernels are float32 only)."""
    from pararealml_tpu_torch.operators.fdm.numerical_integrator import RK4

    diff_eq = cp.differential_equation
    # exact-type check: a user subclass may override the symbolic
    # equation system that the fused kernel would silently ignore
    if not (
        (dtype is None or dtype == torch.float32)
        and type(diff_eq) in _EQUATION_IDS
        and isinstance(integrator, RK4)
        and diff_eq.x_dimension == 2
        and cp.mesh is not None
        and cp.mesh.coordinate_system_type == CoordinateSystem.CARTESIAN
        and cp.are_all_boundary_conditions_static
    ):
        return False
    height, width = cp.mesh.vertices_shape
    return (
        min(height, width) >= 3
        and shared_memory_bytes(height, width, diff_eq.y_dimension)
        <= MAX_SHARED_MEMORY_BYTES
    )


def _component_constraint_tensors(
    cp: ConstrainedProblem, n: int
) -> Dict[str, np.ndarray]:
    """Dense static constraint arrays, one entry per component: Dirichlet
    grids ``(n, H, W)`` and Neumann face vectors ``(2 faces, n, length)``
    (the JAX package's ``_component_constraint_tensors``)."""
    height, width = cp.mesh.vertices_shape
    dtype = np.float32

    if cp.static_y_vertex_constraints is not None:
        dir_mask = cp.static_y_vertex_constraints.mask.numpy().reshape(
            height, width, n
        )
        dir_vals = cp.static_y_vertex_constraints.values.numpy().reshape(
            height, width, n
        )
        dir_vals = np.where(dir_mask, dir_vals, 0.0)
    else:
        dir_mask = np.zeros((height, width, n), bool)
        dir_vals = np.zeros((height, width, n))

    def face_vectors(pair, length):
        """(2 sides, n components, length) mask and value arrays."""
        masks = np.zeros((2, n, length), bool)
        values = np.zeros((2, n, length), dtype)
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
            ).astype(dtype)
        return masks, values

    d_y = cp.static_boundary_vertex_constraints.d_y
    ghost_row_mask, ghost_row_vals = face_vectors(d_y[0], width)
    ghost_col_mask, ghost_col_vals = face_vectors(d_y[1], height)
    return dict(
        dir_mask=np.moveaxis(dir_mask, -1, 0),
        dir_vals=np.moveaxis(dir_vals.astype(dtype), -1, 0),
        ghost_row_mask=ghost_row_mask,
        ghost_row_vals=ghost_row_vals,
        ghost_col_mask=ghost_col_mask,
        ghost_col_vals=ghost_col_vals,
    )


_CONSTANT_NAMES = (
    "dir_mask",
    "dir_vals",
    "ghost_row_mask",
    "ghost_row_vals",
    "ghost_col_mask",
    "ghost_col_vals",
)


class _SystemKernelConfig:
    """Static configuration of the fused system kernels for one problem:
    grid geometry, the equation and its coefficient, the RK4 step's
    float32 constants, and the constraint tensors (copied to each device
    a state arrives on, once)."""

    def __init__(self, cp: ConstrainedProblem, d_t: float):
        diff_eq = cp.differential_equation
        self.equation = _EQUATION_IDS[type(diff_eq)]
        self.n = n = diff_eq.y_dimension
        mesh = cp.mesh
        self.height, self.width = mesh.vertices_shape
        d_x0, d_x1 = mesh.d_x
        # the JAX package computes these in float64 on the host and the
        # kernel rounds them to float32, as the plain version's Python
        # scalars are rounded
        self.coefficient = 1.0 / float(diff_eq._re)
        self.d_t = float(d_t)
        self.half_d_t = 0.5 * self.d_t
        self.sixth_d_t = self.d_t / 6.0
        self.inv_dx0_sqr = 1.0 / float(d_x0) ** 2
        self.inv_dx1_sqr = 1.0 / float(d_x1) ** 2
        self.inv_two_dx0 = 1.0 / (2.0 * float(d_x0))
        self.inv_two_dx1 = 1.0 / (2.0 * float(d_x1))
        self.two_dx0 = 2.0 * float(d_x0)
        self.two_dx1 = 2.0 * float(d_x1)
        self._host_constants = {
            name: torch.as_tensor(value)
            for name, value in _component_constraint_tensors(cp, n).items()
        }
        self._constants: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    @property
    def state_shape(self) -> Tuple[int, int, int]:
        return (self.height, self.width, self.n)

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
    """``_StencilHelpers`` of the JAX package (Cartesian, unpadded) over
    ``(..., H, W)`` component planes."""

    def __init__(self, cfg: _SystemKernelConfig, constants):
        self._cfg = cfg
        _, _, self._grm, self._grv, self._gcm, self._gcv = constants
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

    def laplacian(self, comp, state):
        cfg = self._cfg
        height, width = cfg.height, cfg.width
        above, below, left, right = self._shifts(state)
        d2_0 = (above - 2.0 * state + below) * cfg.inv_dx0_sqr
        ghost_top = torch.where(
            self._grm[0, comp],
            state[..., 1, :] - cfg.two_dx0 * self._grv[0, comp],
            0.0,
        )
        ghost_bottom = torch.where(
            self._grm[1, comp],
            state[..., height - 2, :] + cfg.two_dx0 * self._grv[1, comp],
            0.0,
        )
        d2_0 = torch.cat(
            [
                d2_0[..., :1, :] + ghost_top[..., None, :] * cfg.inv_dx0_sqr,
                d2_0[..., 1: height - 1, :],
                d2_0[..., height - 1:, :]
                + ghost_bottom[..., None, :] * cfg.inv_dx0_sqr,
            ],
            dim=-2,
        )
        d2_1 = (left - 2.0 * state + right) * cfg.inv_dx1_sqr
        ghost_left = torch.where(
            self._gcm[0, comp],
            state[..., :, 1] - cfg.two_dx1 * self._gcv[0, comp],
            0.0,
        )
        ghost_right = torch.where(
            self._gcm[1, comp],
            state[..., :, width - 2] + cfg.two_dx1 * self._gcv[1, comp],
            0.0,
        )
        d2_1 = torch.cat(
            [
                d2_1[..., :, :1] + ghost_left[..., :, None] * cfg.inv_dx1_sqr,
                d2_1[..., :, 1: width - 1],
                d2_1[..., :, width - 1:]
                + ghost_right[..., :, None] * cfg.inv_dx1_sqr,
            ],
            dim=-1,
        )
        return d2_0 + d2_1

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
        width = self._cfg.width
        _, _, left, right = self._shifts(state)
        gradient = (right - left) * self._cfg.inv_two_dx1
        return torch.cat(
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


def _burgers_rhs(cfg: _SystemKernelConfig, helpers: _Helpers, y):
    """The JAX package's ``_make_rhs_builder``, BurgersEquation branch,
    over a tuple of component planes."""
    viscosity = cfg.coefficient
    return tuple(
        viscosity * helpers.laplacian(comp, plane)
        - y[0] * helpers.gradient_0(comp, plane)
        - y[1] * helpers.gradient_1(comp, plane)
        for comp, plane in enumerate(y)
    )


def _rk4_reference(
    state: torch.Tensor, cfg: _SystemKernelConfig, constants
) -> torch.Tensor:
    """One RK4 step over ``(..., H, W, n)`` states in the evaluation
    order of the kernel and of the JAX package's RK4 step factory."""
    dir_mask, dir_vals = constants[0], constants[1]
    helpers = _Helpers(cfg, constants)

    def rhs(y):
        return _burgers_rhs(cfg, helpers, y)

    def apply_dirichlet(y):
        return tuple(
            torch.where(dir_mask[comp], dir_vals[comp], plane)
            for comp, plane in enumerate(y)
        )

    def axpy(y, k, scale):
        return tuple(plane + scale * k_plane for plane, k_plane in zip(y, k))

    y = tuple(state[..., comp] for comp in range(cfg.n))
    k1 = rhs(y)
    k2 = rhs(apply_dirichlet(axpy(y, k1, cfg.half_d_t)))
    k3 = rhs(apply_dirichlet(axpy(y, k2, cfg.half_d_t)))
    k4 = rhs(apply_dirichlet(axpy(y, k3, cfg.d_t)))
    combined = tuple(
        k1_p + 2.0 * k2_p + 2.0 * k3_p + k4_p
        for k1_p, k2_p, k3_p, k4_p in zip(k1, k2, k3, k4)
    )
    return torch.stack(
        apply_dirichlet(axpy(y, combined, cfg.sixth_d_t)), dim=-1
    )


def fused_system_rk4_trajectory_reference(
    y: torch.Tensor, cfg: _SystemKernelConfig, n_steps: int
) -> torch.Tensor:
    """Plain version of the K5 trajectory: ``(..., H, W, n) -> (...,
    n_steps, H, W, n)``."""
    constants = cfg.constants(y.device)
    out = y.new_empty(tuple(y.shape[:-3]) + (n_steps,) + tuple(y.shape[-3:]))
    state = y
    for k in range(n_steps):
        state = _rk4_reference(state, cfg, constants)
        out[..., k, :, :, :] = state
    return out


def fused_system_rk4_end_reference(
    y: torch.Tensor, cfg: _SystemKernelConfig, n_steps: int
) -> torch.Tensor:
    """Plain version of the K5 end state: ``(..., H, W, n) -> (..., H, W,
    n)``."""
    constants = cfg.constants(y.device)
    state = y
    for _ in range(n_steps):
        state = _rk4_reference(state, cfg, constants)
    return state


def fused_system_rk4_step_reference(
    y: torch.Tensor, cfg: _SystemKernelConfig
) -> torch.Tensor:
    """Plain version of the K5 step: ``(..., H, W, n) -> (..., H, W,
    n)``."""
    return _rk4_reference(y, cfg, cfg.constants(y.device))


# -- kernel wrappers ----------------------------------------------------------


def _configure(library: ctypes.CDLL):
    c_int, c_float, c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    library.fused_system_rk4.argtypes = (
        [c_int, c_void_p, c_void_p]
        + [c_int] * 5
        + [c_void_p] * 6
        + [c_float] * 10
        + [c_void_p]
    )
    library.fused_system_rk4.restype = c_int
    library.fused_system_error_string.argtypes = [c_int]
    library.fused_system_error_string.restype = ctypes.c_char_p
    library.fused_system_shared_bytes.argtypes = [c_int, c_int, c_int]
    library.fused_system_shared_bytes.restype = ctypes.c_size_t


def load_kernels() -> ctypes.CDLL:
    """The built and loaded kernel library (compiled on first use)."""
    from pararealml_tpu_torch.ops.cuda_library import load_library

    library = load_library("fused_system")
    if not getattr(library, "_signatures_set", False):
        _configure(library)
        # the applicability gate sizes the kernel's shared memory in
        # Python; the kernel carves it in C: both must agree
        for shape in ((3, 3, 2), (21, 21, 2), (17, 40, 2)):
            if library.fused_system_shared_bytes(
                *shape
            ) != shared_memory_bytes(*shape):
                raise RuntimeError(
                    "shared_memory_bytes disagrees with the kernel's "
                    "fused_system_shared_bytes"
                )
        library._signatures_set = True
    return library


def launch(
    y: torch.Tensor,
    out: torch.Tensor,
    cfg: _SystemKernelConfig,
    n_steps: int,
    write_trajectory: bool,
):
    """Launches the kernel on ``y``'s device and its current stream for a
    contiguous ``(B, H, W, n)`` float32 CUDA state (one CTA per state)
    and raises if the launch is refused. The wrappers here and in
    ``ops/packed_system.py`` call it and count their launches."""
    library = load_kernels()
    constants = cfg.constants(y.device)
    if any(t.device != y.device for t in (out,) + constants):
        raise ValueError(
            f"the output and constraint tensors must be on {y.device}"
        )
    # the ctypes launch targets the current device: make it y's
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        error = library.fused_system_rk4(
            cfg.equation,
            y.data_ptr(),
            out.data_ptr(),
            y.shape[0],
            cfg.height,
            cfg.width,
            n_steps,
            int(write_trajectory),
            *(c.data_ptr() for c in constants),
            cfg.half_d_t,
            cfg.d_t,
            cfg.sixth_d_t,
            cfg.coefficient,
            cfg.inv_dx0_sqr,
            cfg.inv_dx1_sqr,
            cfg.inv_two_dx0,
            cfg.inv_two_dx1,
            cfg.two_dx0,
            cfg.two_dx1,
            stream,
        )
    if error != 0:
        message = library.fused_system_error_string(error).decode()
        raise RuntimeError(
            f"fused system kernel launch failed: {message} ({error})"
        )


def trajectory_buffer(batch: torch.Tensor, cfg, n_steps: int):
    """An uninitialized ``(B, n_steps, H, W, n)`` float32 output."""
    return torch.empty(
        (batch.shape[0], n_steps) + cfg.state_shape,
        dtype=torch.float32,
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
    cp: ConstrainedProblem, d_t: float, n_steps: int
):
    """Builds ``trajectory(y) -> ys`` computing ``n_steps`` fused RK4
    steps through the K5 trajectory kernel: ``(..., H, W, n) -> (...,
    n_steps, H, W, n)``, one CTA per leading index."""
    cfg = _SystemKernelConfig(cp, d_t)

    def trajectory(y: torch.Tensor) -> torch.Tensor:
        lead, batch = states(y, cfg)
        out = fused_system_rk4_trajectory(batch, cfg, n_steps)
        return out.reshape(lead + (n_steps,) + cfg.state_shape)

    return trajectory


def build_fused_system_rk4_end(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    batch: Optional[int] = None,
):
    """Builds ``end(y) -> y_final`` advancing ``n_steps`` fused RK4 steps
    through the K5 end kernel and returning ONLY the final state, or
    ``None`` when the grid does not fit the kernel's shared memory.

    With ``batch=B``, ``end`` maps ``(B, H, W, n) -> (B, H, W, n)``, one
    CTA per state; otherwise it maps one ``(H, W, n)`` state."""
    height, width = cp.mesh.vertices_shape
    n = cp.differential_equation.y_dimension
    if shared_memory_bytes(height, width, n) > MAX_SHARED_MEMORY_BYTES:
        return None
    cfg = _SystemKernelConfig(cp, d_t)
    expected_lead = () if batch is None else (batch,)

    def end(y: torch.Tensor) -> torch.Tensor:
        lead, states_ = states(y, cfg)
        if lead != expected_lead:
            raise ValueError(
                f"expected leading shape {expected_lead}, got {lead}"
            )
        out = fused_system_rk4_end(states_, cfg, n_steps)
        return out.reshape(y.shape)

    return end


def build_fused_system_rk4_step(cp: ConstrainedProblem, d_t: float):
    """Builds ``step(y) -> y_next`` computing one fused RK4 step through
    the K5 step kernel, ``(..., H, W, n) -> (..., H, W, n)``."""
    cfg = _SystemKernelConfig(cp, d_t)

    def step(y: torch.Tensor) -> torch.Tensor:
        _, batch = states(y, cfg)
        out = fused_system_rk4_step(batch, cfg)
        return out.reshape(y.shape)

    return step
