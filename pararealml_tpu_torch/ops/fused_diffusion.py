"""Fused RK4 kernels for 2D diffusion-family problems.

Port of the JAX package's ``ops/fused_diffusion.py``. The three Pallas
TPU kernels there — the trajectory (K1), the end state (K2, single or
batched over Parareal's slices) and the single step (K3) — become one
hand-written CUDA kernel template for Hopper, ``csrc/fused_diffusion.cu``
(see its header for the design). One CTA keeps one state on-chip for all
steps, so an RK4 solve reads the state once and writes either every step
or the end state.

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
solved with RK4, in float32, on a grid whose kernel working set fits the
227 KB of shared memory one CTA can hold. Larger grids take the generic
path; the JAX package's tiled and resident kernels for them are not
ported yet (ROADMAP.md, Queue 2, K6 and K7).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.differential_equation import (
    ConvectionDiffusionEquation,
    DiffusionEquation,
)
from pararealml_tpu_torch.mesh import CoordinateSystem

# the dynamic shared memory one CTA can opt into on Hopper (232,448 B)
MAX_SHARED_MEMORY_BYTES = 227 * 1024


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
    return (
        min(height, width) >= 3
        and shared_memory_bytes(height, width) <= MAX_SHARED_MEMORY_BYTES
    )


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
        + [c_int] * 6
        + [c_void_p] * 6
        + [c_float] * 10
        + [c_void_p]
    )
    library.fused_diffusion_rk4.restype = c_int
    library.fused_diffusion_error_string.argtypes = [c_int]
    library.fused_diffusion_error_string.restype = ctypes.c_char_p
    library.fused_diffusion_shared_bytes.argtypes = [c_int, c_int]
    library.fused_diffusion_shared_bytes.restype = ctypes.c_size_t


def load_kernels() -> ctypes.CDLL:
    """The built and loaded kernel library (compiled on first use)."""
    from pararealml_tpu_torch.ops.cuda_library import load_library

    library = load_library("fused_diffusion")
    if not getattr(library, "_signatures_set", False):
        _configure(library)
        # the applicability gate sizes the kernel's shared memory in
        # Python; the kernel carves it in C: both must agree
        for shape in ((3, 3), (21, 21), (17, 40)):
            if library.fused_diffusion_shared_bytes(
                *shape
            ) != shared_memory_bytes(*shape):
                raise RuntimeError(
                    "shared_memory_bytes disagrees with the kernel's "
                    "fused_diffusion_shared_bytes"
                )
        library._signatures_set = True
    return library


def _launch(
    y: torch.Tensor,
    out: torch.Tensor,
    cfg: _KernelConfig,
    n_steps: int,
    write_trajectory: bool,
):
    """Launches the kernel on ``y``'s device and its current stream for a
    contiguous ``(B, H, W)`` float32 CUDA state and raises if the launch
    is refused."""
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
            stream,
        )
    if error != 0:
        message = library.fused_diffusion_error_string(error).decode()
        raise RuntimeError(
            f"fused diffusion kernel launch failed: {message} ({error})"
        )


def fused_diffusion_rk4_trajectory(
    y: torch.Tensor, cfg: _KernelConfig, n_steps: int
) -> torch.Tensor:
    """K1: ``n_steps`` fused RK4 steps storing every step,
    ``(H, W) -> (n_steps, H, W)`` or ``(B, H, W) -> (B, n_steps, H, W)``
    (one CTA per state)."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_diffusion_rk4_trajectory_reference(y, cfg, n_steps)
    batch = y.reshape(-1, cfg.height, cfg.width)
    out = torch.empty(
        (batch.shape[0], n_steps, cfg.height, cfg.width),
        dtype=torch.float32,
        device=y.device,
    )
    _launch(batch, out, cfg, n_steps, write_trajectory=True)
    fused_diffusion_rk4_trajectory.launches += 1
    return out if y.ndim == 3 else out[0]


def fused_diffusion_rk4_end(
    y: torch.Tensor, cfg: _KernelConfig, n_steps: int
) -> torch.Tensor:
    """K2: ``n_steps`` fused RK4 steps returning the end state only,
    ``(H, W) -> (H, W)`` or ``(B, H, W) -> (B, H, W)`` (one CTA per
    state)."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_diffusion_rk4_end_reference(y, cfg, n_steps)
    batch = y.reshape(-1, cfg.height, cfg.width)
    out = torch.empty_like(batch)
    _launch(batch, out, cfg, n_steps, write_trajectory=False)
    fused_diffusion_rk4_end.launches += 1
    return out.reshape(y.shape)


def fused_diffusion_rk4_step(
    y: torch.Tensor, cfg: _KernelConfig
) -> torch.Tensor:
    """K3: one fused RK4 step (the K1 kernel with ``n_steps = 1``),
    ``(H, W) -> (H, W)`` or ``(B, H, W) -> (B, H, W)``."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_diffusion_rk4_step_reference(y, cfg)
    batch = y.reshape(-1, cfg.height, cfg.width)
    out = torch.empty(
        (batch.shape[0], 1, cfg.height, cfg.width),
        dtype=torch.float32,
        device=y.device,
    )
    _launch(batch, out, cfg, 1, write_trajectory=True)
    fused_diffusion_rk4_step.launches += 1
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
):
    """Builds ``trajectory(y) -> ys`` computing ``n_steps`` fused RK4
    steps through K1: ``(..., H, W, 1) -> (..., n_steps, H, W, 1)``,
    one CTA per leading index."""
    cfg = _KernelConfig(cp, d_t, diffusion_coefficient)

    def trajectory(y: torch.Tensor) -> torch.Tensor:
        lead, grids = _grids(y, cfg)
        out = fused_diffusion_rk4_trajectory(grids, cfg, n_steps)
        return out.reshape(lead + (n_steps, cfg.height, cfg.width, 1))

    return trajectory


def build_fused_diffusion_rk4_end(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    diffusion_coefficient: Optional[float] = None,
    batch: Optional[int] = None,
):
    """Builds ``end(y) -> y_final`` advancing ``n_steps`` fused RK4 steps
    through K2 and returning ONLY the final state, or ``None`` when the
    grid does not fit the kernel's shared memory.

    With ``batch=B``, ``end`` maps ``(B, H, W, 1) -> (B, H, W, 1)``, one
    CTA per slice; otherwise it maps one ``(H, W, 1)`` state."""
    height, width = cp.mesh.vertices_shape
    if shared_memory_bytes(height, width) > MAX_SHARED_MEMORY_BYTES:
        return None
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
    """Builds ``step(y) -> y_next`` computing one fused RK4 step through
    K3, ``(..., H, W, 1) -> (..., H, W, 1)``."""
    cfg = _KernelConfig(cp, d_t, diffusion_coefficient)

    def step(y: torch.Tensor) -> torch.Tensor:
        _, grids = _grids(y, cfg)
        out = fused_diffusion_rk4_step(grids, cfg)
        return out.reshape(y.shape)

    return step
