"""The fused Navier-Stokes RK4 kernel: K5's Navier-Stokes family.

Port of the Navier-Stokes branch of the JAX package's
``ops/fused_system.py`` kernels (K5: ``build_fused_system_rk4_trajectory``,
``build_fused_system_rk4_end`` single or batched, and
``build_fused_system_rk4_step``) for the 2D vorticity-stream-function
system on Cartesian meshes. Its three Pallas TPU kernels become launches
of one hand-written CUDA kernel for Hopper, ``csrc/fused_navier_stokes.cu``
(see its header for the design): one thread block cluster of 1, 2, 4 or 8
blocks holds one state for the whole solve, each block a slab of rows in
shared memory, with the stream function's Jacobi solve inside the kernel.

Each kernel has a wrapper and a plain PyTorch version beside it:

- ``fused_navier_stokes_rk4_trajectory``, ``fused_navier_stokes_rk4_end``
  and ``fused_navier_stokes_rk4_step`` check their input, and launch the
  kernel for a CUDA tensor or run the plain version for a CPU tensor.
  There is no fallback: on a CUDA tensor the kernel runs or the wrapper
  raises. Each counts its kernel launches in ``launches``, and keeps the
  Jacobi sweeps of each state of its last call (the kernel's device
  counters, or the plain version's) in ``sweeps``. They take a test-only
  ``cluster_size=`` to exercise other slab splits.
- ``fused_navier_stokes_rk4_{trajectory,end,step}_reference`` are the
  plain versions, over ``_navier_stokes_step_reference`` of
  :mod:`pararealml_tpu_torch.ops.fused_system` (the JAX package's
  Navier-Stokes branch term for term). They run on any device and in any
  floating-point type, and return the sweeps beside the states.

States use the JAX package's layout: ``(H, W, 4)`` (w, psi, u, v), or
``(B, H, W, 4)`` for a batch (one cluster per state).

Applicability is :func:`~pararealml_tpu_torch.ops.fused_system.
fused_navier_stokes_step_applicable`: the JAX package's gate (a Cartesian
mesh within its VMEM cap, static boundary conditions, RK4, float32) and a
grid that fits the largest cluster (:func:`make_cluster_plan_2d`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.differential_equation import NavierStokesEquation
from pararealml_tpu_torch.mesh import CoordinateSystem
from pararealml_tpu_torch.ops.fused_system import (
    MAX_SHARED_MEMORY_BYTES,
    _navier_stokes_step_reference,
    _SystemKernelConfig,
    states,
)

CLUSTER_SIZES = (1, 2, 4, 8)
# the kernel's shared-memory reduction scratch: two partial-sum slots and
# one sum for each of at most 32 warps, as doubles
_REDUCTION_BYTES = 8 * (2 + 32)


def shared_memory_bytes_2d(rows: int, width: int) -> int:
    """The kernel's shared-memory working set for a slab of ``rows`` rows
    of ``width`` cells: the reduction's doubles, twelve float planes (w,
    psi, u, v; w's two stage buffers and RK4 accumulator; the second
    stream-function buffer; the four Dirichlet value planes) and the four
    Dirichlet byte-mask planes, in the order the CUDA kernel carves them;
    the launch passes it to the kernel."""
    return _REDUCTION_BYTES + (12 * 4 + 4) * rows * width


class ClusterPlan2D(NamedTuple):
    """How one cluster holds an H x W grid: block r of ``cluster_size``
    keeps rows ``[r H // s, (r + 1) H // s)``."""

    cluster_size: int
    height: int
    width: int

    @property
    def slab(self) -> int:
        """The most rows one block holds."""
        return -(-self.height // self.cluster_size)

    @property
    def shared_bytes(self) -> int:
        return shared_memory_bytes_2d(self.slab, self.width)

    @property
    def fits(self) -> bool:
        """Whether each block's slab fits its shared memory."""
        return self.shared_bytes <= MAX_SHARED_MEMORY_BYTES


def cluster_plan_2d(
    height: int, width: int, cluster_size: int
) -> ClusterPlan2D:
    """The plan with ``cluster_size`` blocks, whether or not its slabs fit
    a block's shared memory (the kernel's launch refuses those)."""
    if cluster_size not in CLUSTER_SIZES:
        raise ValueError(
            f"cluster_size must be one of {CLUSTER_SIZES}, got {cluster_size}"
        )
    if height < cluster_size:
        raise ValueError(
            f"a height of {height} rows cannot be split among "
            f"{cluster_size} blocks"
        )
    return ClusterPlan2D(cluster_size, height, width)


def make_cluster_plan_2d(height: int, width: int) -> Optional[ClusterPlan2D]:
    """The smallest cluster (1, 2, 4 or 8 blocks, no more blocks than
    rows) whose largest slab fits a block's 227 KB of shared memory, or
    None when none does: at 52 bytes a cell, 17 x 17 takes one block,
    the example's 101 x 81 two (51 rows, 215,084 B each), and square grids
    up to 186 x 186 eight."""
    if min(height, width) < 3:
        return None
    for size in CLUSTER_SIZES:
        if size > height:
            break
        plan = ClusterPlan2D(size, height, width)
        if plan.fits:
            return plan
    return None


class _NavierStokesConfig(_SystemKernelConfig):
    """K5's configuration of a Navier-Stokes problem with its cluster
    plan (None where the grid fits no cluster)."""

    def __init__(
        self,
        cp: ConstrainedProblem,
        d_t: float,
        anti_laplacian_tol: float = 1e-3,
        anti_laplacian_max_iterations: int = 100_000,
    ):
        if type(cp.differential_equation) is not NavierStokesEquation or (
            cp.mesh.coordinate_system_type != CoordinateSystem.CARTESIAN
        ):
            raise ValueError(
                "the fused Navier-Stokes kernel takes Navier-Stokes "
                "problems on Cartesian meshes only"
            )
        if anti_laplacian_max_iterations < 0:
            raise ValueError("max_iterations must be non-negative")
        super().__init__(
            cp, d_t, anti_laplacian_tol, anti_laplacian_max_iterations
        )
        self.plan = make_cluster_plan_2d(self.height, self.width)


# -- plain PyTorch versions -------------------------------------------------


def _steps_reference(
    y: torch.Tensor,
    cfg: _NavierStokesConfig,
    n_steps: int,
    frames: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_steps`` plain steps from ``(..., H, W, 4)`` states, writing each
    into ``frames[..., k, :, :, :]`` when given; returns the end states and
    each state's total sweeps."""
    constants = cfg.constants(y.device, y.dtype)
    state = y
    sweeps = torch.zeros(tuple(y.shape[:-3]), dtype=torch.int64,
                         device=y.device)
    for k in range(n_steps):
        state, step_sweeps = _navier_stokes_step_reference(
            state, cfg, constants
        )
        sweeps = sweeps + step_sweeps
        if frames is not None:
            frames[..., k, :, :, :] = state
    return state, sweeps


def fused_navier_stokes_rk4_trajectory_reference(
    y: torch.Tensor, cfg: _NavierStokesConfig, n_steps: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the trajectory: ``(..., H, W, 4) -> (..., n_steps,
    H, W, 4)``, and each state's total Jacobi sweeps."""
    frames = y.new_empty(
        tuple(y.shape[:-3]) + (n_steps,) + tuple(y.shape[-3:])
    )
    _, sweeps = _steps_reference(y, cfg, n_steps, frames)
    return frames, sweeps


def fused_navier_stokes_rk4_end_reference(
    y: torch.Tensor, cfg: _NavierStokesConfig, n_steps: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the end state: ``(..., H, W, 4) -> (..., H, W,
    4)``, and each state's total Jacobi sweeps."""
    return _steps_reference(y, cfg, n_steps, None)


def fused_navier_stokes_rk4_step_reference(
    y: torch.Tensor, cfg: _NavierStokesConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one step: ``(..., H, W, 4) -> (..., H, W, 4)``,
    and each state's Jacobi sweeps."""
    return _navier_stokes_step_reference(
        y, cfg, cfg.constants(y.device, y.dtype)
    )


# -- kernel wrappers ----------------------------------------------------------


def _configure(library: ctypes.CDLL):
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    library.fused_navier_stokes_rk4.argtypes = (
        [c_void_p] * 3
        + [c_int] * 7
        + [ctypes.c_size_t]
        + [c_void_p] * 6
        + [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_float,
            ctypes.c_double,
            c_int,
            c_void_p,
        ]
    )
    library.fused_navier_stokes_rk4.restype = c_int
    library.fused_navier_stokes_error_string.argtypes = [c_int]
    library.fused_navier_stokes_error_string.restype = ctypes.c_char_p


def load_kernels() -> ctypes.CDLL:
    """The built and loaded kernel library (compiled on first use)."""
    from pararealml_tpu_torch.ops.cuda_library import load_library

    library = load_library("fused_navier_stokes")
    if not getattr(library, "_signatures_set", False):
        _configure(library)
        library._signatures_set = True
    return library


def _plan(cfg: _NavierStokesConfig, cluster_size: Optional[int]):
    if cluster_size is not None:
        return cluster_plan_2d(cfg.height, cfg.width, cluster_size)
    if cfg.plan is None:
        raise ValueError(
            f"a {cfg.height} x {cfg.width} Navier-Stokes grid does not fit "
            "a cluster of 8 blocks"
        )
    return cfg.plan


def launch(
    y: torch.Tensor,
    out: torch.Tensor,
    sweeps: torch.Tensor,
    cfg: _NavierStokesConfig,
    n_steps: int,
    write_trajectory: bool,
    cluster_size: Optional[int] = None,
):
    """Launches the kernel on ``y``'s device and its current stream for a
    contiguous ``(B, H, W, 4)`` float32 CUDA state (one cluster per state)
    and raises if the kernel's host code refuses the launch: a cluster the
    card cannot place, among them one whose slabs overflow a block's
    shared memory. ``sweeps`` ((B,) int64) receives each state's Jacobi
    sweeps."""
    plan = _plan(cfg, cluster_size)
    if any(t.data_ptr() % 16 for t in (y, out)):
        raise ValueError("the state and output must be 16-byte aligned")
    library = load_kernels()
    constants = cfg.constants(y.device)
    if any(t.device != y.device for t in (out, sweeps) + constants):
        raise ValueError(
            f"the output and constraint tensors must be on {y.device}"
        )
    # the ctypes launch targets the current device: make it y's
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        error = library.fused_navier_stokes_rk4(
            y.data_ptr(),
            out.data_ptr(),
            sweeps.data_ptr(),
            y.shape[0],
            cfg.height,
            cfg.width,
            n_steps,
            int(write_trajectory),
            plan.cluster_size,
            plan.slab,
            plan.shared_bytes,
            *(c.data_ptr() for c in constants[:6]),
            cfg.coefficient_array(),
            cfg.denominator,
            cfg.tol,
            cfg.max_iterations,
            stream,
        )
    if error != 0:
        message = library.fused_navier_stokes_error_string(error).decode()
        raise RuntimeError(
            f"fused Navier-Stokes kernel launch failed with a cluster of "
            f"{plan.cluster_size} blocks of {plan.shared_bytes} bytes of "
            f"shared memory: {message} ({error})"
        )


def _run(wrapper, y, cfg, n_steps, write_trajectory, cluster_size):
    """Launches the kernel over ``y``'s states into a new output, counts
    the launch on ``wrapper`` and keeps the sweeps there."""
    batch = y.reshape((-1,) + cfg.state_shape)
    if write_trajectory:
        out = torch.empty(
            (batch.shape[0], n_steps) + cfg.state_shape,
            dtype=torch.float32,
            device=batch.device,
        )
    else:
        out = torch.empty_like(batch)
    sweeps = torch.zeros(
        batch.shape[0], dtype=torch.int64, device=batch.device
    )
    launch(batch, out, sweeps, cfg, n_steps, write_trajectory, cluster_size)
    wrapper.launches += 1
    wrapper.sweeps = sweeps.reshape(tuple(y.shape[:-3]))
    return out


def fused_navier_stokes_rk4_trajectory(
    y: torch.Tensor,
    cfg: _NavierStokesConfig,
    n_steps: int,
    cluster_size: Optional[int] = None,
) -> torch.Tensor:
    """The trajectory: ``n_steps`` fused steps storing every step, ``(H, W,
    4) -> (n_steps, H, W, 4)`` or ``(B, H, W, 4) -> (B, n_steps, H, W,
    4)`` (one cluster per state). ``cluster_size`` overrides the plan's
    (to exercise other splits)."""
    wrapper = fused_navier_stokes_rk4_trajectory
    cfg.check_state(y)
    if y.device.type == "cpu":
        out, wrapper.sweeps = fused_navier_stokes_rk4_trajectory_reference(
            y, cfg, n_steps
        )
        return out
    out = _run(wrapper, y, cfg, n_steps, True, cluster_size)
    return out if y.ndim == 4 else out[0]


def fused_navier_stokes_rk4_end(
    y: torch.Tensor,
    cfg: _NavierStokesConfig,
    n_steps: int,
    cluster_size: Optional[int] = None,
) -> torch.Tensor:
    """The end: ``n_steps`` fused steps returning the end state only, ``(H,
    W, 4) -> (H, W, 4)`` or ``(B, H, W, 4) -> (B, H, W, 4)`` (one cluster
    per state)."""
    wrapper = fused_navier_stokes_rk4_end
    cfg.check_state(y)
    if y.device.type == "cpu":
        out, wrapper.sweeps = fused_navier_stokes_rk4_end_reference(
            y, cfg, n_steps
        )
        return out
    return _run(wrapper, y, cfg, n_steps, False, cluster_size).reshape(
        y.shape
    )


def fused_navier_stokes_rk4_step(
    y: torch.Tensor,
    cfg: _NavierStokesConfig,
    cluster_size: Optional[int] = None,
) -> torch.Tensor:
    """One fused step (the trajectory kernel with ``n_steps = 1``), ``(H,
    W, 4) -> (H, W, 4)`` or ``(B, H, W, 4) -> (B, H, W, 4)``."""
    wrapper = fused_navier_stokes_rk4_step
    cfg.check_state(y)
    if y.device.type == "cpu":
        out, wrapper.sweeps = fused_navier_stokes_rk4_step_reference(y, cfg)
        return out
    return _run(wrapper, y, cfg, 1, True, cluster_size).reshape(y.shape)


for _wrapper in (
    fused_navier_stokes_rk4_trajectory,
    fused_navier_stokes_rk4_end,
    fused_navier_stokes_rk4_step,
):
    _wrapper.launches = 0
    _wrapper.sweeps = None


# -- builders mirroring the JAX package's API -------------------------------


def build_fused_navier_stokes_rk4_trajectory(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    anti_laplacian_tol: float = 1e-3,
    anti_laplacian_max_iterations: int = 100_000,
):
    """Builds ``trajectory(y) -> ys`` computing ``n_steps`` fused steps,
    ``(..., H, W, 4) -> (..., n_steps, H, W, 4)``, one cluster per leading
    index. Raises ValueError for other problems than Navier-Stokes on a
    Cartesian mesh."""
    cfg = _NavierStokesConfig(
        cp, d_t, anti_laplacian_tol, anti_laplacian_max_iterations
    )

    def trajectory(y: torch.Tensor) -> torch.Tensor:
        lead, batch = states(y, cfg)
        out = fused_navier_stokes_rk4_trajectory(batch, cfg, n_steps)
        return out.reshape(lead + (n_steps,) + cfg.state_shape)

    return trajectory


def build_fused_navier_stokes_rk4_end(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    batch: Optional[int] = None,
    anti_laplacian_tol: float = 1e-3,
    anti_laplacian_max_iterations: int = 100_000,
):
    """Builds ``end(y) -> y_final`` advancing ``n_steps`` fused steps and
    returning ONLY the final state, or ``None`` when the grid fits no
    cluster. With ``batch=B``, ``end`` maps ``(B, H, W, 4) -> (B, H, W,
    4)``, one cluster per state; otherwise it maps one ``(H, W, 4)``
    state."""
    cfg = _NavierStokesConfig(
        cp, d_t, anti_laplacian_tol, anti_laplacian_max_iterations
    )
    if cfg.plan is None:
        return None
    expected_lead = () if batch is None else (batch,)

    def end(y: torch.Tensor) -> torch.Tensor:
        lead, batch_ = states(y, cfg)
        if lead != expected_lead:
            raise ValueError(
                f"expected leading shape {expected_lead}, got {lead}"
            )
        out = fused_navier_stokes_rk4_end(batch_, cfg, n_steps)
        return out.reshape(y.shape)

    return end


def build_fused_navier_stokes_rk4_step(
    cp: ConstrainedProblem,
    d_t: float,
    anti_laplacian_tol: float = 1e-3,
    anti_laplacian_max_iterations: int = 100_000,
):
    """Builds ``step(y) -> y_next`` computing one fused step, ``(..., H,
    W, 4) -> (..., H, W, 4)``."""
    cfg = _NavierStokesConfig(
        cp, d_t, anti_laplacian_tol, anti_laplacian_max_iterations
    )

    def step(y: torch.Tensor) -> torch.Tensor:
        _, batch = states(y, cfg)
        return fused_navier_stokes_rk4_step(batch, cfg).reshape(y.shape)

    return step
