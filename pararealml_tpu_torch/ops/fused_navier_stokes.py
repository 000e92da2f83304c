"""The fused Navier-Stokes RK4 kernel: K5's Navier-Stokes family.

Port of the Navier-Stokes branch of the JAX package's
``ops/fused_system.py`` kernels (K5: ``build_fused_system_rk4_trajectory``,
``build_fused_system_rk4_end`` single or batched, and
``build_fused_system_rk4_step``) for the 2D vorticity-stream-function
system on Cartesian meshes. Its three Pallas TPU kernels become launches
of one hand-written CUDA kernel for Hopper, ``csrc/fused_navier_stokes.cu``
(see its header for the design): one thread block cluster of 1, 2, 4 or 8
blocks holds one state for the whole solve, each block a slab of rows in
shared memory and each thread fixed cells of it (:func:`ownership` models
which), with the stream function's Jacobi solve inside the kernel, its
sweeps in groups between cluster barriers.

Each kernel has a wrapper and a plain PyTorch version beside it:

- ``fused_navier_stokes_rk4_trajectory``, ``fused_navier_stokes_rk4_end``
  and ``fused_navier_stokes_rk4_step`` check their input, and launch the
  kernel for a CUDA tensor or run the plain version for a CPU tensor.
  There is no fallback: on a CUDA tensor the kernel runs or the wrapper
  raises. Each counts its kernel launches in ``launches``, and keeps the
  Jacobi sweeps of each state of its last call (the kernel's device
  counters, or the plain version's) in ``sweeps``. They take a test-only
  ``cluster_size=`` or ``plan=`` (a :class:`ClusterPlan2D`) to exercise
  other slab splits and groups.
- ``fused_navier_stokes_rk4_{trajectory,end,step}_reference`` are the
  plain versions, over ``_navier_stokes_step_reference`` of
  :mod:`pararealml_tpu_torch.ops.fused_system` (the JAX package's
  Navier-Stokes branch term for term). They run on any device and in any
  floating-point type, and return the sweeps beside the states.
- ``_group_schedule_reference`` models the kernel's Jacobi solve in
  groups (slabs, halos, per-sweep partials, the stop found after a group,
  the replay) in plain PyTorch, for the tests only.

States use the JAX package's layout: ``(H, W, 4)`` (w, psi, u, v), or
``(B, H, W, 4)`` for a batch (one cluster per state).

Applicability is :func:`~pararealml_tpu_torch.ops.fused_system.
fused_navier_stokes_step_applicable`: the JAX package's gate (a Cartesian
mesh within its VMEM cap, static boundary conditions, RK4, float32) and a
grid that fits the largest cluster (:func:`make_cluster_plan_2d`).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.differential_equation import NavierStokesEquation
from pararealml_tpu_torch.mesh import CoordinateSystem
from pararealml_tpu_torch.ops.fused_system import (
    MAX_SHARED_MEMORY_BYTES,
    _count_steps,
    _jacobi_sweep_reference,
    _navier_stokes_step_reference,
    _SystemKernelConfig,
    states,
)

CLUSTER_SIZES = (1, 2, 4, 8)
# the Jacobi sweeps a group runs between cluster barriers: the kernel's
# instances
GROUP_SIZES = (1, 2, 3, 4, 8)
# a plan's group where the measured table has no entry: the largest of
# GROUP_SIZES up to it that the plan admits
DEFAULT_GROUP = 4
# the cells a thread of the kernel's instances, each with the most threads
# a block of it takes (its launch bound, which sets its registers: 80, 96
# and 128 a thread)
CELLS_INSTANCES = {1: 768, 3: 640, 10: 512}
# the kernel's shared-memory reduction scratch, as doubles a sweep of a
# group: two sets of one slot, each of at most 32 warps' sum, and each
# thread's sum of squares
_REDUCTION_DOUBLES_A_SWEEP = 2 + 32


def shared_memory_bytes_2d(
    rows: int,
    height: int,
    width: int,
    group: int,
    cluster_size: int,
    threads: int,
) -> int:
    """The kernel's shared-memory working set for a slab of ``rows`` rows
    of an H x W grid with groups of ``group`` sweeps on ``threads``
    threads, in the order the CUDA kernel carves it (its
    ``shared_bytes_2d``): the reduction's doubles; the three
    stream-function buffers, each the slab and its guard rows (``group``
    above and below it on a cluster, one for a single block); w and a
    stage buffer, each the slab and a row above and below it; six float
    planes of the slab (u, v and the four components' Dirichlet values);
    the Neumann faces' float values and byte masks of w and psi. The
    launch passes it to the kernel."""
    guard = group if cluster_size > 1 else 1
    return (
        8 * (_REDUCTION_DOUBLES_A_SWEEP + threads) * group
        + 4 * width * (3 * (rows + 2 * guard) + 2 * (rows + 2) + 6 * rows)
        + 5 * 2 * 2 * (height + width)
    )


class ClusterPlan2D(NamedTuple):
    """How one cluster holds an H x W grid: block r of ``cluster_size``
    keeps rows ``[r H // s, (r + 1) H // s)`` and runs the Jacobi sweeps
    in groups of ``group`` between cluster barriers, with ``threads``
    threads of ``cells`` cells each (0: the fewest cells a thread of
    :data:`CELLS_INSTANCES` whose instance covers the block's cells, and
    as few whole warps as cover them)."""

    cluster_size: int
    height: int
    width: int
    group: int = 1
    threads: int = 0
    cells: int = 0

    @property
    def slab(self) -> int:
        """The most rows one block holds."""
        return -(-self.height // self.cluster_size)

    @property
    def min_rows(self) -> int:
        """The fewest rows one block holds."""
        return self.height // self.cluster_size

    def rows(self, rank: int) -> Tuple[int, int]:
        """Block ``rank``'s rows ``[begin, end)``."""
        size = self.cluster_size
        return rank * self.height // size, (rank + 1) * self.height // size

    def halo(self, rank: int) -> Tuple[int, int]:
        """The halo rows block ``rank``'s sweeps reach above and below its
        slab: ``group - 1`` past each edge that has a neighbour."""
        reach = self.group - 1 if self.cluster_size > 1 else 0
        return (
            reach if rank > 0 else 0,
            reach if rank < self.cluster_size - 1 else 0,
        )

    @property
    def range_cells(self) -> int:
        """The most cells one block's sweeps cover: its rows and its halo
        rows."""
        most = 0
        for rank in range(self.cluster_size):
            begin, end = self.rows(rank)
            most = max(most, (end - begin + sum(self.halo(rank))) * self.width)
        return most

    @property
    def block_cells(self) -> int:
        if self.cells:
            return self.cells
        for cells, most in CELLS_INSTANCES.items():
            threads = self.threads or most
            if threads <= most and cells * threads >= self.range_cells:
                return cells
        # none covers the block: the launch refuses the plan
        return max(CELLS_INSTANCES)

    @property
    def block_threads(self) -> int:
        if self.threads:
            return self.threads
        return 32 * -(-self.range_cells // (32 * self.block_cells))

    @property
    def shared_bytes(self) -> int:
        return shared_memory_bytes_2d(
            self.slab,
            self.height,
            self.width,
            self.group,
            self.cluster_size,
            self.block_threads,
        )

    @property
    def admitted(self) -> bool:
        """Whether the kernel takes the group: one of its instances, and
        on a cluster at most the fewest rows a block holds (a halo comes
        from the adjacent blocks only)."""
        return self.group in GROUP_SIZES and (
            self.cluster_size == 1 or self.group <= self.min_rows
        )

    @property
    def covers(self) -> bool:
        """Whether the threads and cells are an instance's and cover the
        most cells a block's sweeps reach."""
        cells, threads = self.block_cells, self.block_threads
        return (
            cells in CELLS_INSTANCES
            and 32 <= threads <= CELLS_INSTANCES[cells]
            and threads % 32 == 0
            and cells * threads >= self.range_cells
        )

    @property
    def fits(self) -> bool:
        """Whether the kernel takes the plan, its threads and cells cover
        each block's cells and each block's working set fits its shared
        memory."""
        return (
            self.admitted
            and self.covers
            and self.shared_bytes <= MAX_SHARED_MEMORY_BYTES
        )

    def __str__(self) -> str:
        return (
            f"{self.cluster_size} blocks x {self.block_threads} threads x "
            f"{self.block_cells} cells, groups of {self.group}"
        )


def _check_cluster_size(height: int, cluster_size: int):
    if cluster_size not in CLUSTER_SIZES:
        raise ValueError(
            f"cluster_size must be one of {CLUSTER_SIZES}, got {cluster_size}"
        )
    if height < cluster_size:
        raise ValueError(
            f"a height of {height} rows cannot be split among "
            f"{cluster_size} blocks"
        )


def cluster_plan_2d(
    height: int,
    width: int,
    cluster_size: int,
    group: Optional[int] = None,
    threads: int = 0,
    cells: int = 0,
) -> ClusterPlan2D:
    """The plan with ``cluster_size`` blocks, whether or not it fits (the
    kernel's launch refuses those); without ``group``, the largest of
    :data:`GROUP_SIZES` up to :data:`DEFAULT_GROUP` that fits, else 1."""
    _check_cluster_size(height, cluster_size)
    if group is not None:
        return ClusterPlan2D(
            cluster_size, height, width, group, threads, cells
        )
    for size in reversed(GROUP_SIZES):
        plan = ClusterPlan2D(cluster_size, height, width, size, threads, cells)
        if size <= DEFAULT_GROUP and plan.fits:
            return plan
    return ClusterPlan2D(cluster_size, height, width, 1, threads, cells)


def ownership(plan: ClusterPlan2D, rank: int):
    """A plain model of which thread owns which cells of block ``rank`` on
    ``plan``, as the kernel deals them: a dict from (thread, slot) to the
    cell's (row, column, reach, own row, interior), with slot s of thread
    t the list's cell t + s * threads. The list holds the slab's interior
    cells row by row, the halo rows' interior cells (the nearest rows
    first, the upper before the lower), the slab's top face, its side
    faces row by row, its bottom face, and the halo rows' side faces in the
    halo's order; a cell's reach is the sweeps of a group that cover its
    row (the group for the slab's rows, ``group - d`` for a halo row ``d``
    rows past the slab)."""
    height, width, k = plan.height, plan.width, plan.group
    begin, end = plan.rows(rank)
    above, below = plan.halo(rank)
    halo_rows = []
    for d in range(1, max(above, below) + 1):
        if d <= above:
            halo_rows.append(begin - d)
        if d <= below:
            halo_rows.append(end - 1 + d)
    inner_rows = range(max(begin, 1), min(end, height - 1))
    inner = range(1, width - 1)
    cells = [(i, j, True) for i in inner_rows for j in inner]
    cells += [(i, j, True) for i in halo_rows for j in inner]
    if begin == 0:
        cells += [(0, j, False) for j in range(width)]
    cells += [(i, j, False) for i in inner_rows for j in (0, width - 1)]
    if end == height:
        cells += [(height - 1, j, False) for j in range(width)]
    cells += [(i, j, False) for i in halo_rows for j in (0, width - 1)]
    threads = plan.block_threads
    owners = {}
    for q, (i, j, interior) in enumerate(cells):
        own = begin <= i < end
        distance = begin - i if i < begin else i - end + 1
        reach = k if own else k - distance
        owners[(q % threads, q // threads)] = (i, j, reach, own, interior)
    return owners


# The plans measured on the card (tools/ns_plan_sweep.py, NVIDIA H100
# 80GB HBM3 at 700 W): (height, width, batch or None) -> (cluster size,
# group, threads, cells a thread; 0 for the default). The example's single
# state, one Parareal iteration's B = 8 fine ends on it, and the JAX
# tests' 17 x 17.
_MEASURED_PLANS = {
    (101, 81, None): (8, 4, 544, 3),
    (101, 81, 8): (8, 4, 544, 3),
    (17, 17, None): (1, 2, 320, 1),
}


def make_cluster_plan_2d(
    height: int, width: int, batch: Optional[int] = None
) -> Optional[ClusterPlan2D]:
    """The measured plan of ``_MEASURED_PLANS`` for the shape and batch
    where there is one and it fits, else the smallest cluster (1, 2, 4 or
    8 blocks, no more blocks than rows) that fits with groups of one
    sweep, with the group :func:`cluster_plan_2d` gives it; None when none
    fits. At 44 bytes a slab cell, 12 a guard-row cell, 20 a row and a
    column for the faces and 8 a thread a sweep of a group, and at most
    10 x 512 cells a block, a cluster holds square grids up to 193 x 193
    on eight blocks (groups of up to 2 at 192 x 192, of 1 past it)."""
    if min(height, width) < 3:
        return None
    measured = _MEASURED_PLANS.get((height, width, batch)) or (
        _MEASURED_PLANS.get((height, width, None))
    )
    if measured is not None:
        size, group, threads, cells = measured
        if size <= height:
            plan = ClusterPlan2D(size, height, width, group, threads, cells)
            if plan.fits:
                return plan
    for size in CLUSTER_SIZES:
        if size > height:
            break
        if ClusterPlan2D(size, height, width).fits:
            return cluster_plan_2d(height, width, size)
    return None


class _NavierStokesConfig(_SystemKernelConfig):
    """K5's configuration of a Navier-Stokes problem with its cluster
    plan for one state (None where the grid fits no cluster)."""

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


def _group_schedule_reference(
    state: torch.Tensor, cfg: _NavierStokesConfig, plan: ClusterPlan2D
) -> Tuple[torch.Tensor, int, int]:
    """A plain model of the kernel's Jacobi solve of one step of one
    ``(H, W, 4)`` state on ``plan``, for the tests: each block of the
    plan's cluster keeps three stream-function buffers (the state's psi,
    the stage buffer and D1(psi) in the accumulator, where the solve
    starts); at a group's start it copies the ``group`` rows of the start
    buffer S next to its slab from each neighbour (and w's); sweep t of the
    group covers ``group - 1 - t`` halo rows past each slab edge that has
    a neighbour, and sums its own rows' squared updates in float64; after
    the group the blocks' sums are added in rank order and the first
    sweep at which the norm is at most ``cfg.tol`` stops the solve (a
    group runs no more sweeps than ``cfg.max_iterations`` leaves); the
    stopping sweep's psi is taken from its work buffer when it is one of
    the group's last two sweeps, else replayed from S.

    Rows a block has no data for hold NaN, so a schedule that read one
    would spoil its result. Each sweep runs the plain version's sweep
    (:func:`~pararealml_tpu_torch.ops.fused_system._jacobi_sweep_reference`)
    over the whole grid of the block's buffer and keeps the block's rows:
    a cell depends on its neighbours only. Returns the solve's psi ``(H,
    W)``, its sweeps and the sweeps replayed."""
    constants = cfg.constants(state.device, state.dtype)
    dir_mask, dir_vals = constants[0], constants[1]
    height, k, blocks = cfg.height, plan.group, plan.cluster_size
    rows = [
        (r * height // blocks, (r + 1) * height // blocks)
        for r in range(blocks)
    ]
    halo = k if blocks > 1 else 0

    def visible(r):
        # the rows a block keeps: its slab and its halo's rows in the grid
        begin, end = rows[r]
        return max(begin - halo, 0), min(end + halo, height)

    def unknown():
        return torch.full_like(state[..., 0], math.nan)

    w, psi = state[..., 0], state[..., 1]
    sweeps_of = []
    # buffers[r][i]: block r's stream-function buffer i (0 the state's psi,
    # 1 the stage buffer, 2 the accumulator)
    buffers = []
    for r, (begin, end) in enumerate(rows):
        own = [unknown() for _ in range(3)]
        own[0][begin:end] = psi[begin:end]
        own[2][begin:end] = torch.where(
            dir_mask[1], dir_vals[1], psi
        )[begin:end]
        buffers.append(own)
        low, high = visible(r)
        rhs = unknown()
        rhs[low:high] = -w[low:high]
        sweeps_of.append(_jacobi_sweep_reference(cfg, constants, rhs))

    def sweep_rows(r, t):
        begin, end = rows[r]
        low = begin - (k - 1 - t) if r > 0 else begin
        high = end + (k - 1 - t) if r < blocks - 1 else end
        return low, high

    def run(start, t, r, norm):
        """Sweep t of a group from buffer ``start`` on block r; returns its
        own rows' float64 sum of squared updates."""
        work = ((start + 1) % 3, (start + 2) % 3)
        source = buffers[r][start if t == 0 else work[(t - 1) & 1]]
        target = buffers[r][work[t & 1]]
        swept = sweeps_of[r](source)
        low, high = sweep_rows(r, t)
        target[low:high] = swept[low:high]
        if not norm:
            return 0.0
        begin, end = rows[r]
        change = (swept[begin:end] - source[begin:end]).double()
        return float((change * change).sum())

    start, result, iterations, replayed = 2, 2, 0, 0
    while iterations < cfg.max_iterations:
        group = min(k, cfg.max_iterations - iterations)
        for r, (begin, end) in enumerate(rows):
            if r > 0:
                buffers[r][start][begin - halo: begin] = buffers[r - 1][
                    start
                ][begin - halo: begin]
            if r < blocks - 1:
                buffers[r][start][end: end + halo] = buffers[r + 1][start][
                    end: end + halo
                ]
        partials = [
            [run(start, t, r, True) for r in range(blocks)]
            for t in range(group)
        ]
        stop = 0
        for t in range(group):
            total = 0.0
            for partial in partials[t]:
                total += partial
            if not math.sqrt(total) > cfg.tol:
                stop = t + 1
                break
        if stop == 0:
            iterations += group
            start = (start + 1 + ((group - 1) & 1)) % 3
            result = start
            continue
        iterations += stop
        if stop < group - 1:
            for t in range(stop):
                for r in range(blocks):
                    run(start, t, r, False)
            replayed += stop
        result = (start + 1 + ((stop - 1) & 1)) % 3
        break
    solved = torch.cat(
        [buffers[r][result][begin:end] for r, (begin, end) in enumerate(rows)]
    )
    return solved, iterations, replayed


# -- kernel wrappers ----------------------------------------------------------


def _configure(library: ctypes.CDLL):
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    library.fused_navier_stokes_rk4.argtypes = (
        [c_void_p] * 3
        + [c_int] * 10
        + [ctypes.c_size_t]
        + [c_void_p] * 6
        + [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_float,
            ctypes.c_double,
            c_int,
            c_void_p,
            c_int,
            c_void_p,
        ]
    )
    library.fused_navier_stokes_rk4.restype = c_int
    library.fused_navier_stokes_error_string.argtypes = [c_int]
    library.fused_navier_stokes_error_string.restype = ctypes.c_char_p
    library.fused_navier_stokes_instance_attributes.argtypes = [c_int] * 2 + [
        ctypes.POINTER(c_int)
    ] * 3
    library.fused_navier_stokes_instance_attributes.restype = c_int


def load_kernels() -> ctypes.CDLL:
    """The built and loaded kernel library (compiled on first use)."""
    from pararealml_tpu_torch.ops.cuda_library import load_library

    library = load_library("fused_navier_stokes")
    if not getattr(library, "_signatures_set", False):
        _configure(library)
        library._signatures_set = True
    return library


def instance_attributes(group: int, cells: int) -> Tuple[int, int, int]:
    """(registers a thread, spill bytes a thread, most threads a block)
    of the built instance for groups of ``group`` sweeps and ``cells``
    cells a thread, as the card reports them."""
    library = load_kernels()
    values = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int()]
    error = library.fused_navier_stokes_instance_attributes(
        group, cells, *(ctypes.byref(value) for value in values)
    )
    if error != 0:
        message = library.fused_navier_stokes_error_string(error).decode()
        raise RuntimeError(
            f"no such Navier-Stokes instance: {message} ({error})"
        )
    return tuple(value.value for value in values)


def _plan(
    cfg: _NavierStokesConfig,
    batch: int,
    cluster_size: Optional[int],
    plan: Optional[ClusterPlan2D],
) -> ClusterPlan2D:
    """The plan given, or one with ``cluster_size`` blocks, or the
    configuration's measured plan for a batch of ``batch`` states; raises
    for a plan of another grid or one the kernel does not take."""
    if plan is not None:
        if (plan.height, plan.width) != (cfg.height, cfg.width):
            raise ValueError(
                f"a plan for {plan.height} x {plan.width} does not fit a "
                f"{cfg.height} x {cfg.width} grid"
            )
        _check_cluster_size(cfg.height, plan.cluster_size)
        if not plan.admitted:
            raise ValueError(
                f"groups of {plan.group} sweeps are not among "
                f"{GROUP_SIZES} or exceed the fewest rows a block of the "
                f"plan holds ({plan.min_rows})"
            )
        return plan
    if cluster_size is not None:
        return cluster_plan_2d(cfg.height, cfg.width, cluster_size)
    if cfg.plan is None:
        raise ValueError(
            f"a {cfg.height} x {cfg.width} Navier-Stokes grid does not fit "
            "a cluster of 8 blocks"
        )
    if batch == 1:
        return cfg.plan
    return make_cluster_plan_2d(cfg.height, cfg.width, batch)


def launch(
    y: torch.Tensor,
    out: torch.Tensor,
    sweeps: torch.Tensor,
    cfg: _NavierStokesConfig,
    n_steps: int,
    write_trajectory: bool,
    cluster_size: Optional[int] = None,
    plan: Optional[ClusterPlan2D] = None,
    progress=None,
):
    """Launches the kernel on ``y``'s device and its current stream for a
    contiguous ``(B, H, W, 4)`` float32 CUDA state (one cluster per state)
    and raises if the kernel's host code refuses the launch: a cluster the
    card cannot place, among them one whose slabs overflow a block's
    shared memory. ``sweeps`` ((B,) int64) receives each state's Jacobi
    sweeps. A trajectory of one state publishes its finished frames to
    ``progress`` (an ``operator.FrameProgress``) where one is given."""
    plan = _plan(cfg, y.shape[0], cluster_size, plan)
    word, chunk = None, 0
    if progress is not None:
        word, chunk = progress.launch_arguments(y.shape[0])
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
            plan.group,
            plan.block_threads,
            plan.block_cells,
            plan.shared_bytes,
            *(c.data_ptr() for c in constants[:6]),
            cfg.coefficient_array(),
            cfg.denominator,
            cfg.tol,
            cfg.max_iterations,
            word,
            chunk,
            stream,
        )
    if error != 0:
        message = library.fused_navier_stokes_error_string(error).decode()
        raise RuntimeError(
            f"fused Navier-Stokes kernel launch failed with a cluster of "
            f"{plan.cluster_size} blocks of {plan.block_threads} threads of "
            f"{plan.block_cells} cells and {plan.shared_bytes} bytes of "
            f"shared memory, groups of {plan.group} sweeps: {message} "
            f"({error})"
        )


def _run(
    wrapper,
    y,
    cfg,
    n_steps,
    write_trajectory,
    cluster_size,
    plan,
    progress=None,
):
    """Launches the kernel over ``y``'s states into a new output (a
    trajectory publishing to ``progress`` where one is given), counts the
    launch on ``wrapper`` and keeps the sweeps there."""
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
    launch(
        batch,
        out,
        sweeps,
        cfg,
        n_steps,
        write_trajectory,
        cluster_size,
        plan,
        progress,
    )
    wrapper.launches += 1
    wrapper.sweeps = sweeps.reshape(tuple(y.shape[:-3]))
    _count_steps(y, cfg, n_steps)
    return out


def fused_navier_stokes_rk4_trajectory(
    y: torch.Tensor,
    cfg: _NavierStokesConfig,
    n_steps: int,
    cluster_size: Optional[int] = None,
    plan: Optional[ClusterPlan2D] = None,
    progress=None,
) -> torch.Tensor:
    """The trajectory: ``n_steps`` fused steps storing every step, ``(H, W,
    4) -> (n_steps, H, W, 4)`` or ``(B, H, W, 4) -> (B, n_steps, H, W,
    4)`` (one cluster per state). ``cluster_size`` or ``plan`` overrides
    the measured plan (to exercise other splits and groups). A trajectory
    of one state publishes its finished frames to ``progress`` (an
    ``operator.FrameProgress``) while the kernel runs; the plain version
    publishes them all when it returns."""
    wrapper = fused_navier_stokes_rk4_trajectory
    cfg.check_state(y)
    if y.device.type == "cpu":
        out, wrapper.sweeps = fused_navier_stokes_rk4_trajectory_reference(
            y, cfg, n_steps
        )
        _count_steps(y, cfg, n_steps)
        if progress is not None:
            progress.publish_all(1 if y.ndim == 3 else y.shape[0], n_steps)
        return out
    out = _run(
        wrapper, y, cfg, n_steps, True, cluster_size, plan, progress
    )
    return out if y.ndim == 4 else out[0]


def fused_navier_stokes_rk4_end(
    y: torch.Tensor,
    cfg: _NavierStokesConfig,
    n_steps: int,
    cluster_size: Optional[int] = None,
    plan: Optional[ClusterPlan2D] = None,
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
        _count_steps(y, cfg, n_steps)
        return out
    return _run(
        wrapper, y, cfg, n_steps, False, cluster_size, plan
    ).reshape(y.shape)


def fused_navier_stokes_rk4_step(
    y: torch.Tensor,
    cfg: _NavierStokesConfig,
    cluster_size: Optional[int] = None,
    plan: Optional[ClusterPlan2D] = None,
) -> torch.Tensor:
    """One fused step (the trajectory kernel with ``n_steps = 1``), ``(H,
    W, 4) -> (H, W, 4)`` or ``(B, H, W, 4) -> (B, H, W, 4)``."""
    wrapper = fused_navier_stokes_rk4_step
    cfg.check_state(y)
    if y.device.type == "cpu":
        out, wrapper.sweeps = fused_navier_stokes_rk4_step_reference(y, cfg)
        _count_steps(y, cfg, 1)
        return out
    return _run(wrapper, y, cfg, 1, True, cluster_size, plan).reshape(
        y.shape
    )


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
    index; the function, tagged ``publishes``, also takes the
    ``progress=`` of one state (``operator.FrameProgress``). Raises
    ValueError for other problems than Navier-Stokes on a Cartesian
    mesh."""
    cfg = _NavierStokesConfig(
        cp, d_t, anti_laplacian_tol, anti_laplacian_max_iterations
    )

    def trajectory(y: torch.Tensor, progress=None) -> torch.Tensor:
        lead, batch = states(y, cfg)
        publishing = {} if progress is None else {"progress": progress}
        out = fused_navier_stokes_rk4_trajectory(
            batch, cfg, n_steps, **publishing
        )
        return out.reshape(lead + (n_steps,) + cfg.state_shape)

    # the kernel publishes the finished frames of one state to ``progress``
    trajectory.publishes = True
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
