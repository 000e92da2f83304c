"""Fused RK4 kernels for 3D Cartesian problems (K9): diffusion,
convection-diffusion, wave, Burgers and Cahn-Hilliard.

Port of the JAX package's ``ops/fused_system_3d.py``. Its three Pallas TPU
kernels — the trajectory, the end state (single or batched) and the single
step — become launches of one hand-written CUDA kernel template for
Hopper, ``csrc/fused_system_3d.cu`` (see its header for the design). On
the TPU one core's VMEM held the whole volume; on Hopper one thread block
cluster of up to 16 blocks does: its blocks split the depth axis (axis 0)
into slabs and ping-pong each stage's input between two sets of slabs in
shared memory, pushing their edge planes into each other's halo planes
(or, at the large end of the range, reading the planes across a slab
edge from each other's shared memory), while each thread keeps its own
cells' state, accumulator and constraint data in registers (or, at the
large end, in device memory only it touches).

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
conditions, solved with RK4, in float32, on a volume within the JAX
package's VMEM cap (:func:`fits_reference_vmem_3d`, where the JAX package
runs its kernel) that a cluster of at most 16 blocks holds
(:func:`make_cluster_plan_3d`: every cube the cap admits, 76^3 for one
component, 56^3 for two, 48^3 for three). Volumes the cap admits only
because it pads W to 128 lanes, such as 40 x 32 x 128 x 3, take the
generic path. The cluster size and the cells a thread come from a table
measured on the card (``_MEASURED_PLANS_3D``).
"""

from __future__ import annotations

import ctypes
import math
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
# the kernel takes clusters of 1 to 16 blocks (past 8 a non-portable
# size); the sizes the tests force on it
MAX_CLUSTER_SIZE = 16
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# the instances: 1 or 2 cells a thread kept in registers, or (0) the
# cells kept in device memory, each in blocks of up to 1,024 threads (64
# registers a thread)
_MAX_THREADS = 1024
CELLS = (1, 2, 0)
# The plan's table, by components and step kind ("rk4", or
# "cahn-hilliard" for its two-stage step): for each volume and batch
# measured, its D, H, W, the batch, and the cluster size and cells a
# thread that ran it fastest (tools/k9_plan_sweep.py, every plan of the
# instances, on an NVIDIA H100 80GB HBM3 at 700 W). A launch takes the
# entry of its kind whose cell count is nearest its own on a log scale,
# and of that volume's entries the one whose batch is nearest its own:
# the largest valid size up to the entry's that the card holds for the
# whole batch at once, with the entry's cells a thread where they fit.
_MEASURED_PLANS_3D = {
    # diffusion 76^3: 86.800 us a step (the only size that holds it)
    (1, "rk4"): ((76, 76, 76, 1, 16, 0),),
    # wave 56^3: 57.310 us (15: 58.715; 16: 59.493)
    (2, "rk4"): ((56, 56, 56, 1, 14, 0),),
    # the Cahn-Hilliard example 31^3: 5.757 us (16 x memory: 7.212);
    # 56^3: 32.078 us (14: 37.672)
    (2, "cahn-hilliard"): (
        (31, 31, 31, 1, 16, 2),
        (56, 56, 56, 1, 16, 0),
    ),
    # bench.py's 21^3 Burgers: 12.096 us (14 x 1: 12.235; 16 x memory:
    # 15.956); the 3D Parareal's fine ends, B = 8 (500 steps): 19.272 us
    # (7 x 2: 19.726; 9 x 2, the largest size held at once: 19.917; 16 x
    # 1, two waves: 22.552); 48^3: 82.670 us (14: 100.890)
    (3, "rk4"): (
        (21, 21, 21, 1, 16, 1),
        (21, 21, 21, 8, 8, 2),
        (48, 48, 48, 1, 16, 0),
    ),
}
# How many clusters of each size of the kernel the card holds at once
# (cudaOccupancyMaxActiveClusters, tools/k9_plan_sweep.py, NVIDIA H100
# 80GB HBM3): what the plan assumes where no card is asked (the CPU); on
# the card the wrappers ask the card itself.
_MEASURED_ACTIVE_CLUSTERS_3D = {
    1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
    10: 7, 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7,
}


def shared_memory_bytes_3d(
    planes: int, height: int, width: int, n_components: int, halo: bool
) -> int:
    """The kernel's shared memory for a slab of ``planes`` H x W planes of
    n-component states: the two sets of n float slabs a stage's input
    ping-pongs between (8n bytes a cell), each with a halo plane before
    and after the block's planes where ``halo`` (cells in registers);
    the launch computes the same."""
    return 8 * (planes + 2 * halo) * height * width * n_components


class ClusterPlan3D(NamedTuple):
    """How one cluster holds a D x H x W volume of n-component states
    whose step is of kind ``step``: block r of ``cluster_size`` keeps
    planes ``[r D // s, (r + 1) D // s)`` of axis 0, each thread owning
    ``cells`` cells in registers (1 or 2), or with ``cells == 0`` its
    cells in device memory. The plan owns the launch's layout: the kernel
    takes its slab, threads, cells a thread and shared-memory bytes as
    they are."""

    cluster_size: int
    depth: int
    height: int
    width: int
    n_components: int
    cells: int = 1
    step: str = "rk4"

    @property
    def halo(self) -> bool:
        """Whether the blocks keep halo planes that their neighbours push
        their edge planes into: the RK4 families with their cells in
        registers (csrc/fused_system_3d.cu, HaloVolume)."""
        return self.step == "rk4" and self.cells != 0

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
    def block_cells(self) -> int:
        return self.slab * self.height * self.width

    @property
    def threads(self) -> int:
        """The block's threads, in whole warps: its cells over ``cells``,
        or with the cells in device memory up to 1,024."""
        if self.cells == 0:
            return min(_MAX_THREADS, 32 * -(-self.block_cells // 32))
        per_thread = -(-self.block_cells // self.cells)
        return 32 * -(-per_thread // 32)

    @property
    def cells_per_thread(self) -> int:
        if self.cells == 0:
            return -(-self.block_cells // self.threads)
        return self.cells

    @property
    def shared_bytes(self) -> int:
        return shared_memory_bytes_3d(
            self.slab,
            self.height,
            self.width,
            self.n_components,
            self.halo,
        )

    @property
    def fits(self) -> bool:
        """Whether the kernel's instances take the plan: 1 to 16 blocks,
        each with a plane, their slabs in a block's shared memory, and
        the block's cells in at most the instance's threads."""
        return (
            1 <= self.cluster_size <= min(MAX_CLUSTER_SIZE, self.depth)
            and min(self.depth, self.height, self.width) >= 2
            and self.cells in CELLS
            and self.threads <= _MAX_THREADS
            and self.shared_bytes <= MAX_SHARED_MEMORY_BYTES
        )

    def scratch_floats(self, batch: int) -> int:
        """The device memory the threads' cells take with ``cells == 0``
        (2 + 6n floats a cell slot), else 0."""
        if self.cells != 0:
            return 0
        return (
            batch
            * self.cluster_size
            * (2 + 6 * self.n_components)
            * self.threads
            * self.cells_per_thread
        )


def cluster_plan_3d(
    depth: int,
    height: int,
    width: int,
    n_components: int,
    cluster_size: int,
    cells: Optional[int] = None,
    step: str = "rk4",
) -> ClusterPlan3D:
    """The plan with ``cluster_size`` blocks and ``cells`` cells a thread
    (by default the fewest in registers that the instances take, else
    device memory) for a step of kind ``step``, whether or not its slabs
    fit a block's shared memory (the kernel's host code refuses
    those)."""
    if not 1 <= cluster_size <= MAX_CLUSTER_SIZE:
        raise ValueError(
            f"cluster_size must be 1 to {MAX_CLUSTER_SIZE}, got "
            f"{cluster_size}"
        )
    if depth < cluster_size:
        raise ValueError(
            f"a depth of {depth} planes cannot be split among "
            f"{cluster_size} blocks"
        )
    if cells is None:
        for cells in CELLS:
            plan = ClusterPlan3D(
                cluster_size, depth, height, width, n_components, cells, step
            )
            if plan.threads <= _MAX_THREADS:
                return plan
    if cells not in CELLS:
        raise ValueError(f"cells must be one of {CELLS}, got {cells}")
    return ClusterPlan3D(
        cluster_size, depth, height, width, n_components, cells, step
    )


def _measured_active_clusters(plan: ClusterPlan3D) -> int:
    return _MEASURED_ACTIVE_CLUSTERS_3D.get(plan.cluster_size, 0)


def make_cluster_plan_3d(
    depth: int,
    height: int,
    width: int,
    n_components: int,
    step: str = "rk4",
    batch: int = 1,
    active_clusters=None,
) -> Optional[ClusterPlan3D]:
    """Plans K9 for a batch of ``batch`` D x H x W volumes of
    n-component states, or returns None past its range (no cluster of up
    to 16 blocks holds the volume's slabs: at 8n bytes a cell, 76^3 x 1,
    56^3 x 2 and 48^3 x 3 fit). The size is the largest valid one up to
    the measured table's entry for the volume and batch
    (``_MEASURED_PLANS_3D``) at which the card holds every state's
    cluster at once
    (``active_clusters(plan)``, by default the measured counts of
    ``_MEASURED_ACTIVE_CLUSTERS_3D``), each thread owning the entry's
    cells where the size takes them, else the fewest in registers it
    takes, else its cells in device memory (a size is not traded for
    more cells a thread, whose blocks would share multiprocessors); where
    no size is held at once, the smallest valid size (the batch runs in
    waves)."""
    if min(depth, height, width) < 2:
        return None
    plans = [
        plan
        for plan in (
            ClusterPlan3D(
                size, depth, height, width, n_components, cells, step
            )
            for size in range(1, MAX_CLUSTER_SIZE + 1)
            for cells in CELLS
        )
        if plan.fits
    ]
    if not plans:
        return None
    entries = _MEASURED_PLANS_3D.get((n_components, step)) or (
        (depth, height, width, 1, MAX_CLUSTER_SIZE, 1),
    )
    cells = depth * height * width
    *_, preferred, preferred_cells = min(
        entries,
        key=lambda entry: (
            abs(math.log(cells / (entry[0] * entry[1] * entry[2]))),
            abs(math.log(batch / entry[3])),
        ),
    )
    # one plan a size: the entry's cells a thread where the size takes
    # them, else the fewest cells in registers it takes, else device
    # memory (an entry in device memory asks for no more: where registers
    # hold the cells they were faster, tools/k9_plan_sweep.py)
    by_size = {}
    for plan in sorted(
        plans,
        key=lambda plan: (
            plan.cells != preferred_cells or preferred_cells == 0,
            plan.cells == 0,
            plan.cells,
        ),
    ):
        by_size.setdefault(plan.cluster_size, plan)
    smallest = min(by_size)
    within = [
        by_size[size]
        for size in sorted(by_size, reverse=True)
        if size <= max(preferred, smallest)
    ]
    if active_clusters is None:
        active_clusters = _measured_active_clusters
    for plan in within:
        if active_clusters(plan) >= batch:
            return plan
    return within[-1]


def _step_kind(equation_type) -> str:
    return "cahn-hilliard" if equation_type is CahnHilliardEquation else "rk4"


def _padded_cells_3d(vertices_shape) -> int:
    """The JAX package's ``_padded_cells_3d``: the volume with H padded to
    8 sublanes and W to 128 lanes."""
    depth, height, width = vertices_shape
    return depth * (-(-height // 8) * 8) * (-(-width // 128) * 128)


def fits_reference_vmem_3d(cp: ConstrainedProblem) -> bool:
    """Whether the JAX package runs its fused 3D kernel on this problem's
    volume (its ``_fits_vmem_3d``)."""
    # liveness model calibrated on hardware: Mosaic's scoped-stack
    # peak for the 3-component RK4 stage measured ~22 volumes per
    # component (three axes of concatenate temporaries stay live), and
    # the kernel raises the scoped limit to 100 MiB (25M f32)
    n = cp.differential_equation.y_dimension
    return _padded_cells_3d(cp.mesh.vertices_shape) <= 25_000_000 // (
        22 * n + 10
    )


def fused_system_3d_step_applicable(
    cp: ConstrainedProblem,
    integrator,
    dtype: Optional[torch.dtype] = None,
) -> bool:
    """Whether the fused 3D kernels reproduce the generic path for this
    problem (and, when ``dtype`` is given, for states of that dtype: the
    kernels are float32 only): the JAX package's gate (within its VMEM
    cap) and a cluster plan for the volume."""
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
        and fits_reference_vmem_3d(cp)
    ):
        return False
    return (
        make_cluster_plan_3d(
            *cp.mesh.vertices_shape,
            diff_eq.y_dimension,
            _step_kind(type(diff_eq)),
        )
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
    constants, the single-state cluster plan, and the constraint tensors
    (copied to each device and dtype a state arrives in, once)."""

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
        self.step_kind = _step_kind(self.equation_type)
        # the single-state plan of the measured table (a launch plans its
        # own batch)
        self.plan = make_cluster_plan_3d(
            self.depth, self.height, self.width, n, self.step_kind
        )
        # the card's active-cluster counts, by (cluster size, cells, write
        # trajectory), and the launches' plans, by (batch, write
        # trajectory)
        self._active_clusters: Dict[tuple, int] = {}
        self._launch_plans: Dict[tuple, ClusterPlan3D] = {}
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
        + [c_int] * 12
        + [c_void_p] * 9
        + [ctypes.POINTER(ctypes.c_float), c_int, c_void_p]
    )
    library.fused_system_3d_rk4.restype = c_int
    library.fused_system_3d_max_active_clusters.argtypes = [c_int] * 11 + [
        ctypes.POINTER(c_int)
    ]
    library.fused_system_3d_max_active_clusters.restype = c_int
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


def _raise_launch_error(library: ctypes.CDLL, error: int, plan):
    if error != 0:
        message = library.fused_system_3d_error_string(error).decode()
        raise RuntimeError(
            f"fused 3D kernel launch failed with a cluster of "
            f"{plan.cluster_size} blocks of {plan.threads} threads, "
            f"{plan.cells} cells a thread (0: in device memory), "
            f"{plan.shared_bytes} bytes of shared memory: {message} "
            f"({error})"
        )


def card_active_clusters_3d(cfg: _SystemKernelConfig3D, write_trajectory):
    """``active_clusters(plan)`` for :func:`make_cluster_plan_3d` from the
    card: how many clusters of the plan's kernel it holds at once
    (``cudaOccupancyMaxActiveClusters``, the library built on the first
    question), cached on ``cfg``."""
    cache = cfg._active_clusters

    def active_clusters(plan: ClusterPlan3D) -> int:
        key = (plan.cluster_size, plan.cells, bool(write_trajectory))
        if key not in cache:
            library = load_kernels()
            count = ctypes.c_int(0)
            error = library.fused_system_3d_max_active_clusters(
                cfg.equation,
                cfg.depth,
                cfg.height,
                cfg.width,
                int(write_trajectory),
                *_plan_arguments(plan),
                ctypes.byref(count),
            )
            _raise_launch_error(library, error, plan)
            cache[key] = count.value
        return cache[key]

    return active_clusters


def launch_plan(
    cfg: _SystemKernelConfig3D, batch: int = 1, write_trajectory: bool = True
) -> ClusterPlan3D:
    """The plan the wrappers launch for ``batch`` states of ``cfg``
    (trajectory and step kernels with ``write_trajectory``, else the end
    kernel): :func:`make_cluster_plan_3d`'s, asking the card how many
    clusters it holds at once (:func:`card_active_clusters_3d`), cached
    on ``cfg`` (planning takes longer than a short launch). A ValueError,
    before the library is built, past the kernel's range."""
    key = (batch, bool(write_trajectory))
    plan = cfg._launch_plans.get(key)
    if plan is None:
        if cfg.plan is None:
            raise ValueError(
                f"a {cfg.depth} x {cfg.height} x {cfg.width} volume of "
                f"{cfg.n}-component states does not fit a cluster of "
                f"{MAX_CLUSTER_SIZE} blocks"
            )
        plan = make_cluster_plan_3d(
            cfg.depth,
            cfg.height,
            cfg.width,
            cfg.n,
            cfg.step_kind,
            batch,
            card_active_clusters_3d(cfg, write_trajectory),
        )
        cfg._launch_plans[key] = plan
    return plan


def _forced_plan(
    cfg: _SystemKernelConfig3D,
    cluster_size: Optional[int],
    plan: Optional[ClusterPlan3D],
) -> ClusterPlan3D:
    """A test's plan: ``plan``, or the plan with ``cluster_size`` blocks;
    a ValueError, on any device and before any launch, when it is not
    one of this volume's."""
    if plan is None:
        plan = cluster_plan_3d(
            cfg.depth,
            cfg.height,
            cfg.width,
            cfg.n,
            cluster_size,
            step=cfg.step_kind,
        )
    if (
        plan.depth,
        plan.height,
        plan.width,
        plan.n_components,
        plan.step,
    ) != (
        cfg.depth,
        cfg.height,
        cfg.width,
        cfg.n,
        cfg.step_kind,
    ) or plan.cells not in CELLS:
        raise ValueError(
            f"cluster plan {plan} does not fit this {cfg.depth} x "
            f"{cfg.height} x {cfg.width} x {cfg.n} problem"
        )
    return plan


def _plan_arguments(plan: ClusterPlan3D) -> Tuple[int, ...]:
    """The plan as the library takes it: cluster size, cells a thread
    (the instance), slab, threads, cells a thread held, shared bytes."""
    return (
        plan.cluster_size,
        plan.cells,
        plan.slab,
        plan.threads,
        plan.cells_per_thread,
        plan.shared_bytes,
    )


def launch(
    y: torch.Tensor,
    out: torch.Tensor,
    cfg: _SystemKernelConfig3D,
    n_steps: int,
    write_trajectory: bool,
    cluster_size: Optional[int] = None,
    plan: Optional[ClusterPlan3D] = None,
):
    """Launches the kernel on ``y``'s device and its current stream for a
    contiguous ``(B, D, H, W, n)`` float32 CUDA state (one cluster per
    state) and raises if the launch is refused: the volume is outside the
    kernel's range, or the card cannot place one cluster. ``cluster_size``
    or ``plan`` override the planned cluster (tests)."""
    batch = y.shape[0]
    # a volume past the range raises here, before the library is built
    if plan is None and cluster_size is None:
        plan = launch_plan(cfg, batch, write_trajectory)
    else:
        plan = _forced_plan(cfg, cluster_size, plan)
    library = load_kernels()
    constants = cfg.constants(y.device)
    if any(t.device != y.device for t in (out,) + constants):
        raise ValueError(
            f"the output and constraint tensors must be on {y.device}"
        )
    scratch = None
    if plan.cells == 0:
        scratch = torch.empty(
            plan.scratch_floats(batch), dtype=torch.float32, device=y.device
        )
    coefficients = cfg.coefficient_array()
    # the ctypes launch targets the current device: make it y's
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        error = library.fused_system_3d_rk4(
            cfg.equation,
            y.data_ptr(),
            out.data_ptr(),
            batch,
            cfg.depth,
            cfg.height,
            cfg.width,
            n_steps,
            int(write_trajectory),
            *_plan_arguments(plan),
            None if scratch is None else scratch.data_ptr(),
            *(c.data_ptr() for c in constants),
            coefficients,
            cfg.velocity_mask,
            stream,
        )
    _raise_launch_error(library, error, plan)


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
    plan: Optional[ClusterPlan3D] = None,
) -> torch.Tensor:
    """K9 trajectory: ``n_steps`` fused steps storing every step, ``(D, H,
    W, n) -> (n_steps, D, H, W, n)`` or ``(B, D, H, W, n) -> (B, n_steps,
    D, H, W, n)`` (one cluster per state). ``cluster_size`` or ``plan``
    override the planned cluster (to exercise other splits)."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_system_3d_rk4_trajectory_reference(y, cfg, n_steps)
    batch = y.reshape((-1,) + cfg.state_shape)
    out = _trajectory_buffer(batch, cfg, n_steps)
    launch(batch, out, cfg, n_steps, True, cluster_size, plan)
    fused_system_3d_rk4_trajectory.launches += 1
    return out if y.ndim == 5 else out[0]


def fused_system_3d_rk4_end(
    y: torch.Tensor,
    cfg: _SystemKernelConfig3D,
    n_steps: int,
    cluster_size: Optional[int] = None,
    plan: Optional[ClusterPlan3D] = None,
) -> torch.Tensor:
    """K9 end: ``n_steps`` fused steps returning the end state only,
    ``(D, H, W, n) -> (D, H, W, n)`` or ``(B, D, H, W, n) -> (B, D, H, W,
    n)`` (one cluster per state)."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_system_3d_rk4_end_reference(y, cfg, n_steps)
    batch = y.reshape((-1,) + cfg.state_shape)
    out = torch.empty_like(batch)
    launch(batch, out, cfg, n_steps, False, cluster_size, plan)
    fused_system_3d_rk4_end.launches += 1
    return out.reshape(y.shape)


def fused_system_3d_rk4_step(
    y: torch.Tensor,
    cfg: _SystemKernelConfig3D,
    cluster_size: Optional[int] = None,
    plan: Optional[ClusterPlan3D] = None,
) -> torch.Tensor:
    """K9 step: one fused step (the trajectory kernel with ``n_steps =
    1``), ``(D, H, W, n) -> (D, H, W, n)`` or ``(B, D, H, W, n) -> (B, D,
    H, W, n)``."""
    cfg.check_state(y)
    if y.device.type == "cpu":
        return fused_system_3d_rk4_step_reference(y, cfg)
    batch = y.reshape((-1,) + cfg.state_shape)
    out = _trajectory_buffer(batch, cfg, 1)
    launch(batch, out, cfg, 1, True, cluster_size, plan)
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
    ``None`` when the volume does not fit a cluster of 16 blocks (see
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
