"""The finite-difference-method solver.

Port of the JAX package's ``operators/fdm/fdm_operator.py`` (capability
match for PararealML's operators/fdm/fdm_operator.py:27-231)
for static boundary conditions. A solve is one of three formulations,
chosen when it is built:

- for parallel-in-time callers on linear problems, the exact affine
  propagator (:mod:`pararealml_tpu_torch.ops.linear_propagator`);
- where the fused kernels apply (RK4, float32 states, static boundary
  conditions: 2D diffusion or convection-diffusion on a Cartesian mesh;
  2D wave, Burgers, shallow water or Cahn-Hilliard on a Cartesian or a
  polar mesh; 2D Navier-Stokes on a Cartesian mesh with the Jacobi
  anti-Laplacian; 3D diffusion, convection-diffusion, wave, Burgers or
  Cahn-Hilliard on a Cartesian mesh), the hand-written
  CUDA kernels of :mod:`pararealml_tpu_torch.ops.fused_diffusion` (K1-K3
  on grids that fit one CTA's shared memory, the resident K7 and the
  tiled K6 trajectory kernels on larger diffusion grids),
  :mod:`pararealml_tpu_torch.ops.fused_system` (K5 on grids that fit one
  CTA, the tiled K8 trajectory, step and end mode past it),
  :mod:`pararealml_tpu_torch.ops.fused_navier_stokes` (K5's
  Navier-Stokes family, grids that fit one thread block cluster),
  :mod:`pararealml_tpu_torch.ops.fused_system_3d` (K9, volumes that fit
  one thread block cluster), and, for callers that pass a batch of
  states (Parareal's slices), :mod:`pararealml_tpu_torch.ops.packed_system`
  (K4, one CTA per state, on Cartesian 2D systems that fit one CTA), or
  their plain PyTorch versions for CPU tensors;
- otherwise a Python loop over the generic step, which evaluates the
  symbolic right-hand side with stencils on tensors, with the metric
  terms of polar, cylindrical and spherical meshes, and solves
  ``Y_LAPLACIAN`` left-hand sides with the differentiator's
  anti-Laplacian (Jacobi or BiCGStab).

Kernel choice has two levels. :class:`FDMOperator` picks the
formulation, the fused family (diffusion, 2D systems or 3D) and K4, in
one place for trajectories, end states and steps; each family's builders
then pick its kernel by grid size. Callers such as the Parareal schedule
ask for a batch through the operator contract and never name a kernel.

Static boundary conditions become constant dense constraint tensors. All
functions accept states with leading batch axes.

Not ported yet: dynamic boundary conditions and the ``indexed_*``
functions that serve them (ROADMAP.md, Queue 1, slice 1b) and spatial
domain decomposition (slice 7).
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.constraint import (
    apply_constraints_along_last_axis,
)
from pararealml_tpu_torch.differential_equation import LHS
from pararealml_tpu_torch.initial_value_problem import InitialValueProblem
from pararealml_tpu_torch.operator import (
    FrameDrain,
    FrameProgress,
    TorchOperator,
    discretize_time_domain,
    materialize_solution,
)
from pararealml_tpu_torch.operators.fdm.fdm_symbol_mapper import (
    FDMSymbolMapArg,
    FDMSymbolMapper,
)
from pararealml_tpu_torch.operators.fdm.numerical_differentiator import (
    NumericalDifferentiator,
    slice_all_constraint_pairs,
    slice_constraint,
)
from pararealml_tpu_torch.operators.fdm.numerical_integrator import (
    NumericalIntegrator,
)
from pararealml_tpu_torch.solution import Solution
from pararealml_tpu_torch.utils import tracing


def _require_static(cp: ConstrainedProblem):
    if (
        cp.differential_equation.x_dimension
        and not cp.are_all_boundary_conditions_static
    ):
        raise NotImplementedError(
            "dynamic boundary conditions are not ported to PyTorch yet "
            "(ROADMAP.md, Queue 1, slice 1b)"
        )


class _FusedFamily(NamedTuple):
    """A fused family's builders for one problem: ``trajectory(steps)``,
    ``end(steps, batch=None)`` (None where the family has no end kernel
    for the grid) and ``step()``, each returning a function of the
    state."""

    trajectory: Callable
    end: Callable
    step: Callable


class FDMOperator(TorchOperator):
    """A finite difference method differential equation solver."""

    def __init__(
        self,
        integrator: NumericalIntegrator,
        differentiator: NumericalDifferentiator,
        d_t: float,
        fused_kernels: bool = True,
        linear_propagator: bool = True,
        kernel_storage_dtype=None,
        kernel_traj_dtype=None,
        kernel_temporal_block: int = 1,
        spatial_mesh=None,
        spatial_partition=None,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        """
        :param integrator: the time integrator to use
        :param differentiator: the spatial differentiator to use
        :param d_t: the temporal step size
        :param fused_kernels: whether to use the hand-written CUDA
            kernels for the problem classes they cover (RK4 with static
            boundary conditions, float32 states: 2D diffusion and
            convection-diffusion on Cartesian meshes; 2D wave, Burgers,
            shallow water and Cahn-Hilliard on Cartesian meshes and on
            polar meshes away from the origin, past one CTA's shared
            memory only with Dirichlet constraints on the grid's faces;
            3D diffusion, convection-diffusion, wave, Burgers and
            Cahn-Hilliard on Cartesian volumes that fit one thread block
            cluster); the generic path is used otherwise
        :param linear_propagator: whether parallel-in-time callers
            (``trajectory_function(..., time_parallel=True)``, i.e.
            Parareal sub-solves) may compute trajectories of *linear*
            problems as exact affine-propagator matmuls instead of
            sequential stencil stepping; plain ``solve`` calls always
            time-step
        :param kernel_storage_dtype: precision of the stored trajectory
            (and, on the tiled paths, of the state carried between
            residencies or steps) of the large-grid diffusion kernels
            and of the tiled system kernel (K8), on grids past the JAX
            package's VMEM caps, where it takes effect there too:
            ``torch.float32`` (default) or ``torch.bfloat16``, which
            halves the traffic while all arithmetic stays float32; the
            trajectory function then returns that dtype
        :param kernel_traj_dtype: precision of the tiled kernel's stored
            frames alone (defaults to ``kernel_storage_dtype``);
            requires ``kernel_temporal_block >= 2`` when it differs; a
            Parareal over this operator rounds the frames of its batched
            fine trajectory (K4) to it too
        :param kernel_temporal_block: RK4 steps a tile of the tiled
            kernel advances per residency (1, or even; stepped down to
            a divisor of a solve's step count with a feasible tile
            plan); like the two dtypes, it takes effect past the JAX
            package's VMEM cap only
        :param spatial_mesh: not ported yet (spatial domain
            decomposition; ROADMAP.md, Queue 1, slice 7)
        :param spatial_partition: not ported yet (likewise)
        :param device: the device :meth:`solve` runs on (the CUDA card
            when None)
        :param dtype: the state's floating-point type (torch's default
            dtype when None); the fused kernels take float32
        """
        if spatial_mesh is not None or spatial_partition is not None:
            raise NotImplementedError(
                "spatial domain decomposition is not ported to PyTorch yet "
                "(ROADMAP.md, Queue 1, slice 7)"
            )
        super().__init__(d_t, True, device=device, dtype=dtype)
        self._integrator = integrator
        self._differentiator = differentiator
        self._fused_kernels = fused_kernels
        self._linear_propagator = linear_propagator
        self._kernel_storage_dtype = kernel_storage_dtype
        self._kernel_traj_dtype = kernel_traj_dtype
        self._kernel_temporal_block = int(kernel_temporal_block)
        self._compiled_cache = {}
        self._frame_drain = None

    def solve(
        self, ivp: InitialValueProblem, parallel_enabled: bool = True
    ) -> Solution:
        with tracing.span("fdm.solve"):
            cp = ivp.constrained_problem
            _require_static(cp)
            t = discretize_time_domain(ivp.t_interval, self._d_t)
            steps = len(t) - 1
            if steps < 1:
                raise ValueError(
                    "time interval must span at least one full time step"
                )

            dtype, device = self.dtype, self.device
            with tracing.span("solve.initial_state"):
                y_0 = torch.as_tensor(
                    ivp.initial_condition.discrete_y_0(True),
                    dtype=dtype,
                    device=device,
                )
            # the cached problem object is stored alongside the built
            # function, both to pin its id (CPython may otherwise reuse
            # the address for a new problem, silently returning a stale
            # solver) and to guard against id collisions explicitly
            cache_key = (id(cp), steps, dtype, device)
            entry = self._compiled_cache.get(cache_key)
            if entry is None or entry[0] is not cp:
                entry = (
                    cp,
                    self._build_trajectory_fn(cp, steps, dtype=dtype),
                )
                self._compiled_cache[cache_key] = entry

            trajectory = entry[1]
            progress = (
                self._frame_progress(y_0, steps)
                if getattr(trajectory, "publishes", False)
                else None
            )
            with tracing.span("solve.trajectory"):
                if progress is None:
                    ys = trajectory(y_0, float(t[0]))
                else:
                    ys = trajectory(y_0, float(t[0]), progress=progress)
            return materialize_solution(
                ivp,
                t[1:],
                ys,
                vertex_oriented=True,
                d_t=self._d_t,
                progress=progress,
            )

    def _frame_progress(
        self, y_0: torch.Tensor, steps: int
    ) -> Optional[FrameProgress]:
        """The progress that a kernel which publishes its finished frames
        takes, so that the trajectory from ``y_0`` crosses to the host
        while the kernel runs, on this operator's :class:`FrameDrain`; or
        None where it crosses whole: off the card, on a card whose streams
        cannot wait on a word, or in one piece."""
        if self._frame_drain is None:
            if not FrameDrain.usable(y_0.device):
                return None
            self._frame_drain = FrameDrain(y_0.device)
        return self._frame_drain.progress(y_0.numel() * 8, steps)

    def trajectory_function(
        self,
        cp,
        t_interval,
        allow_fused: bool = True,
        time_parallel: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
        batch: Optional[int] = None,
    ) -> Tuple[Callable, np.ndarray]:
        _require_static(cp)
        t = discretize_time_domain(t_interval, self._d_t)
        steps = len(t) - 1
        trajectory = self._build_trajectory_fn(
            cp,
            steps,
            allow_fused=allow_fused,
            time_parallel=time_parallel,
            dtype=dtype,
            device=device,
            batch=batch,
        )
        return trajectory, t[1:]

    def indexed_trajectory_function(self, *args, **kwargs):
        """Slice-indexed trajectories for dynamic boundary conditions
        (not ported yet)."""
        raise NotImplementedError(
            "indexed_trajectory_function serves dynamic boundary "
            "conditions, which are not ported to PyTorch yet (ROADMAP.md, "
            "Queue 1, slice 1b)"
        )

    def indexed_ends_function(self, *args, **kwargs):
        """Slice-indexed end states for dynamic boundary conditions (not
        ported yet)."""
        raise NotImplementedError(
            "indexed_ends_function serves dynamic boundary conditions, "
            "which are not ported to PyTorch yet (ROADMAP.md, Queue 1, "
            "slice 1b)"
        )

    def ends_function(
        self,
        cp,
        t_interval,
        allow_fused: bool = True,
        batch: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> Optional[Callable]:
        """An ends-only solver ``fn(y_0, t_0) -> y_end`` for the interval
        — the counterpart of :meth:`trajectory_function` for consumers
        that need only the final state (Parareal's iterations).

        When a fused end kernel applies (and ``allow_fused``), it runs
        the solve without storing frames: K2, the K5 end or the K9 end
        (the state on-chip for the whole solve), and past one CTA the end
        modes of K7 (diffusion) and K8 (2D systems); ``batch=B`` builds
        the batched variant mapping ``(B, ...) -> (B, ...)`` (tagged
        ``batched``; K4 where it applies), otherwise it maps one state.
        On the generic path the solve is a carry-only loop that never
        stacks per-step states, and the function takes any leading batch
        axes (tagged ``vmappable``; ``batch`` is ignored). Returns None
        for dynamic boundary conditions.
        """
        if (
            cp.differential_equation.x_dimension
            and not cp.are_all_boundary_conditions_static
        ):
            return None
        dtype = self.dtype if dtype is None else dtype
        t = discretize_time_domain(t_interval, self._d_t)
        steps = len(t) - 1
        fused = (
            self._fused_solve(cp, steps, batch, dtype, end=True)
            if allow_fused
            else None
        )
        if fused is not None:
            return fused

        step_fn = self._build_step_function(cp, allow_fused=False)
        d_t = self._d_t

        def ends(y_init, t_start):
            y = y_init
            for k in range(steps):
                y = step_fn(y, k, t_start + d_t * k)
            return y

        ends.vmappable = True
        ends.fused = False
        ends.batched = False
        return ends

    def _fused_anti_laplacian_compatible(self, cp) -> bool:
        """The fused Navier-Stokes kernel runs the stream-function
        anti-Laplacian as an in-kernel Jacobi loop; when the
        differentiator is configured for another scheme, problems with a
        ``Y_LAPLACIAN`` equation stay on the generic path so that the
        requested solver is the one used."""
        if self._differentiator.anti_laplacian_method == "jacobi":
            return True
        eq_sys = cp.differential_equation.symbolic_equation_system
        return not eq_sys.equation_indices_by_type(LHS.Y_LAPLACIAN)

    # -- kernel choice -----------------------------------------------------

    def _fused_family(
        self, cp: ConstrainedProblem, dtype: torch.dtype
    ) -> Optional[_FusedFamily]:
        """The builders of the fused family that covers this problem and
        states of ``dtype``, bound to the step size and this operator's
        settings, or None when fused kernels are off or no family
        applies. The families are tried in this order: diffusion and
        convection-diffusion (K1-K3 on grids that fit one CTA, K7 and K6
        past it), 2D systems (K5, the cluster-resident mode, K8 and the
        Navier-Stokes kernel), 3D (K9); each family's builders pick its
        kernel by grid size."""
        if not self._fused_kernels:
            return None
        from pararealml_tpu_torch.ops import fused_diffusion as diffusion
        from pararealml_tpu_torch.ops import fused_system as system
        from pararealml_tpu_torch.ops import fused_system_3d as system_3d

        d_t, integrator = self._d_t, self._integrator
        if diffusion.fused_diffusion_step_applicable(cp, integrator, dtype):
            return _FusedFamily(
                partial(self._fused_diffusion_trajectory, cp),
                partial(diffusion.build_fused_diffusion_rk4_end, cp, d_t),
                partial(diffusion.build_fused_diffusion_rk4_step, cp, d_t),
            )
        if system.fused_system_step_applicable(
            cp, integrator, dtype
        ) and self._fused_anti_laplacian_compatible(cp):
            knobs = dict(
                anti_laplacian_tol=self._differentiator._tol,
                anti_laplacian_max_iterations=(
                    self._differentiator._max_iterations
                ),
            )
            # kernel_traj_dtype and kernel_temporal_block do not reach
            # the system kernels, and kernel_storage_dtype only past the
            # JAX package's VMEM cap, as in the JAX package
            return _FusedFamily(
                partial(
                    system.build_fused_system_rk4_trajectory,
                    cp,
                    d_t,
                    storage_dtype=self._kernel_storage_dtype,
                    **knobs,
                ),
                partial(system.build_fused_system_rk4_end, cp, d_t, **knobs),
                partial(system.build_fused_system_rk4_step, cp, d_t, **knobs),
            )
        if system_3d.fused_system_3d_step_applicable(cp, integrator, dtype):
            return _FusedFamily(
                *(
                    partial(builder, cp, d_t)
                    for builder in (
                        system_3d.build_fused_system_3d_rk4_trajectory,
                        system_3d.build_fused_system_3d_rk4_end,
                        system_3d.build_fused_system_3d_rk4_step,
                    )
                )
            )
        return None

    def _fused_diffusion_trajectory(self, cp, steps: int) -> Callable:
        """The diffusion family's trajectory builder with the storage
        knobs resolved for this grid and step count."""
        from pararealml_tpu_torch.ops.fused_diffusion import (
            build_fused_diffusion_rk4_trajectory,
            past_reference_vmem,
        )
        from pararealml_tpu_torch.ops.tiled_diffusion import (
            resolve_temporal_block,
            takes_streaming_path,
        )

        # the knobs take effect past the JAX package's VMEM cap only:
        # below it, its whole-grid kernel ignores them
        if past_reference_vmem(cp):
            storage_dtype = self._kernel_storage_dtype
            traj_dtype = self._kernel_traj_dtype
            requested_block = self._kernel_temporal_block
        else:
            storage_dtype = traj_dtype = None
            requested_block = 1
        temporal_block = resolve_temporal_block(
            cp,
            steps,
            requested_block,
            storage_dtype=storage_dtype,
            traj_dtype=traj_dtype,
        )
        if (
            temporal_block == 1
            and traj_dtype is not None
            and traj_dtype != storage_dtype
            and takes_streaming_path(cp)
        ):
            # a split frame dtype needs the blocked pipeline; falling
            # back to the state dtype silently would yield
            # differently-rounded trajectories per solve
            warnings.warn(
                f"kernel_traj_dtype={traj_dtype} "
                "dropped: no even temporal block <= "
                f"{requested_block} divides this "
                f"solve's {steps} steps with a feasible tile "
                "plan, so snapshots keep the storage dtype",
                stacklevel=5,
            )
        return build_fused_diffusion_rk4_trajectory(
            cp,
            self._d_t,
            steps,
            storage_dtype=storage_dtype,
            traj_dtype=(traj_dtype if temporal_block > 1 else storage_dtype),
            temporal_block=temporal_block,
        )

    def _fused_solve(
        self,
        cp: ConstrainedProblem,
        steps: int,
        batch: Optional[int],
        dtype: torch.dtype,
        end: bool,
    ) -> Optional[Callable]:
        """``fn(y_0, t_0)`` for the end state (``end``) or the trajectory
        through a hand-written kernel, or None when none applies: for a
        ``batch`` of states the batched kernels over them (K4,
        :mod:`pararealml_tpu_torch.ops.packed_system`: 2D systems other
        than Navier-Stokes on a Cartesian grid that fits one CTA, a batch
        of two or more), whose trajectory rounds its frames to
        ``kernel_traj_dtype`` as the JAX package's final Parareal
        expansion does; else the fused family's kernel."""
        if not self._fused_kernels:
            return None
        from pararealml_tpu_torch.ops import packed_system

        if batch is not None and packed_system.packed_system_applicable(
            cp, self._integrator, batch, dtype
        ):
            kernel = (
                packed_system.build_packed_system_rk4_ends(
                    cp, self._d_t, steps, batch
                )
                if end
                else packed_system.build_packed_system_rk4_trajectory(
                    cp,
                    self._d_t,
                    steps,
                    batch,
                    traj_dtype=self._kernel_traj_dtype,
                )
            )
            vmappable, batched = False, True
        else:
            family = self._fused_family(cp, dtype)
            if family is None:
                return None
            kernel = (
                family.end(steps, batch=batch)
                if end
                else family.trajectory(steps)
            )
            if kernel is None:
                return None
            # a trajectory kernel runs one CTA (K1, K5), one cluster (K9)
            # or one launch sequence (K6, K7; K8 over all of them at
            # once) per leading index
            vmappable, batched = not end, end and batch is not None

        def fused(y_init, t_start=None, progress=None):
            # the fused families are autonomous with static constraints,
            # so the start time is irrelevant
            if progress is None:
                return kernel(y_init)
            return kernel(y_init, progress=progress)

        fused.vmappable = vmappable
        fused.fused = True
        fused.batched = batched
        # a trajectory kernel of one state that takes a FrameProgress
        fused.publishes = getattr(kernel, "publishes", False)
        return fused

    # -- step construction -------------------------------------------------

    def _build_trajectory_fn(
        self,
        cp: ConstrainedProblem,
        steps: int,
        allow_fused: bool = True,
        time_parallel: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
        batch: Optional[int] = None,
    ) -> Callable:
        """Builds ``fn(y_0, t_0) -> ys`` for the whole trajectory: for
        parallel-in-time callers on linear problems, the affine
        propagator; otherwise a hand-written kernel when one applies (K4
        for a ``batch``, else K1, K5, K6, K7, K8 or K9), else a loop over
        the generic step."""
        dtype = self.dtype if dtype is None else dtype
        device = self.device if device is None else torch.device(device)
        if time_parallel and self._linear_propagator:
            from pararealml_tpu_torch.ops.linear_propagator import (
                build_linear_propagator_trajectory,
                linear_propagator_applicable,
            )

            if linear_propagator_applicable(cp, self._integrator):
                step_fn = self._build_step_function(cp, allow_fused=False)
                y_shape = (
                    tuple(cp.y_shape(True))
                    if cp.differential_equation.x_dimension
                    else (cp.differential_equation.y_dimension,)
                )
                return build_linear_propagator_trajectory(
                    cp, step_fn, steps, y_shape, dtype=dtype, device=device
                )
        fused = (
            self._fused_solve(cp, steps, batch, dtype, end=False)
            if allow_fused
            else None
        )
        if fused is not None:
            return fused

        step_fn = self._build_step_function(cp, allow_fused=False)
        d_t = self._d_t
        y_rank = len(cp.y_shape(True))

        def trajectory(y_init, t_start):
            # the time axis goes right before the state's own axes, after
            # any leading batch axes
            lead = tuple(y_init.shape[: y_init.ndim - y_rank])
            ys = y_init.new_empty(
                lead + (steps,) + tuple(y_init.shape[len(lead):])
            )
            y = y_init
            for k in range(steps):
                y = step_fn(y, k, t_start + d_t * k)
                ys[(Ellipsis, k) + (slice(None),) * y_rank] = y
            return ys

        # the generic loop maps any leading batch axes elementwise
        trajectory.vmappable = True
        trajectory.fused = False
        return trajectory

    def _build_step_function(
        self,
        cp: ConstrainedProblem,
        allow_fused: bool = True,
        dtype: Optional[torch.dtype] = None,
    ) -> Callable:
        """Builds ``step(y, i, t_i) -> y_next`` for one time step, with
        all constraint data resolved to tensors. ``y`` may carry leading
        batch axes. With ``allow_fused``, the fused step kernel is
        used where it applies to states of ``dtype`` (K3 for the
        diffusion family, the K5 step for 2D systems, or the one-step K8
        trajectory past one CTA, the K9 step in 3D)."""
        _require_static(cp)
        dtype = self.dtype if dtype is None else dtype
        family = self._fused_family(cp, dtype) if allow_fused else None
        if family is not None:
            fused_step = family.step()

            def step_fused(y, i, t_i):
                return fused_step(y)

            return step_fused

        diff_eq = cp.differential_equation
        eq_sys = diff_eq.symbolic_equation_system
        mapper = FDMSymbolMapper(cp, self._differentiator)

        d_y_over_d_t_indices = list(
            eq_sys.equation_indices_by_type(LHS.D_Y_OVER_D_T)
        )
        y_indices = list(eq_sys.equation_indices_by_type(LHS.Y))
        y_laplacian_indices = list(
            eq_sys.equation_indices_by_type(LHS.Y_LAPLACIAN)
        )
        all_d_y_over_d_t = len(d_y_over_d_t_indices) == diff_eq.y_dimension

        if diff_eq.x_dimension:
            y_constraint = cp.static_y_vertex_constraints
            d_y_constraints = cp.static_boundary_vertex_constraints.d_y
        else:
            y_constraint = None
            d_y_constraints = None

        d_t = self._d_t
        integrator = self._integrator
        differentiator = self._differentiator
        if y_laplacian_indices:
            laplacian_y_constraint = slice_constraint(
                y_constraint, y_laplacian_indices
            )
            laplacian_d_y_constraints = slice_all_constraint_pairs(
                d_y_constraints, y_laplacian_indices
            )

        def step(y, i, t_i):
            def d_y_over_d_t(offset, y_arg):
                rhs = mapper.map_concatenated(
                    FDMSymbolMapArg(
                        t_i + offset * d_t, y_arg, d_y_constraints
                    ),
                    LHS.D_Y_OVER_D_T,
                )
                if all_d_y_over_d_t:
                    return rhs
                full = torch.zeros_like(y_arg)
                full[..., d_y_over_d_t_indices] = rhs
                return full

            y_next = integrator.integral(
                y, d_t, d_y_over_d_t, lambda offset: y_constraint
            )

            if y_indices:
                y_rhs = mapper.map_concatenated(
                    FDMSymbolMapArg(t_i, y, d_y_constraints), LHS.Y
                )
                y_next = y_next.clone()
                y_next[..., y_indices] = apply_constraints_along_last_axis(
                    slice_constraint(y_constraint, y_indices), y_rhs
                )

            if y_laplacian_indices:
                # the right-hand side from the step-initial state, solved
                # from the current values, as the JAX package does (its
                # constraints at offsets 0 and 1 are one static set here)
                laplacian_rhs = mapper.map_concatenated(
                    FDMSymbolMapArg(t_i, y, d_y_constraints),
                    LHS.Y_LAPLACIAN,
                )
                y_next = y_next.clone()
                y_next[..., y_laplacian_indices] = (
                    differentiator.anti_laplacian(
                        laplacian_rhs,
                        cp.mesh,
                        laplacian_y_constraint,
                        laplacian_d_y_constraints,
                        y_init=y[..., y_laplacian_indices],
                    )
                )
            return y_next

        return step
