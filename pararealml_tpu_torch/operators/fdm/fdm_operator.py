"""The finite-difference-method solver.

Port of the JAX package's ``operators/fdm/fdm_operator.py`` (capability
match for PararealML's operators/fdm/fdm_operator.py:27-231)
for static boundary conditions. A solve is one of three formulations,
chosen when it is built:

- for parallel-in-time callers on linear problems, the exact affine
  propagator (:mod:`pararealml_tpu_torch.ops.linear_propagator`);
- where the fused kernels apply (2D Cartesian diffusion or
  convection-diffusion under RK4, float32 states, grids that fit one
  CTA's shared memory), the hand-written CUDA kernels of
  :mod:`pararealml_tpu_torch.ops.fused_diffusion` (their plain PyTorch
  versions for CPU tensors);
- otherwise a Python loop over the generic step, which evaluates the
  symbolic right-hand side with stencils on tensors.

Static boundary conditions become constant dense constraint tensors. All
functions accept states with leading batch axes.

Not ported yet: dynamic boundary conditions and the ``indexed_*``
functions that serve them (ROADMAP.md, Queue 1, slice 1b), spatial
domain decomposition (slice 7), the block-tiled kernels' storage-dtype
and temporal-block knobs (slice 6), and equations with ``Y_LAPLACIAN``
left-hand sides, which need the anti-Laplacian (slice 6).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.constraint import (
    apply_constraints_along_last_axis,
)
from pararealml_tpu_torch.differential_equation import LHS
from pararealml_tpu_torch.initial_value_problem import InitialValueProblem
from pararealml_tpu_torch.operator import (
    TorchOperator,
    discretize_time_domain,
)
from pararealml_tpu_torch.operators.fdm.fdm_symbol_mapper import (
    FDMSymbolMapArg,
    FDMSymbolMapper,
)
from pararealml_tpu_torch.operators.fdm.numerical_differentiator import (
    NumericalDifferentiator,
    slice_constraint,
)
from pararealml_tpu_torch.operators.fdm.numerical_integrator import (
    NumericalIntegrator,
)
from pararealml_tpu_torch.solution import Solution


def _require_static(cp: ConstrainedProblem):
    if (
        cp.differential_equation.x_dimension
        and not cp.are_all_boundary_conditions_static
    ):
        raise NotImplementedError(
            "dynamic boundary conditions are not ported to PyTorch yet "
            "(ROADMAP.md, Queue 1, slice 1b)"
        )


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
            kernels for the problem class they cover (2D Cartesian
            diffusion and convection-diffusion under RK4 with static
            boundary conditions, float32 states, grids that fit one
            CTA's shared memory); the generic path is used otherwise
        :param linear_propagator: whether parallel-in-time callers
            (``trajectory_function(..., time_parallel=True)``, i.e.
            Parareal sub-solves) may compute trajectories of *linear*
            problems as exact affine-propagator matmuls instead of
            sequential stencil stepping; plain ``solve`` calls always
            time-step
        :param kernel_storage_dtype: not ported yet (the JAX package's
            block-tiled kernels; ROADMAP.md, Queue 1, slice 6)
        :param kernel_traj_dtype: not ported yet (likewise)
        :param kernel_temporal_block: not ported yet (likewise)
        :param spatial_mesh: not ported yet (spatial domain
            decomposition; ROADMAP.md, Queue 1, slice 7)
        :param spatial_partition: not ported yet (likewise)
        :param device: the device :meth:`solve` runs on (torch's default
            device when None)
        :param dtype: the state's floating-point type (torch's default
            dtype when None); the fused kernels take float32
        """
        if (
            kernel_storage_dtype is not None
            or kernel_traj_dtype is not None
            or int(kernel_temporal_block) != 1
        ):
            raise NotImplementedError(
                "the block-tiled kernels' storage dtype, snapshot dtype and "
                "temporal block are not ported to PyTorch yet (ROADMAP.md, "
                "Queue 1, slice 6)"
            )
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
        self._compiled_cache = {}

    def solve(
        self, ivp: InitialValueProblem, parallel_enabled: bool = True
    ) -> Solution:
        cp = ivp.constrained_problem
        _require_static(cp)
        t = discretize_time_domain(ivp.t_interval, self._d_t)
        steps = len(t) - 1
        if steps < 1:
            raise ValueError(
                "time interval must span at least one full time step"
            )

        dtype, device = self.dtype, self.device
        y_0 = torch.as_tensor(
            ivp.initial_condition.discrete_y_0(True),
            dtype=dtype,
            device=device,
        )
        # the cached problem object is stored alongside the built
        # function, both to pin its id (CPython may otherwise reuse the
        # address for a new problem, silently returning a stale solver)
        # and to guard against id collisions explicitly
        cache_key = (id(cp), steps, dtype, device)
        entry = self._compiled_cache.get(cache_key)
        if entry is None or entry[0] is not cp:
            entry = (
                cp,
                self._build_trajectory_fn(cp, steps, dtype=dtype),
            )
            self._compiled_cache[cache_key] = entry

        ys = entry[1](y_0, float(t[0]))
        return Solution(
            ivp,
            t[1:],
            ys.to(torch.float64).cpu().numpy(),
            vertex_oriented=True,
            d_t=self._d_t,
        )

    def trajectory_function(
        self,
        cp,
        t_interval,
        allow_fused: bool = True,
        time_parallel: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
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

        When the fused end kernel applies (and ``allow_fused``), the
        state stays on-chip for the whole solve; ``batch=B`` builds the
        batched variant mapping ``(B, ...) -> (B, ...)`` with one CTA per
        state (tagged ``batched``), otherwise it maps one state. On the
        generic path the solve is a carry-only loop that never stacks
        per-step states, and the function takes any leading batch axes
        (tagged ``vmappable``; ``batch`` is ignored). Returns None for
        dynamic boundary conditions.
        """
        if (
            cp.differential_equation.x_dimension
            and not cp.are_all_boundary_conditions_static
        ):
            return None
        dtype = self.dtype if dtype is None else dtype
        t = discretize_time_domain(t_interval, self._d_t)
        steps = len(t) - 1

        if self._fused_kernels and allow_fused:
            fused_end = self._build_fused_end_fn(cp, steps, batch, dtype)
            if fused_end is not None:

                def fused_ends(y_init, t_start=None):
                    # the fused family is autonomous with static
                    # constraints, so the start time is irrelevant
                    return fused_end(y_init)

                fused_ends.vmappable = False
                fused_ends.fused = True
                fused_ends.batched = batch is not None
                return fused_ends

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

    def _build_fused_end_fn(
        self, cp, steps: int, batch: Optional[int], dtype: torch.dtype
    ) -> Optional[Callable]:
        """The fused end kernel (K2) for this problem, or None when it
        does not apply."""
        from pararealml_tpu_torch.ops.fused_diffusion import (
            build_fused_diffusion_rk4_end,
            fused_diffusion_step_applicable,
        )

        if fused_diffusion_step_applicable(cp, self._integrator, dtype):
            return build_fused_diffusion_rk4_end(
                cp, self._d_t, steps, batch=batch
            )
        return None

    # -- step construction -------------------------------------------------

    def _build_trajectory_fn(
        self,
        cp: ConstrainedProblem,
        steps: int,
        allow_fused: bool = True,
        time_parallel: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> Callable:
        """Builds ``fn(y_0, t_0) -> ys`` for the whole trajectory: for
        parallel-in-time callers on linear problems, the affine
        propagator; otherwise the fused trajectory kernel (K1) when
        applicable, else a loop over the generic step."""
        from pararealml_tpu_torch.ops.fused_diffusion import (
            build_fused_diffusion_rk4_trajectory,
            fused_diffusion_step_applicable,
        )

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
        if (
            self._fused_kernels
            and allow_fused
            and fused_diffusion_step_applicable(cp, self._integrator, dtype)
        ):
            fused_trajectory = build_fused_diffusion_rk4_trajectory(
                cp, self._d_t, steps
            )

            def fused(y_init, t_start=None):
                return fused_trajectory(y_init)

            # one CTA per leading index
            fused.vmappable = True
            fused.fused = True
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
        batch axes. With ``allow_fused``, the fused step kernel (K3) is
        used where it applies to states of ``dtype``."""
        _require_static(cp)
        dtype = self.dtype if dtype is None else dtype
        if self._fused_kernels and allow_fused:
            from pararealml_tpu_torch.ops.fused_diffusion import (
                build_fused_diffusion_rk4_step,
                fused_diffusion_step_applicable,
            )

            if fused_diffusion_step_applicable(cp, self._integrator, dtype):
                fused_step = build_fused_diffusion_rk4_step(cp, self._d_t)

                def step_fused(y, i, t_i):
                    return fused_step(y)

                return step_fused

        diff_eq = cp.differential_equation
        eq_sys = diff_eq.symbolic_equation_system
        if eq_sys.equation_indices_by_type(LHS.Y_LAPLACIAN):
            raise NotImplementedError(
                "equations with Y_LAPLACIAN left-hand sides need the "
                "anti-Laplacian, which is not ported to PyTorch yet "
                "(ROADMAP.md, Queue 1, slice 6)"
            )
        mapper = FDMSymbolMapper(cp, self._differentiator)

        d_y_over_d_t_indices = list(
            eq_sys.equation_indices_by_type(LHS.D_Y_OVER_D_T)
        )
        y_indices = list(eq_sys.equation_indices_by_type(LHS.Y))
        all_d_y_over_d_t = len(d_y_over_d_t_indices) == diff_eq.y_dimension

        if diff_eq.x_dimension:
            y_constraint = cp.static_y_vertex_constraints
            d_y_constraints = cp.static_boundary_vertex_constraints.d_y
        else:
            y_constraint = None
            d_y_constraints = None

        d_t = self._d_t
        integrator = self._integrator

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
            return y_next

        return step
