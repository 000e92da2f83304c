"""Parallel-in-time solving with the Parareal algorithm on one device.

Port of the JAX package's ``operators/parareal/parareal_operator.py``
(capability match for PararealML's operators/parareal/
parareal_operator.py:13-197) for one device: the classic ``"f"``
schedule with ``materialize="final"`` and static boundary conditions.
The time slices are a leading batch axis of every sub-solve, so each
iteration's fine solves are one batched call. The fine operator chooses
how: the schedule asks it through the :class:`TorchOperator` contract
(``trajectory_function`` and ``ends_function`` with ``batch`` set to the
slice count) and never names a kernel. :class:`FDMOperator` answers with
affine-propagator matmuls on linear problems (the default), else the
batched kernels over the slices (K4) or a batched fused end kernel where
they apply, else the generic step loop over the batch.

The coarse sweeps run as a log-depth doubling scan when the coarse
propagator is affine, else slice by slice (through the single-state
fused end kernel where it applies). Early termination uses the
reference's criterion (the maximum per-component RMS of the border
updates against the tolerance), checked on the host after each
iteration. After the loop, the fine trajectories are expanded once from
the final borders (one batched call of the fine trajectory) and shifted
onto the corrected borders. A coarse operator that is neither affine nor
fused, such as a nonlinear supervised-ML surrogate, runs the initial
sweep as one whole-domain roll-out and the corrective sweeps through its
``ends_function``.

Not ported yet: FCF relaxation, ``materialize="iteration"``, dynamic
boundary conditions, callable termination conditions and the host
fallback (ROADMAP.md, Queue 1, slice 1b), ``tune_num_time_slices`` and
multiple devices (slice 7).
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from pararealml_tpu_torch.initial_value_problem import InitialValueProblem
from pararealml_tpu_torch.operator import (
    Operator,
    TorchOperator,
    discretize_time_domain,
    materialize_solution,
)
from pararealml_tpu_torch.solution import Solution
from pararealml_tpu_torch.utils import tracing

TerminationCondition = Union[
    float, Sequence[float], Callable[[np.ndarray, np.ndarray], bool]
]


def make_rms_termination(tolerances):
    """Builds the border-update termination predicate: per-component RMS
    of the border updates, reduced over space, maxed over slices,
    compared against the per-component tolerances (the reference's
    criterion, parareal_operator.py:187-188). ``None`` tolerances
    disable early termination. Returns a boolean tensor."""

    def termination(old_ends, new_ends):
        if tolerances is None:
            return torch.tensor(False)
        diff = new_ends - old_ends
        reduce_axes = tuple(range(1, diff.ndim - 1))
        rms = torch.sqrt(torch.mean(torch.square(diff), dim=reduce_axes))
        max_rms = torch.amax(rms, dim=0)
        return torch.all(
            max_rms
            < torch.as_tensor(tolerances, dtype=diff.dtype, device=diff.device)
        )

    return termination


def _not_ported(feature: str, where: str = "slice 1b") -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to PyTorch yet (ROADMAP.md, Queue 1, "
        f"{where})"
    )


class PararealOperator(TorchOperator):
    """A parallel-in-time solver framework composing a fine and a coarse
    operator over the slices of the time domain."""

    # sub-solves may use parallel-in-time trajectory formulations
    # (affine propagator matmuls) only when every termination tolerance
    # exceeds this floor: the dense-matmul formulation carries an
    # ~1e-6-relative f32 rounding floor vs the stencil steppers, so users
    # demanding tighter agreement (tolerance 0.0 / None means "iterate to
    # exactness") keep stencil fine solves
    _TIME_PARALLEL_TOLERANCE_FLOOR = 1e-5

    def __init__(
        self,
        f: Operator,
        g: Operator,
        termination_condition: Optional[TerminationCondition] = None,
        max_iterations: int = sys.maxsize,
        num_time_slices: Optional[int] = None,
        devices: Optional[Sequence] = None,
        relaxation: str = "f",
        materialize: str = "final",
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        """
        :param f: the fine (accurate, expensive) operator
        :param g: the coarse (cheap) operator
        :param termination_condition: a scalar update tolerance or a
            per-component sequence of tolerances; ``None`` disables
            early termination (callable predicates are not ported yet)
        :param max_iterations: cap on the number of corrective iterations
        :param num_time_slices: number of time slices (default 1: the
            slices of one device)
        :param devices: not ported yet beyond one device
        :param relaxation: ``"f"`` (classic Parareal); ``"fcf"`` is not
            ported yet
        :param materialize: ``"final"``; ``"iteration"`` is not ported
            yet
        :param device: the device :meth:`solve` runs on (the fine
            operator's when None, so the CUDA card unless the fine
            operator was given another)
        :param dtype: the state's floating-point type (the fine
            operator's when None)
        """
        if relaxation not in ("f", "fcf"):
            raise ValueError(
                f"unsupported relaxation '{relaxation}'; expected 'f' "
                "or 'fcf'"
            )
        if materialize not in ("final", "iteration"):
            raise ValueError(
                f"unsupported materialize '{materialize}'; expected "
                "'final' or 'iteration'"
            )
        if relaxation == "fcf":
            raise _not_ported("FCF relaxation")
        if materialize == "iteration":
            raise _not_ported('materialize="iteration"')
        if devices is not None and len(devices) > 1:
            raise _not_ported("Parareal over multiple devices", "slice 7")
        super().__init__(
            f.d_t,
            f.vertex_oriented,
            device=f._device if device is None else device,
            dtype=f._dtype if dtype is None else dtype,
        )
        self._f = f
        self._g = g
        self._termination_condition = termination_condition
        self._max_iterations = max_iterations
        self._num_time_slices = num_time_slices
        self._relaxation = relaxation
        self._materialize = materialize
        self._compiled_cache = {}
        # iterations the last solve ran (for reporting)
        self.last_iterations: Optional[int] = None

    @property
    def f(self) -> Operator:
        """The fine operator."""
        return self._f

    @property
    def g(self) -> Operator:
        """The coarse operator."""
        return self._g

    @property
    def relaxation(self) -> str:
        """The relaxation scheme (``"f"``: classic Parareal)."""
        return self._relaxation

    # -- termination -------------------------------------------------------

    def _tolerance_vector(self, y_dimension: int) -> Optional[np.ndarray]:
        condition = self._termination_condition
        if condition is None:
            return None
        if callable(condition):
            raise _not_ported(
                "a callable termination condition (host-path Parareal)"
            )
        if isinstance(condition, (int, float)):
            return np.full(y_dimension, float(condition))
        if len(condition) != y_dimension:
            raise ValueError(
                f"length of update tolerances ({len(condition)}) must "
                f"match number of y dimensions ({y_dimension})"
            )
        return np.asarray(condition, dtype=float)

    def _use_time_parallel_trajectories(self, cp, y_0=None) -> bool:
        """Whether sub-solves may use parallel-in-time trajectory
        formulations (propagator matmuls): only when the termination
        tolerances all exceed the formulations' rounding floor, scaled by
        the initial state's largest magnitude when it is given (the
        floor is relative, the tolerances absolute)."""
        tolerances = self._tolerance_vector(
            cp.differential_equation.y_dimension
        )
        if tolerances is None:
            return False
        floor = self._TIME_PARALLEL_TOLERANCE_FLOOR
        if y_0 is not None:
            scale = float(torch.max(torch.abs(torch.as_tensor(y_0))))
            if np.isfinite(scale):
                floor = floor * max(1.0, scale)
        return bool(np.all(tolerances > floor))

    # -- solving -----------------------------------------------------------

    def solve(
        self, ivp: InitialValueProblem, parallel_enabled: bool = True
    ) -> Solution:
        if not parallel_enabled:
            return self._f.solve(ivp)

        with tracing.span("parareal.solve"):
            cp = ivp.constrained_problem
            t_interval = ivp.t_interval
            program = self._program_for(cp, t_interval)
            with tracing.span("solve.initial_state"):
                y_0 = torch.as_tensor(
                    ivp.initial_condition.discrete_y_0(
                        self._vertex_oriented
                    ),
                    dtype=self.dtype,
                    device=self.device,
                )
            with tracing.span("solve.trajectory"):
                y_fine = program(y_0, float(t_interval[0]))
            t = discretize_time_domain(t_interval, self._f.d_t)[1:]
            return materialize_solution(
                ivp,
                t,
                y_fine,
                vertex_oriented=self._vertex_oriented,
                d_t=self._f.d_t,
            )

    def trajectory_function(
        self,
        cp,
        t_interval,
        allow_fused: bool = True,
        time_parallel: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
        batch: Optional[int] = None,
    ):
        """The whole Parareal solve as one ``(y_0, t_0) -> ys`` function,
        with ``t_coordinates`` of the fine grid. The function runs in the
        dtype and on the device of ``y_0``; the other arguments of the
        :class:`TorchOperator` contract (``batch`` among them) do not
        change it."""
        program = self._program_for(cp, t_interval)
        t = discretize_time_domain(t_interval, self._f.d_t)
        return program, t[1:]

    def tune_num_time_slices(self, *args, **kwargs):
        """Empirical slice-count tuning (not ported yet)."""
        raise _not_ported("tune_num_time_slices", "slice 7")

    def _program_for(self, cp, t_interval):
        if (
            cp.differential_equation.x_dimension
            and not cp.are_all_boundary_conditions_static
        ):
            raise _not_ported("Parareal with dynamic boundary conditions")
        if not (
            isinstance(self._f, TorchOperator)
            and isinstance(self._g, TorchOperator)
        ):
            raise _not_ported("Parareal over non-tensor operators")
        n = self._num_time_slices or 1
        slice_duration = (t_interval[1] - t_interval[0]) / n
        self._validate_step_sizes(slice_duration)
        y_shape = (
            tuple(cp.y_shape(self._vertex_oriented))
            if cp.differential_equation.x_dimension
            else (cp.differential_equation.y_dimension,)
        )
        return self._compiled_program(cp, n, slice_duration, y_shape)

    def _validate_step_sizes(self, slice_duration: float) -> None:
        for operator, name in ((self._f, "fine"), (self._g, "coarse")):
            steps = round(slice_duration / operator.d_t)
            if not np.isclose(
                slice_duration, operator.d_t * steps
            ) or steps == 0:
                raise ValueError(
                    f"{name} operator time step size ({operator.d_t}) "
                    "must be a divisor of sub-IVP time slice length "
                    f"({slice_duration})"
                )

    def _compiled_program(self, cp, n: int, slice_duration: float, y_shape):
        """Returns the ``(y_0, t_0) -> y_fine`` program, built once per
        problem and decomposition (the problem object is stored to pin its
        id against CPython address reuse)."""
        cache_key = (id(cp), n, round(float(slice_duration), 12))
        entry = self._compiled_cache.get(cache_key)
        if entry is None or entry[0] is not cp:
            entry = (
                cp,
                self._build_program(cp, n, slice_duration, y_shape),
            )
            self._compiled_cache[cache_key] = entry
        return entry[1]

    def _fine_steps(self, slice_duration: float) -> int:
        return round(slice_duration / self._f.d_t)

    def _build_program(self, cp, n: int, slice_duration: float, y_shape):
        """The Parareal program. It runs in the dtype and on the device of
        the initial state it is given."""
        tolerances = self._tolerance_vector(
            cp.differential_equation.y_dimension
        )
        termination = make_rms_termination(tolerances)
        iterations = min(n, self._max_iterations)
        fine_steps = self._fine_steps(slice_duration)
        delta = float(slice_duration)
        dim = int(np.prod(y_shape))
        # sub-solvers by (time-parallel flag, dtype, device): the flag
        # depends on the initial state's magnitude, so they are built on
        # a program call
        sub_solvers = {}

        def build(time_parallel: bool, dtype, device):
            def trajectory(operator, batch=None):
                return operator.trajectory_function(
                    cp,
                    (0.0, slice_duration),
                    allow_fused=True,
                    time_parallel=time_parallel,
                    dtype=dtype,
                    device=device,
                    batch=batch,
                )[0]

            def ends(operator, batch=None):
                return operator.ends_function(
                    cp,
                    (0.0, slice_duration),
                    allow_fused=True,
                    batch=batch,
                    dtype=dtype,
                )

            # the fine trajectories of all slices in one batched call, and
            # their ends: the affine end map, else the fine operator's
            # batched ends, else the trajectory's last frame
            fine_expand = trajectory(self._f, batch=n)
            coarse_fn = trajectory(self._g)
            fine_end = getattr(fine_expand, "end_function", None)
            coarse_end = getattr(coarse_fn, "end_function", None)
            if fine_end is None:
                candidate = ends(self._f, batch=n)
                if candidate is None:
                    fine_end = lambda ys, t: fine_expand(ys, t)[  # noqa: E731
                        (Ellipsis, -1) + (slice(None),) * len(y_shape)
                    ]
                elif getattr(candidate, "batched", False) or getattr(
                    candidate, "vmappable", False
                ):
                    fine_end = candidate
                else:
                    raise RuntimeError(
                        "the fine ends function takes neither a batch nor "
                        "leading batch axes"
                    )

            # coarse ends one slice at a time for the sequential sweep:
            # the affine end map, else the single-state fused end kernel,
            # else the generic loop
            if coarse_end is None:
                coarse_end = ends(self._g)
                if coarse_end is None:
                    coarse_end = lambda y, t: coarse_fn(y, t)[-1]  # noqa

            affine = getattr(coarse_fn, "affine_slice_map", None)
            affine_sweep = (
                None
                if affine is None
                else _build_affine_sweep(affine, n, dim, device)
            )

            # without an affine coarse map, the initial coarse sweep is
            # ONE whole-domain coarse trajectory (the reference's own
            # g.solve(ivp)), so the fused trajectory kernel applies
            coarse_steps_per_slice = round(slice_duration / self._g.d_t)
            coarse_whole_fn = None
            if affine_sweep is None and getattr(
                coarse_fn, "end_function", None
            ) is None:
                coarse_whole_fn, coarse_whole_t = (
                    self._g.trajectory_function(
                        cp,
                        (0.0, n * slice_duration),
                        allow_fused=True,
                        time_parallel=time_parallel,
                        dtype=dtype,
                        device=device,
                    )
                )
                if len(coarse_whole_t) != coarse_steps_per_slice * n:
                    # accumulated rounding made the whole-domain grid
                    # disagree with n x per-slice steps; fall back to the
                    # per-slice sweep
                    coarse_whole_fn = None
            return (
                fine_expand,
                fine_end,
                coarse_end,
                affine_sweep,
                coarse_whole_fn,
                coarse_steps_per_slice,
            )

        def program(y_init: torch.Tensor, t_0=0.0) -> torch.Tensor:
            if tuple(y_init.shape) != tuple(y_shape):
                raise ValueError(
                    f"expected an initial state of shape {y_shape}, got "
                    f"{tuple(y_init.shape)}"
                )
            dtype, device = y_init.dtype, y_init.device
            key = (
                self._use_time_parallel_trajectories(cp, y_init),
                dtype,
                device,
            )
            if key not in sub_solvers:
                sub_solvers[key] = build(*key)
            (
                fine_expand,
                fine_end,
                coarse_end,
                affine_sweep,
                coarse_whole_fn,
                coarse_steps_per_slice,
            ) = sub_solvers[key]
            t_0 = float(t_0)
            slice_starts = [t_0 + j * delta for j in range(n)]
            # per-slice start times, broadcasting against the slice batch
            # (fused kernels and affine maps ignore them: their problems
            # are autonomous)
            slice_times = torch.tensor(
                slice_starts, dtype=dtype, device=device
            ).reshape((n,) + (1,) * len(y_shape))

            # initial coarse sweep
            with tracing.span("parareal.coarse_sweep"):
                if affine_sweep is not None:
                    # corrections-free special case of the corrective
                    # sweep
                    y_borders, coarse_ends = affine_sweep(
                        0,
                        torch.cat(
                            [
                                y_init[None],
                                y_init.new_zeros((n,) + tuple(y_shape)),
                            ]
                        ),
                        y_init.new_zeros((n,) + tuple(y_shape)),
                    )
                else:
                    if coarse_whole_fn is not None:
                        coarse_ends = coarse_whole_fn(y_init, t_0)[
                            coarse_steps_per_slice - 1::
                            coarse_steps_per_slice
                        ]
                    else:
                        y = y_init
                        pieces = []
                        for j in range(n):
                            y = coarse_end(y, slice_starts[j])
                            pieces.append(y)
                        coarse_ends = torch.stack(pieces)
                    y_borders = torch.cat([y_init[None], coarse_ends])

            i = 0
            converged = False
            while i < iterations and not converged:
                with tracing.span("parareal.iteration", i=i):
                    # every slice's fine solve in one batched call
                    with tracing.span("parareal.fine_ends"):
                        fine_ends = fine_end(y_borders[:-1], slice_times)
                    with tracing.span("parareal.correction"):
                        corrections = fine_ends - coarse_ends
                        old_ends = y_borders[1:].clone()
                        if affine_sweep is not None:
                            # log-depth doubling scan instead of n
                            # dependent coarse solves
                            y_borders, coarse_ends = affine_sweep(
                                i, y_borders, corrections
                            )
                        else:
                            y_borders = y_borders.clone()
                            coarse_ends = coarse_ends.clone()
                            # slices before the iteration index are
                            # already exact; border i + 1 keeps the
                            # carried coarse end
                            for j in range(i, n):
                                if j > i:
                                    coarse_ends[j] = coarse_end(
                                        y_borders[j], slice_starts[j]
                                    )
                                y_borders[j + 1] = (
                                    coarse_ends[j] + corrections[j]
                                )
                    # the early exit is decided on the host
                    with tracing.span("parareal.termination"):
                        converged = bool(
                            termination(old_ends, y_borders[1:])
                        )
                i += 1
            self.last_iterations = i

            # materialize the fine trajectories once, from the FINAL
            # borders, in one batched call; then shift each onto its
            # corrected end border (the reference's final shift)
            with tracing.span("parareal.expand"):
                sub_y_fine = fine_expand(y_borders[:-1], slice_times)
                last = (slice(None), -1) + (slice(None),) * len(y_shape)
                shifts = y_borders[1:] - sub_y_fine[last]
                sub_y_fine = sub_y_fine + shifts[:, None]
                return sub_y_fine.reshape(
                    (n * fine_steps,) + tuple(y_shape)
                )

        return program


def _build_affine_sweep(affine_slice_map, n: int, dim: int, device):
    """The corrective coarse sweep over an affine coarse slice map as a
    Hillis-Steele doubling scan: the recurrence y_{j+1} = P y_j + (r +
    correction_j) takes ceil(log2(n)) dependent matmuls against the
    precomputed P^(2^l) instead of n dependent coarse solves. Returns
    None when the doubling powers would exceed 128 MiB (the JAX
    package's cap), in which case the sweep runs slice by slice."""
    from pararealml_tpu_torch.ops.linear_propagator import full_fp32_matmul

    pt_slice, r_slice = (t.to(device) for t in affine_slice_map)
    levels = (n - 1).bit_length()
    if (levels + 2) * dim * dim * pt_slice.element_size() > 128 * 2**20:
        return None
    pt_pows = [pt_slice]
    with full_fp32_matmul():
        for _ in range(levels - 1):
            pt_pows.append(torch.matmul(pt_pows[-1], pt_pows[-1]))

    def affine_sweep(i: int, y_borders, corrections):
        yb = y_borders.reshape(n + 1, dim)
        corr = corrections.reshape(n, dim)
        mask = (torch.arange(n, device=yb.device) >= i)[:, None]
        with full_fp32_matmul():
            # recurrence inputs: w_j = r + corr_j for j >= i (zero below i
            # decouples frozen borders), seeded with P y_i at j == i so
            # prefixes over [i, j] reproduce the sweep exactly
            w = torch.where(mask, r_slice + corr, 0.0)
            w[i] = w[i] + torch.matmul(yb[i], pt_slice)
            v = w
            for level, ptl in enumerate(pt_pows):
                shift = 1 << level
                shifted = torch.cat([v.new_zeros((shift, dim)), v[:-shift]])
                v = v + torch.matmul(shifted, ptl)
            # v[j] = y_{j+1} for j >= i; frozen borders keep their values,
            # and the carried coarse ends are re-derived from the
            # post-sweep borders with one batched matmul
            new_borders = torch.cat([yb[:1], torch.where(mask, v, yb[1:])])
            new_coarse_ends = (
                torch.matmul(new_borders[:-1], pt_slice) + r_slice
            )
        return (
            new_borders.reshape(y_borders.shape),
            new_coarse_ends.reshape(corrections.shape),
        )

    return affine_sweep
