"""Supervised operator learning.

Port of the JAX package's
``operators/ml/supervised/supervised_ml_operator.py``: an operator that
learns solution jumps of size ``d_t`` from an oracle solver, with
auto-regressive, time-variant and input-d_t modes, perturbation-based
data generation (including ``isolate_perturbations`` and
``repeat_on_error``), model fitting over a random split, and
auto-regressive roll-out inference.

Ported for models that expose the fitted step map as ``torch_step_map``
(:class:`StateOperatorRidgeRegressor`,
:class:`ReducedQuadraticStateOperatorRegressor`); their roll-outs are
tensor functions, so the operator composes inside Parareal as its coarse
operator. As in the JAX package, a model that is affine in the state
passes the linear propagator's probe under ``time_parallel`` and turns
Parareal's coarse sweeps into doubling scans; the quadratic model fails
the probe and rolls out.

Data generation batches the perturbed oracle solves of all iterations
along a leading tensor axis (one batched oracle call per time step, or
one overall). The port's fused kernels take a batch, so the oracle's
fused trajectory kernel runs the batch where it applies (the JAX package
asks its oracle for the generic path here, because ``vmap`` cannot
transform its Pallas kernel).

Not ported yet: the ``SKLearnJaxRegressor``/DeepONet models and the
``train_test_split`` branch for models without state blocks (ROADMAP.md,
Queue 1, slice 3), and the ``device_mesh`` fan-out (slice 7).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.initial_condition import DiscreteInitialCondition
from pararealml_tpu_torch.initial_value_problem import InitialValueProblem
from pararealml_tpu_torch.operator import (
    Operator,
    TorchOperator,
    discretize_time_domain,
    materialize_solution,
)
from pararealml_tpu_torch.solution import Solution
from pararealml_tpu_torch.utils import tracing


def _not_ported(feature: str, where: str = "slice 3") -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to PyTorch yet (ROADMAP.md, Queue 1, "
        f"{where})"
    )


def mean_squared_error(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """The mean of the squared errors over all entries (scikit-learn's
    default ``mean_squared_error`` for equally sized outputs)."""
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64).reshape(y_true.shape)
    return float(np.mean((y_true - y_pred) ** 2))


class SupervisedMLOperator(TorchOperator):
    """An operator that learns to map the state at ``t`` to the state at
    ``t + d_t`` from data generated by a high-fidelity oracle."""

    def __init__(
        self,
        d_t: float,
        vertex_oriented: bool,
        auto_regressive: bool = True,
        time_variant: bool = False,
        input_d_t: bool = False,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        """
        :param d_t: the step the model learns
        :param vertex_oriented: whether states are taken at mesh
            vertices or cell centers
        :param auto_regressive: whether inference feeds predictions back
            as inputs
        :param time_variant: whether the time value is a model input
        :param input_d_t: whether the operator step size is a model
            input
        :param device: the device :meth:`solve` runs on (the CUDA card
            when None)
        :param dtype: the state's floating-point type (torch's default
            dtype when None); generated data is stored in it
        """
        if not auto_regressive and not time_variant:
            raise ValueError(
                "operator must be time variant if auto-regression is "
                "disabled"
            )
        if time_variant and input_d_t:
            raise ValueError(
                "operator must be time invariant to use d_t as an input"
            )
        super().__init__(d_t, vertex_oriented, device=device, dtype=dtype)
        self._auto_regressive = auto_regressive
        self._time_variant = time_variant
        self._input_d_t = input_d_t
        self._model: Optional[Any] = None

    @property
    def auto_regressive(self) -> bool:
        """Whether inference feeds predictions back as inputs."""
        return self._auto_regressive

    @property
    def time_variant(self) -> bool:
        """Whether the time value is a model input."""
        return self._time_variant

    @property
    def input_d_t(self) -> bool:
        """Whether the operator step size is a model input."""
        return self._input_d_t

    @property
    def model(self) -> Optional[Any]:
        """The regression model behind the operator."""
        return self._model

    @model.setter
    def model(self, model: Optional[Any]):
        self._model = model

    # -- inference ---------------------------------------------------------

    def solve(
        self, ivp: InitialValueProblem, parallel_enabled: bool = True
    ) -> Solution:
        if self._model is None:
            raise ValueError("operator has no model")
        with tracing.span("supervised_ml.solve"):
            cp = ivp.constrained_problem
            t = discretize_time_domain(ivp.t_interval, self._d_t)
            trajectory, _ = self.trajectory_function(cp, ivp.t_interval)
            with tracing.span("solve.initial_state"):
                y_0 = torch.as_tensor(
                    ivp.initial_condition.discrete_y_0(
                        self._vertex_oriented
                    ),
                    dtype=self.dtype,
                    device=self.device,
                )
            with tracing.span("solve.trajectory"):
                ys = trajectory(y_0, float(t[0]))
            return materialize_solution(
                ivp,
                t[1:],
                ys,
                vertex_oriented=self._vertex_oriented,
                d_t=self._d_t,
            )

    def _build_apply_model(self, cp):
        """Resolves the per-step model application ``apply_model(y_flat,
        t_value) -> prediction`` over ``(..., state)`` tensors (the
        model's own ``torch_step_map``) plus the discrete solution
        shape."""
        step_map = getattr(self._model, "torch_step_map", None)
        if step_map is None:
            raise _not_ported(
                "a model without torch_step_map (SKLearnJaxRegressor, "
                "DeepONet)"
            )
        y_shape = tuple(cp.y_shape(self._vertex_oriented))

        def apply_model(y_flat, t_value):
            return step_map(y_flat)

        return apply_model, y_shape

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
        """The model's roll-out over the time grid as ``(y_0, t_0) ->
        ys`` (leading batch axes map elementwise, so ``batch`` is
        ignored). Under ``time_parallel``, a model that is affine in the
        state becomes the linear propagator (tagged with its
        ``end_function`` and ``affine_slice_map``); a nonlinear one fails
        the probe and rolls out."""
        apply_model, y_shape = self._build_apply_model(cp)
        t = discretize_time_domain(t_interval, self._d_t)
        t_offsets = [float(offset) for offset in t[1:] - t[0]]
        auto_regressive = self._auto_regressive
        time_variant = self._time_variant
        d_t = self._d_t
        dim = int(np.prod(y_shape))

        if time_parallel and auto_regressive and not time_variant:
            from pararealml_tpu_torch.ops.linear_propagator import (
                _MAX_DIM,
                build_linear_propagator_trajectory,
            )

            if dim <= _MAX_DIM:

                def affine_probe_step(y, i, t_value):
                    lead = tuple(y.shape[: y.ndim - len(y_shape)])
                    prediction = apply_model(y.reshape(lead + (dim,)), d_t)
                    return prediction.reshape(y.shape)

                try:
                    trajectory = build_linear_propagator_trajectory(
                        cp,
                        affine_probe_step,
                        len(t) - 1,
                        y_shape,
                        dtype=self.dtype if dtype is None else dtype,
                        device=self.device if device is None else device,
                    )
                    return trajectory, t[1:]
                except ValueError:
                    pass  # not affine in the state: roll out

        def trajectory(y_0, t_0):
            lead = tuple(y_0.shape[: y_0.ndim - len(y_shape)])
            carry = y_0.reshape(lead + (dim,))
            ys = y_0.new_empty(lead + (len(t_offsets),) + y_shape)
            for k, t_offset in enumerate(t_offsets):
                t_value = t_0 + t_offset if time_variant else d_t
                prediction = apply_model(carry, t_value)
                ys[(Ellipsis, k) + (slice(None),) * len(y_shape)] = (
                    prediction.reshape(lead + y_shape)
                )
                if auto_regressive:
                    carry = prediction
            return ys

        trajectory.vmappable = True
        trajectory.fused = False
        return trajectory, t[1:]

    def ends_function(
        self,
        cp,
        t_interval,
        allow_fused: bool = True,
        batch: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        """The carry-only counterpart of :meth:`trajectory_function`:
        ``fn(y_0, t_0) -> y_end`` without stacking per-step predictions
        (Parareal's coarse sweeps consume only slice end states).
        ``batch`` is accepted for interface parity and ignored: the
        function takes any leading batch axes."""
        apply_model, y_shape = self._build_apply_model(cp)
        t = discretize_time_domain(t_interval, self._d_t)
        t_offsets = [float(offset) for offset in t[1:] - t[0]]
        auto_regressive = self._auto_regressive
        time_variant = self._time_variant
        d_t = self._d_t
        dim = int(np.prod(y_shape))

        def ends(y_0, t_0):
            lead = tuple(y_0.shape[: y_0.ndim - len(y_shape)])
            carry = y_0.reshape(lead + (dim,))
            if not auto_regressive:
                # no prediction feedback: the end state is the final
                # step's prediction, one model application
                t_value = t_0 + t_offsets[-1] if time_variant else d_t
                return apply_model(carry, t_value).reshape(y_0.shape)
            for t_offset in t_offsets:
                t_value = t_0 + t_offset if time_variant else d_t
                carry = apply_model(carry, t_value)
            return carry.reshape(y_0.shape)

        ends.vmappable = True
        ends.fused = False
        ends.batched = False
        return ends

    # -- data generation ---------------------------------------------------

    def generate_data(
        self,
        ivp: InitialValueProblem,
        oracle: Operator,
        iterations: int,
        perturbation_function: Callable[[float, np.ndarray], np.ndarray],
        isolate_perturbations: bool = False,
        repeat_on_error: bool = False,
        n_jobs: int = 1,
        seeds: Optional[Sequence[int]] = None,
        device_mesh=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Generates (inputs, targets) pairs by solving perturbed sub-IVPs
        with the oracle.

        ``n_jobs``/``seeds`` exist for API compatibility (``seeds[0]``
        seeds NumPy if provided): batching over iterations on the device
        replaces process parallelism. The inputs and targets are in the
        operator's dtype."""
        if iterations <= 0:
            raise ValueError("number of iterations must be greater than 0")
        if n_jobs < 1:
            raise ValueError("number of jobs must be greater than 0")
        if device_mesh is not None:
            raise _not_ported("data generation over a device mesh", "slice 7")
        if seeds is not None:
            if len(seeds) != n_jobs:
                raise ValueError(
                    f"number of seeds ({len(seeds)}) must match number "
                    f"of jobs ({n_jobs})"
                )
            np.random.seed(seeds[0])

        if self._can_batch_on_device(ivp, oracle, repeat_on_error):
            return self._generate_data_batched(
                ivp,
                oracle,
                iterations,
                perturbation_function,
                isolate_perturbations,
            )
        return self._generate_data_sequential(
            ivp,
            oracle,
            iterations,
            perturbation_function,
            isolate_perturbations,
            repeat_on_error,
        )

    def fit_model(
        self,
        model: Any,
        data: Tuple[np.ndarray, np.ndarray],
        test_size: float = 0.2,
        score_func: Callable[
            [np.ndarray, np.ndarray], float
        ] = mean_squared_error,
    ) -> Tuple[float, Optional[float]]:
        """Fits the model to a random training split of the data, stores
        it, and returns the training and test scores.

        Models tagged ``requires_state_blocks`` consume whole per-state
        row blocks, so the split is drawn over state samples instead of
        individual rows, keeping every block contiguous."""
        if getattr(model, "requires_state_blocks", False):
            y_rows = np.asarray(data[1]).reshape(len(data[0]), -1)
            block = model.state_size // y_rows.shape[1]
            n_samples = len(data[0]) // block
            samples = np.random.permutation(n_samples)
            n_test = round(n_samples * test_size)
            test_samples = samples[:n_test]
            train_samples = samples[n_test:]

            def gather(sample_indices):
                rows = (
                    sample_indices[:, np.newaxis] * block
                    + np.arange(block)
                ).ravel()
                return data[0][rows], data[1][rows]

            x_train, y_train = gather(train_samples)
            x_test, y_test = (
                gather(test_samples) if n_test else (None, None)
            )
        elif test_size:
            raise _not_ported(
                "a row-wise train/test split (scikit-learn's "
                "train_test_split) for models without state blocks"
            )
        else:
            shuffled = np.random.permutation(len(data[0]))
            x_train, y_train = data[0][shuffled], data[1][shuffled]
            x_test = y_test = None

        model.fit(x_train, y_train)
        self._model = model

        train_score = score_func(y_train, model.predict(x_train))
        test_score = (
            score_func(y_test, model.predict(x_test))
            if test_size
            else None
        )
        return train_score, test_score

    def train(
        self,
        ivp: InitialValueProblem,
        oracle: Operator,
        model: Any,
        iterations: int,
        perturbation_function: Callable[[float, np.ndarray], np.ndarray],
        isolate_perturbations: bool = False,
        repeat_on_error: bool = False,
        n_jobs: int = 1,
        seeds: Optional[Sequence[int]] = None,
        test_size: float = 0.2,
        score_func: Callable[
            [np.ndarray, np.ndarray], float
        ] = mean_squared_error,
        device_mesh=None,
    ) -> Tuple[float, Optional[float]]:
        """Generates oracle data and fits the model to it."""
        data = self.generate_data(
            ivp,
            oracle,
            iterations,
            perturbation_function,
            isolate_perturbations=isolate_perturbations,
            repeat_on_error=repeat_on_error,
            n_jobs=n_jobs,
            seeds=seeds,
            device_mesh=device_mesh,
        )
        return self.fit_model(
            model, data, test_size=test_size, score_func=score_func
        )

    # -- internals ---------------------------------------------------------

    def _create_input_placeholder(
        self, cp: ConstrainedProblem
    ) -> np.ndarray:
        """Creates the model input array layout: flattened state features,
        an optional t (or d_t) column, and for PDEs the coordinates of
        each mesh point (one row per point), in the operator's dtype."""
        diff_eq = cp.differential_equation
        time_feature = int(self._time_variant or self._input_d_t)
        dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        if not diff_eq.x_dimension:
            return np.empty(
                (1, diff_eq.y_dimension + time_feature), dtype
            )

        x = cp.mesh.all_index_coordinates(
            self._vertex_oriented, flatten=True
        )
        x = np.asarray(x)
        y_features = np.empty(
            (len(x), diff_eq.y_dimension * len(x)), dtype
        )
        columns = [y_features]
        if time_feature:
            columns.append(np.empty((len(x), 1), dtype))
        columns.append(x.astype(dtype))
        return np.hstack(columns)

    def _apply_static_constraints(self, cp, y: np.ndarray) -> np.ndarray:
        if (
            self._vertex_oriented
            and cp.static_y_vertex_constraints is not None
        ):
            return np.asarray(
                cp.static_y_vertex_constraints.apply(torch.as_tensor(y))
            )
        return y

    def _can_batch_on_device(
        self, ivp: InitialValueProblem, oracle: Operator, repeat: bool
    ) -> bool:
        cp = ivp.constrained_problem
        return (
            isinstance(oracle, TorchOperator)
            and not repeat
            and (
                not cp.differential_equation.x_dimension
                or (
                    cp.are_all_boundary_conditions_static
                    and oracle.vertex_oriented == self._vertex_oriented
                )
            )
        )

    def _record_rows(
        self,
        inputs: np.ndarray,
        targets: np.ndarray,
        row_offset: int,
        n_points: int,
        y_start: np.ndarray,
        y_end: np.ndarray,
        t_value: Optional[float],
        x_dim: int,
        y_dim: int,
    ):
        block = slice(row_offset, row_offset + n_points)
        n_y_features = (
            inputs.shape[1]
            - x_dim
            - (self._time_variant or self._input_d_t)
        )
        inputs[block, :n_y_features] = y_start.reshape((1, -1))
        if t_value is not None:
            inputs[block, n_y_features] = t_value
        targets[block] = y_end.reshape((-1, y_dim))

    def _generate_data_sequential(
        self,
        ivp: InitialValueProblem,
        oracle: Operator,
        iterations: int,
        perturbation_function,
        isolate_perturbations: bool,
        repeat_on_error: bool,
    ) -> Tuple[np.ndarray, np.ndarray]:
        cp = ivp.constrained_problem
        diff_eq = cp.differential_equation
        x_dim, y_dim = diff_eq.x_dimension, diff_eq.y_dimension

        t = discretize_time_domain(ivp.t_interval, self._d_t)
        y_0 = ivp.initial_condition.discrete_y_0(self._vertex_oriented)

        unperturbed_states = None
        if self._auto_regressive and isolate_perturbations and len(t) > 2:
            unperturbed = self._perturb_and_solve(
                InitialValueProblem(
                    cp, (t[0], t[-2]), ivp.initial_condition
                ),
                lambda _, y: y,
                oracle,
                False,
            ).discrete_y(self._vertex_oriented)
            step_indices = (
                np.rint((t[1:-1] - t[0]) / oracle.d_t).astype(int) - 1
            )
            unperturbed_states = unperturbed[step_indices]

        placeholder = self._create_input_placeholder(cp)
        n_points = placeholder.shape[0]
        n_steps = len(t) - 1
        inputs = np.tile(placeholder, (iterations * n_steps, 1))
        targets = np.empty((len(inputs), y_dim), inputs.dtype)

        for iteration in range(iterations):
            offset = iteration * n_points * n_steps
            if self._auto_regressive:
                y_i = y_0
                for i, t_i in enumerate(t[:-1]):
                    solution = self._perturb_and_solve(
                        InitialValueProblem(
                            cp,
                            (t_i, t_i + self._d_t),
                            DiscreteInitialCondition(
                                cp, y_i, self._vertex_oriented
                            ),
                        ),
                        perturbation_function,
                        oracle,
                        repeat_on_error,
                    )
                    sub_ivp = solution.initial_value_problem
                    perturbed_start = (
                        sub_ivp.initial_condition.discrete_y_0(
                            self._vertex_oriented
                        )
                    )
                    perturbed_end = solution.discrete_y(
                        self._vertex_oriented
                    )[-1]
                    self._record_rows(
                        inputs,
                        targets,
                        offset + i * n_points,
                        n_points,
                        perturbed_start,
                        perturbed_end,
                        t[i + 1]
                        if self._time_variant
                        else (self._d_t if self._input_d_t else None),
                        x_dim,
                        y_dim,
                    )
                    y_i = (
                        unperturbed_states[i]
                        if isolate_perturbations and i < n_steps - 1
                        else perturbed_end
                    )
            else:
                solution = self._perturb_and_solve(
                    ivp, perturbation_function, oracle, repeat_on_error
                )
                perturbed_ivp = solution.initial_value_problem
                perturbed_y_0 = (
                    perturbed_ivp.initial_condition.discrete_y_0(
                        self._vertex_oriented
                    )
                )
                trajectory = solution.discrete_y(self._vertex_oriented)
                step_indices = (
                    np.rint((t[1:] - t[0]) / oracle.d_t).astype(int) - 1
                )
                states = trajectory[step_indices]
                for i in range(n_steps):
                    self._record_rows(
                        inputs,
                        targets,
                        offset + i * n_points,
                        n_points,
                        perturbed_y_0,
                        states[i],
                        t[i + 1] if self._time_variant else None,
                        x_dim,
                        y_dim,
                    )

        return inputs, targets

    def _generate_data_batched(
        self,
        ivp: InitialValueProblem,
        oracle: TorchOperator,
        iterations: int,
        perturbation_function,
        isolate_perturbations: bool,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batches the oracle solves of all iterations along a leading
        axis: host-side perturbation, then one batched oracle call per
        time step (auto-regressive) or one overall (otherwise), in the
        oracle's dtype and on its device."""
        cp = ivp.constrained_problem
        diff_eq = cp.differential_equation
        x_dim, y_dim = diff_eq.x_dimension, diff_eq.y_dimension
        oracle_dtype, oracle_device = oracle.dtype, oracle.device

        t = discretize_time_domain(ivp.t_interval, self._d_t)
        n_steps = len(t) - 1
        y_0 = ivp.initial_condition.discrete_y_0(self._vertex_oriented)

        placeholder = self._create_input_placeholder(cp)
        n_points = placeholder.shape[0]
        inputs = np.tile(placeholder, (iterations * n_steps, 1))
        targets = np.empty((len(inputs), y_dim), inputs.dtype)

        def perturb_batch(t_value, states):
            perturbed = []
            for state in states:
                perturbed_state = perturbation_function(t_value, state)
                if perturbed_state.shape != state.shape:
                    raise ValueError(
                        f"perturbed y shape {perturbed_state.shape} "
                        f"must match input y shape {state.shape}"
                    )
                perturbed.append(
                    self._apply_static_constraints(cp, perturbed_state)
                )
            return np.stack(perturbed)

        def oracle_function(t_interval):
            fn, _ = oracle.trajectory_function(
                cp,
                t_interval,
                dtype=oracle_dtype,
                device=oracle_device,
            )
            if not getattr(fn, "vmappable", False):
                raise RuntimeError(
                    "the oracle's trajectory function takes no leading "
                    "batch axes"
                )
            return fn

        def on_device(states):
            return torch.as_tensor(
                states, dtype=oracle_dtype, device=oracle_device
            )

        def to_host(states):
            return states.to(torch.float64).cpu().numpy()

        if self._auto_regressive:
            # one batched oracle solve per step; the trajectory's time
            # axis follows the batch axis
            step_fn = oracle_function((t[0], t[0] + self._d_t))
            unperturbed_states = None
            if isolate_perturbations:
                unperturbed_states = [np.asarray(y_0)]
                for i in range(n_steps - 1):
                    unperturbed_states.append(
                        to_host(
                            step_fn(
                                on_device(unperturbed_states[-1]),
                                float(t[i]),
                            )[-1]
                        )
                    )

            states = np.tile(
                y_0[np.newaxis], (iterations,) + (1,) * y_0.ndim
            )
            for i in range(n_steps):
                perturbed = perturb_batch(t[i], states)
                ends = to_host(
                    step_fn(on_device(perturbed), float(t[i]))[:, -1]
                )
                for iteration in range(iterations):
                    self._record_rows(
                        inputs,
                        targets,
                        (iteration * n_steps + i) * n_points,
                        n_points,
                        perturbed[iteration],
                        ends[iteration],
                        t[i + 1]
                        if self._time_variant
                        else (self._d_t if self._input_d_t else None),
                        x_dim,
                        y_dim,
                    )
                if isolate_perturbations and i < n_steps - 1:
                    states = np.tile(
                        unperturbed_states[i + 1][np.newaxis],
                        (iterations,) + (1,) * y_0.ndim,
                    )
                else:
                    states = ends
        else:
            trajectory_fn = oracle_function((t[0], t[-1]))
            perturbed = perturb_batch(t[0], [y_0] * iterations)
            trajectories = to_host(
                trajectory_fn(on_device(perturbed), float(t[0]))
            )
            step_indices = (
                np.rint((t[1:] - t[0]) / oracle.d_t).astype(int) - 1
            )
            for iteration in range(iterations):
                states = trajectories[iteration][step_indices]
                for i in range(n_steps):
                    self._record_rows(
                        inputs,
                        targets,
                        (iteration * n_steps + i) * n_points,
                        n_points,
                        perturbed[iteration],
                        states[i],
                        t[i + 1] if self._time_variant else None,
                        x_dim,
                        y_dim,
                    )

        return inputs, targets

    def _perturb_and_solve(
        self,
        ivp: InitialValueProblem,
        perturbation_function,
        oracle: Operator,
        repeat_on_error: bool,
    ) -> Solution:
        while True:
            y_0 = ivp.initial_condition.discrete_y_0(
                self._vertex_oriented
            )
            perturbed_y_0 = perturbation_function(
                ivp.t_interval[0], y_0
            )
            if perturbed_y_0.shape != y_0.shape:
                raise ValueError(
                    f"perturbed y shape {perturbed_y_0.shape} must "
                    f"match input y shape {y_0.shape}"
                )
            perturbed_ivp = InitialValueProblem(
                ivp.constrained_problem,
                ivp.t_interval,
                DiscreteInitialCondition(
                    ivp.constrained_problem,
                    perturbed_y_0,
                    self._vertex_oriented,
                ),
            )
            try:
                return oracle.solve(perturbed_ivp)
            except Exception as exception:
                if repeat_on_error:
                    warnings.warn(
                        "Failed to solve IVP with perturbed initial "
                        f"conditions; {str(exception)}"
                    )
                    continue
                raise
