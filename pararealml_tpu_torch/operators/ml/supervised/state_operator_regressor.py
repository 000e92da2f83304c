"""Closed-form ridge regression of the full state-transition operator.

Port of the JAX package's
``operators/ml/supervised/state_operator_regressor.py``: a ridge
least-squares fit of the affine map ``y_{t+d_t} = W y_t + w0`` over the
whole flattened state (:class:`StateOperatorRidgeRegressor`), and its
extension to nonlinear slice jumps, a full-rank linear term plus a
quadratic term in a POD-reduced subspace of the training states
(:class:`ReducedQuadraticStateOperatorRegressor`). Both are fitted in
float64 with numpy, exactly as in the JAX package, and both expose the
fitted step map to :class:`SupervisedMLOperator` as ``torch_step_map``
(the counterpart of ``jax_step_map``).

The models keep scikit-learn's ``fit``/``predict``/``score`` protocol and
the ``requires_state_blocks`` tag without a scikit-learn base class:
the port runs where scikit-learn is not installed.

Inference is plain ``torch.matmul`` in full float32
(:func:`pararealml_tpu_torch.ops.linear_propagator.full_fp32_matmul`), in
the state's dtype and on the state's device, with the trust-region clamp
and the gather-free outer product of the JAX package. These products lie
outside any kernel in the JAX package too (it leaves them to XLA). The
low-rank factoring of the operators (:meth:`_truncated_factors`) is
carried over with the same truncation and the same rounding of the rank
up to a multiple of 128, so that both packages compute the same
function; whether the factoring pays on the H100 is an open question
(ROADMAP.md).

:func:`from_arrays` builds a fitted model from the arrays a JAX model
holds after ``fit`` or ``load``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pararealml_tpu_torch.ops.linear_propagator import full_fp32_matmul


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


class _TensorCache:
    """Tensors of fitted numpy arrays, converted once per (device,
    dtype) a state arrives with."""

    def __init__(self):
        self._by_key: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def clear(self):
        self._by_key.clear()

    def get(self, arrays: Dict[str, Optional[np.ndarray]], like):
        key = (like.device, like.dtype)
        tensors = self._by_key.get(key)
        if tensors is None:
            tensors = {
                name: torch.tensor(array).to(
                    device=like.device, dtype=like.dtype
                )
                for name, array in arrays.items()
                if array is not None
            }
            self._by_key[key] = tensors
        return tensors


class StateOperatorRidgeRegressor:
    """Scikit-learn-protocol ridge regression of the affine state map.

    :param state_size: the flattened solution size (the number of
        leading feature columns carrying the state in the supervised
        input layout)
    :param alpha: the ridge regularization strength, scaled by the
        number of state samples at fit time
    :param dtype: the dtype of the fitted operator (its arrays are kept
        in the matching numpy dtype)
    """

    # SupervisedMLOperator.fit_model splits over whole state samples
    # instead of individual rows for models carrying this tag, keeping
    # the per-state row blocks this regressor reconstructs contiguous
    requires_state_blocks = True

    def __init__(
        self,
        state_size: int,
        alpha: float = 1e-7,
        dtype: torch.dtype = torch.float32,
    ):
        self.state_size = state_size
        self.alpha = alpha
        self.dtype = dtype
        self._weights: Optional[np.ndarray] = None
        self._intercept: Optional[np.ndarray] = None
        self._tensors = _TensorCache()

    @property
    def _np_dtype(self) -> np.dtype:
        return _numpy_dtype(self.dtype)

    # -- fitted-operator surface -------------------------------------------

    @property
    def state_map(self) -> Tuple[np.ndarray, np.ndarray]:
        """The fitted ``(W, w0)`` of ``y' = W y + w0`` over the
        flattened state."""
        if self._weights is None:
            raise ValueError("regressor is not fitted")
        return self._weights, self._intercept

    @state_map.setter
    def state_map(self, value: Tuple[np.ndarray, np.ndarray]):
        weights, intercept = value
        weights = np.asarray(weights, self._np_dtype)
        intercept = np.asarray(intercept, self._np_dtype)
        if weights.shape != (self.state_size, self.state_size):
            raise ValueError(
                f"weights must be {(self.state_size,) * 2}, got "
                f"{weights.shape}"
            )
        if intercept.shape != (self.state_size,):
            raise ValueError(
                f"intercept must be ({self.state_size},), got "
                f"{intercept.shape}"
            )
        self._weights = weights
        self._intercept = intercept
        self._tensors.clear()

    # -- layout handling ----------------------------------------------------

    def _to_state_pairs(
        self, x: np.ndarray, y: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Reconstructs ``(states, next_states)`` from the per-point
        supervised layout: rows arrive in blocks that share the same
        flattened state in the first ``state_size`` columns and carry
        one mesh point's target values each."""
        x = np.asarray(x)
        y = np.asarray(y)
        if x.ndim != 2 or x.shape[1] < self.state_size:
            raise ValueError(
                "inputs must be 2D with at least "
                f"{self.state_size} feature columns"
            )
        y = y.reshape(len(x), -1)
        y_dimension = y.shape[1]
        block = self.state_size // y_dimension
        if (
            block * y_dimension != self.state_size
            or len(x) % block != 0
        ):
            raise ValueError(
                "row count is not a whole number of state blocks"
            )
        states = x[::block, : self.state_size]
        next_states = y.reshape(-1, self.state_size)
        return states, next_states

    # -- scikit-learn protocol ----------------------------------------------

    def fit(
        self, x: np.ndarray, y: np.ndarray
    ) -> "StateOperatorRidgeRegressor":
        states, next_states = self._to_state_pairs(x, y)
        n_samples = len(states)
        design = np.concatenate(
            [states, np.ones((n_samples, 1))], axis=1
        ).astype(np.float64)
        targets = next_states.astype(np.float64)
        gram = design.T @ design
        gram[np.diag_indices_from(gram)] += self.alpha * n_samples
        solution = np.linalg.solve(gram, design.T @ targets)
        self.state_map = (solution[:-1].T, solution[-1])
        return self

    def _operator_arrays(self) -> Dict[str, Optional[np.ndarray]]:
        return {"weights": self._weights, "intercept": self._intercept}

    def _apply_states(self, states: torch.Tensor) -> torch.Tensor:
        """The fitted step map over a ``(..., state)`` batch, in the
        states' dtype and on their device."""
        self._check_fitted()
        c = self._tensors.get(self._operator_arrays(), states)
        with full_fp32_matmul():
            return torch.matmul(states, c["weights"].T) + c["intercept"]

    def _check_fitted(self) -> None:
        if self._weights is None:
            raise ValueError("regressor is not fitted")

    @property
    def torch_step_map(self):
        """``y_flat -> next_y_flat`` of the fitted operator over
        ``(..., state)`` tensors (the protocol
        :class:`SupervisedMLOperator` resolves for its trajectory and
        ends functions; the JAX package's ``jax_step_map``)."""
        self._check_fitted()

        def step(y_flat: torch.Tensor) -> torch.Tensor:
            return self._apply_states(y_flat)

        return step

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Per-row predictions for inputs in the supervised layout
        (each block of rows sharing a state yields that state's
        predicted next values, one mesh point per row), computed on the
        CPU in the model's dtype."""
        x = np.asarray(x)
        n_rows = len(x)
        # block size from the layout: every state column block repeats
        # for each of its mesh points; infer the per-state row count
        # from the first repetition boundary
        block = 1
        while block < n_rows and np.array_equal(
            x[block, : self.state_size], x[0, : self.state_size]
        ):
            block += 1
        if n_rows % block != 0:
            raise ValueError(
                "row count is not a whole number of state blocks"
            )
        states = torch.as_tensor(
            np.asarray(x[::block, : self.state_size], self._np_dtype)
        )
        predictions = self._apply_states(states)
        return predictions.numpy().reshape(n_rows, -1)

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        y = np.asarray(y).reshape(len(x), -1)
        predictions = self.predict(x)
        residual = float(np.sum((y - predictions) ** 2))
        total = float(np.sum((y - np.mean(y, axis=0)) ** 2))
        return 1.0 - residual / total if total else 1.0

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        from pararealml_tpu_torch.utils.checkpoint import save_pytree

        self._check_fitted()
        save_pytree(path, self._saved_arrays())

    def _saved_arrays(self) -> Dict[str, np.ndarray]:
        return {"weights": self._weights, "intercept": self._intercept}

    def load(self, path: str) -> None:
        from pararealml_tpu_torch.utils.checkpoint import load_pytree

        template = dict.fromkeys(self._saved_arrays_template())
        self._set_arrays(load_pytree(path, template))

    def _saved_arrays_template(self) -> Dict[str, tuple]:
        n = self.state_size
        return {"weights": (n, n), "intercept": (n,)}

    def _set_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        self.state_map = (arrays["weights"], arrays["intercept"])


class ReducedQuadraticStateOperatorRegressor(StateOperatorRidgeRegressor):
    """Closed-form ridge fit of a quadratic state-transition map.

    Models the slice jump as

    ``y' = A y + B q(z) + c,   z = (y - mean) V``

    where ``V`` is the ``(state, rank)`` POD basis of the centered
    training states and ``q(z)`` stacks the ``rank (rank + 1) / 2``
    upper-triangular entries of ``z z^T`` (the JAX package's model; see
    its docstring for the derivation).

    :param state_size: the flattened solution size
    :param rank: the POD subspace dimension carrying quadratic terms
    :param alpha: ridge strength, scaled by the sample count at fit
        time
    :param dtype: the dtype of the fitted operator
    :param trust_margin: how far past the training data's per-mode
        coefficient range the quadratic term keeps extrapolating before
        its inputs are clamped (1.0 = exactly the training range)
    """

    def __init__(
        self,
        state_size: int,
        rank: int = 24,
        alpha: float = 1e-9,
        dtype: torch.dtype = torch.float32,
        trust_margin: float = 1.5,
    ):
        super().__init__(state_size, alpha, dtype)
        self.rank = rank
        self.trust_margin = trust_margin
        self._quad_weights: Optional[np.ndarray] = None
        self._quad_weights_full: Optional[np.ndarray] = None
        self._basis: Optional[np.ndarray] = None
        self._mean: Optional[np.ndarray] = None
        self._z_low: Optional[np.ndarray] = None
        self._z_high: Optional[np.ndarray] = None
        self._weight_factors = None
        self._quad_factors = None

    def _check_fitted(self) -> None:
        if self._quad_weights is None:
            raise ValueError("regressor is not fitted")

    @property
    def _triu_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        return np.triu_indices(self.rank)

    def _quadratic_features(self, z: np.ndarray) -> np.ndarray:
        rows, cols = self._triu_indices
        return z[:, rows] * z[:, cols]

    def _expand_quad_weights(self) -> None:
        """Expands the fitted upper-triangular quadratic weights to the
        full ``(state, rank * rank)`` outer-product form used at
        inference, with off-diagonal weights split evenly between the
        two symmetric outer entries (one broadcast multiply instead of a
        gather at every apply)."""
        rows, cols = self._triu_indices
        weights = np.asarray(self._quad_weights, np.float64)
        full = np.zeros(
            (self.state_size, self.rank, self.rank), np.float64
        )
        off_diagonal = (rows != cols).astype(np.float64)
        split = weights * (1.0 - 0.5 * off_diagonal)
        full[:, rows, cols] = split
        full[:, cols, rows] = split
        self._quad_weights_full = full.reshape(
            self.state_size, self.rank * self.rank
        ).astype(self._np_dtype)

    def fit(
        self, x: np.ndarray, y: np.ndarray
    ) -> "ReducedQuadraticStateOperatorRegressor":
        states, next_states = self._to_state_pairs(x, y)
        states = states.astype(np.float64)
        targets = next_states.astype(np.float64)
        n_samples = len(states)

        mean = states.mean(axis=0)
        centered = states - mean
        # POD basis of the training manifold from the symmetric
        # eigenproblem of the state Gram matrix (as in the JAX package)
        gram_states = centered.T @ centered
        eigenvalues, eigenvectors = np.linalg.eigh(gram_states)
        order = np.argsort(eigenvalues)[::-1]
        spread = int(
            np.sum(eigenvalues > max(eigenvalues.max(), 0.0) * 1e-12)
        )
        if spread < self.rank:
            raise ValueError(
                f"rank ({self.rank}) exceeds the training sample "
                f"spread ({spread} modes); provide more data or "
                "lower the rank"
            )
        basis = eigenvectors[:, order[: self.rank]]

        z = centered @ basis
        design = np.concatenate(
            [
                states,
                self._quadratic_features(z),
                np.ones((n_samples, 1)),
            ],
            axis=1,
        )
        gram = design.T @ design
        gram[np.diag_indices_from(gram)] += self.alpha * n_samples
        solution = np.linalg.solve(gram, design.T @ targets)

        n = self.state_size
        n_quad = len(self._triu_indices[0])
        # trust region: the per-mode coefficient range the quadratic
        # term was fitted over, stretched by the margin around each
        # mode's midpoint
        z_min, z_max = z.min(axis=0), z.max(axis=0)
        z_mid = 0.5 * (z_min + z_max)
        z_half = 0.5 * (z_max - z_min) * self.trust_margin
        self._set_arrays(
            {
                "weights": solution[:n].T,
                "quad_weights": solution[n: n + n_quad].T,
                "intercept": solution[-1],
                "basis": basis,
                "mean": mean,
                "z_low": z_mid - z_half,
                "z_high": z_mid + z_half,
            }
        )
        return self

    @staticmethod
    def _truncated_factors(matrix, dtype, max_rel_error):
        """Low-rank SVD factors ``(right, left)`` of an operator matrix,
        or ``None`` when truncation at the tolerance saves nothing. The
        rank is the count of singular values above ``max_rel_error *
        sigma_0``, rounded up to a multiple of 128 as in the JAX package
        (its matrix unit's width), so both packages factor alike."""
        m64 = np.asarray(matrix, np.float64)
        u, sigma, vt = np.linalg.svd(m64, full_matrices=False)
        if sigma[0] == 0.0:
            return None
        r = int(np.sum(sigma > sigma[0] * max_rel_error))
        r = -(-max(1, r) // 128) * 128
        n_out, n_in = m64.shape
        if r * (n_out + n_in) >= n_out * n_in:
            return None
        right = vt[:r].T  # (n_in, r)
        left = u[:, :r] * sigma[:r]  # (n_out, r)
        return right.astype(dtype), left.astype(dtype)

    def _factor_operators(self, max_rel_error: float = 1e-6) -> None:
        self._weight_factors = self._truncated_factors(
            self._weights, self._np_dtype, max_rel_error
        )
        self._quad_factors = self._truncated_factors(
            self._quad_weights_full, self._np_dtype, max_rel_error
        )

    def _operator_arrays(self) -> Dict[str, Optional[np.ndarray]]:
        arrays = {
            "weights": self._weights,
            "quad_weights_full": self._quad_weights_full,
            "intercept": self._intercept,
            "basis": self._basis,
            "mean": self._mean,
            "z_low": self._z_low,
            "z_high": self._z_high,
        }
        for prefix, factors in (
            ("weight", self._weight_factors),
            ("quad", self._quad_factors),
        ):
            if factors is not None:
                arrays[f"{prefix}_right"], arrays[f"{prefix}_left"] = factors
        return arrays

    def _apply_states(self, states: torch.Tensor) -> torch.Tensor:
        self._check_fitted()
        c = self._tensors.get(self._operator_arrays(), states)
        with full_fp32_matmul():
            z = torch.matmul(states - c["mean"], c["basis"])
            z = torch.minimum(torch.maximum(z, c["z_low"]), c["z_high"])
            # gather-free quadratic features: the full outer product
            # (see _expand_quad_weights)
            quad = (z[..., :, None] * z[..., None, :]).reshape(
                *z.shape[:-1], self.rank * self.rank
            )
            if "weight_right" in c:
                linear = torch.matmul(
                    torch.matmul(states, c["weight_right"]),
                    c["weight_left"].T,
                )
            else:
                linear = torch.matmul(states, c["weights"].T)
            if "quad_right" in c:
                quadratic = torch.matmul(
                    torch.matmul(quad, c["quad_right"]), c["quad_left"].T
                )
            else:
                quadratic = torch.matmul(quad, c["quad_weights_full"].T)
            return linear + quadratic + c["intercept"]

    def _saved_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "weights": self._weights,
            "quad_weights": self._quad_weights,
            "intercept": self._intercept,
            "basis": self._basis,
            "mean": self._mean,
            "z_low": self._z_low,
            "z_high": self._z_high,
        }

    def _saved_arrays_template(self) -> Dict[str, tuple]:
        n, r = self.state_size, self.rank
        return {
            "weights": (n, n),
            "quad_weights": (n, len(self._triu_indices[0])),
            "intercept": (n,),
            "basis": (n, r),
            "mean": (n,),
            "z_low": (r,),
            "z_high": (r,),
        }

    def _set_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """Takes the seven fitted arrays (the saved form), checks their
        shapes, and derives the inference form: the expanded quadratic
        weights and the low-rank factors."""
        dtype = self._np_dtype
        for name, shape in self._saved_arrays_template().items():
            array = np.asarray(arrays[name], dtype)
            if array.shape != shape:
                raise ValueError(
                    f"{name} must have shape {shape}, got {array.shape}"
                )
            setattr(self, f"_{name}", array)
        self._tensors.clear()
        self._expand_quad_weights()
        self._factor_operators()


def from_arrays(
    arrays: Dict[str, np.ndarray], dtype: torch.dtype = torch.float32
) -> StateOperatorRidgeRegressor:
    """The port's fitted regressor from the arrays a JAX regressor holds
    after ``fit`` or ``load`` (the names it saves): ``weights`` and
    ``intercept`` for :class:`StateOperatorRidgeRegressor`, plus
    ``quad_weights``, ``basis``, ``mean``, ``z_low`` and ``z_high`` for
    :class:`ReducedQuadraticStateOperatorRegressor` (whose expanded
    weights and factors are derived as in the JAX package)."""
    state_size = int(np.shape(arrays["weights"])[0])
    if "basis" in arrays:
        model = ReducedQuadraticStateOperatorRegressor(
            state_size,
            rank=int(np.shape(arrays["basis"])[1]),
            dtype=dtype,
        )
    else:
        model = StateOperatorRidgeRegressor(state_size, dtype=dtype)
    model._set_arrays(arrays)
    return model
