"""The port's state-operator regressors and supervised-ML operator held
against the JAX package: the float64 fits to 1e-10 of each array's
largest entry (the same numpy computation in both packages), the fitted
step maps on states partly outside the trust region (float32 to 1e-5,
float64 to 1e-12, relative: the two frameworks' matmuls sum in other
orders), ``from_arrays`` on the committed rank-32 Burgers model, and the
operator's roll-outs, data generation and train/test split on a 9 x 9
Burgers problem in float64 (1e-10)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from pararealml_tpu.operators.fdm import FDMOperator as JaxFDMOperator
from pararealml_tpu.operators.fdm import RK4 as JaxRK4
from pararealml_tpu.operators.fdm import (
    ThreePointCentralDifferenceMethod as JaxThreePoint,
)
from pararealml_tpu.operators.ml import supervised as jax_supervised
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.ml import supervised
from pararealml_tpu_torch.utils import load_pytree
from tests.test_torch_cuda import QUAD_ASSET, burgers_problem

torch.set_num_threads(1)

FIT_RTOL = 1e-10
ARRAY_NAMES = (
    "weights",
    "quad_weights",
    "intercept",
    "basis",
    "mean",
    "z_low",
    "z_high",
)
# the small Burgers problem of the operator tests: a 9 x 9 grid, the
# coarse step spanning 40 fine steps of 2.5e-3
SML_D_T = 0.1
FINE_D_T = 2.5e-3


def _assert_close(actual, expected, rtol):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    scale = max(float(np.abs(expected).max()), 1e-300)
    assert float(np.abs(actual - expected).max()) <= rtol * scale


def _quadratic_layout_data(seed=0, state_size=12, n_points=6, samples=60):
    """Synthetic data of a quadratic map in the supervised per-point
    layout: every sample gives ``n_points`` rows sharing its state."""
    rng = np.random.default_rng(seed)
    states = rng.standard_normal((samples, state_size))
    w = 0.3 * rng.standard_normal((state_size, state_size))
    next_states = states @ w.T + 0.1 * (states**2) @ w + 0.5
    coords = rng.standard_normal((n_points, 2))
    x = np.concatenate(
        [np.repeat(states, n_points, axis=0), np.tile(coords, (samples, 1))],
        axis=1,
    )
    return x, next_states.reshape(samples * n_points, -1)


def _jax_arrays(model):
    return {
        name: np.asarray(getattr(model, f"_{name}")) for name in ARRAY_NAMES
    }


def test_quadratic_fit_matches_jax():
    x, y = _quadratic_layout_data()
    expected = jax_supervised.ReducedQuadraticStateOperatorRegressor(
        12, rank=5, dtype=jnp.float64
    ).fit(x, y)
    actual = supervised.ReducedQuadraticStateOperatorRegressor(
        12, rank=5, dtype=torch.float64
    ).fit(x, y)
    for name, value in _jax_arrays(expected).items():
        _assert_close(getattr(actual, f"_{name}"), value, FIT_RTOL)
    _assert_close(
        actual._quad_weights_full, expected._quad_weights_full, FIT_RTOL
    )
    assert actual.score(x, y) == pytest.approx(expected.score(x, y), 1e-10)
    with pytest.raises(ValueError, match="spread"):
        supervised.ReducedQuadraticStateOperatorRegressor(12, rank=50).fit(
            x, y
        )


def test_ridge_fit_and_predict_match_jax():
    x, y = _quadratic_layout_data(seed=1)
    expected = jax_supervised.StateOperatorRidgeRegressor(
        12, dtype=jnp.float64
    ).fit(x, y)
    actual = supervised.StateOperatorRidgeRegressor(
        12, dtype=torch.float64
    ).fit(x, y)
    for actual_part, expected_part in zip(
        actual.state_map, expected.state_map
    ):
        _assert_close(actual_part, expected_part, FIT_RTOL)
    _assert_close(actual.predict(x[:12]), expected.predict(x[:12]), 1e-12)


@pytest.mark.parametrize(
    "dtype, rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)]
)
def test_step_map_matches_jax(dtype, rtol):
    x, y = _quadratic_layout_data(seed=2)
    jax_dtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    jax_model = jax_supervised.ReducedQuadraticStateOperatorRegressor(
        12, rank=5, dtype=jax_dtype
    ).fit(x, y)
    model = supervised.from_arrays(_jax_arrays(jax_model), dtype=dtype)
    states = np.random.default_rng(3).standard_normal((8, 12))
    # half the states far outside the training range engage the clamp
    states[4:] *= 6.0
    z = (states - np.asarray(jax_model._mean)) @ np.asarray(jax_model._basis)
    assert np.any(z > np.asarray(jax_model._z_high))
    assert np.all(z[:4] < 10.0 * np.abs(np.asarray(jax_model._z_high)))
    expected = jax.vmap(jax_model.jax_step_map)(jnp.asarray(states, jax_dtype))
    actual = model.torch_step_map(torch.as_tensor(states, dtype=dtype))
    assert actual.dtype == dtype
    _assert_close(actual.numpy(), expected, rtol)


def test_from_arrays_reproduces_the_committed_model():
    """The rank-32 Burgers coarse model loaded by the JAX package and
    carried across as arrays: the same factors and the same map (float32,
    1e-5 relative)."""
    # both packages factor the 882-wide operators with an SVD; one BLAS
    # thread keeps it from oversubscribing a host shared by test workers
    with threadpool_limits(limits=1):
        jax_model = jax_supervised.ReducedQuadraticStateOperatorRegressor(
            882, rank=32
        )
        jax_model.load(QUAD_ASSET)
        model = supervised.from_arrays(_jax_arrays(jax_model))
    assert model.rank == 32 and model.state_size == 882
    for ours, theirs in (
        (model._weight_factors, jax_model._weight_factors),
        (model._quad_factors, jax_model._quad_factors),
    ):
        assert (ours is None) == (theirs is None)
        if ours is not None:
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, np.asarray(b))
    for name, value in load_pytree(QUAD_ASSET).items():
        np.testing.assert_array_equal(getattr(model, f"_{name}"), value)

    y_0 = burgers_problem(vars(torch_pkg)).initial_condition.discrete_y_0(
        True
    )
    rng = np.random.default_rng(4)
    states = (
        y_0.reshape(1, -1) * rng.uniform(0.8, 1.2, (6, 1))
    ).astype(np.float32)
    expected = jax.vmap(jax_model.jax_step_map)(jnp.asarray(states))
    actual = model.torch_step_map(torch.as_tensor(states))
    _assert_close(actual.numpy(), expected, 1e-5)


# -- the operator ----------------------------------------------------------


def _perturbation(t, y):
    return y * np.random.uniform(0.9, 1.1, size=y.shape)


def _generate(module, sml, oracle, iterations=2, t_end=3 * SML_D_T):
    ivp = burgers_problem(vars(module), extent=2.0, t_end=t_end)
    np.random.seed(7)
    return sml.generate_data(ivp, oracle, iterations, _perturbation)


@functools.lru_cache(maxsize=None)
def fitted_quad_arrays():
    """A rank-6 quadratic coarse model of the 9 x 9 Burgers problem for
    slices of 0.2, fitted in float64 on the port's oracle data (6
    perturbed runs to T = 0.8); its arrays feed both packages."""
    sml = supervised.SupervisedMLOperator(
        0.2, True, device="cpu", dtype=torch.float64
    )
    oracle = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        FINE_D_T,
        device="cpu",
        dtype=torch.float64,
    )
    data = _generate(torch_pkg, sml, oracle, iterations=6, t_end=0.8)
    model = supervised.ReducedQuadraticStateOperatorRegressor(
        162, rank=6, dtype=torch.float64
    )
    sml.fit_model(model, data)
    return model._saved_arrays()


def _operators(d_t=SML_D_T):
    arrays = fitted_quad_arrays()
    model = supervised.from_arrays(arrays, dtype=torch.float64)
    torch_sml = supervised.SupervisedMLOperator(
        d_t, True, device="cpu", dtype=torch.float64
    )
    torch_sml.model = model
    jax_model = jax_supervised.ReducedQuadraticStateOperatorRegressor(
        162, rank=6, dtype=jnp.float64
    )
    for name, value in arrays.items():
        setattr(jax_model, f"_{name}", jnp.asarray(value))
    jax_model._expand_quad_weights()
    jax_model._factor_operators()
    jax_sml = jax_supervised.SupervisedMLOperator(d_t, True)
    jax_sml.model = jax_model
    return torch_sml, jax_sml


def test_operator_roll_outs_match_jax():
    torch_sml, jax_sml = _operators()
    ivps = [
        burgers_problem(vars(module), extent=2.0, t_end=0.5)
        for module in (jax_pkg, torch_pkg)
    ]
    expected = jax_sml.solve(ivps[0]).discrete_y()
    actual = torch_sml.solve(ivps[1]).discrete_y()
    assert actual.shape == (5, 9, 9, 2)
    _assert_close(actual, expected, FIT_RTOL)

    cps = [ivp.constrained_problem for ivp in ivps]
    y_0 = ivps[0].initial_condition.discrete_y_0(True)
    jax_fn, _ = jax_sml.trajectory_function(
        cps[0], (0.0, 0.5), time_parallel=True
    )
    torch_fn, t = torch_sml.trajectory_function(
        cps[1], (0.0, 0.5), time_parallel=True
    )
    # the quadratic model is not affine: no propagator, a roll-out
    assert not hasattr(torch_fn, "end_function")
    assert not hasattr(jax_fn, "end_function")
    np.testing.assert_allclose(t, np.arange(1, 6) * SML_D_T)
    _assert_close(torch_fn(torch.as_tensor(y_0), 0.0), actual, 1e-14)
    ends = torch_sml.ends_function(cps[1], (0.0, 0.5))
    expected_ends = jax_sml.ends_function(cps[0], (0.0, 0.5))(y_0, 0.0)
    _assert_close(ends(torch.as_tensor(y_0), 0.0), expected_ends, FIT_RTOL)
    # leading batch axes map elementwise
    batch = torch.stack([torch.as_tensor(y_0), 0.9 * torch.as_tensor(y_0)])
    _assert_close(ends(batch, 0.0)[0], expected_ends, FIT_RTOL)


def test_affine_model_takes_the_propagator_path():
    """A ridge model is affine in the state: under ``time_parallel`` its
    roll-out becomes the linear propagator, as in the JAX package."""
    torch_sml, jax_sml = _operators()
    arrays = fitted_quad_arrays()
    torch_sml.model = supervised.from_arrays(
        {"weights": arrays["weights"], "intercept": arrays["intercept"]},
        dtype=torch.float64,
    )
    jax_sml.model = jax_supervised.StateOperatorRidgeRegressor(
        162, dtype=jnp.float64
    )
    jax_sml.model.state_map = (arrays["weights"], arrays["intercept"])
    cps = [
        burgers_problem(vars(module), extent=2.0).constrained_problem
        for module in (jax_pkg, torch_pkg)
    ]
    jax_fn, _ = jax_sml.trajectory_function(
        cps[0], (0.0, 0.4), time_parallel=True
    )
    torch_fn, _ = torch_sml.trajectory_function(
        cps[1], (0.0, 0.4), time_parallel=True
    )
    assert hasattr(torch_fn, "end_function") and hasattr(
        jax_fn, "end_function"
    )
    for ours, theirs in zip(
        torch_fn.affine_slice_map, jax_fn.affine_slice_map
    ):
        _assert_close(ours.numpy(), theirs, FIT_RTOL)


@pytest.mark.parametrize("auto_regressive", [True, False])
def test_generate_data_matches_jax(auto_regressive):
    """Two perturbed runs over three coarse steps, with the same numpy
    seed: the same inputs and targets to 1e-10 (float64)."""
    jax_sml = jax_supervised.SupervisedMLOperator(
        SML_D_T, True, auto_regressive=auto_regressive, time_variant=True
    )
    torch_sml = supervised.SupervisedMLOperator(
        SML_D_T,
        True,
        auto_regressive=auto_regressive,
        time_variant=True,
        device="cpu",
        dtype=torch.float64,
    )
    expected = _generate(
        jax_pkg, jax_sml, JaxFDMOperator(JaxRK4(), JaxThreePoint(), FINE_D_T)
    )
    oracle = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        FINE_D_T,
        device="cpu",
        dtype=torch.float64,
    )
    actual = _generate(torch_pkg, torch_sml, oracle)
    assert actual[0].shape == expected[0].shape == (2 * 3 * 81, 162 + 1 + 2)
    for ours, theirs in zip(actual, expected):
        assert ours.dtype == np.float64
        _assert_close(ours, theirs, FIT_RTOL)


def test_fit_model_splits_as_jax_does():
    """The state-block split draws the same samples from the same numpy
    seed: the same fitted arrays and scores."""
    x, y = _quadratic_layout_data(seed=5)
    jax_model = jax_supervised.ReducedQuadraticStateOperatorRegressor(
        12, rank=4, dtype=jnp.float64
    )
    model = supervised.ReducedQuadraticStateOperatorRegressor(
        12, rank=4, dtype=torch.float64
    )
    np.random.seed(11)
    expected = jax_supervised.SupervisedMLOperator(0.1, True).fit_model(
        jax_model, (x, y), test_size=0.25
    )
    np.random.seed(11)
    actual = supervised.SupervisedMLOperator(0.1, True).fit_model(
        model, (x, y), test_size=0.25
    )
    np.testing.assert_allclose(actual, expected, rtol=1e-10)
    for name, value in _jax_arrays(jax_model).items():
        _assert_close(getattr(model, f"_{name}"), value, FIT_RTOL)
    # a row-wise split needs scikit-learn's train_test_split
    with pytest.raises(NotImplementedError, match="slice 3"):
        supervised.SupervisedMLOperator(0.1, True).fit_model(
            object(), (x, y)
        )
