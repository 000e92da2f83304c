"""The PyTorch port's slice as a whole: Parareal on a shrunken flagship
diffusion_2d problem (11 x 11 grid, T = 1, 4 slices) held against the
JAX package's Parareal in float64 to rtol 1e-8, both through the affine
propagators (the default) and through the stencil sub-solves
(``linear_propagator=False``); the float32 route through the fused end
kernel's plain version held against the affine route; and the port
solving a problem in a process where JAX cannot be imported."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from bench import build_problem
from pararealml_tpu.operators.fdm import FDMOperator as JaxFDMOperator
from pararealml_tpu.operators.fdm import RK4 as JaxRK4
from pararealml_tpu.operators.fdm import (
    ThreePointCentralDifferenceMethod as JaxThreePoint,
)
from pararealml_tpu.operators.parareal import (
    PararealOperator as JaxPararealOperator,
)
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.parareal import PararealOperator
from pararealml_tpu_torch.ops import fused_diffusion

torch.set_num_threads(1)

T_END = 1.0
FINE_D_T = 1e-2
# one coarse step per slice: coarse enough that Parareal iterates
COARSE_D_T = 0.25
N_SLICES = 4
TOLERANCE = 2.5e-3


def _ivp(module):
    return build_problem(module, T_END, d_x=1.0)


def _torch_parareal(linear_propagator, dtype, tolerance=TOLERANCE):
    def fdm(d_t):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            d_t,
            linear_propagator=linear_propagator,
            dtype=dtype,
        )

    return PararealOperator(
        fdm(FINE_D_T),
        fdm(COARSE_D_T),
        tolerance,
        num_time_slices=N_SLICES,
    )


@pytest.mark.parametrize("linear_propagator", [True, False])
def test_parareal_matches_jax(linear_propagator):
    def jax_fdm(d_t):
        return JaxFDMOperator(
            JaxRK4(),
            JaxThreePoint(),
            d_t,
            linear_propagator=linear_propagator,
        )

    expected = (
        JaxPararealOperator(
            jax_fdm(FINE_D_T),
            jax_fdm(COARSE_D_T),
            TOLERANCE,
            num_time_slices=N_SLICES,
        )
        .solve(_ivp(vars(jax_pkg)))
        .discrete_y()
    )
    parareal = _torch_parareal(linear_propagator, torch.float64)
    actual = parareal.solve(_ivp(vars(torch_pkg))).discrete_y()

    assert actual.shape == expected.shape == (100, 11, 11, 1)
    # the shrunken problem still takes more than one correction
    assert parareal.last_iterations > 1
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(actual, expected, rtol=1e-8, atol=1e-8 * scale)


def test_float32_fused_route_matches_affine_route(monkeypatch):
    """float32 states take the fused kernels where the propagator is off
    (their plain versions on the CPU): the batched end kernel for the fine
    ends, the single-state one for the coarse sweep and the trajectory
    kernel for the coarse start and the final expansion. The result
    agrees with the affine route to float32 accuracy."""
    ivp = _ivp(vars(torch_pkg))
    affine = _torch_parareal(True, torch.float32).solve(ivp).discrete_y()

    calls = []
    for name in ("fused_diffusion_rk4_end", "fused_diffusion_rk4_trajectory"):
        wrapper = getattr(fused_diffusion, name)

        def counting(*args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append(_name)
            return _wrapper(*args, **kwargs)

        monkeypatch.setattr(fused_diffusion, name, counting)
    fused = _torch_parareal(False, torch.float32).solve(ivp).discrete_y()

    assert set(calls) == {
        "fused_diffusion_rk4_end",
        "fused_diffusion_rk4_trajectory",
    }
    scale = float(np.abs(affine).max())
    # float32 rounding over 100 fine steps on two different routes
    assert float(np.abs(fused - affine).max()) <= 1e-5 * scale


def test_port_runs_without_jax():
    """The port imports no JAX: with ``import jax`` made to fail, the
    package imports and solves a 5-step problem."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import pararealml_tpu_torch as p
        from pararealml_tpu_torch.operators.fdm import (
            RK4, FDMOperator, ThreePointCentralDifferenceMethod,
        )
        from bench import build_problem
        ivp = build_problem(vars(p), 0.05, d_x=1.0)
        solution = FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), 0.01
        ).solve(ivp)
        ys = solution.discrete_y()
        assert ys.shape == (5, 11, 11, 1), ys.shape
        assert np.isfinite(ys).all()
        assert not any(name.startswith("jax") for name in sys.modules
                       if sys.modules[name] is not None)
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=repo)
    result = subprocess.run(
        [sys.executable, "-c", script],
        cwd=repo,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"
