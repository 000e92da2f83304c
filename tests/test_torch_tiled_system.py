"""The tiled system kernel's plain PyTorch version (the CPU side of the
CUDA kernel K8) held against the JAX package: against its Pallas kernel in
interpret mode in float32, and against its generic path in float64 for
the four families; the port's own tile plan, the build function's errors,
the dispatch rule against the JAX package's gates, the ``FDMOperator``
dispatch to K8 past one CTA, and ``kernel_storage_dtype`` taking effect
only past the JAX package's VMEM cap, as there. The CUDA kernel itself is
held against its plain version in tests/test_torch_cuda.py.

Tolerances: float32 results agree to 1e-5 relative to the largest value
(the two evaluate the same float32 operations in the same order; the
tolerance covers contraction); float64 results agree with the generic
path to 1e-10 (the same operations, regrouped only where the generic
path sums its symbolic terms); bfloat16 storage agrees with float32
storage to 2e-2 of the largest value (the JAX test's bound)."""

import functools

import jax
import numpy as np
import pytest
import torch

import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from pararealml_tpu.operators.fdm import FDMOperator as JaxFDMOperator
from pararealml_tpu.operators.parareal import (
    PararealOperator as JaxPararealOperator,
)
from pararealml_tpu.operators.fdm import RK4 as JaxRK4
from pararealml_tpu.operators.fdm import (
    ThreePointCentralDifferenceMethod as JaxThreePoint,
)
from pararealml_tpu.ops import fused_system as jax_fused
from pararealml_tpu.ops import tiled_system as jax_tiled
from pararealml_tpu_torch.operators.fdm import (
    RK4,
    FDMOperator,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu_torch.operators.parareal import PararealOperator
from pararealml_tpu_torch.ops import fused_system as torch_fused
from pararealml_tpu_torch.ops import packed_system as torch_packed
from pararealml_tpu_torch.ops import tiled_system as torch_tiled
from tests.test_torch_cuda import states_2d, system_problem

torch.set_num_threads(1)

F32_TOL = 1e-5
F64_TOL = 1e-10
BF16_TOL = 2e-2
D_T = 1e-3
STEPS = 5


@pytest.fixture
def x64_off():
    """The JAX package's fused kernels switch themselves off under x64,
    which the suite enables; turn it off inside the test only."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _problems(family, faces, shape=(17, 33)):
    return tuple(
        system_problem(vars(module), family, faces, shape)
        for module in (jax_pkg, torch_pkg)
    )


def _relative_error(actual, expected):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    return np.abs(actual - expected).max() / np.abs(expected).max()


@pytest.mark.parametrize(
    "shape, n, halo, rows, cols, blocks",
    [
        # the examples' grids: wave and Cahn-Hilliard 101², shallow water
        # 101 x 51 x 3, and the JAX package's 641² Burgers
        ((101, 101), 2, 4, 12, 32, 130),
        ((101, 101), 2, 1, 8, 32, 68),
        ((101, 51), 3, 4, 12, 32, 78),
        ((641, 641), 2, 4, 32, 96, 216),
        # tests/test_tiled_system.py's grid: five tile rows, the last
        # clamped to end on the grid's last row
        ((17, 33), 2, 4, 12, 32, 10),
    ],
)
def test_tile_plan(shape, n, halo, rows, cols, blocks):
    plan = torch_tiled.make_system_tile_plan(*shape, n, halo)
    assert (plan.rows, plan.cols, plan.blocks) == (rows, cols, blocks)
    assert plan.shared_bytes <= torch_fused.MAX_SHARED_MEMORY_BYTES
    height, width = shape
    for starts, tile, extent in (
        (plan.starts_h, plan.tile_h, height),
        (plan.starts_w, plan.tile_w, width),
    ):
        # the tiles cover the grid, the last one clamped inside it
        assert starts[0] == 0
        assert all(b <= a + tile for a, b in zip(starts, starts[1:]))
        assert starts[-1] + tile == extent
    if shape == (17, 33):
        assert plan.starts_h == (0, 4, 8, 12, 13)
    assert torch_tiled.make_system_tile_plan(2, 40, n) is None
    # no family has one component
    assert torch_tiled.make_system_tile_plan(*shape, 1, halo) is None


# three interpret-mode runs of the Pallas kernel: each costs seconds of
# tracing on the CPU
@pytest.mark.parametrize(
    "family, faces, storage",
    [
        ("burgers", "dirichlet", "bfloat16"),
        ("shallow_water", "partial", "float32"),
        ("cahn_hilliard", "neumann", "float32"),
    ],
)
def test_plain_version_matches_pallas_kernel(family, faces, storage, x64_off):
    """In float32 storage and in bfloat16 storage, where both round every
    frame to bfloat16 (to nearest even) from the same float32 values."""
    jax_cp, torch_cp = _problems(family, faces)
    n = jax_cp.differential_equation.y_dimension
    y = states_2d((17, 33), n)
    expected = jax_tiled.build_tiled_system_rk4_trajectory(
        jax_cp,
        D_T,
        STEPS,
        interpret=True,
        storage_dtype=getattr(jax.numpy, storage),
    )(y)
    actual = torch_tiled.build_tiled_system_rk4_trajectory(
        torch_cp, D_T, STEPS, storage_dtype=getattr(torch, storage)
    )(torch.as_tensor(y))
    assert actual.dtype == getattr(torch, storage)
    assert _relative_error(actual.float(), expected) <= F32_TOL


@pytest.mark.parametrize(
    "family, faces",
    [
        ("wave", "dirichlet"),
        ("burgers", "neumann"),
        ("shallow_water", "partial"),
        ("cahn_hilliard", "dirichlet"),
    ],
)
def test_plain_version_matches_generic_path_in_float64(family, faces):
    jax_cp, torch_cp = _problems(family, faces)
    n = jax_cp.differential_equation.y_dimension
    y = states_2d((17, 33), n).astype(np.float64)
    generic, _ = JaxFDMOperator(
        JaxRK4(), JaxThreePoint(), D_T, fused_kernels=False
    ).trajectory_function(jax_cp, (0.0, STEPS * D_T))
    expected = np.asarray(generic(y, 0.0))
    cfg = torch_tiled._TiledSystemConfig(torch_cp, D_T)
    actual = torch_tiled.tiled_system_rk4_trajectory_reference(
        torch.as_tensor(y), cfg, STEPS
    )
    assert actual.dtype == torch.float64
    assert _relative_error(actual, expected) <= F64_TOL


def test_bfloat16_storage_matches_float32():
    """The frames round to bfloat16 once a step; the JAX test's 4 steps
    stay within its bound, and a batch advances each state as it advances
    alone."""
    _, cp = _problems("wave", "dirichlet")
    cfg = torch_tiled._TiledSystemConfig(cp, 2e-3)
    ys = torch.as_tensor(states_2d((17, 33), 2, batch=2))
    f32 = torch_tiled.tiled_system_rk4_trajectory(ys, cfg, 4)
    bf16 = torch_tiled.tiled_system_rk4_trajectory(
        ys, cfg, 4, storage_dtype=torch.bfloat16
    )
    assert bf16.dtype == torch.bfloat16 and bf16.shape == (2, 4, 17, 33, 2)
    assert _relative_error(bf16.float(), f32) <= BF16_TOL
    np.testing.assert_array_equal(
        bf16[1].float().numpy(),
        torch_tiled.tiled_system_rk4_trajectory(
            ys[1], cfg, 4, storage_dtype=torch.bfloat16
        )
        .float()
        .numpy(),
    )


def _bench_burgers(module, d_x):
    """bench.py's 2D Burgers problem (Re 100, zero-flux faces, Gaussians
    of covariance 0.75 I at the centre with amplitudes 1 and 0.5) on [0,
    5]² at spacing ``d_x``, and its initial state in float32."""
    flux = module.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = module.ConstrainedProblem(
        module.BurgersEquation(2, 100.0),
        module.Mesh([(0.0, 5.0)] * 2, [d_x] * 2),
        [(flux, flux)] * 2,
    )
    ic = module.GaussianInitialCondition(
        cp, [(np.full(2, 2.5), 0.75 * np.eye(2))] * 2, [1.0, 0.5]
    )
    return cp, np.asarray(ic.discrete_y_0(True), np.float32)


def bfloat16_storage_drift(d_t, n_steps, d_x=0.125):
    """What rounding the state to bfloat16 once a step does to bench.py's
    2D Burgers problem over ``n_steps`` steps of ``d_t``: through the JAX
    package's generic float32 step rounded after every step, and through
    the port's K8 plain version in bfloat16 storage. Returns, for each
    (``"jax"``, ``"port"``), the last frame's distance from the JAX
    float32 run's, and (``"jax_moved"``, ``"port_moved"``, ``"f32_moved"``)
    how far each run's last frame moved from its initial state, all as a
    share of the float32 last frame's largest value."""
    import jax.numpy as jnp

    jax_cp, y = _bench_burgers(jax_pkg, d_x)
    step = JaxFDMOperator(
        JaxRK4(), JaxThreePoint(), d_t, fused_kernels=False
    )._build_step_function(jax_cp, 0.0, n_steps, static_only=True)

    @jax.jit
    def last_frames(y):
        def advance(rounded):
            def body(i, y):
                y = step(y, i, i * d_t)
                if rounded:
                    y = y.astype(jnp.bfloat16).astype(jnp.float32)
                return y

            return jax.lax.fori_loop(0, n_steps, body, y)

        return advance(False), advance(True)

    f32, jax_bf16 = (np.asarray(frame, np.float64) for frame in last_frames(y))
    torch_cp, _ = _bench_burgers(torch_pkg, d_x)
    port_bf16 = (
        torch_tiled.tiled_system_rk4_trajectory_reference(
            torch.as_tensor(y),
            torch_tiled._TiledSystemConfig(torch_cp, d_t),
            n_steps,
            torch.bfloat16,
        )[-1]
        .double()
        .numpy()
    )
    rounded_y_0 = torch.as_tensor(y).bfloat16().double().numpy()
    scale = np.abs(f32).max()
    return dict(
        jax=np.abs(jax_bf16 - f32).max() / scale,
        port=np.abs(port_bf16 - f32).max() / scale,
        jax_moved=np.abs(jax_bf16 - rounded_y_0).max() / scale,
        port_moved=np.abs(port_bf16 - rounded_y_0).max() / scale,
        f32_moved=np.abs(f32 - y).max() / scale,
    )


def test_bfloat16_drift_comes_from_the_once_a_step_rounding(x64_off):
    """The 641² Burgers run's bfloat16 drift is the once-a-step rounding,
    in the JAX package too. On bench.py's problem at 41² over the same
    time (1,000 steps of 1e-3), the increments are under half a bfloat16
    step almost everywhere: the rounded state moves less than a tenth as
    far as the float32 one, through the JAX generic step and the port's
    plain version alike, and the last frame misses the float32 one by far
    more than the 2e-2 bound. With 20 steps of 5e-2 over the same time
    the miss is less than half as large."""
    small = bfloat16_storage_drift(1e-3, 1000)
    assert small["jax_moved"] < small["f32_moved"] / 10
    assert small["port_moved"] < small["f32_moved"] / 10
    assert small["jax"] > BF16_TOL
    assert abs(small["port"] - small["jax"]) <= F32_TOL
    large = bfloat16_storage_drift(5e-2, 20)
    assert large["jax"] < small["jax"] / 2
    assert large["port"] < small["port"] / 2


def _add_interior_dirichlet(module, cp):
    """Adds one interior Dirichlet vertex to ``cp``'s static y
    constraints (the face ones stay)."""
    from pararealml_tpu.constraint import Constraint as JaxConstraint
    from pararealml_tpu_torch.constraint import Constraint as TorchConstraint

    n = cp.differential_equation.y_dimension
    shape = tuple(cp.mesh.vertices_shape) + (n,)
    old = cp.static_y_vertex_constraints
    mask = np.asarray(old.mask).reshape(shape).copy()
    values = np.where(mask, np.asarray(old.values).reshape(shape), 0.0)
    mask[shape[0] // 2, shape[1] // 2] = True
    values[shape[0] // 2, shape[1] // 2] = 1.0
    constraint = JaxConstraint if module is jax_pkg else TorchConstraint
    cp._y_vertex_constraints = constraint(
        values.reshape(np.asarray(old.values).shape),
        mask.reshape(np.asarray(old.mask).shape),
    )
    return cp


def test_build_function_raises_as_the_jax_one_does():
    navier_stokes = torch_pkg.ConstrainedProblem(
        torch_pkg.NavierStokesEquation(500.0),
        torch_pkg.Mesh([(0.0, 4.0), (0.0, 8.0)], [0.25, 0.25]),
        [
            (
                torch_pkg.DirichletBoundaryCondition(
                    lambda x, t: np.zeros((len(x), 4)), is_static=True
                ),
            )
            * 2
        ]
        * 2,
    )
    with pytest.raises(ValueError, match="Navier-Stokes"):
        torch_tiled.build_tiled_system_rk4_trajectory(navier_stokes, D_T, 2)
    _, cp = _problems("burgers", "dirichlet")
    with pytest.raises(ValueError, match="storage_dtype"):
        torch_tiled.build_tiled_system_rk4_trajectory(
            cp, D_T, 2, storage_dtype=torch.float16
        )
    _, thin = _problems("burgers", "neumann", shape=(2, 9))
    with pytest.raises(ValueError, match="range"):
        torch_tiled.build_tiled_system_rk4_trajectory(thin, D_T, 2)
    with pytest.raises(ValueError, match="interior"):
        torch_tiled.build_tiled_system_rk4_trajectory(
            _add_interior_dirichlet(
                torch_pkg, _problems("wave", "dirichlet")[1]
            ),
            D_T,
            2,
        )
    cfg = torch_tiled._TiledSystemConfig(cp, D_T)
    y = torch.zeros((17, 33, 2))
    with pytest.raises(TypeError, match="float32"):
        torch_tiled.tiled_system_rk4_trajectory(y.double(), cfg, 2)
    with pytest.raises(ValueError, match="storage_dtype"):
        torch_tiled.tiled_system_rk4_trajectory(y, cfg, 2, torch.float64)


def test_dispatch_rule_matches_jax(x64_off):
    """The port's gates against the JAX package's on grids past one CTA
    (81² for two components, 65² for three), except where ROADMAP.md's
    Queue 3 logs a deliberate difference: shallow water past the JAX
    package's VMEM cap takes K8, and float64 states take the generic
    path. Within the JAX package's VMEM cap and the cluster's range the
    trajectories and end states take the cluster-resident mode, as the
    JAX package's take its K5 there, interior Dirichlet constraints
    included; past the cap K8 and its end mode."""
    cases = {
        "wave": ("dirichlet", (81, 81), True),
        "burgers": ("neumann", (81, 81), True),
        "cahn_hilliard": ("partial", (81, 81), True),
        "shallow_water": ("dirichlet", (65, 65), True),
    }
    for family, (faces, shape, expected) in cases.items():
        jax_cp, torch_cp = _problems(family, faces, shape)
        assert not torch_fused.fits_one_block(torch_cp)
        assert torch_fused.cluster_system_applicable(torch_cp)
        assert not torch_tiled.tiled_system_applicable(torch_cp)
        assert jax_fused.fused_system_step_applicable(jax_cp, JaxRK4())
        assert torch_fused.fused_system_step_applicable(
            torch_cp, RK4(), torch.float32
        )
        assert not torch_fused.fused_system_step_applicable(
            torch_cp, RK4(), torch.float64
        )
        # K4 keeps the one-CTA condition (it has no tiled variant)
        assert not torch_packed.packed_system_applicable(
            torch_cp, RK4(), 4, torch.float32
        )
        # the end takes the mode's end (K5's end in the JAX package)
        assert torch_fused.build_fused_system_rk4_end(torch_cp, D_T, 2)
    # past the JAX package's VMEM cap, shallow water stays generic there
    jax_cp, torch_cp = _problems("shallow_water", "neumann", (641, 641))
    assert not jax_tiled.tiled_system_applicable(jax_cp)
    assert torch_tiled.tiled_system_applicable(torch_cp)
    jax_cp, torch_cp = _problems("wave", "dirichlet", (641, 641))
    assert jax_tiled.tiled_system_applicable(jax_cp)
    assert torch_tiled.tiled_system_applicable(torch_cp)
    # interior Dirichlet past one CTA: K5 in VMEM there, the mode here
    # (its dense Dirichlet mask); K8 keeps refusing it
    jax_cp, torch_cp = (
        _add_interior_dirichlet(module, cp)
        for module, cp in zip(
            (jax_pkg, torch_pkg), _problems("wave", "dirichlet", (81, 81))
        )
    )
    assert jax_fused.fused_system_step_applicable(jax_cp, JaxRK4())
    assert torch_fused.fused_system_step_applicable(torch_cp, RK4())
    assert torch_fused.cluster_system_applicable(torch_cp)
    assert not torch_tiled.tiled_system_applicable(torch_cp)
    assert torch_fused.build_fused_system_rk4_end(torch_cp, D_T, 2)


def test_fdm_operator_dispatches_past_one_cta_to_k8(monkeypatch):
    """With the one-CTA limit and the JAX package's VMEM cap (past which
    alone ``kernel_storage_dtype`` takes effect, as there) patched down, a
    17 x 33 Burgers problem's trajectory and step go through the K8
    wrapper (its plain version here), in the stored dtype, and agree with
    the generic path to float32 rounding; its ends, single and batched,
    take K8's end mode (its plain version here), equal to the
    trajectory's last frame."""
    monkeypatch.setattr(torch_fused, "MAX_SHARED_MEMORY_BYTES", 1024)
    # and the cluster-resident mode's range, so that K8 takes the grid
    monkeypatch.setattr(torch_fused, "CLUSTER_MAX_BLOCK_CELLS", 0)
    # 24 x 128 padded cells of two components: past a cap of 1,024
    monkeypatch.setattr(
        torch_fused, "REFERENCE_VMEM_BUDGET_CELLS", 1024 * (7 * 2 + 4)
    )
    calls = []
    end_calls = []
    wrapper = torch_tiled.tiled_system_rk4_trajectory
    end_wrapper = torch_tiled.tiled_system_rk4_end

    def counting(y, *args, **kwargs):
        calls.append(tuple(y.shape))
        return wrapper(y, *args, **kwargs)

    def counting_ends(y, *args, **kwargs):
        end_calls.append(tuple(y.shape))
        return end_wrapper(y, *args, **kwargs)

    monkeypatch.setattr(torch_tiled, "tiled_system_rk4_trajectory", counting)
    monkeypatch.setattr(torch_tiled, "tiled_system_rk4_end", counting_ends)
    _, cp = _problems("burgers", "dirichlet")
    y = torch.as_tensor(states_2d((17, 33), 2))

    def operator(fused, **kwargs):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            D_T,
            fused_kernels=fused,
            device="cpu",
            dtype=torch.float32,
            **kwargs,
        )

    interval = (0.0, STEPS * D_T)
    fused_fn, _ = operator(True).trajectory_function(cp, interval)
    generic_fn, _ = operator(False).trajectory_function(cp, interval)
    assert fused_fn.fused and not generic_fn.fused
    fused, generic = fused_fn(y, 0.0), generic_fn(y, 0.0)
    assert calls == [(1, 17, 33, 2)]
    assert _relative_error(fused, generic) <= F32_TOL
    bf16_fn, _ = operator(
        True, kernel_storage_dtype=torch.bfloat16
    ).trajectory_function(cp, interval)
    bf16 = bf16_fn(y, 0.0)
    assert bf16.dtype == torch.bfloat16
    assert _relative_error(bf16.float(), fused) <= BF16_TOL
    step = operator(True)._build_step_function(cp)
    np.testing.assert_array_equal(step(y, 0, 0.0).numpy(), fused[0].numpy())
    ends = operator(True).ends_function(cp, interval, batch=2)
    assert ends.fused and ends.batched
    calls.clear()
    np.testing.assert_array_equal(
        ends(torch.stack([y, y]), 0.0)[1].numpy(), fused[-1].numpy()
    )
    single = operator(True).ends_function(cp, interval)
    assert single.fused and not single.batched
    np.testing.assert_array_equal(
        single(y, 0.0).numpy(), fused[-1].numpy()
    )
    assert not calls
    assert end_calls == [(2, 17, 33, 2), (1, 17, 33, 2)]


def _wave_example(module):
    """examples/wave_2d_fdm.py's problem (101², Dirichlet 0 on every face,
    a Gaussian of amplitude 3 in y0) and its float32 initial state."""
    zero = module.DirichletBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = module.ConstrainedProblem(
        module.WaveEquation(2),
        module.Mesh([(-5.0, 5.0), (-5.0, 5.0)], [0.1, 0.1]),
        [(zero, zero)] * 2,
    )
    ic = module.GaussianInitialCondition(
        cp, [(np.array([0.0, 2.5]), 0.1 * np.eye(2))] * 2, [3.0, 0.0]
    )
    return cp, np.asarray(ic.discrete_y_0(True), np.float32)


_WAVE_INTERVAL = (0.0, 0.03)


@functools.lru_cache(maxsize=None)
def _jax_k5_wave_example():
    """The JAX package's FDM trajectory on the wave example's 101² problem
    over 3 steps of 0.01 with ``kernel_storage_dtype=bfloat16``, which its
    K5 ignores there: one interpret-mode run of its K5, shared by the two
    tests below. Returns the float32 initial state and the frames."""
    import jax.numpy as jnp

    jax_cp, y = _wave_example(jax_pkg)
    jax.config.update("jax_enable_x64", False)
    try:
        jax_fn, _ = JaxFDMOperator(
            JaxRK4(), JaxThreePoint(), 0.01, kernel_storage_dtype=jnp.bfloat16
        ).trajectory_function(jax_cp, _WAVE_INTERVAL)
        expected = jax_fn(jnp.asarray(y), 0.0)
        assert expected.dtype == jnp.float32
        return y, np.asarray(expected)
    finally:
        jax.config.update("jax_enable_x64", True)


def test_end_mode_matches_pallas_k5_on_the_wave_example():
    """K8's end mode (its plain version) on the wave example's 101² grid,
    past one CTA, against the last frame of the JAX package's K5 in
    interpret mode (what the JAX package runs there, end and trajectory
    alike), to 1e-5 of the largest value; through
    ``build_fused_system_rk4_end``, single and batched."""
    torch_cp, _ = _wave_example(torch_pkg)
    y, expected = _jax_k5_wave_example()
    end = torch_fused.build_fused_system_rk4_end(torch_cp, 0.01, 3)
    actual = end(torch.as_tensor(y))
    assert actual.dtype == torch.float32
    assert _relative_error(actual, expected[-1]) <= F32_TOL
    batched = torch_fused.build_fused_system_rk4_end(
        torch_cp, 0.01, 3, batch=2
    )(torch.as_tensor(np.stack([y, y])))
    np.testing.assert_array_equal(batched[1].numpy(), actual.numpy())


def test_storage_dtype_takes_effect_only_past_the_jax_vmem_cap(x64_off):
    """``kernel_storage_dtype=bfloat16`` on the wave example's 101²
    problem, which lies within the JAX package's VMEM cap: its K5 ignores
    the knob, and so does the port's K8 there. Both packages return
    float32, equal to float32 rounding (1e-5 of the largest value) over 3
    steps of 0.01 (before, the port returned bfloat16, 2.9e-2 away).
    Past the cap the knob takes effect in both
    (``test_fdm_operator_dispatches_past_one_cta_to_k8``)."""
    torch_cp, _ = _wave_example(torch_pkg)
    assert not torch_fused.fits_one_block(torch_cp)
    assert torch_fused.fits_reference_vmem(torch_cp)
    interval = _WAVE_INTERVAL
    y, expected = _jax_k5_wave_example()
    torch_fn, _ = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        0.01,
        kernel_storage_dtype=torch.bfloat16,
        device="cpu",
        dtype=torch.float32,
    ).trajectory_function(torch_cp, interval)
    assert torch_fn.fused
    actual = torch_fn(torch.as_tensor(y), 0.0)
    assert expected.dtype == np.float32
    assert actual.dtype == torch.float32
    assert _relative_error(actual, expected) <= F32_TOL


@pytest.mark.parametrize(
    "family, faces",
    [("burgers", "dirichlet"), ("cahn_hilliard", "neumann")],
)
def test_end_mode_matches_generic_path_in_float64(family, faces):
    """K8's end mode (its plain version) in float64 against the JAX
    package's generic path over 5 steps, batched, to 1e-10 of the largest
    value: the end is the trajectory's last frame, with nothing stored."""
    jax_cp, torch_cp = _problems(family, faces)
    n = jax_cp.differential_equation.y_dimension
    ys = states_2d((17, 33), n, batch=2).astype(np.float64)
    generic, _ = JaxFDMOperator(
        JaxRK4(), JaxThreePoint(), D_T, fused_kernels=False
    ).trajectory_function(jax_cp, (0.0, STEPS * D_T))
    expected = np.stack([np.asarray(generic(y, 0.0))[-1] for y in ys])
    cfg = torch_tiled._TiledSystemConfig(torch_cp, D_T)
    actual = torch_tiled.tiled_system_rk4_end_reference(
        torch.as_tensor(ys), cfg, STEPS
    )
    assert actual.dtype == torch.float64
    assert _relative_error(actual, expected) <= F64_TOL


def test_end_wrapper_refuses_before_any_launch():
    """The end mode raises, on any device and before any launch, where
    the trajectory does: no tile plan, a plan that does not fit, interior
    Dirichlet constraints, Navier-Stokes, float64 states; on the CPU it
    runs its plain version and counts no launch."""
    _, cp = _problems("wave", "dirichlet")
    cfg = torch_tiled._TiledSystemConfig(cp, D_T)
    y = torch.as_tensor(states_2d((17, 33), 2))
    with pytest.raises(ValueError, match="does not fit"):
        torch_tiled.tiled_system_rk4_end(
            y, cfg, 2, plan=cfg.plan._replace(halo=0)
        )
    with pytest.raises(TypeError, match="float32"):
        torch_tiled.tiled_system_rk4_end(y.double(), cfg, 2)
    _, thin = _problems("burgers", "neumann", shape=(2, 9))
    with pytest.raises(ValueError, match="range"):
        torch_tiled.build_tiled_system_rk4_end(thin, D_T, 2)
    with pytest.raises(ValueError, match="interior"):
        torch_tiled.build_tiled_system_rk4_end(
            _add_interior_dirichlet(
                torch_pkg, _problems("wave", "dirichlet")[1]
            ),
            D_T,
            2,
        )
    end = torch_tiled.build_tiled_system_rk4_end(cp, D_T, 3, batch=2)
    with pytest.raises(ValueError, match="leading shape"):
        end(y)
    launches = torch_tiled.tiled_system_rk4_end.launches
    np.testing.assert_array_equal(
        end(torch.stack([y, y]))[0].numpy(),
        torch_tiled.tiled_system_rk4_trajectory_reference(y, cfg, 3)[
            -1
        ].numpy(),
    )
    assert torch_tiled.tiled_system_rk4_end.launches == launches


def test_parareal_past_one_cta_takes_the_batched_k8_end(monkeypatch):
    """A Parareal over a 17 x 33 wave problem (4 slices of 10 fine steps
    and one coarse step at a Courant number of 0.6) with the one-CTA
    limit patched down: every iteration's fine ends go through K8's end mode
    for the 4 slices at once (one z-slice of the grid a time slice; its
    plain version here), the corrective coarse sweeps through its
    single-state end, and the final expansion through the batched K8
    trajectory; no K4. The solution matches the JAX package's Parareal
    (its generic path under the suite's x64) to 1e-5 of the largest
    value, after more than one iteration."""
    monkeypatch.setattr(torch_fused, "MAX_SHARED_MEMORY_BYTES", 1024)
    # and the cluster-resident mode's range, so that K8 takes the grid
    monkeypatch.setattr(torch_fused, "CLUSTER_MAX_BLOCK_CELLS", 0)
    calls = []
    for module, name in (
        (torch_tiled, "tiled_system_rk4_end"),
        (torch_tiled, "tiled_system_rk4_trajectory"),
        (torch_packed, "packed_system_rk4_ends"),
    ):
        wrapper = getattr(module, name)

        def counting(y, *args, _wrapper=wrapper, _name=name, **kwargs):
            calls.append((_name, tuple(y.shape[:-3])))
            return _wrapper(y, *args, **kwargs)

        monkeypatch.setattr(module, name, counting)

    def ivp(module):
        cp = system_problem(vars(module), "wave", "dirichlet")
        return module.InitialValueProblem(
            cp,
            (0.0, 0.4),
            module.DiscreteInitialCondition(
                cp, states_2d((17, 33), 2).astype(np.float64), True
            ),
        )

    def fdm(d_t):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            d_t,
            device="cpu",
            dtype=torch.float32,
        )

    parareal = PararealOperator(fdm(1e-2), fdm(0.1), 1e-5, num_time_slices=4)
    actual = parareal.solve(ivp(torch_pkg)).discrete_y()
    assert parareal.last_iterations > 1
    fine_ends = calls.count(("tiled_system_rk4_end", (4,)))
    assert fine_ends == parareal.last_iterations
    assert ("tiled_system_rk4_end", (1,)) in calls
    assert calls.count(("tiled_system_rk4_trajectory", (4,))) == 1
    assert not any(name == "packed_system_rk4_ends" for name, _ in calls)

    def jax_fdm(d_t):
        return JaxFDMOperator(JaxRK4(), JaxThreePoint(), d_t)

    expected = (
        JaxPararealOperator(
            jax_fdm(1e-2), jax_fdm(0.1), 1e-5, num_time_slices=4
        )
        .solve(ivp(jax_pkg))
        .discrete_y()
    )
    assert actual.shape == expected.shape == (40, 17, 33, 2)
    assert _relative_error(actual, expected) <= F32_TOL
