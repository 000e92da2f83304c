"""The fused diffusion kernels' plain PyTorch versions (the CPU side of
the CUDA kernels K1-K3) held against the JAX package's Pallas kernels in
interpret mode, in float32 to atol = rtol = 1e-5 after at most 20 steps
(the two evaluate the same operations in the same order; the tolerance
covers float32 rounding of contracted or reordered operations), plus the
applicability predicate and the wrappers' CPU routing. The CUDA kernels
themselves are held against their plain versions in
tests/test_torch_cuda.py."""

import jax
import numpy as np
import pytest
import torch

import pararealml_tpu as jax_pkg
import pararealml_tpu_torch as torch_pkg
from pararealml_tpu.operators.fdm import ForwardEulerMethod as JaxEuler
from pararealml_tpu.operators.fdm import RK4 as JaxRK4
from bench import build_problem
from pararealml_tpu.ops import fused_diffusion as jax_fused
from pararealml_tpu.ops import tiled_diffusion as jax_tiled
from pararealml_tpu_torch.operators.fdm import ForwardEulerMethod, RK4
from pararealml_tpu_torch.ops import fused_diffusion as torch_fused
from pararealml_tpu_torch.ops import resident_diffusion as torch_resident
from pararealml_tpu_torch.ops import tiled_diffusion as torch_tiled
from tests.test_torch_cuda import INSTANCE_REGISTERS, PROBLEMS

torch.set_num_threads(1)

TOL = 1e-5
D_T = 1e-3


@pytest.fixture
def x64_off():
    """The JAX package's fused kernels switch themselves off under x64,
    which the suite enables; turn it off inside the test only."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _problems(name):
    return (
        PROBLEMS[name](vars(jax_pkg)).constrained_problem,
        PROBLEMS[name](vars(torch_pkg)).constrained_problem,
    )


def _states(cp, batch=None, seed=0):
    """Smooth O(1) states from a seed: the problem's own Dirichlet values
    plus random Fourier modes."""
    rng = np.random.default_rng(seed)
    height, width = cp.mesh.vertices_shape
    x = np.linspace(0.0, np.pi, height)[:, None]
    y = np.linspace(0.0, np.pi, width)[None, :]
    count = 1 if batch is None else batch
    states = []
    for _ in range(count):
        a, b, c = rng.uniform(0.5, 1.5, 3)
        k, m = rng.integers(1, 4, 2)
        states.append(a * np.sin(k * x) * np.cos(m * y) + b * x / np.pi + c)
    states = np.stack(states).astype(np.float32)[..., None]
    return states[0] if batch is None else states


def _assert_close(actual, expected):
    actual = np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape
    np.testing.assert_allclose(actual, expected, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_trajectory_reference_matches_pallas_kernel(problem, x64_off):
    jax_cp, torch_cp = _problems(problem)
    y = _states(jax_cp)
    steps = 20
    expected = jax_fused.build_fused_diffusion_rk4_trajectory(
        jax_cp, D_T, steps, interpret=True
    )(y)
    trajectory = torch_fused.build_fused_diffusion_rk4_trajectory(
        torch_cp, D_T, steps
    )
    _assert_close(trajectory(torch.as_tensor(y)), expected)


def test_end_reference_matches_pallas_kernel(x64_off):
    jax_cp, torch_cp = _problems("neumann")
    steps = 20
    y = _states(jax_cp)
    expected = jax_fused.build_fused_diffusion_rk4_end(
        jax_cp, D_T, steps, interpret=True
    )(y)
    end = torch_fused.build_fused_diffusion_rk4_end(torch_cp, D_T, steps)
    _assert_close(end(torch.as_tensor(y)), expected)


def test_batched_end_reference_matches_pallas_kernel(x64_off):
    jax_cp, torch_cp = _problems("flagship")
    steps, batch = 20, 3
    ys = _states(jax_cp, batch=batch)
    expected = jax_fused.build_fused_diffusion_rk4_end(
        jax_cp, D_T, steps, interpret=True, batch=batch
    )(ys)
    end = torch_fused.build_fused_diffusion_rk4_end(
        torch_cp, D_T, steps, batch=batch
    )
    actual = end(torch.as_tensor(ys))
    _assert_close(actual, expected)
    # one state of the batch advances exactly as it does alone
    single = torch_fused.build_fused_diffusion_rk4_end(torch_cp, D_T, steps)
    np.testing.assert_array_equal(
        actual[1].numpy(), single(torch.as_tensor(ys[1])).numpy()
    )


def test_step_reference_matches_pallas_kernel(x64_off):
    jax_cp, torch_cp = _problems("convection")
    y = _states(jax_cp)
    jax_step = jax_fused.build_fused_diffusion_rk4_step(
        jax_cp, D_T, interpret=True
    )
    torch_step = torch_fused.build_fused_diffusion_rk4_step(torch_cp, D_T)
    expected, actual = y, torch.as_tensor(y)
    for _ in range(3):
        expected = jax_step(expected)
        actual = torch_step(actual)
    _assert_close(actual, expected)


@pytest.mark.parametrize(
    "case",
    [
        "flagship",
        "neumann",
        "convection",
        "wave",
        "euler",
        "resident_641",
        "tiled_2049",
    ],
)
def test_applicability_matches_jax(case, x64_off):
    if case in ("resident_641", "tiled_2049"):
        # the bench's large grids: past the one-CTA gate, on the resident
        # and on the tiled route in both packages
        n = int(case.split("_")[1])
        jax_cp, torch_cp = (
            build_problem(
                vars(module), 1e-3, d_x=10.0 / (n - 1), d=0.05
            ).constrained_problem
            for module in (jax_pkg, torch_pkg)
        )
        shape = torch_cp.mesh.vertices_shape
        assert not torch_fused.fits_one_block(*shape)
        streams = case == "tiled_2049"
        assert torch_tiled.takes_streaming_path(torch_cp) == streams
        assert jax_tiled.takes_streaming_path(jax_cp) == streams
    elif case == "wave":
        cps = []
        for module in (jax_pkg, torch_pkg):
            mesh = module.Mesh([(0.0, 1.0)], [0.5])
            bc = module.NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 2)), is_static=True
            )
            cps.append(
                module.ConstrainedProblem(
                    module.WaveEquation(1), mesh, [(bc, bc)]
                )
            )
        jax_cp, torch_cp = cps
    else:
        jax_cp, torch_cp = _problems(
            "flagship" if case == "euler" else case
        )
    jax_integrator, torch_integrator = (
        (JaxEuler(), ForwardEulerMethod())
        if case == "euler"
        else (JaxRK4(), RK4())
    )
    expected = jax_fused.fused_diffusion_step_applicable(
        jax_cp, jax_integrator
    )
    assert (
        torch_fused.fused_diffusion_step_applicable(
            torch_cp, torch_integrator
        )
        == expected
    )
    # the kernels take float32 states only
    assert not torch_fused.fused_diffusion_step_applicable(
        torch_cp, torch_integrator, torch.float64
    )


def test_applicability_requires_the_grid_to_fit_shared_memory():
    mesh = torch_pkg.Mesh([(0.0, 64.0), (0.0, 64.0)], [0.5, 0.5])
    bc = torch_pkg.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = torch_pkg.ConstrainedProblem(
        torch_pkg.DiffusionEquation(2), mesh, [(bc, bc)] * 2
    )
    assert torch_fused.shared_memory_bytes(129, 129) > (
        torch_fused.MAX_SHARED_MEMORY_BYTES
    )
    assert not torch_fused.fits_one_block(129, 129)
    # K1-K3 do not take the grid: its trajectory and step go to the
    # resident kernel's route, and its end to that kernel's end mode
    end = torch_fused.build_fused_diffusion_rk4_end(cp, D_T, 3)
    y = torch.ones((129, 129, 1))
    np.testing.assert_array_equal(
        end(y).numpy(),
        torch_fused.build_fused_diffusion_rk4_trajectory(cp, D_T, 3)(y)[
            -1
        ].numpy(),
    )
    assert torch_fused.fused_diffusion_step_applicable(cp, RK4())
    assert torch_resident.make_resident_plan(129, 129) is not None
    assert not torch_tiled.takes_streaming_path(cp)


def test_wrappers_run_the_plain_version_for_cpu_tensors():
    _, cp = _problems("flagship")
    cfg = torch_fused._KernelConfig(cp, D_T)
    y = torch.as_tensor(_states(cp, batch=2)[..., 0])
    wrappers = (
        torch_fused.fused_diffusion_rk4_trajectory,
        torch_fused.fused_diffusion_rk4_end,
        torch_fused.fused_diffusion_rk4_step,
    )
    launches = [w.launches for w in wrappers]
    np.testing.assert_array_equal(
        torch_fused.fused_diffusion_rk4_trajectory(y, cfg, 4).numpy(),
        torch_fused.fused_diffusion_rk4_trajectory_reference(
            y, cfg, 4
        ).numpy(),
    )
    np.testing.assert_array_equal(
        torch_fused.fused_diffusion_rk4_end(y[0], cfg, 4).numpy(),
        torch_fused.fused_diffusion_rk4_trajectory_reference(
            y[0], cfg, 4
        )[-1].numpy(),
    )
    np.testing.assert_array_equal(
        torch_fused.fused_diffusion_rk4_step(y, cfg).numpy(),
        torch_fused.fused_diffusion_rk4_end_reference(y, cfg, 1).numpy(),
    )
    # no kernel ran, so no launch was counted
    assert [w.launches for w in wrappers] == launches


def test_wrappers_reject_what_the_kernel_does_not_take():
    _, cp = _problems("flagship")
    cfg = torch_fused._KernelConfig(cp, D_T)
    y = torch.zeros(cp.mesh.vertices_shape, dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        torch_fused.fused_diffusion_rk4_end(y.double(), cfg, 2)
    with pytest.raises(ValueError, match="shape"):
        torch_fused.fused_diffusion_rk4_end(y[:-1], cfg, 2)
    with pytest.raises(ValueError, match="contiguous"):
        torch_fused.fused_diffusion_rk4_end(
            torch.zeros((21, 42), dtype=torch.float32)[:, ::2], cfg, 2
        )


@pytest.mark.parametrize("builder", ["trajectory", "end", "step"])
def test_built_functions_reject_float64_states(builder):
    # a float64 state is refused, never silently run in float32
    _, cp = _problems("flagship")
    built = {
        "trajectory": lambda: torch_fused.build_fused_diffusion_rk4_trajectory(
            cp, D_T, 2
        ),
        "end": lambda: torch_fused.build_fused_diffusion_rk4_end(cp, D_T, 2),
        "step": lambda: torch_fused.build_fused_diffusion_rk4_step(cp, D_T),
    }[builder]()
    y = torch.as_tensor(_states(cp), dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        built(y)


def test_batched_k1_and_k2_serve_the_packed_diffusion_kernel(x64_off):
    """The JAX package's K4 diffusion family (its packed kernel over
    Parareal's slices) has no port of its own: the port's Parareal takes
    the batched K2 end for every iteration's fine ends and the batched K1
    trajectory for the final expansion. Their plain versions against the
    JAX packed trajectory in interpret mode over 3 slices of the flagship
    problem, to 1e-5: the trajectory frame by frame, the end against its
    last frame."""
    from pararealml_tpu.ops import packed_system as jax_packed

    jax_cp, torch_cp = _problems("flagship")
    steps, batch = 10, 3
    ys = _states(jax_cp, batch=batch)
    expected = np.asarray(
        jax_packed.build_packed_system_rk4_trajectory(
            jax_cp, D_T, steps, batch, interpret=True
        )(ys)
    )
    trajectory = torch_fused.build_fused_diffusion_rk4_trajectory(
        torch_cp, D_T, steps
    )(torch.as_tensor(ys))
    end = torch_fused.build_fused_diffusion_rk4_end(
        torch_cp, D_T, steps, batch=batch
    )(torch.as_tensor(ys))
    _assert_close(trajectory, expected)
    _assert_close(end, expected[:, -1])


# -- K1-K3's plans: plain Python, no kernel and no Pallas call -------------

# the plan make_k1_plan picks for each grid the plan sweep measured
# (tools/k1_plan_sweep.py) and for grids between them (the rule: the
# layout of the entry nearest in cells), by (height, width, batch)
EXPECTED_PLANS = {
    (21, 21, 1): "strips: 21 rows",
    (21, 21, 8): "cells: 448 threads x 1",
    (17, 17, 1): "cells: 320 threads x 1",
    (17, 40, 1): "cells: 800 threads x 1",
    (3, 3, 1): "strips: 3 rows",
    (51, 51, 1): "cells: 928 threads x 4",
    (104, 104, 1): "cells: 992 threads x 11",
    # between the entries: 5 x 5 takes the 3 x 3 entry's strips, 17 x 17
    # slices the B = 8 entry's one cell a thread, 41 x 41 and 90 x 90 the
    # 51 x 51 and 104 x 104 entries' four and eleven cells a thread
    (5, 5, 1): "strips: 5 rows",
    (17, 17, 8): "cells: 320 threads x 1",
    (41, 41, 1): "cells: 448 threads x 4",
    (90, 90, 1): "cells: 768 threads x 11",
}


@pytest.mark.parametrize("key", sorted(EXPECTED_PLANS))
def test_make_k1_plan_picks_the_measured_plan(key):
    height, width, batch = key
    assert str(torch_fused.make_k1_plan(height, width, batch)) == (
        EXPECTED_PLANS[key]
    )


def test_table_plans_fit_the_card():
    """Every table plan covers its grid within 1,024 threads and a
    block's 232,448 B of shared memory, and every instance the source
    builds (the cells a thread its registers are compiled for) holds
    1,024 threads without a spill, with and without convection."""
    for (height, width, _), plan in torch_fused._MEASURED_PLANS.items():
        assert plan.covers(height, width), plan
        assert plan.threads <= 1024
        assert plan.shared_bytes(height, width) <= 232_448
    instances = [("cells", c) for c in torch_fused.CELLS_INSTANCES]
    for layout, cells in instances + [("strips", 0)]:
        for convection in (False, True):
            registers, spills = INSTANCE_REGISTERS[
                (layout, cells, convection)
            ]
            assert 1024 * registers <= 65_536, (layout, cells)
            assert spills == 0, (layout, cells)
    k1_keys = [key for key in INSTANCE_REGISTERS if key[0] != "navier_stokes"]
    assert len(k1_keys) == 2 * len(instances) + 2


def _admitted_shapes():
    """Grids the one-CTA gate admits: for each height, the widest it
    admits and a few narrower ones, and the narrowest and tallest."""
    shapes = set()
    for height in list(range(3, 40)) + list(range(40, 3300, 37)):
        if not torch_fused.fits_one_block(height, 3):
            break
        width = 3
        step = 1024
        while step:
            if torch_fused.fits_one_block(height, width + step):
                width += step
            else:
                step //= 2
        shapes |= {(height, width), (height, 3), (height, max(3, width // 2))}
        if height < 40:
            shapes |= {(height, w) for w in range(3, min(width, 40) + 1)}
    return sorted(shapes)


def test_every_admitted_grid_has_a_plan():
    shapes = _admitted_shapes()
    assert (104, 104) in shapes or any(h * w >= 10_816 for h, w in shapes)
    for height, width in shapes:
        for batch in (1, 8):
            plan = torch_fused.make_k1_plan(height, width, batch)
            assert plan is not None, (height, width, batch)
            assert plan.covers(height, width), (plan, height, width)
    # and nothing past the gate
    assert torch_fused.make_k1_plan(129, 129) is None


@pytest.mark.parametrize(
    "shape", [(21, 21), (17, 17), (17, 40), (3, 3), (51, 51), (104, 104)]
)
def test_ownership_covers_every_cell_once(shape):
    """The plain model of the layouts' ownership: on the chosen plan, the
    strips plan and a few cells plans of the grid, every cell is owned
    exactly once, and each band's halo rows are the rows next to it, which
    its neighbours own."""
    height, width = shape
    chosen = torch_fused.make_k1_plan(height, width)
    plans = [chosen] + [
        plan
        for plan in torch_fused.k1_plans(height, width)
        if plan.layout == "strips" or plan.threads in (32, 1024)
    ]
    for plan in plans:
        owners, halos = torch_fused.ownership(plan, height, width)
        cells = list(owners.values())
        assert len(cells) == len(set(cells)) == height * width, plan
        if plan.layout == "cells":
            # interior cells first: a thread's cells past the interior
            # count are face cells
            interior = (height - 2) * (width - 2)
            for (thread, slot), (i, j) in owners.items():
                q = thread + slot * plan.threads
                on_face = i in (0, height - 1) or j in (0, width - 1)
                assert on_face == (q >= interior)
            continue
        assert len(halos) == plan.threads // 32 == height
        bands = {}
        for (thread, _), (i, _) in owners.items():
            bands.setdefault(thread // 32, set()).add(i)
        for band, ((first, end), above, below) in enumerate(halos):
            assert bands[band] == set(range(first, end)) == {band}
            assert above == (first - 1 if band else None)
            assert below == (end if band < height - 1 else None)
            if above is not None:
                assert above in bands[band - 1]
            if below is not None:
                assert below in bands[band + 1]


def test_wrappers_refuse_a_plan_that_does_not_cover_the_grid():
    _, cp = _problems("flagship")
    cfg = torch_fused._KernelConfig(cp, D_T)
    y = torch.zeros(cp.mesh.vertices_shape, dtype=torch.float32)
    # too few threads for the instance's cells, and strips of 8 rows for
    # 21 rows
    for plan in (
        torch_fused.K1Plan("cells", 32, cells=1),
        torch_fused.K1Plan("strips", 256),
    ):
        with pytest.raises(ValueError, match="does not cover"):
            torch_fused.fused_diffusion_rk4_end(y, cfg, 2, plan=plan)
