"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

Drives ``pararealml_tpu_torch`` — never JAX — through the diffusion_2d
Parareal flagship at its full size (21 x 21 grid, Dirichlet 1.5 on the x
faces, zero-flux y faces, a Gaussian of amplitude 1000, RK4 with fine
d_t 1e-3 to T = 40, tolerance 2.5e-3):

1. builds the hand-written CUDA kernels from ``pararealml_tpu_torch/csrc``
   and holds each (K1 trajectory, K2 end, K3 step) against its plain
   PyTorch version on the same CUDA tensors, on three problems, and on
   the flagship at the shapes and step counts the main path gives K1
   and K2;
2. runs the main path with every launch counter at 0: the sequential
   fine solve through ``FDMOperator.solve``, then Parareal with 8 slices
   (coarse d_t 1e-2), 100 slices (coarse d_t 5e-2) and 8 slices with the
   affine propagators off; it reads the counters right after and checks
   that K1 and K2, the kernels of the path, were launched (K3, the
   single step, is not on this path, as in the JAX package), then checks
   the outputs against the fine trajectory and the fine trajectory
   against the affine propagator's;
3. times each with CUDA events (warm, median of 5);
4. profiles each run with ``torch.profiler`` and prints the device's
   busy time (the union of its kernel and copy intervals) and idle share
   (1 - busy / the CUDA-event time of phase 3).

Run it from the repository root with no arguments: ``python3
chip_smoke.py``. It needs one CUDA card and ``nvcc`` and exits non-zero,
printing no result, without them. The line before last is the card's
name and power limit as nvidia-smi gives them; before it, one JSON line
lists the path's kernels; the last line is ``{"ok": true, "device":
...}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

T_END = 40.0
FINE_D_T = 1e-3
TOLERANCE = 2.5e-3
KERNEL_REL_TOL = 1e-5
SOURCE = "pararealml_tpu_torch/csrc/fused_diffusion.cu"
JAX_KERNELS = "pararealml_tpu/ops/fused_diffusion.py"
# the main path's kernels: (name, the Pallas kernel it replaces in the
# JAX package)
KERNELS = (
    ("fused_diffusion_rk4_trajectory", f"{JAX_KERNELS}:363"),
    ("fused_diffusion_rk4_end", f"{JAX_KERNELS}:538"),
)
# ported and checked here, but not on the main path (in neither package)
STEP_KERNEL = "fused_diffusion_rk4_step"


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]


def flagship(prml, t_end=T_END):
    """The diffusion_2d Parareal flagship (bench.py:build_problem)."""
    bcs = [
        (
            prml.DirichletBoundaryCondition(
                lambda x, t: np.full((len(x), 1), 1.5), is_static=True
            ),
        )
        * 2,
        (
            prml.NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 1)), is_static=True
            ),
        )
        * 2,
    ]
    cp = prml.ConstrainedProblem(
        prml.DiffusionEquation(2, 1.0),
        prml.Mesh([(0.0, 10.0), (0.0, 10.0)], [0.5, 0.5]),
        bcs,
    )
    ic = prml.GaussianInitialCondition(
        cp, [(np.full(2, 5.0), np.eye(2))], [1000.0]
    )
    return prml.InitialValueProblem(cp, (0.0, t_end), ic)


def kernel_problems(prml):
    """The flagship, an all-Neumann problem with a constant flux, and a
    convection-diffusion problem (tests/test_fused_diffusion.py)."""
    neumann = prml.ConstrainedProblem(
        prml.DiffusionEquation(2, 0.3),
        prml.Mesh([(0.0, 4.0), (0.0, 4.0)], [0.25, 0.25]),
        [
            (
                prml.NeumannBoundaryCondition(
                    lambda x, t: np.full((len(x), 1), 0.5), is_static=True
                ),
            )
            * 2
        ]
        * 2,
    )
    convection = prml.ConstrainedProblem(
        prml.ConvectionDiffusionEquation(2, [0.8, -0.4], 0.3),
        prml.Mesh([(0.0, 4.0), (0.0, 4.0)], [0.25, 0.25]),
        [
            (
                prml.DirichletBoundaryCondition(
                    lambda x, t: np.zeros((len(x), 1)), is_static=True
                ),
            )
            * 2,
            (
                prml.NeumannBoundaryCondition(
                    lambda x, t: np.full((len(x), 1), 0.2), is_static=True
                ),
            )
            * 2,
        ],
    )
    problems = {"flagship": flagship(prml).constrained_problem}
    problems["neumann"] = neumann
    problems["convection"] = convection
    initial = {
        "flagship": flagship(prml).initial_condition,
        "neumann": prml.GaussianInitialCondition(
            neumann, [(np.array([1.5, 2.5]), 0.5 * np.eye(2))], [10.0]
        ),
        "convection": prml.GaussianInitialCondition(
            convection, [(np.full(2, 2.0), 0.5 * np.eye(2))], [10.0]
        ),
    }
    return problems, initial


def cuda_ms(torch, fn, reps=5):
    """Median CUDA-event time of ``fn()`` in ms, after one warm run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy_ms(torch, fn, reps=3):
    """``fn()``'s device busy time per run in ms under torch.profiler —
    the union of the intervals of every kernel, copy and fill it ran —
    with the three names of most device time, after one warm run; None
    when the profiler saw nothing on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        spans.append((event.time_range.start, event.time_range.end))
        by_name[event.name] = (
            by_name.get(event.name, 0.0) + event.time_range.elapsed_us()
        )
    if not spans:
        return None, ""
    busy_us, covered = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > covered:
            busy_us += end - max(start, covered)
            covered = end
    total = sum(by_name.values())
    top = ", ".join(
        f"{name[:40]} {100.0 * us / total:.0f}%"
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    )
    return busy_us / reps / 1e3, top


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print(
            "chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is "
            "false",
            file=sys.stderr,
        )
        return 1

    import sympy

    import pararealml_tpu_torch as prml
    from pararealml_tpu_torch.operators.fdm import (
        RK4,
        FDMOperator,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu_torch.operators.parareal import PararealOperator
    from pararealml_tpu_torch.ops import cuda_library
    from pararealml_tpu_torch.ops import fused_diffusion as fd

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, sympy {sympy.__version__}, "
        f"capability {torch.cuda.get_device_capability(device)}"
    )

    start = time.perf_counter()
    fd.load_kernels()
    log(
        f"kernel library ready in {time.perf_counter() - start:.2f} s "
        f"(nvcc: {cuda_library.build_seconds.get('fused_diffusion', 0.0):.2f}"
        " s)"
    )
    build_log = cuda_library.build_logs.get("fused_diffusion", "")
    for line in build_log.splitlines():
        if "registers" in line:
            log(f"  ptxas: {line.strip()}")

    names = [name for name, _ in KERNELS] + [STEP_KERNEL]
    wrappers = {name: getattr(fd, name) for name in names}
    errors = {name: 0.0 for name in names}

    # -- phase 1: every kernel against its plain version -----------------
    problems, initial = kernel_problems(prml)
    for label, cp in problems.items():
        cfg = fd._KernelConfig(cp, FINE_D_T)
        y = torch.as_tensor(
            initial[label].discrete_y_0(True)[..., 0],
            dtype=torch.float32,
            device=device,
        ).contiguous()
        batch = torch.stack(
            [y * (0.5 + 0.125 * i) + 0.1 * i for i in range(8)]
        ).contiguous()
        checks = [
            ("fused_diffusion_rk4_trajectory", y, "200 steps", 200),
            ("fused_diffusion_rk4_end", y, "single, 200 steps", 200),
            ("fused_diffusion_rk4_end", batch, "B=8, 200 steps", 200),
            (STEP_KERNEL, batch, "B=8", None),
        ]
        if label == "flagship":
            # the main path's own shapes: the batched final expansion
            # and fine ends of 8 slices x 5000 fine steps, and one coarse
            # slice of 500 steps
            checks += [
                ("fused_diffusion_rk4_trajectory", batch, "B=8, 5000 steps",
                 5000),
                ("fused_diffusion_rk4_end", batch, "B=8, 5000 steps", 5000),
                ("fused_diffusion_rk4_end", y, "single, 500 steps", 500),
            ]
        for name, state, what, n_steps in checks:
            args = (state, cfg) if n_steps is None else (state, cfg, n_steps)
            kernel = wrappers[name](*args)
            plain = getattr(fd, f"{name}_reference")(*args)
            torch.cuda.synchronize()
            assert kernel.shape == plain.shape, (name, what)
            abs_err = float((kernel - plain).abs().max())
            rel_err = abs_err / float(plain.abs().max())
            errors[name] = max(errors[name], abs_err)
            log(
                f"kernels: {label:10s} {name} ({what}): "
                f"max|d|/max|y| = {rel_err:.3e}"
            )
            if not rel_err <= KERNEL_REL_TOL:
                raise AssertionError(
                    f"{name} disagrees with its plain version on {label}"
                )
    log("phase kernels: ok")

    # -- phase 2: the main path, counted ---------------------------------
    ivp = flagship(prml)
    cp = ivp.constrained_problem
    y_0 = torch.as_tensor(
        ivp.initial_condition.discrete_y_0(True),
        dtype=torch.float32,
        device=device,
    )

    def fdm(d_t, linear_propagator=True):
        return FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            d_t,
            linear_propagator=linear_propagator,
            device=device,
            dtype=torch.float32,
        )

    configs = [
        ("8 slices, coarse d_t 1e-2", 8, 1e-2, True),
        ("100 slices, coarse d_t 5e-2", 100, 5e-2, True),
        ("8 slices, coarse d_t 1e-2, linear_propagator=False", 8, 1e-2,
         False),
    ]
    f = fdm(FINE_D_T)
    parareals = [
        (
            label,
            PararealOperator(
                fdm(FINE_D_T, linear_propagator),
                fdm(coarse_d_t, linear_propagator),
                TOLERANCE,
                num_time_slices=n,
            ),
        )
        for label, n, coarse_d_t, linear_propagator in configs
    ]

    for wrapper in wrappers.values():
        wrapper.launches = 0
    fine = f.solve(ivp).discrete_y()
    fine_launches = {name: w.launches for name, w in wrappers.items()}
    solutions = []
    for label, parareal in parareals:
        solutions.append(parareal.solve(ivp).discrete_y())
    launches = {name: w.launches for name, w in wrappers.items()}

    log(f"main-path launches: {launches} (fine solve alone: {fine_launches})")
    assert fine_launches["fused_diffusion_rk4_trajectory"] >= 1
    # only the run with the propagators off reaches the end kernel
    assert fine_launches["fused_diffusion_rk4_end"] == 0
    for name, _ in KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    assert fine.shape == (40000, 21, 21, 1), fine.shape
    assert np.isfinite(fine).all()
    assert np.all(fine[:, 0, :, 0] == 1.5) and np.all(fine[:, -1, :, 0] == 1.5)
    propagated, _ = f.trajectory_function(cp, (0.0, T_END), time_parallel=True)
    affine_diff = float(
        np.abs(propagated(y_0).cpu().numpy() - fine).max()
    )
    log(
        f"phase fine: trajectory {fine.shape}, Dirichlet faces 1.5, "
        f"max|fused - affine propagator| = {affine_diff:.3e}"
    )
    assert affine_diff <= TOLERANCE
    fine_device = torch.as_tensor(fine, dtype=torch.float32, device=device)

    diffs = []
    for (label, parareal), ys in zip(parareals, solutions):
        assert ys.shape == fine.shape and np.isfinite(ys).all(), label
        diff = float(np.abs(ys - fine).max())
        log(
            f"phase parareal: {label}: {parareal.last_iterations} "
            f"iterations, max diff vs fine {diff:.3e}"
        )
        diffs.append(diff)
    assert diffs[0] <= 4e-3, diffs[0]

    # -- phase 3: times (CUDA events, warm, median of 5) ------------------
    fine_fn, _ = f.trajectory_function(cp, (0.0, T_END))
    runs = {"fine": lambda: fine_fn(y_0)}
    fine_ms = cuda_ms(torch, runs["fine"])
    run_ms = {"fine": fine_ms}
    log(f"time: fine solve, K1 kernel, 40000 steps: {fine_ms:.3f} ms [{card}]")

    cfg = fd._KernelConfig(cp, FINE_D_T)
    y_grid = y_0[..., 0].contiguous()
    slice_batch = y_grid.expand(8, 21, 21).contiguous()
    timings = {
        "fused_diffusion_rk4_trajectory": (
            "21x21, 2000 steps",
            lambda: fd.fused_diffusion_rk4_trajectory(y_grid, cfg, 2000),
            lambda: fd.fused_diffusion_rk4_trajectory_reference(
                y_grid, cfg, 2000
            ),
        ),
        "fused_diffusion_rk4_end": (
            "21x21, 500 steps (one coarse slice)",
            lambda: fd.fused_diffusion_rk4_end(y_grid, cfg, 500),
            lambda: fd.fused_diffusion_rk4_end_reference(y_grid, cfg, 500),
        ),
        STEP_KERNEL: (
            "21x21, 1 step",
            lambda: fd.fused_diffusion_rk4_step(y_grid, cfg),
            lambda: fd.fused_diffusion_rk4_step_reference(y_grid, cfg),
        ),
    }
    kernel_ms = {}
    for name, (what, kernel, plain) in timings.items():
        kernel_ms[name] = (cuda_ms(torch, kernel), cuda_ms(torch, plain))
        log(
            f"time: {name} ({what}): kernel {kernel_ms[name][0]:.3f} ms, "
            f"plain {kernel_ms[name][1]:.3f} ms [{card}]"
        )
    batched_end_ms = cuda_ms(
        torch, lambda: fd.fused_diffusion_rk4_end(slice_batch, cfg, 5000)
    )
    log(
        "time: fused_diffusion_rk4_end (B=8, 5000 steps: one iteration's "
        f"fine ends): kernel {batched_end_ms:.3f} ms [{card}]"
    )
    for (label, parareal), diff in zip(parareals, diffs):
        program, _ = parareal.trajectory_function(cp, (0.0, T_END))
        runs[label] = lambda program=program: program(y_0)
        run_ms[label] = ms = cuda_ms(torch, runs[label])
        check = float((program(y_0) - fine_device).abs().max())
        assert abs(check - diff) <= 1e-3, (check, diff)
        log(
            f"time: parareal {label}: {ms:.3f} ms, speedup vs fused fine "
            f"{fine_ms / ms:.3f}x, {parareal.last_iterations} iterations "
            f"[{card}]"
        )

    # -- phase 4: device busy time and idle share (torch.profiler) -------
    for label, run in runs.items():
        busy_ms, top = device_busy_ms(torch, run)
        if busy_ms is None:
            log(f"profile: {label}: not measured (no device events)")
            continue
        log(
            f"profile: {label}: device busy {busy_ms:.3f} ms of "
            f"{run_ms[label]:.3f} ms, idle share "
            f"{1.0 - busy_ms / run_ms[label]:.3f}; top: {top} [{card}]"
        )

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": kernel_ms[name][0],
            "plain_ms": kernel_ms[name][1],
        }
        for name, replaces in KERNELS
    ]
    log(
        f"{STEP_KERNEL} (K3, replaces {JAX_KERNELS}:671, not on the main "
        f"path): launches {launches[STEP_KERNEL]}, max_abs_err "
        f"{errors[STEP_KERNEL]!r}, ms {kernel_ms[STEP_KERNEL][0]!r}, "
        f"plain_ms {kernel_ms[STEP_KERNEL][1]!r}"
    )
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
