"""Splits a Jacobi sweep and an RK4 stage of the Navier-Stokes kernel
(``csrc/fused_navier_stokes.cu``) into their segments on the example's
grid.

``ncu`` does not run on the card's host, so this tool builds a copy of
the kernel's source with ``-DNS_SWEEP_SPLIT``: lane 0 of every warp of
block 0 (rank 0 of the first state's cluster) then adds the ``clock64()``
cycles it spends in each segment to a buffer, with the sweeps it computed
and replayed and the groups it ran, and its thread 0 stamps the
globaltimer and ``clock64()`` at the start and the end of the step loop,
which gives the block's cycles a microsecond.

The case is ``examples/navier_stokes_fdm.py`` (101 x 81 x 4, d_t 0.05,
Jacobi to 1e-3) from its state after 100 steps, over 200 steps, on the
measured plan and on the same plan with groups of one sweep. It prints,
for each, the time a step without stamps (CUDA events), the counted
sweeps, the sweeps computed and replayed and the groups, and each
segment's cycles (the mean over the block's warps and the largest) and
microseconds: per counted sweep for the solve's segments (the halo copy,
the reduction, the barrier and the decision once a group, spread over
its counted sweeps), per stage for the stages' and per step for the
step's end.

Run it from the repository root on a machine with one CUDA card:
``python3 tools/ns_sweep_split.py [results.json]`` (under a minute, most
of it the build). ``chip_smoke.py`` calls :func:`run` too.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import pararealml_tpu_torch as prml  # noqa: E402
from pararealml_tpu_torch.ops import cuda_library  # noqa: E402
from pararealml_tpu_torch.ops import fused_navier_stokes as ns  # noqa: E402

DEFINE = "-DNS_SWEEP_SPLIT"
SOURCE = "fused_navier_stokes.cu"
# the segment names, in the kernel's split order, and what each is
# counted per: a stage ("stage"), a counted sweep ("sweep") or a step
SEGMENTS = (
    ("stage arithmetic", "stage"),
    ("stage cluster barrier", "stage"),
    ("halo copy", "sweep"),
    ("stencil and update", "sweep"),
    ("in-block reduction", "sweep"),
    ("cluster barrier", "sweep"),
    ("remote partials and decision", "sweep"),
    ("replay", "sweep"),
    ("step end", "step"),
    ("step-end barrier", "step"),
)
COUNTS = ("computed sweeps", "replayed sweeps", "groups")
START_STEPS = 100
STEPS = 200


def build_split_library() -> ctypes.CDLL:
    """Builds (once per source) and loads the instrumented copy of the
    kernel's source under ``build/``."""
    source_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "pararealml_tpu_torch",
        "csrc",
    )
    digest = hashlib.sha256(
        " ".join(cuda_library.NVCC_FLAGS + (DEFINE,)).encode()
    )
    for name in [SOURCE] + sorted(
        entry for entry in os.listdir(source_dir) if entry.endswith(".cuh")
    ):
        with open(os.path.join(source_dir, name), "rb") as f:
            digest.update(f.read())
    path = os.path.join(
        cuda_library.BUILD_DIR,
        f"fused_navier_stokes_split-{digest.hexdigest()[:16]}.so",
    )
    if not os.path.exists(path):
        os.makedirs(cuda_library.BUILD_DIR, exist_ok=True)
        partial = f"{path}.{os.getpid()}.partial"
        subprocess.run(
            [
                cuda_library._nvcc(),
                *cuda_library.NVCC_FLAGS,
                DEFINE,
                "-o",
                partial,
                os.path.join(source_dir, SOURCE),
            ],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(partial, path)
    library = ctypes.CDLL(path)
    ns._configure(library)
    library.fused_navier_stokes_split_buffers.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    library.fused_navier_stokes_split_buffers.restype = ctypes.c_int
    library.fused_navier_stokes_split_columns.restype = ctypes.c_int
    return library


def split(cfg, y, n_steps, library, sums, clock, **plan):
    """Runs one trajectory of ``n_steps`` through the instrumented library;
    returns the recorded block's per-warp sums ((warps, columns) int64 on
    the CPU), its clock stamps (four int64) and the counted sweeps."""
    sums.zero_()
    clock.zero_()
    error = library.fused_navier_stokes_split_buffers(
        sums.data_ptr(), clock.data_ptr()
    )
    if error != 0:
        raise RuntimeError(f"fused_navier_stokes_split_buffers failed "
                           f"({error})")
    built = ns.load_kernels
    ns.load_kernels = lambda: library
    try:
        ns.fused_navier_stokes_rk4_trajectory(y, cfg, n_steps, **plan)
        torch.cuda.synchronize()
    finally:
        ns.load_kernels = built
        library.fused_navier_stokes_split_buffers(None, None)
    return (
        sums.cpu(),
        clock.cpu(),
        int(ns.fused_navier_stokes_rk4_trajectory.sweeps),
    )


def plans(cfg):
    """(label, wrapper keyword arguments) of each plan split: the measured
    plan and the same plan with groups of one sweep (one norm a sweep, the
    schedule of the kernel before its groups)."""
    for group in dict.fromkeys((cfg.plan.group, 1)):
        plan = cfg.plan._replace(group=group)
        yield str(plan), {"plan": plan}


def run(device, card, log=print):
    """Splits a sweep and a stage of the example's solve from its state
    after ``START_STEPS`` steps, for each plan; logs and returns one dict
    a plan."""
    library = build_split_library()
    columns = library.fused_navier_stokes_split_columns()
    ivp = chip_smoke.navier_stokes_problem(prml)
    cfg = ns._NavierStokesConfig(ivp.constrained_problem, chip_smoke.NS_D_T)
    y_0 = torch.as_tensor(
        ivp.initial_condition.discrete_y_0(True),
        dtype=torch.float32,
        device=device,
    )
    y = ns.fused_navier_stokes_rk4_trajectory(y_0, cfg, START_STEPS)[
        -1
    ].contiguous()
    results = []
    for label, plan in plans(cfg):
        ms = chip_smoke.cuda_ms(
            torch,
            lambda: ns.fused_navier_stokes_rk4_trajectory(
                y, cfg, STEPS, **plan
            ),
        )
        sweeps = int(ns.fused_navier_stokes_rk4_trajectory.sweeps)
        sums = torch.zeros((32, columns), dtype=torch.int64, device=device)
        clock = torch.zeros(4, dtype=torch.int64, device=device)
        # a warm run, then the measured one
        split(cfg, y, STEPS, library, sums, clock, **plan)
        cycles, stamps, split_sweeps = split(
            cfg, y, STEPS, library, sums, clock, **plan
        )
        assert split_sweeps == sweeps, (split_sweeps, sweeps)
        warps = cycles[cycles[:, : len(SEGMENTS)].sum(dim=1) > 0].double()
        span_us = float(stamps[2] - stamps[0]) / 1e3
        rate = float(stamps[3] - stamps[1]) / span_us
        per = {"stage": 4 * STEPS, "sweep": sweeps, "step": STEPS}
        rows = []
        for index, (name, unit) in enumerate(SEGMENTS):
            column = warps[:, index] / per[unit]
            rows.append(
                dict(
                    segment=name,
                    per=unit,
                    cycles=float(column.mean()),
                    max_cycles=float(column.max()),
                    us=float(column.mean()) / rate,
                )
            )
        counts = {
            name: int(warps[0, len(SEGMENTS) + index])
            for index, name in enumerate(COUNTS)
        }
        sweep_us = sum(r["us"] for r in rows if r["per"] == "sweep")
        stage_us = sum(r["us"] for r in rows if r["per"] == "stage")
        result = dict(
            case="navier-stokes 101x81x4",
            plan=label,
            start_steps=START_STEPS,
            steps=STEPS,
            step_us=1e3 * ms / STEPS,
            sweeps=sweeps,
            span_us=span_us,
            cycles_per_us=rate,
            sweep_us=sweep_us,
            stage_us=stage_us,
            counts=counts,
            segments=rows,
        )
        results.append(result)
        log(
            f"ns split: 101 x 81 x 4, {label}, {STEPS} steps from step "
            f"{START_STEPS}: {result['step_us']:.3f} us a step without "
            f"stamps, {sweeps} counted sweeps ({counts}); with stamps the "
            f"loop spans {span_us:.3f} us at {rate:.0f} cycles a us; a "
            f"counted sweep {sweep_us:.3f} us, a stage {stage_us:.3f} us "
            f"[{card}]"
        )
        for row in rows:
            log(
                f"ns split:   {row['segment']:30s} {row['cycles']:9.1f} "
                f"cycles a {row['per']} (max over warps "
                f"{row['max_cycles']:9.1f}), {row['us']:.3f} us"
            )
        del sums, clock
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("ns_sweep_split.py needs a CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    results = run(torch.device("cuda", 0), card)
    paths = sys.argv[1:]
    if paths:
        with open(paths[0], "w") as f:
            json.dump(dict(card=card, results=results), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
