"""Measures the Navier-Stokes kernel's plan table on the card: times the
kernel (``csrc/fused_navier_stokes.cu``) at every plan it takes on three
cases and prints the fastest, whose cluster size, group, threads and
cells a thread ``_MEASURED_PLANS`` of ``ops/fused_navier_stokes.py``
records.

A plan is a cluster size (1, 2, 4 or 8 blocks that an instance covers),
a group of Jacobi sweeps between cluster barriers (every one of
``GROUP_SIZES`` the plan admits and fits) and the cells a thread (every
one of ``CELLS_INSTANCES`` that covers a block's cells, on as few whole
warps as hold them). For each case
the tool first holds every plan's output over a few steps against the
plain version (0.0 apart, the same sweeps), then times the case's run at
each plan (CUDA events, the median of three after a warm run).

The cases: ``examples/navier_stokes_fdm.py``'s solve (101 x 81 x 4, 2,000
steps of 0.05 from rest: the trajectory), one iteration of its 8-slice
Parareal's fine ends (B = 8 states 8 steps apart along that solve, 8
steps each: the end), and the JAX tests' 17 x 17 problem (Re 500, an O(1)
state from a seed, 200 steps: the trajectory).

Run it from the repository root on a machine with one CUDA card:
``python3 tools/ns_plan_sweep.py [results.json]`` (about two minutes).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import pararealml_tpu_torch as prml  # noqa: E402
from pararealml_tpu_torch.ops import fused_navier_stokes as ns  # noqa: E402

CHECK_STEPS = 10
EXAMPLE_STEPS = 2000
SLICES = 8
SLICE_STEPS = 8
SMALL_STEPS = 200


def plans(height, width):
    """Every plan the kernel takes on an H x W grid, as the tool times
    them."""
    found = []
    for size in ns.CLUSTER_SIZES:
        if size > height or not ns.cluster_plan_2d(
            height, width, size, 1
        ).fits:
            continue
        for group in ns.GROUP_SIZES:
            for cells in ns.CELLS_INSTANCES:
                plan = ns.cluster_plan_2d(
                    height, width, size, group, cells=cells
                )
                if plan.fits:
                    found.append(plan)
    return found


def cases(device):
    """(label, config, state or batch, steps, trajectory, batch key) of
    each case."""
    ivp = chip_smoke.navier_stokes_problem(prml)
    cfg = ns._NavierStokesConfig(ivp.constrained_problem, chip_smoke.NS_D_T)
    y_0 = torch.as_tensor(
        ivp.initial_condition.discrete_y_0(True),
        dtype=torch.float32,
        device=device,
    )
    yield "navier-stokes 101x81x4 solve", cfg, y_0, EXAMPLE_STEPS, True, None
    frames = ns.fused_navier_stokes_rk4_trajectory(
        y_0, cfg, SLICES * SLICE_STEPS
    )
    starts = torch.cat(
        [y_0[None], frames[SLICE_STEPS - 1: -1: SLICE_STEPS]]
    ).contiguous()
    yield (
        f"navier-stokes 101x81x4 fine ends B={SLICES}",
        cfg,
        starts,
        SLICE_STEPS,
        False,
        SLICES,
    )
    small = ns._NavierStokesConfig(
        chip_smoke.navier_stokes_problem(prml, example=False),
        chip_smoke.NS_D_T,
    )
    state = torch.as_tensor(
        np.random.default_rng(0).uniform(-0.5, 0.5, (17, 17, 4)),
        dtype=torch.float32,
        device=device,
    )
    yield "navier-stokes 17x17x4", small, state, SMALL_STEPS, True, None


def run(device, card, log=print):
    """Checks and times every plan of each case; logs each and the
    fastest; returns one dict a case."""
    results = []
    for label, cfg, y, steps, trajectory, batch in cases(device):
        wrapper = (
            ns.fused_navier_stokes_rk4_trajectory
            if trajectory
            else ns.fused_navier_stokes_rk4_end
        )
        plain = (
            ns.fused_navier_stokes_rk4_trajectory_reference
            if trajectory
            else ns.fused_navier_stokes_rk4_end_reference
        )
        check_steps = min(steps, CHECK_STEPS)
        expected, expected_sweeps = plain(y, cfg, check_steps)
        rows = []
        for plan in plans(cfg.height, cfg.width):
            out = wrapper(y, cfg, check_steps, plan=plan)
            torch.cuda.synchronize()
            if not (
                torch.equal(out, expected)
                and torch.equal(wrapper.sweeps, expected_sweeps)
            ):
                raise AssertionError(
                    f"{label}: {plan} disagrees with the plain version"
                )
            ms = chip_smoke.cuda_ms(
                torch, lambda: wrapper(y, cfg, steps, plan=plan), reps=3
            )
            sweeps = int(wrapper.sweeps.sum())
            rows.append(
                dict(
                    cluster_size=plan.cluster_size,
                    group=plan.group,
                    threads=plan.block_threads,
                    cells=plan.block_cells,
                    shared_bytes=plan.shared_bytes,
                    ms=ms,
                    sweeps=sweeps,
                )
            )
            log(
                f"ns plans: {label}: {plan}: {ms:.3f} ms, {sweeps} sweeps "
                f"[{card}]"
            )
        best = min(rows, key=lambda row: row["ms"])
        log(
            f"ns plans: {label}: fastest {best['cluster_size']} blocks x "
            f"{best['threads']} threads x {best['cells']} cells, groups of "
            f"{best['group']}: {best['ms']:.3f} ms (table entry "
            f"({cfg.height}, {cfg.width}, {batch}): ({best['cluster_size']}, "
            f"{best['group']}, {best['threads']}, {best['cells']})) [{card}]"
        )
        results.append(
            dict(
                case=label,
                shape=(cfg.height, cfg.width),
                batch=batch,
                steps=steps,
                plans=rows,
                best=best,
            )
        )
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("ns_plan_sweep.py needs a CUDA card", file=sys.stderr)
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
