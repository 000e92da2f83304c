"""Measures the cluster-resident mode's plan table on the card: times the
mode on the 2D examples' grids at every cluster size and cells-a-thread
choice its instances take, beside per-step K8 in turns, and asks the card
how many clusters of each size it holds at once.

For each case it first holds every plan's output over a few steps against
the mode's plain version (K5's), then times the trajectory (or, for the
batched case, the end) at each plan, and prints the fastest, whose
cluster size and cells a thread ``_MEASURED_CLUSTERS`` of
``ops/fused_system.py`` records, and the counts of
``cluster_system_max_active_clusters`` that ``_MEASURED_ACTIVE_CLUSTERS``
records.

The cases: ``examples/wave_2d_fdm.py`` (101 x 101 x 2),
``examples/shallow_water_fdm.py`` (101 x 51 x 3),
``examples/cahn_hilliard_2d_fdm.py`` (101 x 101 x 2),
``examples/wave_polar_fdm.py`` (51 x 201 x 2), and the wave example's
8-slice Parareal fine ends (B = 8 x 101 x 101 x 2, 250 steps).

Run it from the repository root on a machine with one CUDA card:
``python3 tools/cluster_plan_sweep.py [results.json]`` (about three
minutes).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import pararealml_tpu_torch as prml  # noqa: E402
from pararealml_tpu_torch.ops import (  # noqa: E402
    cuda_library,
    fused_system,
    tiled_system,
)

STEPS = 1000
CHECK_STEPS = 10
END_BATCH = 8
END_STEPS = 250


def cases():
    """(label, constrained problem, d_t, batch or None, steps) of each
    case."""
    ivp, d_t = chip_smoke.wave_example(prml)
    yield "wave 101x101x2", ivp.constrained_problem, d_t, None, STEPS
    ivp, d_t = chip_smoke.shallow_water_example(prml)
    yield "shallow water 101x51x3", ivp.constrained_problem, d_t, None, STEPS
    ivp = chip_smoke.cahn_hilliard_2d(torch, prml, 101, 1.0)
    yield "cahn-hilliard 101x101x2", ivp.constrained_problem, 5e-4, None, STEPS
    ivp, d_t = chip_smoke.wave_polar_example(prml)
    yield "polar wave 51x201x2", ivp.constrained_problem, d_t, None, STEPS
    ivp, d_t = chip_smoke.wave_example(prml)
    yield (
        f"wave 101x101x2 ends B={END_BATCH}",
        ivp.constrained_problem,
        d_t,
        END_BATCH,
        END_STEPS,
    )


def plans(cfg):
    """Every plan of the mode's instances for ``cfg``'s grid."""
    for size in range(1, fused_system.MAX_CLUSTER_SIZE + 1):
        for cells in fused_system._CLUSTER_CELLS:
            plan = fused_system.ClusterPlan(
                cfg.height, cfg.width, cfg.n, cfg.polar, size, cells
            )
            if plan.fits and plan.cluster_size > 1:
                yield plan


def run(device, card, log=print):
    cuda_library.build_libraries(["cluster_system", "tiled_system"])
    for line in cuda_library.build_logs.get("cluster_system", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas cluster_system: {line.strip()}")
    results = []
    for label, cp, d_t, batch, n_steps in cases():
        cfg = fused_system._SystemKernelConfig(cp, d_t)
        tcfg = tiled_system._TiledSystemConfig(cp, d_t)
        shape = cp.mesh.vertices_shape
        ys = chip_smoke.smooth_states_2d(
            torch, device, shape, cfg.n, batch=batch or 1
        )
        active = fused_system.card_active_clusters(cfg, batch is None)
        chosen = fused_system.cluster_plan(cfg, batch or 1, None, active)
        expected = fused_system.fused_system_rk4_trajectory_reference(
            ys, cfg, CHECK_STEPS
        )
        rows = []
        for plan in plans(cfg):
            out = fused_system.cluster_system_rk4_trajectory(
                ys, cfg, CHECK_STEPS, plan=plan
            )
            torch.cuda.synchronize()
            error = float((out - expected).abs().max())
            if batch is None:
                def kernel(plan=plan):
                    return fused_system.cluster_system_rk4_trajectory(
                        ys[0], cfg, n_steps, plan=plan
                    )
            else:
                def kernel(plan=plan):
                    return fused_system.cluster_system_rk4_end(
                        ys, cfg, n_steps, plan=plan
                    )
            ms = chip_smoke.cuda_ms(torch, kernel)
            rows.append(
                dict(
                    cluster_size=plan.cluster_size,
                    cells=plan.cells,
                    threads=plan.threads,
                    active_clusters=active(plan),
                    step_us=1e3 * ms / n_steps,
                    max_abs_err=error,
                )
            )
            log(
                f"sweep: {label}: cluster {plan.cluster_size:2d} x "
                f"{plan.threads:3d} threads, {plan.cells} cells a thread: "
                f"{1e3 * ms / n_steps:.3f} us a step, {active(plan)} "
                f"clusters at once, max|d| vs plain {error:.3e} [{card}]"
            )
            if batch is not None:
                end = fused_system.cluster_system_rk4_end(
                    ys, cfg, CHECK_STEPS, plan=plan
                )
                torch.cuda.synchronize()
                error = max(error, float((end - expected[:, -1]).abs().max()))
            if error != 0.0:
                raise AssertionError(f"{label}: {plan} differs from plain")
        if batch is None:
            def k8():
                return tiled_system.tiled_system_rk4_trajectory(
                    ys[0], tcfg, n_steps
                )
        else:
            def k8():
                return tiled_system.tiled_system_rk4_end(ys, tcfg, n_steps)
        k8_ms = chip_smoke.cuda_ms(torch, k8)
        best = min(rows, key=lambda row: row["step_us"])
        log(
            f"sweep: {label}: fastest cluster {best['cluster_size']} "
            f"({best['cells']} cells a thread) {best['step_us']:.3f} us a "
            f"step; the plan's choice cluster {chosen.cluster_size} "
            f"({chosen.cells}); per-step K8 {1e3 * k8_ms / n_steps:.3f} us a "
            f"step [{card}]"
        )
        results.append(
            dict(
                case=label,
                steps=n_steps,
                batch=batch,
                plan=(chosen.cluster_size, chosen.cells),
                k8_step_us=1e3 * k8_ms / n_steps,
                rows=rows,
            )
        )
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_plan_sweep.py needs a CUDA card", file=sys.stderr)
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
