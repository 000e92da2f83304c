"""Measures the fused 3D kernel's (K9's) plan table on the card: times K9
on the 3D main path's volumes at every cluster size and cells-a-thread
choice its instances take, and asks the card how many clusters of each
size it holds at once.

For each case it first holds every plan's output over a few steps against
K9's plain version (0.0 is expected: ``-fmad=false``), then times the
trajectory (or, for the batched case, the end) at each plan, and prints
the fastest, whose cluster size and cells a thread ``_MEASURED_PLANS_3D``
of ``ops/fused_system_3d.py`` records, and the counts of
``fused_system_3d_max_active_clusters`` that
``_MEASURED_ACTIVE_CLUSTERS_3D`` records.

The cases: bench.py's ``bench_3d`` Burgers problem (21^3 x 3, d_t 0.01),
``examples/cahn_hilliard_3d_fdm.py`` (31^3 x 2, d_t 0.05), the 3D
Parareal's fine ends (B = 8 x 21^3 x 3, 250 steps), and the largest cube
of each component count the JAX package's cap admits (76^3 diffusion,
56^3 wave and Cahn-Hilliard, 48^3 Burgers; 20 steps from random states,
clusters of 8 blocks or more).

:func:`turns` times the plan the wrappers pick against the 8- and 4-block
plans of the same kernel on those cases, in turns (chosen, 8, 4, 4, 8,
chosen); ``chip_smoke.py`` calls it.

Run it from the repository root on a machine with one CUDA card:
``python3 tools/k9_plan_sweep.py [results.json]`` (about three
minutes).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import pararealml_tpu_torch as prml  # noqa: E402
from pararealml_tpu_torch.ops import (  # noqa: E402
    cuda_library,
    fused_system_3d as k9,
)

STEPS = 500
LARGE_STEPS = 20
CHECK_STEPS = 5
# the largest cube of each component count the JAX cap admits, and the
# smallest cluster size swept on them
LARGE_CUBES = (
    ("diffusion", 76),
    ("wave", 56),
    ("cahn-hilliard", 56),
    ("burgers", 48),
)
LARGE_MIN_CLUSTER = 8
LARGE_D_T = 1e-6
END_BATCH = chip_smoke.PARAREAL_3D_SLICES
END_STEPS = chip_smoke.BURGERS_3D_STEPS // chip_smoke.PARAREAL_3D_SLICES


def cases(device, large=False):
    """(label, config, states ((B, D, H, W, n) on the card), batched) of
    each case; with ``large`` also the largest cubes."""
    burgers = chip_smoke.burgers_3d(prml)
    ch = chip_smoke.cahn_hilliard_3d(torch, prml, STEPS)
    burgers_cfg = k9._SystemKernelConfig3D(
        burgers.constrained_problem, chip_smoke.BURGERS_3D_D_T
    )

    def initial(ivp):
        return torch.as_tensor(
            ivp.initial_condition.discrete_y_0(True),
            dtype=torch.float32,
            device=device,
        )[None].contiguous()

    y = initial(burgers)
    yield "burgers 21^3 x 3", burgers_cfg, y, False
    yield (
        "cahn-hilliard 31^3 x 2",
        k9._SystemKernelConfig3D(ch.constrained_problem, chip_smoke.CH_3D_D_T),
        initial(ch),
        False,
    )
    slices = torch.cat(
        [y * (1.0 - 0.01 * i) for i in range(END_BATCH)]
    ).contiguous()
    yield f"burgers 21^3 x 3 ends B={END_BATCH}", burgers_cfg, slices, True
    if large:
        # the largest cube of each component count the JAX cap admits
        for family, edge in LARGE_CUBES:
            cp = chip_smoke.problem_3d(prml, family, True, (edge,) * 3)
            # a step small enough that random states stay finite
            cfg = k9._SystemKernelConfig3D(cp, LARGE_D_T)
            ys = torch.as_tensor(
                np.random.default_rng(0).uniform(
                    -1.0, 1.0, (1,) + cfg.state_shape
                ),
                dtype=torch.float32,
                device=device,
            )
            yield f"{family} {edge}^3 x {cfg.n}", cfg, ys, False


def plans(cfg):
    """Every plan of the kernel's instances for ``cfg``'s volume."""
    for size in range(1, k9.MAX_CLUSTER_SIZE + 1):
        for cells in k9.CELLS:
            if size > cfg.depth:
                continue
            plan = k9.cluster_plan_3d(
                cfg.depth,
                cfg.height,
                cfg.width,
                cfg.n,
                size,
                cells,
                cfg.step_kind,
            )
            if plan.fits:
                yield plan


def _kernel(cfg, ys, batched, n_steps, plan):
    if batched:
        return lambda: k9.fused_system_3d_rk4_end(ys, cfg, n_steps, plan=plan)
    return lambda: k9.fused_system_3d_rk4_trajectory(
        ys[0], cfg, n_steps, plan=plan
    )


def run(device, card, log=print):
    cuda_library.build_libraries(["fused_system_3d"])
    for line in cuda_library.build_logs.get("fused_system_3d", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas fused_system_3d: {line.strip()}")
    results = []
    for label, cfg, ys, batched in cases(device, large=True):
        large = cfg.depth * cfg.height * cfg.width > 50_000
        n_steps = END_STEPS if batched else (LARGE_STEPS if large else STEPS)
        active = k9.card_active_clusters_3d(cfg, not batched)
        chosen = k9.launch_plan(cfg, ys.shape[0], not batched)
        expected = k9.fused_system_3d_rk4_trajectory_reference(
            ys, cfg, CHECK_STEPS
        )
        rows = []
        for plan in plans(cfg):
            if large and plan.cluster_size < LARGE_MIN_CLUSTER:
                continue
            out = k9.fused_system_3d_rk4_trajectory(
                ys, cfg, CHECK_STEPS, plan=plan
            )
            end = k9.fused_system_3d_rk4_end(ys, cfg, CHECK_STEPS, plan=plan)
            torch.cuda.synchronize()
            error = max(
                float((out - expected).abs().max()),
                float((end - expected[:, -1]).abs().max()),
            )
            if error != 0.0:
                raise AssertionError(f"{label}: {plan} differs from plain")
            ms = chip_smoke.cuda_ms(
                torch, _kernel(cfg, ys, batched, n_steps, plan)
            )
            rows.append(
                dict(
                    cluster_size=plan.cluster_size,
                    cells=plan.cells,
                    threads=plan.threads,
                    cells_per_thread=plan.cells_per_thread,
                    active_clusters=active(plan),
                    step_us=1e3 * ms / n_steps,
                    max_abs_err=error,
                )
            )
            log(
                f"sweep: {label}: cluster {plan.cluster_size:2d} x "
                f"{plan.threads:4d} threads, {plan.cells} cells a thread "
                f"({plan.cells_per_thread} held): {1e3 * ms / n_steps:.3f} "
                f"us a step, {active(plan)} clusters at once, max|d| vs "
                f"plain {error:.3e} [{card}]"
            )
        best = min(rows, key=lambda row: row["step_us"])
        log(
            f"sweep: {label}: fastest cluster {best['cluster_size']} "
            f"({best['cells']} cells a thread) {best['step_us']:.3f} us a "
            f"step; the plan's choice cluster {chosen.cluster_size} "
            f"({chosen.cells}) [{card}]"
        )
        results.append(
            dict(
                case=label,
                steps=n_steps,
                batch=ys.shape[0] if batched else None,
                plan=(chosen.cluster_size, chosen.cells),
                rows=rows,
            )
        )
    return results


def turns(device, card, log=print, reps=2):
    """Times the chosen plan against the 8- and 4-block plans (the fewest
    register cells that fit) on each case, in turns: chosen, 8, 4, 4, 8,
    chosen, ``reps`` times over; returns one dict a case with each plan's
    mean ms."""
    results = []
    for label, cfg, ys, batched in cases(device):
        n_steps = (
            END_STEPS
            if batched
            else (
                chip_smoke.CH_3D_STEPS
                if cfg.n == 2
                else chip_smoke.BURGERS_3D_STEPS
            )
        )
        chosen = k9.launch_plan(cfg, ys.shape[0], not batched)
        contenders = {"chosen": chosen}
        for size in (8, 4):
            contenders[f"{size} blocks"] = k9.cluster_plan_3d(
                cfg.depth,
                cfg.height,
                cfg.width,
                cfg.n,
                size,
                step=cfg.step_kind,
            )
        order = ["chosen", "8 blocks", "4 blocks"]
        times = {name: [] for name in order}
        for _ in range(reps):
            for name in order + order[::-1]:
                times[name].append(
                    chip_smoke.cuda_ms(
                        torch,
                        _kernel(cfg, ys, batched, n_steps, contenders[name]),
                        reps=3,
                    )
                )
        means = {name: sum(t) / len(t) for name, t in times.items()}
        results.append(
            dict(
                case=label,
                steps=n_steps,
                plans={
                    name: (plan.cluster_size, plan.cells)
                    for name, plan in contenders.items()
                },
                ms=means,
                all_ms=times,
            )
        )
        log(
            f"turns: {label}, {n_steps} steps: "
            + ", ".join(
                f"{name} ({contenders[name].cluster_size} x "
                f"{contenders[name].cells} cells) {means[name]:.3f} ms"
                for name in order
            )
            + f" (means of {2 * reps} turns) [{card}]"
        )
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("k9_plan_sweep.py needs a CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    device = torch.device("cuda", 0)
    results = run(device, card)
    counts = {}
    for label, cfg, ys, batched in cases(device):
        active = k9.card_active_clusters_3d(cfg, not batched)
        counts[label] = {
            plan.cluster_size: active(plan)
            for plan in plans(cfg)
            if plan.cells
            == k9.cluster_plan_3d(
                cfg.depth,
                cfg.height,
                cfg.width,
                cfg.n,
                plan.cluster_size,
                step=cfg.step_kind,
            ).cells
        }
        print(f"active clusters: {label}: {counts[label]} [{card}]")
    paths = sys.argv[1:]
    if paths:
        with open(paths[0], "w") as f:
            json.dump(dict(card=card, results=results, active=counts), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
