"""Times the tiled system kernel (K8) over 50-60 tilings at several grid
sizes, for the table of tiles its plan takes
(``pararealml_tpu_torch/ops/tiled_system.py``, ``_MEASURED_TILES``).

For each family (wave, Burgers, shallow water, Cahn-Hilliard) and grid
(101², 201², 321², 641², 1025², and 101 x 51 for shallow water), and for
the polar wave example's problem (``examples/wave_polar_fdm.py``, 51 x
201), it times one K8 trajectory of a few hundred steps (CUDA events, the
median of 5 after a warm run) on every tiling of ``ROWS`` x ``COLS`` cells
of shared memory that fits a block, and prints the plan's tiling and time
beside the six fastest; given a path, it also writes every time there as
JSON.

Run it from the repository root on a machine with one CUDA card:
``python3 tools/k8_tile_sweep.py [--polar] [results.json]``. It takes
about two minutes on an H100; ``--polar`` times the polar case alone.
"""

import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import pararealml_tpu_torch as prml  # noqa: E402
from pararealml_tpu_torch.ops import fused_system, tiled_system  # noqa: E402

FAMILIES = {
    "wave": "dirichlet",
    "burgers": "neumann",
    "shallow-water": "partial",
    "cahn-hilliard": "neumann",
}
# grid: steps timed
GRIDS = {
    (101, 101): 1000,
    (101, 51): 1000,
    (201, 201): 500,
    (321, 321): 300,
    (641, 641): 200,
    (1025, 1025): 60,
}
# the polar wave example at its own grid: steps timed
POLAR_STEPS = 1000
ROWS = (6, 8, 10, 12, 16, 20, 24, 32, 48, 64)
COLS = (16, 24, 32, 48, 64, 96, 128)


def cases(polar_only):
    """(label, constrained problem, steps) of every timed case."""
    if not polar_only:
        for family, faces in FAMILIES.items():
            for shape, steps in GRIDS.items():
                if shape == (101, 51) and family != "shallow-water":
                    continue
                cp = chip_smoke.system_problem_2d(prml, family, faces, shape)
                yield f"{family} {shape[0]}x{shape[1]}", family, cp, steps
    ivp, _ = chip_smoke.wave_polar_example(prml)
    yield "polar wave 51x201", "polar-wave", ivp.constrained_problem, (
        POLAR_STEPS
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_tile_sweep.py needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = chip_smoke.card_line()
    print(card, flush=True)
    arguments = sys.argv[1:]
    polar_only = "--polar" in arguments
    paths = [a for a in arguments if a != "--polar"]
    k8 = tiled_system.tiled_system_rk4_trajectory
    results = []
    for label, family, cp, steps in cases(polar_only):
        shape = cp.mesh.vertices_shape
        cfg = tiled_system._TiledSystemConfig(cp, 1e-4)
        y = chip_smoke.smooth_states_2d(torch, device, shape, cfg.n)
        times = []
        for rows, cols in itertools.product(ROWS, COLS):
            plan = cfg.plan._replace(rows=rows, cols=cols)
            if (
                plan.tile_h <= 0
                or plan.tile_w <= 0
                or plan.shared_bytes
                > fused_system.MAX_SHARED_MEMORY_BYTES
            ):
                continue
            ms = chip_smoke.cuda_ms(
                torch, lambda: k8(y, cfg, steps, plan=plan), reps=5
            )
            times.append((1e3 * ms / steps, rows, cols, plan.blocks))
        times.sort()
        chosen = (cfg.plan.rows, cfg.plan.cols)
        chosen_us = next(t for t, r, c, _ in times if (r, c) == chosen)
        fastest = ", ".join(
            f"{rows}x{cols} {us:.3f}" for us, rows, cols, _ in times[:6]
        )
        ratio = chosen_us / times[0][0]
        print(
            f"{label}: plan {chosen[0]}x"
            f"{chosen[1]} {chosen_us:.3f} us a step ({ratio:.3f} x the "
            f"fastest); fastest, us a step: {fastest} [{card}]",
            flush=True,
        )
        results.append(
            dict(family=family, shape=shape, plan=chosen, times=times)
        )
        del y
        torch.cuda.empty_cache()
    if paths:
        with open(paths[0], "w") as f:
            json.dump(dict(card=card, results=results), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
