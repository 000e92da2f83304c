"""Splits a step of the whole-grid system kernel (K5) into its load, the
arithmetic of each stage, each block barrier and the final store.

``ncu`` does not run on the card's host, so this tool builds a copy of
``pararealml_tpu_torch/csrc/fused_system.cu`` with ``-DK5_STEP_SPLIT``:
lane 0 of every warp of the first block then sums the ``clock64()``
cycles it spends in each segment of a solve and writes the sums to a
buffer. It runs one K5 trajectory on each case with the instrumented
build, reads the sums, and prints, per step, the cycles each segment
takes (the mean over the warps and the largest), its share of the step
and its microseconds (cycles scaled by the instrumented kernel's
CUDA-event time), beside the step time of the library build without
stamps. A stage's arithmetic ends when the warp has written its cells; a
barrier's segment is the warp's wait there for the block's slowest warp.

The cases are the main paths' K5 shapes: bench.py's 2D Burgers problem
(21 x 21 x 2, d_t 2.5e-3, one cell a thread) and
``examples/shallow_water_polar_fdm.py``'s problem (36 x 51 x 3, d_t
0.0025, more cells than a block has threads).

Run it from the repository root on a machine with one CUDA card:
``python3 tools/k5_step_split.py [results.json]`` (about a minute, most
of it the two builds). ``chip_smoke.py`` calls :func:`run` too.
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
from pararealml_tpu_torch.ops import cuda_library, fused_system  # noqa: E402

DEFINE = "-DK5_STEP_SPLIT"
# the segment names of an RK4 step and of a Cahn-Hilliard step, in the
# kernel's kSplitSegments order (unused segments are None)
RK4_SEGMENTS = (
    "load",
    "stage 1",
    "barrier 1",
    "stage 2",
    "barrier 2",
    "stage 3",
    "barrier 3",
    "stage 4 + frame store",
    "barrier 4",
    "end store",
)
CAHN_HILLIARD_SEGMENTS = (
    "load",
    "stage 1",
    "barrier 1",
    "stage 2 + frame store",
    "barrier 2",
    None,
    None,
    None,
    None,
    "end store",
)
# each case: label, the problem builder, d_t and steps timed
STEPS = {"burgers 21x21x2": 2000, "shallow water polar 36x51x3": 1000}


def build_split_library() -> ctypes.CDLL:
    """Builds (once per source) and loads the instrumented copy of
    ``fused_system.cu`` under ``build/``."""
    source_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "pararealml_tpu_torch",
        "csrc",
    )
    digest = hashlib.sha256(
        " ".join(cuda_library.NVCC_FLAGS + (DEFINE,)).encode()
    )
    for name in ["fused_system.cu"] + sorted(
        entry for entry in os.listdir(source_dir) if entry.endswith(".cuh")
    ):
        with open(os.path.join(source_dir, name), "rb") as f:
            digest.update(f.read())
    path = os.path.join(
        cuda_library.BUILD_DIR,
        f"fused_system_split-{digest.hexdigest()[:16]}.so",
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
                os.path.join(source_dir, "fused_system.cu"),
            ],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(partial, path)
    library = ctypes.CDLL(path)
    fused_system._configure(library)
    library.fused_system_split_buffer.argtypes = [ctypes.c_void_p]
    library.fused_system_split_buffer.restype = ctypes.c_int
    library.fused_system_split_segments.restype = ctypes.c_int
    return library


def cases():
    """(label, constrained problem, d_t, float32 initial state on the
    CPU) of each case."""
    ivp = chip_smoke.burgers(prml)
    yield "burgers 21x21x2", ivp, chip_smoke.BURGERS_FINE_D_T
    ivp, d_t = chip_smoke.shallow_water_polar_example(prml)
    yield "shallow water polar 36x51x3", ivp, d_t


def split(cfg, y, n_steps, library, sums):
    """Runs one K5 trajectory of ``n_steps`` through the instrumented
    library and returns its per-warp segment sums ((warps, segments)
    int64 on the CPU) and its CUDA-event time in ms."""
    sums.zero_()
    error = library.fused_system_split_buffer(sums.data_ptr())
    if error != 0:
        raise RuntimeError(f"fused_system_split_buffer failed ({error})")
    out = fused_system.trajectory_buffer(y[None], cfg, n_steps)
    built = fused_system.load_kernels
    fused_system.load_kernels = lambda: library
    try:
        ms = chip_smoke.once_ms(
            torch,
            lambda: fused_system.launch(
                y[None], out, cfg, n_steps, write_trajectory=True
            ),
        )
    finally:
        fused_system.load_kernels = built
        library.fused_system_split_buffer(None)
    return sums.cpu(), ms


def run(device, card, log=print):
    """Splits a step of each case and logs the split; returns one dict
    per case."""
    library = build_split_library()
    segments = library.fused_system_split_segments()
    results = []
    for label, ivp, d_t in cases():
        cp = ivp.constrained_problem
        cfg = fused_system._SystemKernelConfig(cp, d_t)
        y = torch.as_tensor(
            ivp.initial_condition.discrete_y_0(True),
            dtype=torch.float32,
            device=device,
        ).contiguous()
        n_steps = STEPS[label]
        plain_ms = chip_smoke.cuda_ms(
            torch,
            lambda: fused_system.fused_system_rk4_trajectory(y, cfg, n_steps),
        )
        sums = torch.zeros((32, segments), dtype=torch.int64, device=device)
        # a warm run, then the measured one
        split(cfg, y, n_steps, library, sums)
        cycles, stamped_ms = split(cfg, y, n_steps, library, sums)
        warps = cycles[cycles.sum(dim=1) > 0].double()
        names = (
            RK4_SEGMENTS
            if cfg.equation_type is not prml.CahnHilliardEquation
            else CAHN_HILLIARD_SEGMENTS
        )
        total = float(warps.sum(dim=1).mean())
        # cycles a microsecond, from the stamped kernel's event time
        rate = total / (1e3 * stamped_ms)
        rows = []
        for index, name in enumerate(names):
            if name is None:
                continue
            column = warps[:, index]
            per_step = 1.0 if name in ("load", "end store") else n_steps
            mean = float(column.mean()) / per_step
            rows.append(
                dict(
                    segment=name,
                    cycles=mean,
                    max_cycles=float(column.max()) / per_step,
                    share=float(column.mean()) / total,
                    us=mean / rate,
                )
            )
        result = dict(
            case=label,
            steps=n_steps,
            warps=int(warps.shape[0]),
            step_us=1e3 * plain_ms / n_steps,
            stamped_step_us=1e3 * stamped_ms / n_steps,
            cycles_per_us=rate,
            segments=rows,
        )
        results.append(result)
        log(
            f"k5 split: {label}, {n_steps} steps, {result['warps']} warps: "
            f"{result['step_us']:.3f} us a step ({result['stamped_step_us']:.3f} "
            f"with stamps, {rate:.0f} cycles a us) [{card}]"
        )
        for row in rows:
            unit = "the solve" if row["segment"] in ("load", "end store") else (
                "a step"
            )
            log(
                f"k5 split:   {row['segment']:22s} {row['cycles']:9.1f} "
                f"cycles {unit} (max over warps {row['max_cycles']:9.1f}), "
                f"{100 * row['share']:5.1f}% of the solve, {row['us']:.3f} us"
            )
        del y, sums
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_step_split.py needs a CUDA card", file=sys.stderr)
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
