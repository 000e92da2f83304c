"""Splits a step of the fused 3D kernel (K9) into cell setup, neighbour
loads, face handling, stage arithmetic, the Dirichlet override and stage
write, cluster barriers, frame stores, and the slab load and end store.

``ncu`` does not run on the card's host, so this tool builds a copy of
``pararealml_tpu_torch/csrc/fused_system_3d.cu`` with ``-DK9_STEP_SPLIT``:
lane 0 of every warp of every block of the first state's cluster then
adds the ``clock64()`` cycles it spends in each segment to a sum, and the
first thread of every block stamps the globaltimer at its entry and exit,
so that the launch's span is known. A mark closes its segment once the
value it names has arrived, so a load's latency lands in the segment that
issued it. The tool runs one K9 trajectory of each case through the
instrumented build and prints, per step, the cycles of each segment (the
mean over the recorded warps and the largest), its microseconds (cycles
over the rate the recorded warps ran at: their cycles over the launch's
span), beside the step time of the library build without stamps (CUDA
events). The stamps cost time of their own: the instrumented span is
printed beside the plain step time.

The cases are the main path's two volumes: bench.py's ``bench_3d``
Burgers problem (21^3 x 3, d_t 0.01) and
``examples/cahn_hilliard_3d_fdm.py`` (31^3 x 2, d_t 0.05), from their
initial conditions, each on the plan the wrappers pick.

Run it from the repository root on a machine with one CUDA card:
``python3 tools/k9_step_split.py [results.json]`` (under a minute, most
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
from pararealml_tpu_torch.ops import (  # noqa: E402
    cuda_library,
    fused_system_3d,
)

DEFINE = "-DK9_STEP_SPLIT"
# the segments, in the kernel's kSplit* order
SEGMENTS = (
    "cell setup",
    "neighbour loads",
    "face handling",
    "stage arithmetic",
    "Dirichlet override and stage write",
    "cluster barriers",
    "frame stores",
    "slab load and end store",
)
STEPS = 300
# the most blocks a cluster has and warps a block has
_RANKS = 16
_WARPS = 32
# an initial span start above any globaltimer reading (atomicMin lowers it)
_NO_START = 2**63 - 1


def build_split_library() -> ctypes.CDLL:
    """Builds (once per source) and loads the instrumented copy of
    ``fused_system_3d.cu`` under ``build/``."""
    source_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "pararealml_tpu_torch",
        "csrc",
    )
    digest = hashlib.sha256(
        " ".join(cuda_library.NVCC_FLAGS + (DEFINE,)).encode()
    )
    for name in ["fused_system_3d.cu"] + sorted(
        entry for entry in os.listdir(source_dir) if entry.endswith(".cuh")
    ):
        with open(os.path.join(source_dir, name), "rb") as f:
            digest.update(f.read())
    path = os.path.join(
        cuda_library.BUILD_DIR,
        f"fused_system_3d_split-{digest.hexdigest()[:16]}.so",
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
                os.path.join(source_dir, "fused_system_3d.cu"),
            ],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(partial, path)
    library = ctypes.CDLL(path)
    fused_system_3d._configure(library)
    library.fused_system_3d_split_buffers.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    library.fused_system_3d_split_buffers.restype = ctypes.c_int
    library.fused_system_3d_split_segments.restype = ctypes.c_int
    return library


def cases(device):
    """(label, config, initial state) of each case."""
    ivp = chip_smoke.burgers_3d(prml)
    yield (
        "burgers 21^3 x 3",
        fused_system_3d._SystemKernelConfig3D(
            ivp.constrained_problem, chip_smoke.BURGERS_3D_D_T
        ),
        ivp,
    )
    ivp = chip_smoke.cahn_hilliard_3d(torch, prml, STEPS)
    yield (
        "cahn-hilliard 31^3 x 2",
        fused_system_3d._SystemKernelConfig3D(
            ivp.constrained_problem, chip_smoke.CH_3D_D_T
        ),
        ivp,
    )


def split(cfg, y, n_steps, library, sums, span):
    """Runs one K9 trajectory of ``n_steps`` through the instrumented
    library; returns the recorded warps' segment sums ((ranks, warps,
    segments) int64 on the CPU) and the launch's first entry and last
    exit (globaltimer ns)."""
    sums.zero_()
    span[0] = _NO_START
    span[1] = 0
    error = library.fused_system_3d_split_buffers(
        sums.data_ptr(), span.data_ptr()
    )
    if error != 0:
        raise RuntimeError(f"fused_system_3d_split_buffers failed ({error})")
    built = fused_system_3d.load_kernels
    fused_system_3d.load_kernels = lambda: library
    try:
        fused_system_3d.fused_system_3d_rk4_trajectory(y, cfg, n_steps)
        torch.cuda.synchronize()
    finally:
        fused_system_3d.load_kernels = built
        library.fused_system_3d_split_buffers(None, None)
    return sums.cpu(), span.cpu()


def run(device, card, log=print, steps=STEPS):
    """Splits a K9 step of each case on the wrappers' plan, logs it;
    returns one dict per case."""
    library = build_split_library()
    segments = library.fused_system_3d_split_segments()
    assert segments == len(SEGMENTS), segments
    results = []
    for label, cfg, ivp in cases(device):
        y = torch.as_tensor(
            ivp.initial_condition.discrete_y_0(True),
            dtype=torch.float32,
            device=device,
        ).contiguous()
        step_ms = chip_smoke.cuda_ms(
            torch,
            lambda: fused_system_3d.fused_system_3d_rk4_trajectory(
                y, cfg, steps
            ),
        )
        sums = torch.zeros(
            (_RANKS, _WARPS, segments), dtype=torch.int64, device=device
        )
        span = torch.zeros(2, dtype=torch.int64, device=device)
        # a warm run, then the measured one
        split(cfg, y, steps, library, sums, span)
        cycles, stamps = split(cfg, y, steps, library, sums, span)
        flat = cycles.reshape(-1, segments)
        warps = flat[flat.sum(dim=1) > 0].double()
        span_us = float(stamps[1] - stamps[0]) / 1e3
        # cycles a microsecond of the recorded warps: their whole run
        # over the launch's span
        rate = float(warps.sum(dim=1).mean()) / span_us
        rows = []
        for index, name in enumerate(SEGMENTS):
            column = warps[:, index] / (
                1 if name == "slab load and end store" else steps
            )
            mean = float(column.mean())
            rows.append(
                dict(
                    segment=name,
                    cycles=mean,
                    max_cycles=float(column.max()),
                    us=mean / rate,
                )
            )
        chosen = fused_system_3d.launch_plan(cfg, 1, True)
        result = dict(
            case=label,
            steps=steps,
            plan=str(chosen),
            warps=int(warps.shape[0]),
            step_us=1e3 * step_ms / steps,
            instrumented_step_us=span_us / steps,
            cycles_per_us=rate,
            segments=rows,
        )
        results.append(result)
        log(
            f"k9 split: {label}, {steps} steps, {chosen}: "
            f"{result['step_us']:.3f} us a step without stamps, "
            f"{result['instrumented_step_us']:.3f} with them; "
            f"{result['warps']} warps recorded at {rate:.0f} cycles a "
            f"us [{card}]"
        )
        for row in rows:
            unit = (
                "cycles in all"
                if row["segment"] == "slab load and end store"
                else "cycles a step"
            )
            log(
                f"k9 split:   {row['segment']:36s} {row['cycles']:10.1f} "
                f"{unit} (max over warps {row['max_cycles']:10.1f}), "
                f"{row['us']:.3f} us"
            )
        del y, sums, span
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("k9_step_split.py needs a CUDA card", file=sys.stderr)
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
