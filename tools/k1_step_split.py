"""Splits a step of the fused diffusion kernel (K1) into index setup,
neighbour loads, face handling, stage arithmetic, the Dirichlet select and
stage write, the barrier wait, the frame store, and the load and end
store.

``ncu`` does not run on the card's host, so this tool builds a copy of
``pararealml_tpu_torch/csrc/fused_diffusion.cu`` with ``-DK1_STEP_SPLIT``:
every warp of the first block then adds the ``clock64()`` cycles it
spends in each segment to sums that lane 0 writes out at its exit, and
the first thread stamps the globaltimer at the block's entry and exit. A
mark closes its segment once the value it names has arrived, so a load's
latency lands in the segment that issued it. The tool runs one K1
trajectory of each case through the instrumented build and prints, per
step, the cycles of each segment (the mean over the warps and the
largest) and its microseconds (cycles over the rate the warps ran at:
their cycles over the block's span), beside the step time of the library
build without stamps (CUDA events). The stamps cost time of their own:
the instrumented span is printed beside the plain step time. On the
redesigned kernel the full split's marks (eight a stage) double a step,
so the tool also builds a coarse split (``-DK1_STEP_SPLIT=2``: neighbour
loads, the rest of the stage, the barrier and the frame store, with no
marks inside the arithmetic) that stays nearer the plain step; read the
full split's segments only against its own instrumented span.

The cases: the flagship's 21 x 21 diffusion problem (bench.py's
``build_problem``, d_t 1e-3) and the 17 x 17 convection-diffusion
problem of ``tests/test_fused_diffusion.py`` (d_t 1e-3), from their
initial conditions, each on the plan the wrappers pick.

Run it from the repository root on a machine with one CUDA card:
``python3 tools/k1_step_split.py [results.json]`` (about a minute, most
of it the two builds). ``chip_smoke.py`` calls :func:`run` too.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import pararealml_tpu_torch as prml  # noqa: E402
from pararealml_tpu_torch.ops import (  # noqa: E402
    cuda_library,
    fused_diffusion,
)

# the full and the coarse split's builds
DEFINES = {"full": "-DK1_STEP_SPLIT", "coarse": "-DK1_STEP_SPLIT=2"}
# the segments, in the kernel's kSplit* order
SEGMENTS = (
    "index setup",
    "neighbour loads",
    "face handling",
    "stage arithmetic",
    "Dirichlet select and stage write",
    "barrier wait",
    "frame store",
    "load and end store",
)
# the coarse split's segments (its face and arithmetic marks are off:
# their time lands in the update segment)
COARSE_SEGMENTS = {
    "index setup": "index setup",
    "neighbour loads": "neighbour loads",
    "Dirichlet select and stage write": (
        "faces, arithmetic, Dirichlet select and stage write"
    ),
    "barrier wait": "barrier wait",
    "frame store": "frame store",
    "load and end store": "load and end store",
}
STEPS = 2000
# the most warps a block has
_WARPS = 32


def _build(define: str) -> ctypes.CDLL:
    """Builds (once per source) and loads an instrumented copy of
    ``fused_diffusion.cu`` under ``build/``."""
    source_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "pararealml_tpu_torch",
        "csrc",
    )
    digest = hashlib.sha256(
        " ".join(cuda_library.NVCC_FLAGS + (define,)).encode()
    )
    for name in ["fused_diffusion.cu"] + sorted(
        entry for entry in os.listdir(source_dir) if entry.endswith(".cuh")
    ):
        with open(os.path.join(source_dir, name), "rb") as f:
            digest.update(f.read())
    path = os.path.join(
        cuda_library.BUILD_DIR,
        f"fused_diffusion_split-{digest.hexdigest()[:16]}.so",
    )
    if not os.path.exists(path):
        os.makedirs(cuda_library.BUILD_DIR, exist_ok=True)
        partial = f"{path}.{os.getpid()}.{threading.get_ident()}.partial"
        subprocess.run(
            [
                cuda_library._nvcc(),
                *cuda_library.NVCC_FLAGS,
                define,
                "-o",
                partial,
                os.path.join(source_dir, "fused_diffusion.cu"),
            ],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(partial, path)
    library = ctypes.CDLL(path)
    fused_diffusion._configure(library)
    library.fused_diffusion_split_buffers.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    library.fused_diffusion_split_buffers.restype = ctypes.c_int
    library.fused_diffusion_split_segments.restype = ctypes.c_int
    return library


def build_split_library():
    """Builds both instrumented copies at once (one nvcc each); returns
    them by split ("full", "coarse")."""
    libraries = {}
    errors = []

    def build(level):
        try:
            libraries[level] = _build(DEFINES[level])
        except Exception as error:  # re-raised below, in the caller
            errors.append(error)

    threads = [
        threading.Thread(target=build, args=(level,)) for level in DEFINES
    ]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    return libraries


def cases():
    """(label, constrained problem, initial condition) of each case."""
    ivp = chip_smoke.flagship(prml)
    yield "flagship 21x21", ivp.constrained_problem, ivp.initial_condition
    problems, initial = chip_smoke.kernel_problems(prml)
    yield (
        "convection-diffusion 17x17",
        problems["convection"],
        initial["convection"],
    )


def split(cfg, y, n_steps, library, sums, span):
    """Runs one K1 trajectory of ``n_steps`` through the instrumented
    library; returns the warps' segment sums ((warps, segments) int64 on
    the CPU) and the block's entry and exit (globaltimer ns)."""
    sums.zero_()
    span.zero_()
    error = library.fused_diffusion_split_buffers(
        sums.data_ptr(), span.data_ptr()
    )
    if error != 0:
        raise RuntimeError(f"fused_diffusion_split_buffers failed ({error})")
    built = fused_diffusion.load_kernels
    fused_diffusion.load_kernels = lambda: library
    try:
        fused_diffusion.fused_diffusion_rk4_trajectory(y, cfg, n_steps)
        torch.cuda.synchronize()
    finally:
        fused_diffusion.load_kernels = built
        library.fused_diffusion_split_buffers(None, None)
    return sums.cpu(), span.cpu()


def _segments(cycles, stamps, steps, names):
    """The rows of one split: each named segment's mean and largest
    cycles over the warps (a step, or in all for the load and end store)
    and its microseconds; and the warps, their cycles a µs and the
    instrumented span."""
    warps = cycles[cycles.sum(dim=1) > 0].double()
    span_us = float(stamps[1] - stamps[0]) / 1e3
    # cycles a microsecond of the warps: their whole run over the block's
    # span
    rate = float(warps.sum(dim=1).mean()) / span_us
    rows = []
    for index, name in enumerate(SEGMENTS):
        if name not in names:
            continue
        column = warps[:, index] / (
            1 if name == "load and end store" else steps
        )
        mean = float(column.mean())
        rows.append(
            dict(
                segment=names[name],
                cycles=mean,
                max_cycles=float(column.max()),
                us=mean / rate,
            )
        )
    return rows, int(warps.shape[0]), rate, span_us


def run(device, card, log=print, steps=STEPS):
    """Splits a K1 step of each case on the wrappers' plan, fully and
    coarsely, logs both; returns one dict per case."""
    libraries = build_split_library()
    for library in libraries.values():
        segments = library.fused_diffusion_split_segments()
        assert segments == len(SEGMENTS), segments
    splits = (
        ("full", {name: name for name in SEGMENTS}),
        ("coarse", COARSE_SEGMENTS),
    )
    results = []
    for label, cp, initial in cases():
        cfg = fused_diffusion._KernelConfig(cp, chip_smoke.FINE_D_T)
        y = torch.as_tensor(
            initial.discrete_y_0(True)[..., 0],
            dtype=torch.float32,
            device=device,
        ).contiguous()
        step_ms = chip_smoke.cuda_ms(
            torch,
            lambda: fused_diffusion.fused_diffusion_rk4_trajectory(
                y, cfg, steps
            ),
        )
        sums = torch.zeros(
            (_WARPS, len(SEGMENTS)), dtype=torch.int64, device=device
        )
        span = torch.zeros(2, dtype=torch.int64, device=device)
        plan = cfg.plan(1)
        result = dict(
            case=label,
            steps=steps,
            plan=str(plan),
            step_us=1e3 * step_ms / steps,
        )
        for level, names in splits:
            library = libraries[level]
            # a warm run, then the measured one
            split(cfg, y, steps, library, sums, span)
            cycles, stamps = split(cfg, y, steps, library, sums, span)
            rows, warps, rate, span_us = _segments(
                cycles, stamps, steps, names
            )
            result[level] = dict(
                warps=warps,
                instrumented_step_us=span_us / steps,
                cycles_per_us=rate,
                segments=rows,
            )
            log(
                f"k1 split ({level}): {label}, {steps} steps, {plan}: "
                f"{result['step_us']:.3f} us a step without stamps, "
                f"{span_us / steps:.3f} with them; {warps} warps at "
                f"{rate:.0f} cycles a us [{card}]"
            )
            for row in rows:
                unit = (
                    "cycles in all"
                    if row["segment"] == "load and end store"
                    else "cycles a step"
                )
                log(
                    f"k1 split ({level}):   {row['segment']:34s} "
                    f"{row['cycles']:10.1f} {unit} (max over warps "
                    f"{row['max_cycles']:10.1f}), {row['us']:.3f} us"
                )
        results.append(result)
        del y, sums, span
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_step_split.py needs a CUDA card", file=sys.stderr)
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
