"""Splits a step of the tiled system kernel (K8) into the launch gap, the
tile load, the four stages, the block barriers and the frame store, and
times the whole-grid kernel (K5) on a thread block cluster on the same
states.

``ncu`` does not run on the card's host, so this tool builds a copy of
``pararealml_tpu_torch/csrc/tiled_system.cu`` with ``-DK8_STEP_SPLIT``:
lane 0 of every warp of the middle tile's block then adds the
``clock64()`` cycles it spends in each segment of a step to a buffer, and
the first thread of every block stamps the globaltimer at its entry and
its exit, so that each launch's span (first entry to last exit) and the
gap before the next launch are known. It runs one K8 trajectory on each
case with the instrumented build and prints, per step, the cycles of each
segment (the mean over the block's warps and the largest), its
microseconds (cycles over the rate the recorded block ran at: its cycles
a step over the launch's span), the span and the launch gap (the medians
over the launches), beside the step time of the library build without
stamps (CUDA events).

In the same run it times K5's cluster kernel on the same states with the
cluster size given (8 by default): the port admits K5 only where the
working set of its first design fits one block's 227 KB, so the tool
lifts that gate (``fused_system.MAX_SHARED_MEMORY_BYTES``) for its own
launches alone.

The cases are the 2D examples' grids: ``examples/wave_2d_fdm.py`` (101 x
101 x 2, d_t 0.01) and ``examples/shallow_water_fdm.py`` (101 x 51 x 3,
d_t 0.0025), from their initial conditions.

Run it from the repository root on a machine with one CUDA card:
``python3 tools/k8_step_split.py [results.json]`` (under a minute, most
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
    fused_system,
    tiled_system,
)

DEFINE = "-DK8_STEP_SPLIT"
# the segment names of an RK4 step, in the kernel's kSplitSegments order,
# and the part of the split each belongs to
SEGMENTS = (
    ("tile load", "load"),
    ("barrier after the load", "barriers"),
    ("stage 1", "stages"),
    ("barrier 1", "barriers"),
    ("stage 2", "stages"),
    ("barrier 2", "barriers"),
    ("stage 3", "stages"),
    ("barrier 3", "barriers"),
    ("stage 4", "stages"),
    ("barrier 4", "barriers"),
    ("frame store", "store"),
)
STEPS = 2000
K5_CLUSTER_SIZE = 8
# an initial span start above any globaltimer reading (atomicMin lowers it)
_NO_START = 2**63 - 1


def build_split_library() -> ctypes.CDLL:
    """Builds (once per source) and loads the instrumented copy of
    ``tiled_system.cu`` under ``build/``."""
    source_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "pararealml_tpu_torch",
        "csrc",
    )
    digest = hashlib.sha256(
        " ".join(cuda_library.NVCC_FLAGS + (DEFINE,)).encode()
    )
    for name in ["tiled_system.cu"] + sorted(
        entry for entry in os.listdir(source_dir) if entry.endswith(".cuh")
    ):
        with open(os.path.join(source_dir, name), "rb") as f:
            digest.update(f.read())
    path = os.path.join(
        cuda_library.BUILD_DIR,
        f"tiled_system_split-{digest.hexdigest()[:16]}.so",
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
                os.path.join(source_dir, "tiled_system.cu"),
            ],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(partial, path)
    library = ctypes.CDLL(path)
    tiled_system._configure(library)
    library.tiled_system_split_buffers.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    library.tiled_system_split_buffers.restype = ctypes.c_int
    library.tiled_system_split_segments.restype = ctypes.c_int
    return library


def cases():
    """(label, initial value problem, d_t) of each case."""
    ivp, d_t = chip_smoke.wave_example(prml)
    yield "wave 101x101x2", ivp, d_t
    ivp, d_t = chip_smoke.shallow_water_example(prml)
    yield "shallow water 101x51x3", ivp, d_t


def split(cfg, y, n_steps, library, sums, spans):
    """Runs one K8 trajectory of ``n_steps`` through the instrumented
    library; returns the recorded block's per-warp segment sums ((warps,
    segments) int64 on the CPU) and each launch's first entry and last
    exit ((n_steps, 2) globaltimer ns on the CPU)."""
    sums.zero_()
    spans[:, 0] = _NO_START
    spans[:, 1] = 0
    error = library.tiled_system_split_buffers(
        sums.data_ptr(), spans.data_ptr()
    )
    if error != 0:
        raise RuntimeError(f"tiled_system_split_buffers failed ({error})")
    built = tiled_system.load_kernels
    tiled_system.load_kernels = lambda: library
    try:
        tiled_system.tiled_system_rk4_trajectory(y, cfg, n_steps)
        torch.cuda.synchronize()
    finally:
        tiled_system.load_kernels = built
        library.tiled_system_split_buffers(None, None)
    return sums.cpu(), spans.cpu()


def k5_cluster_ms(cp, d_t, y, n_steps, cluster_size):
    """K5's trajectory of ``n_steps`` on a cluster of ``cluster_size``
    blocks, its gate lifted for this call alone: (CUDA-event ms, frames)."""
    cfg = fused_system._SystemKernelConfig(cp, d_t)
    out = fused_system.trajectory_buffer(y[None], cfg, n_steps)
    gate = fused_system.MAX_SHARED_MEMORY_BYTES
    fused_system.MAX_SHARED_MEMORY_BYTES = 2**62
    try:
        ms = chip_smoke.cuda_ms(
            torch,
            lambda: fused_system.launch(
                y[None], out, cfg, n_steps, True, cluster_size=cluster_size
            ),
        )
    finally:
        fused_system.MAX_SHARED_MEMORY_BYTES = gate
    return ms, out[0]


def run(device, card, log=print, cluster_size=K5_CLUSTER_SIZE):
    """Splits a K8 step of each case, times K5 on a cluster of
    ``cluster_size`` on the same state, logs both; returns one dict per
    case."""
    library = build_split_library()
    segments = library.tiled_system_split_segments()
    results = []
    for label, ivp, d_t in cases():
        cp = ivp.constrained_problem
        cfg = tiled_system._TiledSystemConfig(cp, d_t)
        y = torch.as_tensor(
            ivp.initial_condition.discrete_y_0(True),
            dtype=torch.float32,
            device=device,
        ).contiguous()
        k8_ms = chip_smoke.cuda_ms(
            torch,
            lambda: tiled_system.tiled_system_rk4_trajectory(y, cfg, STEPS),
        )
        sums = torch.zeros((32, segments), dtype=torch.int64, device=device)
        spans = torch.zeros((STEPS, 2), dtype=torch.int64, device=device)
        # a warm run, then the measured one
        split(cfg, y, STEPS, library, sums, spans)
        cycles, stamps = split(cfg, y, STEPS, library, sums, spans)
        warps = cycles[cycles.sum(dim=1) > 0].double() / STEPS
        span_ns = (stamps[:, 1] - stamps[:, 0]).double()
        gap_ns = (stamps[1:, 0] - stamps[:-1, 1]).double()
        span_us = float(span_ns.median()) / 1e3
        gap_us = float(gap_ns.median()) / 1e3
        step_cycles = float(warps.sum(dim=1).mean())
        # cycles a microsecond of the recorded block: its step over the
        # launch's span (every block of these grids runs in one wave)
        rate = step_cycles / span_us
        rows = []
        parts = {"load": 0.0, "stages": 0.0, "barriers": 0.0, "store": 0.0}
        for index, (name, part) in enumerate(SEGMENTS):
            column = warps[:, index]
            mean = float(column.mean())
            parts[part] += mean / rate
            rows.append(
                dict(
                    segment=name,
                    part=part,
                    cycles=mean,
                    max_cycles=float(column.max()),
                    us=mean / rate,
                )
            )
        k8_frames = tiled_system.tiled_system_rk4_trajectory(y, cfg, STEPS)
        k5_ms, k5_frames = k5_cluster_ms(cp, d_t, y, STEPS, cluster_size)
        scale = float(k8_frames[:100].abs().max())
        k5_vs_k8 = float((k5_frames[:100] - k8_frames[:100]).abs().max())
        result = dict(
            case=label,
            steps=STEPS,
            blocks=cfg.plan.blocks,
            tile=(cfg.plan.rows, cfg.plan.cols),
            warps=int(warps.shape[0]),
            step_us=1e3 * k8_ms / STEPS,
            span_us=span_us,
            gap_us=gap_us,
            gap_mean_us=float(gap_ns.mean()) / 1e3,
            cycles_per_us=rate,
            parts_us=dict(launch_gap=gap_us, **parts),
            segments=rows,
            k5_cluster_size=cluster_size,
            k5_step_us=1e3 * k5_ms / STEPS,
            k5_vs_k8_first_100=k5_vs_k8 / scale,
        )
        results.append(result)
        log(
            f"k8 split: {label}, {STEPS} steps, {cfg.plan.blocks} blocks of "
            f"{cfg.plan.rows} x {cfg.plan.cols}: {result['step_us']:.3f} us a "
            f"step without stamps; with stamps a launch spans {span_us:.3f} "
            f"us and the gap to the next is {gap_us:.3f} us (median; mean "
            f"{result['gap_mean_us']:.3f}); the recorded block ran "
            f"{rate:.0f} cycles a us [{card}]"
        )
        log(
            "k8 split:   launch gap {launch_gap:.3f} us, tile load {load:.3f}, "
            "four stages {stages:.3f}, barriers {barriers:.3f}, store "
            "{store:.3f}".format(**result["parts_us"])
        )
        for row in rows:
            log(
                f"k8 split:   {row['segment']:24s} {row['cycles']:9.1f} "
                f"cycles a step (max over warps {row['max_cycles']:9.1f}), "
                f"{row['us']:.3f} us"
            )
        log(
            f"k8 split: {label}: K5 on a cluster of {cluster_size} "
            f"{result['k5_step_us']:.3f} us a step against K8's "
            f"{result['step_us']:.3f}; first 100 frames max|d|/max|y| = "
            f"{result['k5_vs_k8_first_100']:.3e} [{card}]"
        )
        del y, sums, spans, k8_frames, k5_frames
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_step_split.py needs a CUDA card", file=sys.stderr)
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
