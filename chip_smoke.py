"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

Drives ``pararealml_tpu_torch`` — never JAX — through its ported paths
at full size, each through the entry points a user calls.

The diffusion_2d Parareal flagship (21 x 21 grid, Dirichlet 1.5 on the x
faces, zero-flux y faces, a Gaussian of amplitude 1000, RK4 with fine
d_t 1e-3 to T = 40, tolerance 2.5e-3):

1. builds the hand-written CUDA kernels from ``pararealml_tpu_torch/csrc``
   (one nvcc per source, all at once) and holds each of the flagship's
   (K1 trajectory, K2 end, K3 step) against its plain PyTorch version on
   the same CUDA tensors, on three problems and the other grids of K1's
   measured plan table, at the plan the wrappers pick and at every table
   plan that covers the grid, and on the flagship at the shapes and step
   counts the main path gives K1 and K2;
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
   (1 - busy / the CUDA-event time of phase 3), then splits a K1 step on
   the wrappers' plans (``tools/k1_step_split.py``).

The 2D Burgers Parareal with a quadratic ML coarse operator (bench.py's
``bench_nonlinear_sml``: Re = 100 on a 21 x 21 grid with zero-flux faces,
RK4 with fine d_t 2.5e-3 to T = 200, i.e. 80,000 fine steps; 100 slices
of the committed rank-32 model ``bench_assets/sml_quad_burgers_2d.msgpack``,
tolerance 2.5e-3), on the card by default (no ``device`` argument):

5. holds K5 (trajectory, end, step) and K4 (ends, trajectory) against
   their plain versions on the bench problem and a mixed-BC one at 200
   steps, and at the main path's shapes: K4 at 100 slices x 800 steps and
   the K5 trajectory at 2,000 steps;
6. runs the path with every counter at 0: the fine solve (80,000 steps,
   K5), the robust Parareal (<= 12 iterations) and the one-shot Parareal
   (1 iteration), each iteration's fine ends on K4 and the final
   expansion on K4, and the example's own training recipe at its own size
   (``examples/burgers_2d_quadratic_ml_parareal.py``: T = 40, 20 slices,
   10 perturbed runs through the batched K5 trajectory, a rank-24 fit);
   it checks the launch counts, that the fine trajectory's first 2,000
   steps are phase 5's K5 output, the robust run's max diff vs fine
   against 2 x the tolerance (bench.py's gate) and the fit's finite MSE;
7. times the fine solve (median of 3), both Parareal runs and every
   kernel beside its plain version (median of 5, of 3 for plain versions
   at the main path's shapes);
8. profiles the fine solve and both Parareal runs as in phase 4.

The large-grid diffusion path (bench.py's ``bench_large_grid`` and
``bench_streaming``: ``build_problem``'s diffusion with d = 0.05 on
[0, 10]^2 at d_x = 10 / (n - 1)), on the card by default:

9. holds the resident kernel (K7) and the tiled kernel (K6) against
   their plain versions on small grids that exercise every branch
   (tests/test_tiled_diffusion.py's three problems and a folded one with
   convection), with float32 and bfloat16 frames and states, K6 at
   temporal blocks 1, 2 and 4, each on its own tile plan and on small
   tiles whose last ones overhang the grid, and K6 against K7 on a
   161 x 161 grid;
10. runs the path with every counter at 0 through
    ``FDMOperator(...).trajectory_function``: 641 x 641, d_t 1e-4, 2,000
    steps (K7, float32 and bfloat16 frames) and 2049 x 2049, d_t 1e-5, 192
    steps (K6: float32 at temporal block 1 and 2, bfloat16 state at 2),
    plus one ``solve`` at 641 x 641 over 10 steps; it reads the counters
    right after, then checks the last frames (finite, Dirichlet faces at
    1.5), the temporal block against block 1 (equal), the first frames
    against the generic path (atol = rtol = 1e-4) and against the plain
    versions at a cut step count;
11. times both kernels at those shapes (median of 5), their plain
    versions (one run each: they take seconds) and the generic path at
    641 x 641 over 20 steps (scaled to 2,000 and labelled so), and prints
    the bfloat16 error of the last frame against float32;
12. profiles the two float32 runs as in phase 4.

The 3D Cartesian path (bench.py's ``bench_3d``: 21^3 viscous Burgers,
Re = 100, zero-flux faces, a Gaussian in the first component, d_t 0.01;
and ``examples/cahn_hilliard_3d_fdm.py``: 31^3 Cahn-Hilliard, gamma = 0.5,
zero-flux faces, d_t 0.05), on the card by default:

13. holds the fused 3D kernel (K9: trajectory, single and batched end,
    step) against its plain version for each of its five families with
    all-Neumann faces and with Dirichlet 0.1 lower and Neumann 0.05 upper
    faces, on a 17 x 7 x 9 volume at every forced cluster size (1, 2, 4,
    8 and 16 blocks) with every cells-a-thread instance that takes it
    (registers and device memory), at the main path's shapes on the
    plan the wrappers pick and on 8 and 4 blocks, at every plan of the
    measured table on its own volume, and at the largest cube of three
    components the JAX cap admits (48^3, also timed over 20 steps);
14. runs the path with every counter at 0: 2,000 Burgers steps and the
    example's 3,000 Cahn-Hilliard steps through
    ``FDMOperator.trajectory_function`` (one K9 launch each), a
    200-step Cahn-Hilliard ``solve``, and Parareal over a K9 fine (d_t
    0.01) and a K9 coarse (d_t 1.25) operator on the Burgers problem, 8
    slices over T = 20; it reads the counters right after, checks the
    Burgers frames against the generic path (atol = rtol = 1e-4), the
    solve against the trajectory, and Parareal against the fine
    trajectory, on a problem where the coarse operator alone fails that
    check and at least two iterations must correct it;
15. times both trajectories, the generic path over 20 steps (scaled,
    and labelled so), the plain versions once, Parareal, and each kernel
    at its timed shape beside its plain version and its bound;
16. profiles the two trajectories and Parareal as in phase 4.

The 2D system path past one CTA and the wave, shallow-water and
Cahn-Hilliard families of K4/K5 (``examples/wave_2d_fdm.py``,
``examples/shallow_water_fdm.py`` and ``examples/cahn_hilliard_2d_fdm.py``
at their own sizes, and bench.py's 2D Burgers problem at 641^2), on the
card by default:

17. holds the tiled kernel (K8) against its plain version for each of its
    four families with Dirichlet/Neumann and partial Neumann faces on a
    17 x 33 grid (a batch of two), float32 and bfloat16 storage, on its
    plan's 10 tiles (6 for Cahn-Hilliard; the last ones clamped), on 42
    tiles and on one, and
    K5 (trajectory, end, step) and K4 (B = 4 ends and trajectory) for the
    wave, shallow-water and Cahn-Hilliard functors on 21 x 23 over 200
    steps; and checks that K8 refuses, before any launch, a grid with no
    plan, interior Dirichlet constraints and a plan with too narrow a
    halo;
18. runs the path with every counter at 0: the three examples'
    ``FDMOperator.solve`` (wave 101^2 x 2,000 steps, shallow water 101 x
    51 x 8,000 steps, Cahn-Hilliard 101^2 x 10,000 steps) and the 641^2
    Burgers ``trajectory_function`` over 1,000 steps in float32 and with
    ``kernel_storage_dtype=torch.bfloat16``, one launch each with no
    generic step built (the examples' on the cluster-resident mode,
    641^2 on K8), then an 8-slice Cahn-Hilliard Parareal on 41^2 (fine
    d_t 1e-4, coarse 5e-4, T = 0.4) over K4 fine ends and expansion and
    K5 coarse sweeps; it checks each run's first 20 frames against its
    kernel's plain version and the generic path (atol = rtol = 1e-4),
    bfloat16 against float32 over the first 4 frames (2e-2 of the largest
    value; the last frame's difference is printed, not gated: at d_t 1e-3
    the increments are under half a bfloat16 step, and the JAX generic
    step rounded once a step drifts as far, see tests/
    test_torch_tiled_system.py), and Parareal against
    the fine trajectory (2 x the tolerance), where the coarse operator
    alone fails that check and at least two iterations must correct it;
19. times each full-width run, the generic path over 20 steps at the
    same size (scaled, and labelled so), K8 on its plan's tiles against
    two other tilings at each size, the Parareal against its fine
    solve, and each kernel function at its path's shapes beside its plain
    version and its bound, holding it against that plain version there
    (the Cahn-Hilliard K4 and K5 functions at the Parareal's 41^2: B = 8
    fine ends and expansion over 500 steps, the 800-step coarse roll-out
    and a 100-step coarse end; 1e-5 relative);
20. profiles each run as in phase 4.

The curvilinear path (``examples/shallow_water_polar_fdm.py`` and
``examples/wave_polar_fdm.py`` unchanged, and ``examples/burgers_3d_fdm.py``'s
spherical problem), on the card by default:

21. holds polar K5 (trajectory, B = 4 end, step over 100 steps) and polar
    K8 (a batch of two, float32 and bfloat16 storage, on its plan's tiles,
    small tiles and one tile) against their plain versions for the four
    families on the JAX tests' 21 x 41 polar mesh, polar K8 against polar
    K5 (the same order of operations: equal frames), and K4's trajectory
    with bfloat16 frames (``kernel_traj_dtype`` under Parareal) against its
    plain version and the float32 frames rounded once;
22. runs the path with every counter at 0 through ``FDMOperator.solve``:
    shallow water polar 36 x 51 x 3 over 4,000 steps (one polar K5
    launch), wave polar 51 x 201 x 2 over 25,000 steps (one launch of the
    cluster-resident mode), with no generic step built, and
    the spherical Burgers problem 9 x 21 x 6 x 3 over 200 steps (the
    generic path, in both packages); it checks the first 20 frames of each
    polar run against the plain version and the generic path (atol = rtol
    = 1e-4), its last frame against the generic path run over the whole
    horizon in float32 (``POLAR_LAST_TOL``; 100 generic steps captured in
    a CUDA graph and replayed), and the spherical solve against the port's
    CPU float64 solve (``SPHERICAL_TOL``);
23. times both polar runs and the spherical one (once: seconds of eager
    steps), the generic path over 20 steps (scaled, and labelled so), and
    each polar kernel function at its path's grid over 100 steps beside
    its plain version and its bound, and K4 with bfloat16 frames beside
    float32 frames;
24. profiles each run as in phase 4 (the spherical one over its first 20
    steps).

The Navier-Stokes path (``examples/navier_stokes_fdm.py`` unchanged: Re
5000 on 101 x 81, Dirichlet vorticity and stream function on every face,
d_t 0.05 to T = 100), on the card by default:

25. holds the Navier-Stokes kernel (trajectory, B = 4 end, step) against
    its plain version on the JAX tests' 17 x 17 problem (one block, 20
    steps) and over the example's first 50 steps, the first step's
    700-sweep solve included, on its measured plan, that plan with
    groups of one Jacobi sweep, and every cluster size whose blocks an
    instance covers (2, 4 and 8) at its default group and cells a thread,
    0.0 apart with the Jacobi sweeps each counted equal;
26. runs the path with every counter at 0: the example's
    ``FDMOperator.solve`` (2,000 steps, one launch, no generic step
    built) and an 8-slice Parareal over its first 3.2 time units (coarse
    d_t 4 x the fine, fine ends through the batched end kernel); it
    checks the first 100 frames against the generic path in float32 on
    the card (``NS_HEAD_TOL``), prints the last frame's difference from
    the generic path run over the whole horizon (not held: float32
    rounding in two orders over 2,000 solves), and Parareal's iterations
    and difference from the fine solve;
27. times the solve, Parareal, the generic path over 20 steps (scaled,
    and labelled so) and each kernel function at its path's shapes
    beside its plain version (once) and its bound from the sweeps it
    counted; times the solve, one Parareal iteration's B = 8 fine ends
    and the Parareal on the measured plans against the same plans with
    groups of one sweep, in turns; and splits a Jacobi sweep and a stage
    (``tools/ns_sweep_split.py``);
28. profiles the solve and Parareal as in phase 4.

The end states past one CTA (K8's and K7's end modes) and K5's step
split, on the card by default:

29. holds K8's end mode (B = 3 and single, four families on 101^2, the
    polar wave example's 51 x 201) and K7's end mode and K7 with a
    Dirichlet square inside 201^2 against their plain versions;
30. runs with every counter at 0 an 8-slice Parareal over the wave
    example's 101^2 (its fine and coarse ends on the cluster-resident
    mode), ``ends_function`` over 20 steps of 641^2 Burgers (K8's end
    mode) and ``ends_function`` and ``solve`` on the 201^2 diffusion
    problem with the square (K7), and checks them;
31. times the Parareal, one iteration's fine ends against the generic
    carry-only loop, and each end function at its path's shapes beside
    its plain version and its bound;
32. prints K5's step split (``tools/k5_step_split.py``) and profiles.

The cluster-resident mode on the 2D examples' grids (one thread block
cluster of up to 16 blocks a state, all steps in one launch), on the
card by default:

33. holds the mode against its plain version (K5's, bit for bit) at the
    wave, shallow-water, Cahn-Hilliard and polar wave examples' shapes
    on every plan its instances take (clusters of 2 to 16 blocks, 1, 2
    or 4 cells a thread; the plan's single-state and B = 8 choices among
    them), its end (B = 2) and bfloat16 frames, and checks that a
    cluster of 17 blocks is refused before any launch;
34. runs with every counter at 0 the four examples' ``solve`` (one
    launch of the mode each, no K8, K5 or K4) and the wave example's
    8-slice Parareal (its fine and coarse ends and its expansion on the
    mode, no K8), and holds the mode against per-step K8 over each
    example's horizon (the first ``MODE_HEAD_STEPS`` frames to
    ``MODE_K8_TOL`` of the largest value; the last frame printed);
35. times the mode and per-step K8 in turns (K8, mode, mode, K8) at each
    example's full length and on one Parareal iteration's B = 8 fine
    ends, and each of the mode's functions over ``MODE_TIMED_STEPS``
    steps beside its plain version and its bound;
36. prints K8's step split (``tools/k8_step_split.py``: launch gap, tile
    load, stages, barriers and store, and K5 on a cluster of 8 on the
    same states) and profiles each timed run on both routes.

37. prints K9's step split (``tools/k9_step_split.py``: cell setup,
    neighbour loads, face handling, stage arithmetic, the Dirichlet
    override, barriers, frame stores) on the 21^3 and 31^3 volumes, and
    times K9's chosen plans against its 8- and 4-block plans in turns on
    the two trajectories and the B = 8 fine ends
    (``tools/k9_plan_sweep.py``).

Run it from the repository root with no arguments: ``python3
chip_smoke.py``. It needs one CUDA card and ``nvcc`` and exits non-zero,
printing no result, without them. The line before last is the card's
name and power limit as nvidia-smi gives them; before it, one JSON line
lists every ported kernel with its launches on the main paths, its
largest deviation from its plain version, its time, its plain version's
time and its bound (the least time the card could take for its work at
the timed shapes); the last line is ``{"ok": true, "device": ...}``.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# the card's peaks, and the bounds they give with the Navier-Stokes
# operation counts, shared with the benchmark
from benchmark.roofline import PEAK_BYTES_PER_S, bound, navier_stokes_bound


T_END = 40.0
FINE_D_T = 1e-3
TOLERANCE = 2.5e-3
KERNEL_REL_TOL = 1e-5
SOURCE = "pararealml_tpu_torch/csrc/fused_diffusion.cu"
JAX_KERNELS = "pararealml_tpu/ops/fused_diffusion.py"
# the flagship's kernels: (name, the Pallas kernel it replaces in the
# JAX package)
KERNELS = (
    ("fused_diffusion_rk4_trajectory", f"{JAX_KERNELS}:363"),
    ("fused_diffusion_rk4_end", f"{JAX_KERNELS}:538"),
)
# ported and checked here, but not on the main path (in neither package)
STEP_KERNEL = "fused_diffusion_rk4_step"
# K1-K3's times before their redesign, at the shapes phase 3 times them
# (PERF.md, sections 5 and 6: this script's earlier runs on an NVIDIA H100
# 80GB HBM3 at 700 W), printed beside this run's
K1_BEFORE_REDESIGN_MS = {
    "fine solve": 88.568,
    "fused_diffusion_rk4_trajectory": 4.481,
    "fused_diffusion_rk4_end": 1.130,
    STEP_KERNEL: 0.085,
    "fused_diffusion_rk4_end B=8": 10.985,
    "8 slices, coarse d_t 1e-2, linear_propagator=False": 39.185,
}

# the Burgers path (bench.py:513-545, :594-656)
BURGERS_T_END = 200.0
BURGERS_FINE_D_T = 2.5e-3
BURGERS_SLICES = 100
BURGERS_MAX_ITERATIONS = 12
BURGERS_TOLERANCE = 2.5e-3
BURGERS_RANK = 32
BURGERS_ASSET = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "bench_assets",
    "sml_quad_burgers_2d.msgpack",
)
# the example's training recipe
# (examples/burgers_2d_quadratic_ml_parareal.py:39-58)
EXAMPLE_T_END = 40.0
EXAMPLE_SLICES = 20
EXAMPLE_RUNS = 10
EXAMPLE_RANK = 24
# the K5 trajectory checked against its plain version at the start of
# the fine solve
K5_HEAD_STEPS = 2000
SYSTEM_SOURCE = "pararealml_tpu_torch/csrc/fused_system.cu"
# (name, module, Pallas kernel it replaces, on the Burgers main path)
SYSTEM_KERNELS = (
    (
        "packed_system_rk4_ends",
        "packed_system",
        "pararealml_tpu/ops/packed_system.py:493",
        True,
    ),
    (
        "packed_system_rk4_trajectory",
        "packed_system",
        "pararealml_tpu/ops/packed_system.py:559",
        True,
    ),
    (
        "fused_system_rk4_trajectory",
        "fused_system",
        "pararealml_tpu/ops/fused_system.py:822",
        True,
    ),
    (
        "fused_system_rk4_end",
        "fused_system",
        "pararealml_tpu/ops/fused_system.py:964",
        False,
    ),
    (
        "fused_system_rk4_step",
        "fused_system",
        "pararealml_tpu/ops/fused_system.py:1098",
        False,
    ),
)

# the large-grid diffusion path (bench.py:1091-1097, :1290-1295)
LARGE_N = 641
LARGE_STEPS = 2000
LARGE_D_T = 1e-4
STREAM_N = 2049
STREAM_STEPS = 192
STREAM_D_T = 1e-5
LARGE_DIFFUSIVITY = 0.05
LARGE_SOLVE_STEPS = 10
# frames compared with the generic path, and steps compared with the
# plain versions at full width
LARGE_HEAD_STEPS = 5
STREAM_HEAD_STEPS = 3
LARGE_PLAIN_STEPS = 20
STREAM_PLAIN_STEPS = 8
GENERIC_TIMED_STEPS = 20
# bfloat16 against float32, of the largest value: one rounding of a frame
# (half a bfloat16 step, 2^-8 at most) for the resident kernel, whose
# state stays float32; the roundings of the state accumulate over the
# tiled kernel's 96 residencies
RESIDENT_BF16_TOL = 2.0**-8
TILED_BF16_TOL = 2e-2
LARGE_SOURCE = "pararealml_tpu_torch/csrc/tiled_diffusion.cu"
# (name, module, Pallas kernel it replaces)
LARGE_KERNELS = (
    (
        "resident_diffusion_rk4_trajectory",
        "resident_diffusion",
        "pararealml_tpu/ops/resident_diffusion.py:76",
    ),
    (
        "tiled_diffusion_rk4_trajectory",
        "tiled_diffusion",
        "pararealml_tpu/ops/tiled_diffusion.py:374",
    ),
)

# the 3D path (bench.py:1509-1567, examples/cahn_hilliard_3d_fdm.py)
BURGERS_3D_STEPS = 2000
BURGERS_3D_D_T = 0.01
CH_3D_STEPS = 3000
CH_3D_D_T = 0.05
CH_3D_GAMMA = 0.5
CH_3D_SOLVE_STEPS = 200
# Parareal over the Burgers problem: 8 slices of 250 fine and 2 coarse
# steps. The coarse d_t is the largest that divides a slice and keeps RK4
# stable on this problem (d_t nu |lambda_max| = 2.4 of 2.79): its own
# slice ends miss the fine ones by about 5e-5, past the gate below, so the
# check fails unless the corrections bring them back, which takes 2
# iterations at this tolerance. A finer coarse d_t (0.1 to 0.625) misses
# them by 2.3e-6 at most, inside the gate, and stops after one iteration.
PARAREAL_3D_SLICES = 8
PARAREAL_3D_COARSE_D_T = 1.25
PARAREAL_3D_TOLERANCE = 1e-6
# Parareal's trajectory against the fine one: the correction leaves
# float32 rounding of the two K9 paths (values up to 0.18)
PARAREAL_3D_GATE = 1e-5
# the volume every cluster size takes (17 planes: slabs of one and two
# at 16 blocks)
K9_SMALL_SHAPE = (17, 7, 9)
K9_SMALL_STEPS = 20
# the largest cube of three components the JAX package's cap admits (its
# cells in device memory on 16 blocks), its steps held against the plain
# version and timed
K9_LARGE_SHAPE = (48, 48, 48)
K9_LARGE_STEPS = 5
K9_LARGE_TIMED_STEPS = 20
# the d_t of the checks at the plan table's volumes, from random states
K9_TABLE_D_T = 1e-6
# K9's times before its redesign at the shapes this script times them
# (PERF.md, sections 5 and 6: this script's earlier runs on an NVIDIA
# H100 80GB HBM3 at 700 W), printed beside this run's
K9_BEFORE_REDESIGN_MS = {
    "fused_system_3d_rk4_trajectory": 8.486,
    "fused_system_3d_rk4_end": 12.146,
    "fused_system_3d_rk4_step": 0.132,
    "coarse end": 0.191,
    "3d burgers fine": 82.882,
    "3d cahn-hilliard": 36.883,
    "3d parareal": 39.882,
}
# frames held against the generic path, the generic path's and the plain
# versions' timed steps, and the kernels' timed shapes
BURGERS_3D_HEAD_STEPS = 20
GENERIC_3D_TIMED_STEPS = 20
PLAIN_3D_TIMED_STEPS = 20
K9_TIMED_STEPS = 200
THREE_D_SOURCE = "pararealml_tpu_torch/csrc/fused_system_3d.cu"
# (name, the Pallas kernel it replaces, on the 3D main path)
THREE_D_KERNELS = (
    (
        "fused_system_3d_rk4_trajectory",
        "pararealml_tpu/ops/fused_system_3d.py:532",
        True,
    ),
    (
        "fused_system_3d_rk4_end",
        "pararealml_tpu/ops/fused_system_3d.py:723",
        True,
    ),
    (
        "fused_system_3d_rk4_step",
        "pararealml_tpu/ops/fused_system_3d.py:861",
        False,
    ),
)

# the 2D system path (examples/wave_2d_fdm.py, examples/shallow_water_fdm.py,
# examples/cahn_hilliard_2d_fdm.py at 101^2 and 101 x 51, and bench.py's
# 2D Burgers problem, bench.py:521-545, at 641^2)
WAVE_T_END = 20.0
SHALLOW_WATER_T_END = 20.0
CH_2D_T_END = 5.0
BURGERS_641_STEPS = 1000
BURGERS_641_D_T = 1e-3
CH_2D_GAMMA = 0.01
# small grids for the kernels against their plain versions: K8 on
# tests/test_tiled_system.py's 17 x 33 grid, K4/K5 on 21 x 23
SYSTEM_SMALL_SHAPE = (17, 33)
SYSTEM_SMALL_STEPS = 12
K5_FAMILY_SHAPE = (21, 23)
K5_FAMILY_STEPS = 200
# frames held against the plain version and the generic path, and the
# generic path's and the plain version's timed steps at full width
SYSTEM_HEAD_STEPS = 20
SYSTEM_TIMED_STEPS = 20
# bfloat16 storage against float32 over the JAX test's horizon
# (tests/test_tiled_system.py:215-246: 4 steps, 2e-2 of the largest value)
BF16_HEAD_STEPS = 4
# Parareal over examples/cahn_hilliard_2d_fdm.py's problem on [0, 4]^2
# (41^2, one CTA): 8 slices of 500 fine steps (d_t 1e-4) and 100 coarse
# steps (d_t 5e-4, the example's own). On the CPU (plain versions,
# float32) the coarse operator misses the fine slice ends by 3.6e-4 from
# the fine starts and the whole coarse trajectory the fine one by 4.2e-2,
# both past the gate of 2 x the tolerance, and Parareal stops after 2
# iterations, 6.9e-8 from the fine trajectory.
CH_PARAREAL_N = 41
CH_PARAREAL_T_END = 0.4
CH_PARAREAL_SLICES = 8
CH_PARAREAL_FINE_D_T = 1e-4
CH_PARAREAL_COARSE_D_T = 5e-4
CH_PARAREAL_TOLERANCE = 5e-5
TILED_SYSTEM_SOURCE = "pararealml_tpu_torch/csrc/tiled_system.cu"
TILED_SYSTEM_KERNEL = "tiled_system_rk4_trajectory"
TILED_SYSTEM_REPLACES = "pararealml_tpu/ops/tiled_system.py:369"
CLUSTER_KERNEL = "cluster_system_rk4_trajectory"
# the cluster-resident mode (phases 33-36): the examples' grids on one
# thread block cluster a state; each plan against its plain version over
# MODE_SMALL_STEPS steps, the mode against per-step K8 over the first
# MODE_HEAD_STEPS frames to MODE_K8_TOL of the largest value (float32 in
# two orders), each kernel function timed beside its plain version over
# MODE_TIMED_STEPS steps
CLUSTER_SOURCE = "pararealml_tpu_torch/csrc/cluster_system.cu"
MODE_SMALL_STEPS = 10
MODE_HEAD_STEPS = 100
MODE_K8_TOL = 1e-4
MODE_TIMED_STEPS = 100

# the curvilinear path: examples/shallow_water_polar_fdm.py (36 x 51 x 3,
# d_t 0.0025, T = 10: 4,000 steps, one CTA: polar K5),
# examples/wave_polar_fdm.py (51 x 201 x 2, d_t 0.002, T = 50: 25,000
# steps, past one CTA: polar K8, the port's carrier of the JAX package's
# polar K5 there) and examples/burgers_3d_fdm.py (spherical 9 x 21 x 6 x 3,
# d_t 0.5, T = 100: 200 steps, the generic path in both packages)
SHALLOW_WATER_POLAR_T_END = 10.0
WAVE_POLAR_T_END = 50.0
SPHERICAL_T_END = 100.0
# the kernels against their plain versions on the JAX tests' polar mesh
# (tests/test_fused_system.py _polar_cp: r in [2.5, 7.5], 21 x 41)
POLAR_SMALL_STEPS = 100
# each polar kernel function timed at its path's grid over this many steps
# (the plain versions take milliseconds a step)
POLAR_TIMED_STEPS = 100
# the last frame of each polar example against the generic path in float32
# on the card, of the largest value: float32 rounding over the whole
# horizon, in two orders of evaluation. On the CPU the plain versions
# missed it by 1.4e-6 (shallow water, 4,000 steps) and by 3.0e-5 (wave,
# 25,000 steps)
POLAR_LAST_TOL = 1e-4
# the spherical Burgers solve on the card (float32) against the port's CPU
# float64 solve, of the largest value: float32 rounding over 200 steps
SPHERICAL_TOL = 1e-5
POLAR_KERNELS = (
    ("fused_system_rk4_trajectory", "fused_system", SYSTEM_SOURCE,
     "pararealml_tpu/ops/fused_system.py:822"),
    ("fused_system_rk4_end", "fused_system", SYSTEM_SOURCE,
     "pararealml_tpu/ops/fused_system.py:964"),
    ("fused_system_rk4_step", "fused_system", SYSTEM_SOURCE,
     "pararealml_tpu/ops/fused_system.py:1098"),
    (TILED_SYSTEM_KERNEL, "tiled_system", TILED_SYSTEM_SOURCE,
     "pararealml_tpu/ops/fused_system.py:822"),
)

# the Navier-Stokes path: examples/navier_stokes_fdm.py unchanged (Re 5000
# on [-2.5, 2.5] x [0, 4] at 0.05: 101 x 81 x 4; Dirichlet w and psi on
# every face; d_t 0.05 to T = 100: 2,000 steps; the stream function's
# Jacobi solve to 1e-3), one launch of the Navier-Stokes kernel in a
# thread block cluster
NS_T_END = 100.0
NS_D_T = 0.05
# the kernel against its plain version on the JAX tests' 17 x 17 problem
# (Re 500, one block) and over the example's first steps (the first step's
# long solve included) at every cluster size whose slabs fit a block
NS_SMALL_STEPS = 20
NS_PREFIX_STEPS = 50
# the solve's first frames against the generic path in float32 on the card
NS_HEAD_STEPS = 100
NS_HEAD_TOL = 1e-4
# Parareal over a shortened horizon of the example: 8 slices of 0.4
# (8 fine steps, 2 coarse steps of 4 x the fine d_t)
NS_PARAREAL_T_END = 3.2
NS_PARAREAL_SLICES = 8
NS_PARAREAL_COARSE_D_T = 0.2
NS_PARAREAL_TOLERANCE = 1e-3
# the generic path timed over this many steps from frame NS_HEAD_STEPS,
# and the trajectory kernel beside its plain version over this many (the
# plain version takes 20 ms a step: the solve itself is timed whole)
NS_GENERIC_TIMED_STEPS = 20
NS_TIMED_STEPS = 200
NS_SOURCE = "pararealml_tpu_torch/csrc/fused_navier_stokes.cu"
NS_KERNELS = (
    ("fused_navier_stokes_rk4_trajectory",
     "pararealml_tpu/ops/fused_system.py:822"),
    ("fused_navier_stokes_rk4_end", "pararealml_tpu/ops/fused_system.py:964"),
    ("fused_navier_stokes_rk4_step",
     "pararealml_tpu/ops/fused_system.py:1098"),
)
# the end modes past one CTA: an 8-slice Parareal over
# examples/wave_2d_fdm.py's problem (101^2, past one CTA; fine d_t 0.01,
# the example's own, coarse d_t 0.05), its fine ends through the batched
# K8 end, its coarse ends through the single-state K8 end; and
# bench.py:build_problem's diffusion (d = 0.05) at 201^2 with a Dirichlet
# square of 2 over the middle ninth, past one CTA, through K7's end mode
WAVE_PARAREAL_T_END = 20.0
WAVE_PARAREAL_SLICES = 8
WAVE_PARAREAL_COARSE_D_T = 0.05
WAVE_PARAREAL_TOLERANCE = 1e-3
END_K8_SHAPE = (101, 101)
END_SMALL_STEPS = 21
# K8's end mode on its path: 641^2 Burgers (past the JAX package's VMEM
# cap, so past the cluster-resident mode), one ends_function over 20
# steps (the wave example's fine and coarse ends take the mode)
END_K8_641_STEPS = 20
END_K7_N = 201
END_K7_STEPS = 200
END_K7_D_T = 1e-3
END_K7_SQUARE = 2.0
END_REPLACES = {
    "tiled_system_rk4_end": "pararealml_tpu/ops/fused_system.py:964",
    "tiled_system_rk4_end:polar": "pararealml_tpu/ops/fused_system.py:964",
    "resident_diffusion_rk4_end": "pararealml_tpu/ops/fused_diffusion.py:538",
}

# float32 operations one RK4 step does per grid cell, counted from the
# kernels' arithmetic: diffusion (K1-K3) evaluates a 10-operation
# right-hand side and 5 stage updates per stage. The 2D systems (K4, K5,
# K8) are counted as K9's table below, with a Laplacian's 2 s and
# Cahn-Hilliard's y0 * y0 once: a Laplacian is 8 operations and its
# coefficient 1, a gradient 2, and the 13 stage updates of a component a
# step (2 + 4 + 4 + 3). Burgers: per component and stage a Laplacian and
# two gradient terms (9 + 2 x 4), 4 x 2 x 17 + 2 x 13 = 162; wave: one
# Laplacian per stage, 4 x 9 + 2 x 13 = 62; shallow water: per stage six
# gradients (12), the divergence (1), eta's right-hand side (9) and u's
# and w's (19 each: a Laplacian and five products and sums), 4 x 60 + 3
# x 13 = 279; Cahn-Hilliard: three Laplacians (27), the potential's
# cube and differences (4) and y0's update (4), 35
FLOPS_PER_CELL_STEP = {
    "diffusion": 62,
    "burgers": 162,
    "wave": 62,
    "shallow-water": 279,
    "cahn-hilliard": 35,
}
# the same for K9's families on the main path, counted from its arithmetic:
# a Laplacian is 13 (2 s once, three per axis, two sums, the coefficient),
# a gradient term 4 (difference, scale, product, subtraction); Burgers
# evaluates three components of a Laplacian and three gradient terms per
# stage and 13 stage updates per component and step (4 x 3 x 25 + 39);
# Cahn-Hilliard three Laplacians and 4 + 4 updates a step (3 x 13 + 8)
K9_FLOPS_PER_CELL_STEP = {"burgers": 339, "cahn-hilliard": 47}
# the polar families (polar K5 and K8), counted the same way: the polar
# Laplacian adds d2_1 / r, the radial derivative and the sum, times 1 / r
# (3 operations, and the radial derivative's 2 where the right-hand side
# does not compute it anyway), gradient_1 one product, and the
# shallow-water divergence u / r and its sum (2). Wave: 4 x (9 + 5) + 2 x
# 13 = 82; Burgers: 4 x 2 x (17 + 3 + 1) + 2 x 13 = 194; shallow water:
# 4 x (60 + 2 x 3 + 3 + 2) + 3 x 13 = 323; Cahn-Hilliard: 35 + 3 x 5 = 50
FLOPS_PER_CELL_STEP.update(
    {
        "polar-wave": 82,
        "polar-burgers": 194,
        "polar-shallow-water": 323,
        "polar-cahn-hilliard": 50,
    }
)


# K5's and K4's times before the K5 redesign, at the shapes this script
# times them (PERF.md, section 6: this script's earlier runs on an NVIDIA
# H100 80GB HBM3 at 700 W), printed beside this run's
K5_BEFORE_REDESIGN_MS = {
    ("packed_system_rk4_ends",
     "B=100, 800 steps (one iteration's fine ends)"): 4.047,
    ("packed_system_rk4_trajectory",
     "B=100, 800 steps (the final expansion)"): 4.073,
    ("fused_system_rk4_trajectory", "21x21x2, 2000 steps"): 10.073,
    ("fused_system_rk4_end", "21x21x2, 800 steps"): 4.157,
    ("fused_system_rk4_step", "21x21x2, 1 step"): 0.121,
    ("burgers fine", "80000 steps"): 399.375,
    ("packed_system_rk4_ends:cahn-hilliard",
     "B=8 x 41^2 x 2 Cahn-Hilliard, 500 steps (one iteration's fine ends)"):
        1.570,
    ("packed_system_rk4_trajectory:cahn-hilliard",
     "B=8 x 41^2 x 2 Cahn-Hilliard, 500 steps (the final expansion)"): 1.665,
    ("fused_system_rk4_trajectory:cahn-hilliard",
     "41^2 x 2 Cahn-Hilliard, 800 coarse steps (the coarse roll-out)"): 2.695,
    ("fused_system_rk4_end:cahn-hilliard",
     "41^2 x 2 Cahn-Hilliard, 100 coarse steps (one slice of a coarse "
     "sweep)"): 0.430,
    ("fused_system_rk4_trajectory:wave", "21 x 23 x 2 wave, 200 steps"): 0.633,
    ("fused_system_rk4_trajectory:shallow-water",
     "21 x 23 x 3 shallow-water, 200 steps"): 1.418,
    ("cahn-hilliard 41^2 fine", "4000 steps"): 12.784,
    ("fused_system_rk4_trajectory:polar",
     "36 x 51 x 3 polar shallow water, 100 steps"): 1.682,
    ("fused_system_rk4_end:polar",
     "36 x 51 x 3 polar shallow water, 100 steps"): 1.603,
    ("fused_system_rk4_step:polar",
     "36 x 51 x 3 polar shallow water, 1 step"): 0.110,
    ("shallow water polar 36 x 51 x 3", "4000 steps"): 60.153,
}


def before_k1_redesign(key):
    """``; before the K1-K3 redesign X ms`` where section 6 of PERF.md
    has the time of ``key`` before the redesign, else an empty string."""
    ms = K1_BEFORE_REDESIGN_MS.get(key)
    return "" if ms is None else f"; before the K1-K3 redesign {ms:.3f} ms"


def before_redesign(key, what):
    """``; before the K5 redesign X ms`` where section 6 of PERF.md has
    the time of ``key`` at ``what``, else an empty string."""
    ms = K5_BEFORE_REDESIGN_MS.get((key, what))
    return "" if ms is None else f"; before the K5 redesign {ms:.3f} ms"


def stencil_bound(
    family: str,
    batch: int,
    n_steps: int,
    cells: int,
    components: int,
    trajectory: bool,
):
    """The bound of an RK4 stencil kernel: it reads each state and its
    constraint grids once (a float value and a byte mask a cell and
    component) and writes every step or the end state."""
    values = cells * components
    read = 4 * batch * values + 5 * values
    written = 4 * batch * values * (n_steps if trajectory else 1)
    return bound(
        read + written,
        FLOPS_PER_CELL_STEP[family] * batch * n_steps * cells,
    )


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


def flagship(prml, t_end=T_END, d_x=0.5, d=1.0):
    """The diffusion_2d Parareal flagship (bench.py:build_problem): with
    the defaults a 21 x 21 grid and diffusion coefficient 1."""
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
        prml.DiffusionEquation(2, d),
        prml.Mesh([(0.0, 10.0), (0.0, 10.0)], [d_x, d_x]),
        bcs,
    )
    ic = prml.GaussianInitialCondition(
        cp, [(np.full(2, 5.0), np.eye(2))], [1000.0]
    )
    return prml.InitialValueProblem(cp, (0.0, t_end), ic)


def grid_problem(prml, height, width):
    """A diffusion problem on an H x W grid of spacing 0.25 with the
    flagship's faces: Dirichlet 1.5 on axis 0, zero flux on axis 1."""
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
    return prml.ConstrainedProblem(
        prml.DiffusionEquation(2, 0.3),
        prml.Mesh(
            [(0.0, 0.25 * (height - 1)), (0.0, 0.25 * (width - 1))],
            [0.25, 0.25],
        ),
        bcs,
    )


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


def once_ms(torch, fn):
    """CUDA-event time of one run of ``fn()`` in ms, without a warm run:
    for plain versions that take seconds."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


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


def burgers(prml, t_end=None, mixed=False):
    """The 2D Burgers problem of bench.py's ``build_burgers_problem`` (to
    ``BURGERS_T_END`` unless ``t_end`` is given); with ``mixed``,
    Dirichlet faces of value 0.5 on axis 0 and the component fluxes
    (0.3, -0.2) on axis 1 instead of zero flux."""
    if t_end is None:
        t_end = BURGERS_T_END
    if mixed:
        bcs = [
            (
                prml.DirichletBoundaryCondition(
                    lambda x, t: np.full((len(x), 2), 0.5), is_static=True
                ),
            )
            * 2,
            (
                prml.NeumannBoundaryCondition(
                    lambda x, t: np.tile([0.3, -0.2], (len(x), 1)),
                    is_static=True,
                ),
            )
            * 2,
        ]
    else:
        bcs = [
            (
                prml.NeumannBoundaryCondition(
                    lambda x, t: np.zeros((len(x), 2)), is_static=True
                ),
            )
            * 2
        ] * 2
    cp = prml.ConstrainedProblem(
        prml.BurgersEquation(2, 100.0),
        prml.Mesh([(0.0, 5.0)] * 2, [0.25] * 2),
        bcs,
    )
    ic = prml.GaussianInitialCondition(
        cp, [(np.full(2, 2.5), 0.75 * np.eye(2))] * 2, [1.0, 0.5]
    )
    return prml.InitialValueProblem(cp, (0.0, t_end), ic)


def burgers_phases(
    torch, prml, device, card, cuda_ms, once_ms, device_busy_ms
):
    """Phases 5-8: the Burgers path. Returns the kernels' entries of the
    JSON line. ``cuda_ms``, ``once_ms`` and ``device_busy_ms`` are the
    timing and profiling functions."""
    from pararealml_tpu_torch.operators.fdm import (
        RK4,
        FDMOperator,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu_torch.operators.ml.supervised import (
        ReducedQuadraticStateOperatorRegressor,
        SupervisedMLOperator,
    )
    from pararealml_tpu_torch.operators.parareal import PararealOperator
    from pararealml_tpu_torch.ops import fused_system as fs
    from pararealml_tpu_torch.ops import packed_system as ps
    from pararealml_tpu_torch.utils import SEEDS, set_random_seed

    modules = {"fused_system": fs, "packed_system": ps}
    wrappers = {
        name: getattr(modules[module], name)
        for name, module, _, _ in SYSTEM_KERNELS
    }
    plain = {
        name: getattr(modules[module], f"{name}_reference")
        for name, module, _, _ in SYSTEM_KERNELS
    }
    errors = {name: 0.0 for name in wrappers}
    fine_steps = round(BURGERS_T_END / BURGERS_FINE_D_T)
    slice_steps = fine_steps // BURGERS_SLICES

    # -- phase 5: K4 and K5 against their plain versions -----------------
    ivp = burgers(prml)
    cp = ivp.constrained_problem
    y_0 = torch.as_tensor(
        ivp.initial_condition.discrete_y_0(True),
        dtype=torch.float32,
        device=device,
    )
    k5_head = None
    mixed = burgers(prml, 1.0, True)
    for label, problem in (("bench", ivp), ("mixed", mixed)):
        cfg = fs._SystemKernelConfig(
            problem.constrained_problem, BURGERS_FINE_D_T
        )
        y = torch.as_tensor(
            problem.initial_condition.discrete_y_0(True),
            dtype=torch.float32,
            device=device,
        )
        batch = torch.stack(
            [y * (0.5 + 0.125 * i) + 0.05 * i for i in range(8)]
        ).contiguous()
        checks = [
            ("fused_system_rk4_trajectory", y, "200 steps", 200),
            ("fused_system_rk4_end", y, "single, 200 steps", 200),
            ("fused_system_rk4_end", batch, "B=8, 200 steps", 200),
            ("fused_system_rk4_step", batch, "B=8", None),
            ("packed_system_rk4_ends", batch, "B=8, 200 steps", 200),
            ("packed_system_rk4_trajectory", batch, "B=8, 200 steps", 200),
        ]
        if label == "bench":
            # the main path's own shapes: one iteration's fine ends and
            # the final expansion of 100 slices x 800 steps, and the
            # first 2,000 steps of the fine solve
            slices = torch.stack(
                [y * (0.9 + 0.002 * i) for i in range(BURGERS_SLICES)]
            ).contiguous()
            checks += [
                ("packed_system_rk4_ends", slices,
                 f"B={BURGERS_SLICES}, {slice_steps} steps", slice_steps),
                ("packed_system_rk4_trajectory", slices,
                 f"B={BURGERS_SLICES}, {slice_steps} steps", slice_steps),
                ("fused_system_rk4_trajectory", y,
                 f"{K5_HEAD_STEPS} steps", K5_HEAD_STEPS),
            ]
        for name, state, what, n_steps in checks:
            args = (state, cfg) if n_steps is None else (state, cfg, n_steps)
            kernel = wrappers[name](*args)
            reference = plain[name](*args)
            torch.cuda.synchronize()
            assert kernel.shape == reference.shape, (name, what)
            abs_err = float((kernel - reference).abs().max())
            rel_err = abs_err / float(reference.abs().max())
            errors[name] = max(errors[name], abs_err)
            log(
                f"kernels: burgers {label:5s} {name} ({what}): "
                f"max|d|/max|y| = {rel_err:.3e}"
            )
            if not rel_err <= KERNEL_REL_TOL:
                raise AssertionError(
                    f"{name} disagrees with its plain version on {label}"
                )
            if label == "bench" and what == f"{K5_HEAD_STEPS} steps":
                k5_head = kernel.double().cpu().numpy()
    log("phase burgers kernels: ok")

    # -- phase 6: the main path, counted ---------------------------------
    # no device argument anywhere: the entry points run on the card
    fine = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), BURGERS_FINE_D_T
    )
    model = ReducedQuadraticStateOperatorRegressor(882, rank=BURGERS_RANK)
    model.load(BURGERS_ASSET)
    coarse = SupervisedMLOperator(BURGERS_T_END / BURGERS_SLICES, True)
    coarse.model = model
    parareals = {
        label: PararealOperator(
            fine,
            coarse,
            BURGERS_TOLERANCE,
            num_time_slices=BURGERS_SLICES,
            max_iterations=max_iterations,
        )
        for label, max_iterations in (
            ("robust", BURGERS_MAX_ITERATIONS),
            ("one_shot", 1),
        )
    }
    example_ivp = burgers(prml, EXAMPLE_T_END)
    example_coarse = SupervisedMLOperator(EXAMPLE_T_END / EXAMPLE_SLICES, True)

    for wrapper in wrappers.values():
        wrapper.launches = 0
    fine_ys = fine.solve(ivp).discrete_y()
    fine_launches = {name: w.launches for name, w in wrappers.items()}
    solutions, iterations = {}, {}
    for label, parareal in parareals.items():
        solutions[label] = parareal.solve(ivp).discrete_y()
        iterations[label] = parareal.last_iterations
    set_random_seed(SEEDS[0])
    data = example_coarse.generate_data(
        example_ivp,
        fine,
        EXAMPLE_RUNS,
        lambda t, y: y * np.random.uniform(0.9, 1.1, size=y.shape),
    )
    example_model = ReducedQuadraticStateOperatorRegressor(
        882, rank=EXAMPLE_RANK
    )
    train_mse, test_mse = example_coarse.fit_model(example_model, data)
    launches = {name: w.launches for name, w in wrappers.items()}

    log(
        f"burgers main-path launches: {launches} (fine solve alone: "
        f"{fine_launches}); iterations {iterations}"
    )
    assert fine.device.type == coarse.device.type == "cuda"
    assert fine_launches["fused_system_rk4_trajectory"] >= 1
    assert launches["packed_system_rk4_ends"] == sum(iterations.values())
    assert launches["packed_system_rk4_trajectory"] == len(parareals)
    # the example's data generation: one batched launch per coarse step
    assert (
        launches["fused_system_rk4_trajectory"]
        == fine_launches["fused_system_rk4_trajectory"] + EXAMPLE_SLICES
    )
    for name, _, _, on_path in SYSTEM_KERNELS:
        if on_path and launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    assert fine_ys.shape == (fine_steps, 21, 21, 2), fine_ys.shape
    assert np.isfinite(fine_ys).all()
    assert np.array_equal(fine_ys[: len(k5_head)], k5_head)
    log(
        f"phase burgers fine: trajectory {fine_ys.shape}, finite, first "
        f"{len(k5_head)} steps equal to phase 5's K5 output"
    )
    diffs = {}
    for label, ys in solutions.items():
        assert ys.shape == fine_ys.shape and np.isfinite(ys).all(), label
        diffs[label] = float(np.abs(ys - fine_ys).max())
    log(
        f"phase burgers parareal: robust {iterations['robust']} iterations, "
        f"max diff vs fine {diffs['robust']:.3e} (gate "
        f"{2 * BURGERS_TOLERANCE:g}); one-shot max diff vs fine "
        f"{diffs['one_shot']:.3e}"
    )
    assert diffs["robust"] <= 2 * BURGERS_TOLERANCE, diffs
    log(
        f"phase burgers example fit: inputs {data[0].shape}, rank "
        f"{EXAMPLE_RANK}, MSE train {train_mse!r} test {test_mse!r}"
    )
    assert np.isfinite(train_mse) and np.isfinite(test_mse)
    del fine_ys, solutions, data

    # -- phase 7: times --------------------------------------------------
    fine_fn, _ = fine.trajectory_function(cp, (0.0, BURGERS_T_END))
    runs = {"burgers fine": lambda: fine_fn(y_0)}
    run_ms = {"burgers fine": cuda_ms(torch, runs["burgers fine"], reps=3)}
    fine_bound_ms, fine_bound_by = stencil_bound(
        "burgers", 1, fine_steps, 21 * 21, 2, True
    )
    log(
        f"time: burgers fine solve, K5 trajectory, {fine_steps} steps: "
        f"{run_ms['burgers fine']:.3f} ms, bound {fine_bound_ms * 1e3:.3f} "
        f"us ({fine_bound_by})"
        f"{before_redesign('burgers fine', f'{fine_steps} steps')} [{card}]"
    )
    for label, parareal in parareals.items():
        program, _ = parareal.trajectory_function(cp, (0.0, BURGERS_T_END))
        key = f"burgers parareal {label}"
        runs[key] = lambda program=program: program(y_0)
        run_ms[key] = cuda_ms(torch, runs[key])
        log(
            f"time: {key}: {run_ms[key]:.3f} ms, speedup vs K5 fine "
            f"{run_ms['burgers fine'] / run_ms[key]:.3f}x, "
            f"{parareal.last_iterations} iterations [{card}]"
        )

    cfg = fs._SystemKernelConfig(cp, BURGERS_FINE_D_T)
    cells = cfg.height * cfg.width
    y_grid = y_0.contiguous()
    slices = torch.stack(
        [y_grid * (0.9 + 0.002 * i) for i in range(BURGERS_SLICES)]
    ).contiguous()
    n = BURGERS_SLICES
    timings = {
        "packed_system_rk4_ends": (
            f"B={n}, {slice_steps} steps (one iteration's fine ends)",
            (slices, cfg, slice_steps),
            stencil_bound("burgers", n, slice_steps, cells, 2, False),
        ),
        "packed_system_rk4_trajectory": (
            f"B={n}, {slice_steps} steps (the final expansion)",
            (slices, cfg, slice_steps),
            stencil_bound("burgers", n, slice_steps, cells, 2, True),
        ),
        "fused_system_rk4_trajectory": (
            f"21x21x2, {K5_HEAD_STEPS} steps",
            (y_grid, cfg, K5_HEAD_STEPS),
            stencil_bound("burgers", 1, K5_HEAD_STEPS, cells, 2, True),
        ),
        "fused_system_rk4_end": (
            f"21x21x2, {slice_steps} steps",
            (y_grid, cfg, slice_steps),
            stencil_bound("burgers", 1, slice_steps, cells, 2, False),
        ),
        "fused_system_rk4_step": (
            "21x21x2, 1 step",
            (y_grid, cfg),
            stencil_bound("burgers", 1, 1, cells, 2, True),
        ),
    }
    entries = []
    for name, module, replaces, on_path in SYSTEM_KERNELS:
        what, args, (bound_ms, bound_by) = timings[name]
        kernel_ms = cuda_ms(torch, lambda: wrappers[name](*args))
        # the plain versions take seconds at the path's shapes: one run
        plain_ms = once_ms(torch, lambda: plain[name](*args))
        log(
            f"time: {name} ({what}): kernel {kernel_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms (one run), bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}){before_redesign(name, what)} [{card}]"
        )
        entries.append(
            {
                "name": name,
                "route": "cuda",
                "source": SYSTEM_SOURCE,
                "replaces": replaces,
                "on_path": on_path,
                "launches": launches[name],
                "max_abs_err": errors[name],
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_us": bound_ms * 1e3,
                "bound_by": bound_by,
                "library_ms": None,
                "timed": what,
            }
        )

    # the example's data generation: EXAMPLE_SLICES batched K5 trajectory
    # launches of EXAMPLE_RUNS perturbed states over one slice each, timed
    # end to end (host loop and perturbations included) and one launch
    # alone
    def generate():
        set_random_seed(SEEDS[0])
        example_coarse.generate_data(
            example_ivp,
            fine,
            EXAMPLE_RUNS,
            lambda t, y: y * np.random.uniform(0.9, 1.1, size=y.shape),
        )

    generate_ms = cuda_ms(torch, generate, reps=3)
    example_steps = round(EXAMPLE_T_END / EXAMPLE_SLICES / BURGERS_FINE_D_T)
    runs_batch = torch.stack(
        [y_grid * (0.9 + 0.02 * i) for i in range(EXAMPLE_RUNS)]
    ).contiguous()
    launch_ms = cuda_ms(
        torch,
        lambda: fs.fused_system_rk4_trajectory(runs_batch, cfg, example_steps),
    )
    launch_bound_ms, launch_bound_by = stencil_bound(
        "burgers", EXAMPLE_RUNS, example_steps, cells, 2, True
    )
    log(
        f"time: generate_data ({EXAMPLE_SLICES} batched K5 trajectory "
        f"launches of B={EXAMPLE_RUNS} x {example_steps} steps): "
        f"{generate_ms:.3f} ms end to end; one launch {launch_ms:.3f} ms "
        f"(x {EXAMPLE_SLICES} = {EXAMPLE_SLICES * launch_ms:.3f} ms), bound "
        f"{launch_bound_ms * 1e3:.3f} us ({launch_bound_by}) [{card}]"
    )
    del runs_batch

    # -- phase 8: device busy time and idle share (torch.profiler) -------
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
    return entries


def large_grid_problem(prml, h_extent, w_extent, d_x, convection, flux):
    """tests/test_tiled_diffusion.py's problem: coefficient 0.3, Dirichlet
    rows of value 1.5, Neumann columns of the given flux."""
    if convection:
        diff_eq = prml.ConvectionDiffusionEquation(2, [0.8, -0.4], 0.3)
    else:
        diff_eq = prml.DiffusionEquation(2, 0.3)
    bcs = [
        (
            prml.DirichletBoundaryCondition(
                lambda x, t: np.full((len(x), 1), 1.5), is_static=True
            ),
        )
        * 2,
        (
            prml.NeumannBoundaryCondition(
                lambda x, t: np.full((len(x), 1), flux), is_static=True
            ),
        )
        * 2,
    ]
    return prml.ConstrainedProblem(
        diff_eq, prml.Mesh([(0.0, h_extent), (0.0, w_extent)], [d_x, d_x]), bcs
    )


def bench_diffusion(prml, n, steps, d_t):
    """bench.py:build_problem's diffusion on an n x n grid of [0, 10]^2
    (Dirichlet 1.5 on the x faces, zero flux on the y faces, a Gaussian
    of amplitude 1000) with d = 0.05, over ``steps`` steps of ``d_t``."""
    return flagship(prml, steps * d_t, 10.0 / (n - 1), LARGE_DIFFUSIVITY)


def large_grid_bound(cfg, n_steps, frame_bytes):
    """The bound of a Horner-form trajectory kernel: the state read once
    and every frame written once, against its float32 operations."""
    cells = cfg.height * cfg.width
    return bound(
        4 * cells + n_steps * cells * frame_bytes,
        cfg.flops_per_cell_step * n_steps * cells,
    )


def tiled_traffic_ms(plan, cfg, n_steps, temporal_block, state_bytes,
                     frame_bytes, separate_state):
    """The time the tiled kernel's own traffic takes at the card's
    memory rate: per residency every block reads its haloed tile (and
    writes its tile of the carried state where the frames do not carry
    it), and every step writes one frame."""
    cells = cfg.height * cfg.width
    residencies = n_steps // temporal_block
    tiles = plan.n_tiles_h * plan.n_tiles_w
    moved = residencies * tiles * plan.smem_rows * plan.smem_cols * state_bytes
    if separate_state:
        moved += residencies * cells * state_bytes
    moved += n_steps * cells * frame_bytes
    return 1e3 * moved / PEAK_BYTES_PER_S


def large_grid_phases(
    torch, prml, device, card, cuda_ms, once_ms, device_busy_ms
):
    """Phases 9-12: the large-grid diffusion path. Returns the two
    kernels' entries of the JSON line. ``cuda_ms``, ``once_ms`` and
    ``device_busy_ms`` are the timing and profiling functions."""
    from pararealml_tpu_torch.operators.fdm import (
        RK4,
        FDMOperator,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu_torch.ops import fused_diffusion as fd
    from pararealml_tpu_torch.ops import resident_diffusion as rd
    from pararealml_tpu_torch.ops import tiled_diffusion as td

    modules = {"resident_diffusion": rd, "tiled_diffusion": td}
    wrappers = {
        name: getattr(modules[module], name)
        for name, module, _ in LARGE_KERNELS
    }
    k7, k6 = (name for name, _, _ in LARGE_KERNELS)
    errors = {name: 0.0 for name in wrappers}
    bf16, f32 = torch.bfloat16, torch.float32

    def check(name, what, kernel, plain, tolerance=KERNEL_REL_TOL):
        torch.cuda.synchronize()
        assert kernel.shape == plain.shape, (name, what)
        assert kernel.dtype == plain.dtype, (name, what)
        abs_err = float((kernel.float() - plain.float()).abs().max())
        rel_err = abs_err / float(plain.float().abs().max())
        errors[name] = max(errors[name], abs_err)
        if not rel_err <= tolerance:
            raise AssertionError(
                f"{name} disagrees with its plain version ({what}): "
                f"{rel_err:.3e}"
            )
        return rel_err

    # -- phase 9: K6 and K7 against their plain versions, small grids ----
    small_problems = {
        "folded 17x33": (4.0, 8.0, 0.25, False, 0.0),
        "convection 33x17": (8.0, 4.0, 0.25, True, 0.2),
        "flux 81x81": (10.0, 10.0, 0.125, False, 0.1),
        "folded convection 81x81": (10.0, 10.0, 0.125, True, 0.0),
    }
    for label, args in small_problems.items():
        cp = large_grid_problem(prml, *args)
        height, width = cp.mesh.vertices_shape
        x = torch.linspace(0.0, 3.0, height, device=device)[:, None]
        z = torch.linspace(0.0, 2.0, width, device=device)[None, :]
        y = (1.5 + torch.sin(2.0 * x) * torch.cos(3.0 * z)).contiguous()
        resident_cfg = td._HornerConfig(cp, 0.005, resident=True)
        tiled_cfg = td._HornerConfig(cp, 0.005)
        worst = {k7: 0.0, k6: 0.0}
        count = {k7: 0, k6: 0}
        # 8 x 8 tiles with a barrier every step and every third step (23
        # steps: the last group is cut short)
        tiles = (-(-height // 8), -(-width // 8), 8, 8)
        resident_plans = (
            None, rd._ResidentPlan(*tiles, 1), rd._ResidentPlan(*tiles, 3)
        )
        for storage in (f32, bf16):
            plain = rd.resident_diffusion_rk4_trajectory_reference(
                y, resident_cfg, 23, storage
            )
            for plan in resident_plans:
                kernel = rd.resident_diffusion_rk4_trajectory(
                    y, resident_cfg, 23, storage, plan=plan
                )
                worst[k7] = max(
                    worst[k7], check(k7, f"{label}, {storage}", kernel, plain)
                )
                count[k7] += 1
        for block in (1, 2, 4):
            dtypes = [(None, None), (bf16, None)]
            if block > 1:
                dtypes += [(None, bf16), (bf16, f32)]
            # tiles of max(12, halo) x max(20, halo) cells
            small_tiled = td.make_tile_plan(
                height,
                width,
                block,
                8 * block + max(12, 4 * block),
                8 * block + max(20, 4 * block),
            )
            assert small_tiled is not None
            for storage, traj in dtypes:
                plain = td.tiled_diffusion_rk4_trajectory_reference(
                    y, tiled_cfg, 16, storage, traj, block
                )
                for plan in (None, small_tiled):
                    kernel = td.tiled_diffusion_rk4_trajectory(
                        y, tiled_cfg, 16, storage, traj, block, plan=plan
                    )
                    worst[k6] = max(
                        worst[k6],
                        check(
                            k6,
                            f"{label}, block {block}, {storage}, {traj}",
                            kernel,
                            plain,
                        ),
                    )
                    count[k6] += 1
        log(
            f"kernels: large-grid {label}: K7 {count[k7]} cases (float32 "
            f"and bfloat16 frames, own plan and 8x8 tiles with a barrier "
            f"per 1 and per 3 steps) max|d|/max|y| = "
            f"{worst[k7]:.3e}; K6 {count[k6]} cases (blocks 1, 2, 4, "
            f"float32 and bfloat16 state and frames, own plan and small "
            f"tiles) max|d|/max|y| = {worst[k6]:.3e}"
        )
    # K6 against K7 on one grid both take: they share the arithmetic up to
    # the rounding of the folded coefficients
    cp = large_grid_problem(prml, 10.0, 10.0, 10.0 / 160.0, False, 0.0)
    x = torch.linspace(0.0, 3.0, 161, device=device)[:, None]
    y = (1.5 + torch.sin(2.0 * x) * torch.cos(3.0 * x.T)).contiguous()
    tiled = td.tiled_diffusion_rk4_trajectory(
        y, td._HornerConfig(cp, 2e-3), 50
    )
    resident = rd.resident_diffusion_rk4_trajectory(
        y, td._HornerConfig(cp, 2e-3, resident=True), 50
    )
    torch.cuda.synchronize()
    cross = float((tiled - resident).abs().max() / resident.abs().max())
    log(
        f"kernels: K6 against K7, 161x161, 50 steps: max|d|/max|y| = "
        f"{cross:.3e} (tolerance {KERNEL_REL_TOL:g})"
    )
    assert cross <= KERNEL_REL_TOL, cross
    log("phase large-grid kernels: ok")

    # -- phase 10: the path at full width, counted -----------------------
    large_ivp = bench_diffusion(prml, LARGE_N, LARGE_STEPS, LARGE_D_T)
    stream_ivp = bench_diffusion(prml, STREAM_N, STREAM_STEPS, STREAM_D_T)
    large_cp = large_ivp.constrained_problem
    stream_cp = stream_ivp.constrained_problem
    assert rd.make_resident_plan(LARGE_N, LARGE_N) is not None
    assert td.takes_streaming_path(stream_cp)
    # the storage knobs take effect past the JAX package's VMEM cap only,
    # as there: both grids lie past it, so their bfloat16 runs keep
    # bfloat16 (the dtype checks below)
    assert fd.past_reference_vmem(large_cp)
    assert fd.past_reference_vmem(stream_cp)

    def initial(ivp):
        return torch.as_tensor(
            ivp.initial_condition.discrete_y_0(True),
            dtype=f32,
            device=device,
        )

    def fdm(d_t, **kwargs):
        # no device argument: the entry points run on the card
        return FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), d_t, **kwargs
        )

    def trajectory_fn(cp, d_t, steps, **kwargs):
        return fdm(d_t, **kwargs).trajectory_function(
            cp, (0.0, steps * d_t)
        )[0]

    large_y, stream_y = initial(large_ivp), initial(stream_ivp)
    large_fns = {
        "float32": trajectory_fn(large_cp, LARGE_D_T, LARGE_STEPS),
        "bfloat16 frames": trajectory_fn(
            large_cp, LARGE_D_T, LARGE_STEPS, kernel_storage_dtype=bf16
        ),
    }
    stream_fns = {
        "float32, block 1": trajectory_fn(
            stream_cp, STREAM_D_T, STREAM_STEPS
        ),
        "float32, block 2": trajectory_fn(
            stream_cp, STREAM_D_T, STREAM_STEPS, kernel_temporal_block=2
        ),
        "bfloat16 state, block 2": trajectory_fn(
            stream_cp,
            STREAM_D_T,
            STREAM_STEPS,
            kernel_storage_dtype=bf16,
            kernel_temporal_block=2,
        ),
    }

    def last_frame(ys, n, steps, dtype):
        """Checks a trajectory's shape and dtype and its last frame
        (finite, Dirichlet x faces at 1.5) and returns that frame."""
        assert tuple(ys.shape) == (steps, n, n, 1), ys.shape
        assert ys.dtype == dtype, ys.dtype
        last = ys[-1].float().clone()
        assert bool(torch.isfinite(last).all())
        assert bool((last[0] == 1.5).all()) and bool((last[-1] == 1.5).all())
        return last

    for wrapper in wrappers.values():
        wrapper.launches = 0
    large_last = {}
    for label, fn in large_fns.items():
        ys = fn(large_y, 0.0)
        large_last[label] = last_frame(
            ys, LARGE_N, LARGE_STEPS, f32 if label == "float32" else bf16
        )
        if label == "float32":
            large_head = ys[:LARGE_PLAIN_STEPS].clone()
        del ys
    solved = fdm(LARGE_D_T).solve(
        bench_diffusion(prml, LARGE_N, LARGE_SOLVE_STEPS, LARGE_D_T)
    ).discrete_y()
    large_launches = {name: w.launches for name, w in wrappers.items()}
    stream_last = {}
    for label, fn in stream_fns.items():
        ys = fn(stream_y, 0.0)
        stream_last[label] = last_frame(
            ys,
            STREAM_N,
            STREAM_STEPS,
            bf16 if label.startswith("bfloat16") else f32,
        )
        if label == "float32, block 1":
            stream_f32 = ys
        elif label == "float32, block 2":
            assert torch.equal(ys, stream_f32), "block 2 differs from block 1"
        del ys
    stream_head = stream_f32[:STREAM_PLAIN_STEPS].clone()
    del stream_f32
    torch.cuda.empty_cache()
    launches = {name: w.launches for name, w in wrappers.items()}
    log(
        f"large-grid main-path launches: {launches} (the {LARGE_N}x{LARGE_N} "
        f"runs alone: {large_launches}); CUDA launches inside: K7 one "
        f"cooperative launch per trajectory, K6 {STREAM_STEPS} per "
        f"trajectory at block 1 and {STREAM_STEPS // 2} at block 2"
    )
    assert large_launches == {k7: len(large_fns) + 1, k6: 0}, large_launches
    assert launches[k6] == len(stream_fns), launches
    assert launches[k7] == large_launches[k7], launches
    assert solved.shape == (LARGE_SOLVE_STEPS, LARGE_N, LARGE_N, 1)
    assert solved.dtype == np.float64 and np.isfinite(solved).all()
    assert np.array_equal(
        solved, large_head[:LARGE_SOLVE_STEPS].double().cpu().numpy()
    )
    log(
        f"phase large-grid path: {LARGE_N}x{LARGE_N} x {LARGE_STEPS} steps "
        f"(K7) and {STREAM_N}x{STREAM_N} x {STREAM_STEPS} steps (K6): last "
        f"frames finite with Dirichlet faces 1.5, block 2 equal to block 1, "
        f"solve over {LARGE_SOLVE_STEPS} steps equal to the trajectory's "
        f"first frames"
    )
    bf16_errors = {
        "resident": float(
            (large_last["bfloat16 frames"] - large_last["float32"]).abs().max()
            / large_last["float32"].abs().max()
        ),
        "tiled": float(
            (
                stream_last["bfloat16 state, block 2"]
                - stream_last["float32, block 1"]
            ).abs().max()
            / stream_last["float32, block 1"].abs().max()
        ),
    }
    log(
        f"bfloat16 against float32, last frame, max|d|/max|y|: K7 frames "
        f"{bf16_errors['resident']:.3e} (one rounding; limit "
        f"{RESIDENT_BF16_TOL:.3e}), K6 state at block 2 "
        f"{bf16_errors['tiled']:.3e} ({STREAM_STEPS // 2} roundings; limit "
        f"{TILED_BF16_TOL:g})"
    )
    assert bf16_errors["resident"] <= RESIDENT_BF16_TOL
    assert bf16_errors["tiled"] <= TILED_BF16_TOL

    # the first frames against the generic path, and a cut-down step
    # count against the plain versions (on the same CUDA tensors)
    for label, cp, d_t, y, head, head_steps in (
        ("K7", large_cp, LARGE_D_T, large_y, large_head, LARGE_HEAD_STEPS),
        ("K6", stream_cp, STREAM_D_T, stream_y, stream_head,
         STREAM_HEAD_STEPS),
    ):
        generic = trajectory_fn(cp, d_t, head_steps, fused_kernels=False)(
            y, 0.0
        )
        difference = (head[:head_steps] - generic).abs()
        allowed = 1e-4 + 1e-4 * generic.abs()
        log(
            f"phase large-grid path: {label} first {head_steps} frames "
            f"against the generic path: max|d| = {float(difference.max()):.3e}"
            f" (atol = rtol = 1e-4)"
        )
        assert bool((difference <= allowed).all()), label
        del generic, difference, allowed
    plain = rd.resident_diffusion_rk4_trajectory_reference(
        large_y[..., 0].contiguous(),
        td._HornerConfig(large_cp, LARGE_D_T, resident=True),
        LARGE_PLAIN_STEPS,
    )
    rel = check(k7, "full width", large_head[..., 0], plain)
    log(
        f"kernels: {k7} ({LARGE_N}x{LARGE_N}, {LARGE_PLAIN_STEPS} steps): "
        f"max|d|/max|y| = {rel:.3e}"
    )
    plain = td.tiled_diffusion_rk4_trajectory_reference(
        stream_y[..., 0].contiguous(),
        td._HornerConfig(stream_cp, STREAM_D_T),
        STREAM_PLAIN_STEPS,
    )
    rel = check(k6, "full width", stream_head[..., 0], plain)
    log(
        f"kernels: {k6} ({STREAM_N}x{STREAM_N}, {STREAM_PLAIN_STEPS} "
        f"steps): max|d|/max|y| = {rel:.3e}"
    )
    del plain, large_head, stream_head, large_last, stream_last
    torch.cuda.empty_cache()

    # -- phase 11: times -------------------------------------------------
    resident_cfg = td._HornerConfig(large_cp, LARGE_D_T, resident=True)
    tiled_cfg = td._HornerConfig(stream_cp, STREAM_D_T)
    run_ms = {}
    for label, fn in large_fns.items():
        key = f"{LARGE_N}x{LARGE_N} {label}"
        run_ms[key] = cuda_ms(torch, lambda fn=fn: fn(large_y, 0.0))
        bound_ms, bound_by = large_grid_bound(
            resident_cfg, LARGE_STEPS, 4 if label == "float32" else 2
        )
        log(
            f"time: K7 {key}, {LARGE_STEPS} steps: {run_ms[key]:.3f} ms "
            f"({1e3 * run_ms[key] / LARGE_STEPS:.3f} us a step), bound "
            f"{bound_ms:.3f} ms ({bound_by}) [{card}]"
        )
    for label, fn in stream_fns.items():
        key = f"{STREAM_N}x{STREAM_N} {label}"
        run_ms[key] = cuda_ms(torch, lambda fn=fn: fn(stream_y, 0.0))
        block = 1 if label.endswith("1") else 2
        item = 2 if label.startswith("bfloat16") else 4
        bound_ms, bound_by = large_grid_bound(tiled_cfg, STREAM_STEPS, item)
        traffic_ms = tiled_traffic_ms(
            td.make_tile_plan(STREAM_N, STREAM_N, block),
            tiled_cfg, STREAM_STEPS, block, item, item, False,
        )
        log(
            f"time: K6 {key}, {STREAM_STEPS} steps: {run_ms[key]:.3f} ms "
            f"({1e3 * run_ms[key] / STREAM_STEPS:.3f} us a step), bound "
            f"{bound_ms:.3f} ms ({bound_by}), the kernel's own traffic "
            f"(haloed tile reads and frames) {traffic_ms:.3f} ms at the "
            f"memory rate [{card}]"
        )
    generic_fn = trajectory_fn(
        large_cp, LARGE_D_T, GENERIC_TIMED_STEPS, fused_kernels=False
    )
    generic_ms = cuda_ms(torch, lambda: generic_fn(large_y, 0.0), reps=3)
    scaled_ms = generic_ms * LARGE_STEPS / GENERIC_TIMED_STEPS
    k7_ms = run_ms[f"{LARGE_N}x{LARGE_N} float32"]
    log(
        f"time: generic path {LARGE_N}x{LARGE_N}, {GENERIC_TIMED_STEPS} "
        f"steps: {generic_ms:.3f} ms (median of 3), scaled to "
        f"{LARGE_STEPS} steps {scaled_ms:.3f} ms (scaled, not run): K7 "
        f"{scaled_ms / k7_ms:.3f}x faster [{card}]"
    )
    large_grid, stream_grid = (
        y[..., 0].contiguous() for y in (large_y, stream_y)
    )
    plain_ms = {
        k7: once_ms(
            torch,
            lambda: rd.resident_diffusion_rk4_trajectory_reference(
                large_grid, resident_cfg, LARGE_STEPS
            ),
        ),
        k6: once_ms(
            torch,
            lambda: td.tiled_diffusion_rk4_trajectory_reference(
                stream_grid, tiled_cfg, STREAM_STEPS
            ),
        ),
    }
    torch.cuda.empty_cache()
    # what a grid-wide barrier costs K7: the same solve with one barrier
    # per 1, 2 and 4 steps (the plan's choice is 2)
    for steps_per_barrier in (1, 2, 4):
        plan = rd.make_resident_plan(LARGE_N, LARGE_N, steps_per_barrier)
        if plan is None:
            continue
        barrier_ms = cuda_ms(
            torch,
            lambda plan=plan: rd.resident_diffusion_rk4_trajectory(
                large_grid, resident_cfg, LARGE_STEPS, plan=plan
            ),
        )
        log(
            f"time: K7 {LARGE_N}x{LARGE_N} float32, one barrier per "
            f"{steps_per_barrier} steps, {plan.n_tiles_h}x{plan.n_tiles_w} "
            f"tiles of {plan.tile_h}x{plan.tile_w}: {barrier_ms:.3f} ms "
            f"[{card}]"
        )
    timed = {
        k7: (
            f"{LARGE_N}x{LARGE_N}, {LARGE_STEPS} steps, float32",
            k7_ms,
            large_grid_bound(resident_cfg, LARGE_STEPS, 4),
        ),
        k6: (
            f"{STREAM_N}x{STREAM_N}, {STREAM_STEPS} steps, float32, block 1",
            run_ms[f"{STREAM_N}x{STREAM_N} float32, block 1"],
            large_grid_bound(tiled_cfg, STREAM_STEPS, 4),
        ),
    }
    entries = []
    for name, _, replaces in LARGE_KERNELS:
        what, kernel_ms, (bound_ms, bound_by) = timed[name]
        log(
            f"time: {name} ({what}): kernel {kernel_ms:.3f} ms, plain "
            f"{plain_ms[name]:.3f} ms (one run), bound {bound_ms:.3f} ms "
            f"({bound_by}) [{card}]"
        )
        entries.append(
            {
                "name": name,
                "route": "cuda",
                "source": LARGE_SOURCE,
                "replaces": replaces,
                "on_path": True,
                "launches": launches[name],
                "max_abs_err": errors[name],
                "ms": kernel_ms,
                "plain_ms": plain_ms[name],
                "bound_ms": bound_ms,
                "bound_us": bound_ms * 1e3,
                "bound_by": bound_by,
                "library_ms": None,
                "timed": what,
            }
        )

    # -- phase 12: device busy time and idle share (torch.profiler) ------
    profiled = {
        f"{LARGE_N}x{LARGE_N} float32": lambda: large_fns["float32"](
            large_y, 0.0
        ),
        f"{STREAM_N}x{STREAM_N} float32, block 1": lambda: stream_fns[
            "float32, block 1"
        ](stream_y, 0.0),
    }
    for label, run in profiled.items():
        busy_ms, top = device_busy_ms(torch, run)
        if busy_ms is None:
            # the profiler at times reports no device event for a run of
            # one long kernel: ask once more
            busy_ms, top = device_busy_ms(torch, run, reps=1)
        if busy_ms is None:
            log(f"profile: {label}: not measured (no device events)")
            continue
        log(
            f"profile: {label}: device busy {busy_ms:.3f} ms of "
            f"{run_ms[label]:.3f} ms, idle share "
            f"{1.0 - busy_ms / run_ms[label]:.3f}; top: {top} [{card}]"
        )
    return entries


def burgers_3d(prml):
    """bench.py's ``bench_3d`` problem: 3-component viscous Burgers (Re =
    100) on [0, 5]^3 at d_x 0.25 (21^3), zero-flux faces, a Gaussian of
    covariance 0.5 I in the first component, over ``BURGERS_3D_STEPS``
    steps of ``BURGERS_3D_D_T``."""
    n = 3
    bcs = [
        (
            prml.NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), n)), is_static=True
            ),
        )
        * 2
    ] * 3
    cp = prml.ConstrainedProblem(
        prml.BurgersEquation(3, 100.0),
        prml.Mesh([(0.0, 5.0)] * 3, [0.25] * 3),
        bcs,
    )
    ic = prml.GaussianInitialCondition(
        cp, [(np.full(3, 2.5), 0.5 * np.eye(3))] * n, [1.0, 0.0, 0.0]
    )
    return prml.InitialValueProblem(
        cp, (0.0, BURGERS_3D_STEPS * BURGERS_3D_D_T), ic
    )


def cahn_hilliard_3d(torch, prml, n_steps):
    """examples/cahn_hilliard_3d_fdm.py's problem: Cahn-Hilliard with
    gamma = 0.5 on [1, 31]^3 at d_x 1 (31^3), zero-flux faces, y0 a
    uniform perturbation of amplitude 0.05 from numpy seed 0 and y1 its
    chemical potential, over ``n_steps`` steps of ``CH_3D_D_T``."""
    from pararealml_tpu_torch.operators.fdm import (
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu_torch.operators.fdm.numerical_differentiator import (
        slice_all_constraint_pairs,
    )

    mesh = prml.Mesh([(1.0, 31.0)] * 3, [1.0] * 3)
    bcs = [
        (
            prml.NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 2)), is_static=True
            ),
        )
        * 2
    ] * 3
    cp = prml.ConstrainedProblem(
        prml.CahnHilliardEquation(3, gamma=CH_3D_GAMMA), mesh, bcs
    )
    np.random.seed(0)
    y_0_0 = 0.05 * np.random.uniform(-1.0, 1.0, mesh.vertices_shape + (1,))
    d_y_constraints = slice_all_constraint_pairs(
        cp.static_boundary_vertex_constraints.d_y, slice(0, 1)
    )
    laplacian = ThreePointCentralDifferenceMethod().laplacian(
        torch.as_tensor(y_0_0), mesh, d_y_constraints
    ).numpy()
    y_0_1 = y_0_0**3 - y_0_0 - CH_3D_GAMMA * laplacian
    ic = prml.DiscreteInitialCondition(
        cp, np.concatenate([y_0_0, y_0_1], axis=-1), True
    )
    return prml.InitialValueProblem(cp, (0.0, n_steps * CH_3D_D_T), ic)


def problem_3d(prml, family, dirichlet, shape):
    """A small problem of one of K9's families (tests/test_torch_cuda.py's
    ``problem_3d``): spacing 0.125, zero-flux faces, or Dirichlet 0.1 on
    the lower and Neumann 0.05 on the upper face of every axis."""
    equation, n = {
        "diffusion": (prml.DiffusionEquation(3, 0.3), 1),
        "convection-diffusion": (
            prml.ConvectionDiffusionEquation(3, [0.4, -0.3, 0.2], 0.2),
            1,
        ),
        "wave": (prml.WaveEquation(3, 1.2), 2),
        "burgers": (prml.BurgersEquation(3, 50.0), 3),
        "cahn-hilliard": (prml.CahnHilliardEquation(3), 2),
    }[family]
    mesh = prml.Mesh([(0.0, (s - 1) * 0.125) for s in shape], [0.125] * 3)
    if dirichlet:
        bcs = [
            (
                prml.DirichletBoundaryCondition(
                    lambda x, t: np.full((len(x), n), 0.1), is_static=True
                ),
                prml.NeumannBoundaryCondition(
                    lambda x, t: np.full((len(x), n), 0.05), is_static=True
                ),
            )
        ] * 3
    else:
        bcs = [
            (
                prml.NeumannBoundaryCondition(
                    lambda x, t: np.zeros((len(x), n)), is_static=True
                ),
            )
            * 2
        ] * 3
    return prml.ConstrainedProblem(equation, mesh, bcs)


def k9_bound(family, cfg, batch, n_steps, trajectory):
    """The bound of a K9 launch: each state and the constraint tensors
    (a float value and a byte mask a value, and the Neumann faces) read
    once, every step or the end state written once, against the
    family's operations per cell and step."""
    values = cfg.depth * cfg.height * cfg.width * cfg.n
    faces = 2 * cfg.n * (
        cfg.height * cfg.width
        + cfg.depth * cfg.width
        + cfg.depth * cfg.height
    )
    read = 4 * batch * values + 5 * values + 5 * faces
    written = 4 * batch * values * (n_steps if trajectory else 1)
    cells = cfg.depth * cfg.height * cfg.width
    return bound(
        read + written,
        K9_FLOPS_PER_CELL_STEP[family] * batch * n_steps * cells,
    )


def three_d_phases(
    torch, prml, device, card, cuda_ms, once_ms, device_busy_ms
):
    """Phases 13-16: the 3D Cartesian path. Returns the three kernel
    functions' entries of the JSON line. ``cuda_ms``, ``once_ms`` and
    ``device_busy_ms`` are the timing and profiling functions."""
    from pararealml_tpu_torch.operators.fdm import (
        RK4,
        FDMOperator,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu_torch.operators.parareal import PararealOperator
    from pararealml_tpu_torch.ops import fused_system_3d as k9

    wrappers = {name: getattr(k9, name) for name, _, _ in THREE_D_KERNELS}
    plain = {
        name: getattr(k9, f"{name}_reference")
        for name, _, _ in THREE_D_KERNELS
    }
    trajectory_name, end_name, step_name = (n for n, _, _ in THREE_D_KERNELS)
    errors = {name: 0.0 for name in wrappers}

    def check(name, what, kernel, expected):
        torch.cuda.synchronize()
        assert kernel.shape == expected.shape, (name, what)
        abs_err = float((kernel - expected).abs().max())
        rel_err = abs_err / float(expected.abs().max())
        errors[name] = max(errors[name], abs_err)
        if not rel_err <= KERNEL_REL_TOL:
            raise AssertionError(
                f"{name} disagrees with its plain version ({what}): "
                f"{rel_err:.3e}"
            )
        return rel_err

    def states(shape, n, batch=None, seed=0):
        rng = np.random.default_rng(seed)
        lead = () if batch is None else (batch,)
        return torch.as_tensor(
            rng.uniform(-1.0, 1.0, lead + tuple(shape) + (n,)),
            dtype=torch.float32,
            device=device,
        )

    def initial(ivp):
        return torch.as_tensor(
            ivp.initial_condition.discrete_y_0(True),
            dtype=torch.float32,
            device=device,
        )

    def before(label):
        ms = K9_BEFORE_REDESIGN_MS.get(label)
        return "" if ms is None else f" (before the redesign {ms:.3f} ms)"

    # -- phase 13: K9 against its plain version --------------------------
    families = (
        "diffusion",
        "convection-diffusion",
        "wave",
        "burgers",
        "cahn-hilliard",
    )
    for family in families:
        worst, cases = 0.0, 0
        for dirichlet in (False, True):
            cp = problem_3d(prml, family, dirichlet, K9_SMALL_SHAPE)
            cfg = k9._SystemKernelConfig3D(cp, 1e-3)
            y = states(K9_SMALL_SHAPE, cfg.n)
            ys = states(K9_SMALL_SHAPE, cfg.n, batch=3, seed=1)
            steps = K9_SMALL_STEPS
            checks = [
                (trajectory_name, (y, cfg, steps), "single"),
                (end_name, (y, cfg, steps), "single"),
                (end_name, (ys, cfg, steps), "B=3"),
                (step_name, (ys, cfg), "B=3"),
            ]
            # every forced cluster size, each with every cells-a-thread
            # instance that takes it (registers and device memory)
            plans = [
                plan
                for size in k9.CLUSTER_SIZES
                for plan in (
                    k9.cluster_plan_3d(
                        *K9_SMALL_SHAPE, cfg.n, size, cells, cfg.step_kind
                    )
                    for cells in k9.CELLS
                )
                if plan.fits
            ]
            for name, args, what in checks:
                expected = plain[name](*args)
                for plan in plans:
                    kernel = wrappers[name](*args, plan=plan)
                    worst = max(
                        worst,
                        check(
                            name,
                            f"{family}, dirichlet={dirichlet}, {what}, "
                            f"cluster of {plan.cluster_size}, "
                            f"{plan.cells} cells a thread",
                            kernel,
                            expected,
                        ),
                    )
                    cases += 1
        log(
            f"kernels: 3d {family}: {cases} cases (trajectory, single and "
            f"B=3 end, step; Neumann and Dirichlet/Neumann faces; clusters "
            f"of {', '.join(map(str, k9.CLUSTER_SIZES))} blocks, each with "
            f"cells a thread {', '.join(map(str, k9.CELLS))} (0: in device "
            f"memory) where the instances take them, on {K9_SMALL_SHAPE}) "
            f"max|d|/max|y| = {worst:.3e}"
        )
    burgers_ivp = burgers_3d(prml)
    ch_ivp = cahn_hilliard_3d(torch, prml, CH_3D_STEPS)
    burgers_cp = burgers_ivp.constrained_problem
    ch_cp = ch_ivp.constrained_problem
    burgers_y, ch_y = initial(burgers_ivp), initial(ch_ivp)
    fine_cfg = k9._SystemKernelConfig3D(burgers_cp, BURGERS_3D_D_T)
    coarse_cfg = k9._SystemKernelConfig3D(burgers_cp, PARAREAL_3D_COARSE_D_T)
    ch_cfg = k9._SystemKernelConfig3D(ch_cp, CH_3D_D_T)
    slice_steps = BURGERS_3D_STEPS // PARAREAL_3D_SLICES
    coarse_steps = round(
        BURGERS_3D_STEPS * BURGERS_3D_D_T / PARAREAL_3D_COARSE_D_T
    ) // PARAREAL_3D_SLICES
    slices = torch.stack(
        [burgers_y * (1.0 - 0.01 * i) for i in range(PARAREAL_3D_SLICES)]
    ).contiguous()
    # the main path's shapes; the first two are also the shapes phase 15
    # times, so their plain versions are timed here, once
    full_width = [
        (trajectory_name, (burgers_y, fine_cfg, K9_TIMED_STEPS),
         f"21^3 x 3 Burgers, {K9_TIMED_STEPS} steps"),
        (end_name, (slices, fine_cfg, slice_steps),
         f"B={PARAREAL_3D_SLICES} x 21^3 x 3, {slice_steps} steps (one "
         f"iteration's fine ends)"),
        (end_name, (burgers_y, coarse_cfg, coarse_steps),
         f"21^3 x 3, coarse d_t, {coarse_steps} steps"),
        (step_name, (slices, fine_cfg), f"B={PARAREAL_3D_SLICES} x 21^3 x 3"),
        (trajectory_name, (ch_y, ch_cfg, K9_TIMED_STEPS),
         f"31^3 x 2 Cahn-Hilliard, {K9_TIMED_STEPS} steps"),
    ]
    timed = {}
    for name, args, what in full_width:
        if name in timed or name == step_name:
            expected = plain[name](*args)
        else:
            outputs = []
            plain_ms = once_ms(
                torch, lambda: outputs.append(plain[name](*args))
            )
            expected = outputs.pop()
            timed[name] = (what, args, plain_ms)
        rel = check(name, what, wrappers[name](*args), expected)
        batch = args[0].shape[0] if args[0].ndim == 5 else 1
        plan = k9.launch_plan(args[1], batch, name != end_name)
        log(
            f"kernels: {name} ({what}, the plan's cluster of "
            f"{plan.cluster_size} x {plan.threads} threads, {plan.cells} "
            f"cells a thread): max|d|/max|y| = {rel:.3e}"
        )
        if name == step_name:
            continue
        # the 8- and 4-block plans that phase 16 times against it
        for size in (8, 4):
            other = k9.cluster_plan_3d(
                *args[1].state_shape[:3],
                args[1].n,
                size,
                step=args[1].step_kind,
            )
            rel = check(
                name,
                f"{what}, cluster of {size}",
                wrappers[name](*args, plan=other),
                expected,
            )
            log(
                f"kernels: {name} ({what}, cluster of {size} x "
                f"{other.threads} threads, {other.cells} cells a thread): "
                f"max|d|/max|y| = {rel:.3e}"
            )
    # every plan of the measured table, on its own volume (random states
    # and a step small enough that they stay finite): the trajectory, the
    # single end, the batched end (B = 2, or the entry's batch) and the
    # step (B = 2)
    table_family = {
        (1, "rk4"): "diffusion",
        (2, "rk4"): "wave",
        (2, "cahn-hilliard"): "cahn-hilliard",
        (3, "rk4"): "burgers",
    }
    for (n, step), entries in k9._MEASURED_PLANS_3D.items():
        for depth, height, width, batch, size, cells in entries:
            shape = (depth, height, width)
            cfg = k9._SystemKernelConfig3D(
                problem_3d(prml, table_family[(n, step)], True, shape),
                K9_TABLE_D_T,
            )
            plan = k9.cluster_plan_3d(*shape, n, size, cells, step)
            y = states(shape, n)
            ys = states(shape, n, batch=max(2, batch), seed=1)
            for name, args, what in (
                (trajectory_name, (y, cfg, K9_LARGE_STEPS), "single"),
                (end_name, (y, cfg, K9_LARGE_STEPS), "single"),
                (end_name, (ys, cfg, K9_LARGE_STEPS), f"B={len(ys)}"),
                (step_name, (ys[:2].contiguous(), cfg), "B=2"),
            ):
                rel = check(
                    name,
                    f"table plan {plan}, {what}",
                    wrappers[name](*args, plan=plan),
                    plain[name](*args),
                )
                log(
                    f"kernels: {name} (the table's {shape} x {n} "
                    f"{table_family[(n, step)]}, entry for B={batch}, "
                    f"{what}, cluster of {size} x {plan.threads} threads, "
                    f"{plan.cells_per_thread} cells a thread in "
                    f"{'device memory' if cells == 0 else 'registers'}, "
                    f"{K9_LARGE_STEPS} steps): max|d|/max|y| = {rel:.3e}"
                )
            del y, ys
    torch.cuda.empty_cache()
    # the largest three-component cube the JAX cap admits
    large_cp = problem_3d(prml, "burgers", True, K9_LARGE_SHAPE)
    assert k9.fused_system_3d_step_applicable(large_cp, RK4())
    large_cfg = k9._SystemKernelConfig3D(large_cp, 1e-3)
    large_y = states(K9_LARGE_SHAPE, 3)
    large_ys = states(K9_LARGE_SHAPE, 3, batch=2, seed=1)
    for name, args, what in (
        (trajectory_name, (large_y, large_cfg, K9_LARGE_STEPS), "single"),
        (end_name, (large_y, large_cfg, K9_LARGE_STEPS), "single"),
        (end_name, (large_ys, large_cfg, K9_LARGE_STEPS), "B=2"),
        (step_name, (large_ys, large_cfg), "B=2"),
    ):
        rel = check(
            name,
            f"{K9_LARGE_SHAPE} x 3 {what}",
            wrappers[name](*args),
            plain[name](*args),
        )
        batch = args[0].shape[0] if args[0].ndim == 5 else 1
        plan = k9.launch_plan(large_cfg, batch, name != end_name)
        log(
            f"kernels: {name} ({K9_LARGE_SHAPE} x 3 Burgers, {what}, "
            f"{K9_LARGE_STEPS} steps, cluster of {plan.cluster_size} x "
            f"{plan.threads} threads, {plan.cells_per_thread} cells a thread "
            f"in {'device memory' if plan.cells == 0 else 'registers'}): "
            f"max|d|/max|y| = {rel:.3e}"
        )
    large_ms = cuda_ms(
        torch,
        lambda: wrappers[trajectory_name](
            large_y, large_cfg, K9_LARGE_TIMED_STEPS
        ),
        reps=3,
    )
    large_bound, large_by = k9_bound(
        "burgers", large_cfg, 1, K9_LARGE_TIMED_STEPS, True
    )
    log(
        f"time: {trajectory_name} ({K9_LARGE_SHAPE} x 3 Burgers, "
        f"{K9_LARGE_TIMED_STEPS} steps): {large_ms:.3f} ms "
        f"({1e3 * large_ms / K9_LARGE_TIMED_STEPS:.3f} us a step), bound "
        f"{large_bound * 1e3:.3f} us ({large_by}) [{card}]"
    )
    del large_y, large_ys
    torch.cuda.empty_cache()
    log("phase 3d kernels: ok")

    # -- phase 14: the path at full width, counted -----------------------
    def fdm(d_t, **kwargs):
        # no device argument: the entry points run on the card
        return FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), d_t, **kwargs
        )

    burgers_fn, _ = fdm(BURGERS_3D_D_T).trajectory_function(
        burgers_cp, (0.0, BURGERS_3D_STEPS * BURGERS_3D_D_T)
    )
    ch_fn, _ = fdm(CH_3D_D_T).trajectory_function(
        ch_cp, (0.0, CH_3D_STEPS * CH_3D_D_T)
    )
    parareal = PararealOperator(
        fdm(BURGERS_3D_D_T),
        fdm(PARAREAL_3D_COARSE_D_T),
        PARAREAL_3D_TOLERANCE,
        num_time_slices=PARAREAL_3D_SLICES,
    )
    assert burgers_fn.fused and ch_fn.fused

    for wrapper in wrappers.values():
        wrapper.launches = 0
    burgers_ys = burgers_fn(burgers_y, 0.0)
    ch_ys = ch_fn(ch_y, 0.0)
    ch_last = ch_ys[-1].clone()
    ch_head = ch_ys[:CH_3D_SOLVE_STEPS].double().cpu().numpy()
    del ch_ys
    solved = fdm(CH_3D_D_T).solve(
        cahn_hilliard_3d(torch, prml, CH_3D_SOLVE_STEPS)
    ).discrete_y()
    trajectory_launches = {name: w.launches for name, w in wrappers.items()}
    parareal_ys = parareal.solve(burgers_ivp).discrete_y()
    launches = {name: w.launches for name, w in wrappers.items()}
    iterations = parareal.last_iterations
    parareal_launches = {
        name: launches[name] - trajectory_launches[name] for name in launches
    }
    log(
        f"3d main-path launches: {launches} (the two trajectories and the "
        f"solve: {trajectory_launches}; Parareal: {parareal_launches}, "
        f"{iterations} iterations: in iteration i (from 0) one batched end "
        f"launch of {PARAREAL_3D_SLICES} clusters for the fine ends and "
        f"{PARAREAL_3D_SLICES - 1} - i single-state end launches for the "
        f"coarse sweep)"
    )
    assert trajectory_launches == {
        trajectory_name: 3, end_name: 0, step_name: 0
    }, trajectory_launches
    # Parareal: the initial coarse sweep and the final expansion on the
    # trajectory kernel, each iteration's fine ends as one batched end
    # launch and its coarse sweep as one single end launch per slice past
    # the first not yet exact (iteration i leaves slices up to i exact)
    assert iterations >= 1
    coarse_launches = sum(
        PARAREAL_3D_SLICES - 1 - i for i in range(iterations)
    )
    assert parareal_launches == {
        trajectory_name: 2,
        end_name: iterations + coarse_launches,
        step_name: 0,
    }, parareal_launches
    for name, _, on_path in THREE_D_KERNELS:
        if on_path and launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    assert tuple(burgers_ys.shape) == (BURGERS_3D_STEPS, 21, 21, 21, 3)
    assert bool(torch.isfinite(burgers_ys[-1]).all())
    assert tuple(ch_last.shape) == (31, 31, 31, 2)
    assert bool(torch.isfinite(ch_last).all())
    assert solved.shape == (CH_3D_SOLVE_STEPS, 31, 31, 31, 2)
    assert solved.dtype == np.float64
    assert np.array_equal(solved, ch_head)
    del solved, ch_head
    generic_fn, _ = fdm(
        BURGERS_3D_D_T, fused_kernels=False
    ).trajectory_function(
        burgers_cp, (0.0, BURGERS_3D_HEAD_STEPS * BURGERS_3D_D_T)
    )
    assert not generic_fn.fused
    generic = generic_fn(burgers_y, 0.0)
    head = burgers_ys[:BURGERS_3D_HEAD_STEPS]
    difference = (head - generic).abs()
    assert bool((difference <= 1e-4 + 1e-4 * generic.abs()).all())
    parareal_diff = float(
        (torch.as_tensor(parareal_ys, device=device) - burgers_ys.double())
        .abs()
        .max()
    )
    # the coarse operator alone, from the fine slice ends: what a Parareal
    # that skipped its corrections would expand from
    coarse_end = burgers_y
    coarse_diff = 0.0
    for index in range(1, PARAREAL_3D_SLICES):
        coarse_end = wrappers[end_name](coarse_end, coarse_cfg, coarse_steps)
        fine_end = burgers_ys[index * slice_steps - 1]
        coarse_diff = max(
            coarse_diff, float((coarse_end - fine_end).abs().max())
        )
    fine_size = k9.launch_plan(fine_cfg, 1, True).cluster_size
    ch_size = k9.launch_plan(ch_cfg, 1, True).cluster_size
    log(
        f"phase 3d path: Burgers 21^3 x {BURGERS_3D_STEPS} steps (one K9 "
        f"launch, cluster of {fine_size}), first "
        f"{BURGERS_3D_HEAD_STEPS} frames against the generic path max|d| = "
        f"{float(difference.max()):.3e} (atol = rtol = 1e-4); Cahn-Hilliard "
        f"31^3 x {CH_3D_STEPS} steps (one K9 launch, cluster of "
        f"{ch_size}) finite, max|y0| "
        f"{float(ch_last[..., 0].abs().max()):.4f}; solve over "
        f"{CH_3D_SOLVE_STEPS} steps equal to the trajectory's first frames"
    )
    log(
        f"phase 3d parareal: {PARAREAL_3D_SLICES} slices, coarse d_t "
        f"{PARAREAL_3D_COARSE_D_T}, tolerance {PARAREAL_3D_TOLERANCE:g}: "
        f"{iterations} iterations, max diff vs fine {parareal_diff:.3e} "
        f"(gate {PARAREAL_3D_GATE:g}; the coarse operator alone misses the "
        f"fine slice ends by {coarse_diff:.3e}; max|y| "
        f"{float(burgers_ys.abs().max()):.4f})"
    )
    assert parareal_diff <= PARAREAL_3D_GATE, parareal_diff
    # the gate can see a missing or wrong correction only if the coarse
    # starts alone fail it, and then a correction must have run
    assert coarse_diff > PARAREAL_3D_GATE, coarse_diff
    assert iterations >= 2, iterations
    del generic, difference, head, parareal_ys, burgers_ys
    torch.cuda.empty_cache()

    # -- phase 15: times -------------------------------------------------
    runs = {
        "3d burgers fine": lambda: burgers_fn(burgers_y, 0.0),
        "3d cahn-hilliard": lambda: ch_fn(ch_y, 0.0),
    }
    run_ms = {label: cuda_ms(torch, run) for label, run in runs.items()}
    for label, family, cfg, steps in (
        ("3d burgers fine", "burgers", fine_cfg, BURGERS_3D_STEPS),
        ("3d cahn-hilliard", "cahn-hilliard", ch_cfg, CH_3D_STEPS),
    ):
        bound_ms, bound_by = k9_bound(family, cfg, 1, steps, True)
        log(
            f"time: {label}, K9 trajectory, {steps} steps: "
            f"{run_ms[label]:.3f} ms{before(label)} "
            f"({1e3 * run_ms[label] / steps:.3f} us a step), bound "
            f"{bound_ms:.3f} ms ({bound_by}) [{card}]"
        )
    for label, cp, cfg, d_t, steps, y in (
        ("3d burgers fine", burgers_cp, fine_cfg, BURGERS_3D_D_T,
         BURGERS_3D_STEPS, burgers_y),
        ("3d cahn-hilliard", ch_cp, ch_cfg, CH_3D_D_T, CH_3D_STEPS, ch_y),
    ):
        generic_fn, _ = fdm(d_t, fused_kernels=False).trajectory_function(
            cp, (0.0, GENERIC_3D_TIMED_STEPS * d_t)
        )
        generic_ms = cuda_ms(torch, lambda: generic_fn(y, 0.0), reps=3)
        scaled_ms = generic_ms * steps / GENERIC_3D_TIMED_STEPS
        plain_run_ms = once_ms(
            torch,
            lambda: k9.fused_system_3d_rk4_trajectory_reference(
                y, cfg, PLAIN_3D_TIMED_STEPS
            ),
        )
        log(
            f"time: generic path {label}, {GENERIC_3D_TIMED_STEPS} steps: "
            f"{generic_ms:.3f} ms (median of 3), scaled to {steps} steps "
            f"{scaled_ms:.3f} ms (scaled, not run): K9 "
            f"{scaled_ms / run_ms[label]:.3f}x faster; plain version "
            f"{PLAIN_3D_TIMED_STEPS} steps {plain_run_ms:.3f} ms (one run), "
            f"scaled to {steps} steps "
            f"{plain_run_ms * steps / PLAIN_3D_TIMED_STEPS:.3f} ms [{card}]"
        )
    program, _ = parareal.trajectory_function(
        burgers_cp, (0.0, BURGERS_3D_STEPS * BURGERS_3D_D_T)
    )
    runs["3d parareal"] = lambda: program(burgers_y)
    run_ms["3d parareal"] = cuda_ms(torch, runs["3d parareal"])
    log(
        f"time: 3d parareal, {PARAREAL_3D_SLICES} slices: "
        f"{run_ms['3d parareal']:.3f} ms{before('3d parareal')}, speedup "
        f"vs K9 fine "
        f"{run_ms['3d burgers fine'] / run_ms['3d parareal']:.3f}x, "
        f"{parareal.last_iterations} iterations [{card}]"
    )
    # the plain versions of the trajectory and the end ran once in phase
    # 13 at these shapes; the step's is timed here
    step_args = (burgers_y, fine_cfg)
    timed[step_name] = (
        "21^3 x 3, 1 step",
        step_args,
        cuda_ms(torch, lambda: plain[step_name](*step_args)),
    )
    bounds = {
        trajectory_name: k9_bound(
            "burgers", fine_cfg, 1, K9_TIMED_STEPS, True
        ),
        end_name: k9_bound(
            "burgers", fine_cfg, PARAREAL_3D_SLICES, slice_steps, False
        ),
        step_name: k9_bound("burgers", fine_cfg, 1, 1, True),
    }
    entries = []
    for name, replaces, on_path in THREE_D_KERNELS:
        what, args, plain_ms = timed[name]
        bound_ms, bound_by = bounds[name]
        kernel_ms = cuda_ms(torch, lambda: wrappers[name](*args))
        log(
            f"time: {name} ({what}): kernel {kernel_ms:.3f} ms{before(name)}, "
            f"plain {plain_ms:.3f} ms"
            f"{'' if name == step_name else ' (one run)'}, bound "
            f"{bound_ms * 1e3:.3f} us ({bound_by}) [{card}]"
        )
        entries.append(
            {
                "name": name,
                "route": "cuda",
                "source": THREE_D_SOURCE,
                "replaces": replaces,
                "on_path": on_path,
                "launches": launches[name],
                "max_abs_err": errors[name],
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_us": bound_ms * 1e3,
                "bound_by": bound_by,
                "library_ms": None,
                "timed": what,
            }
        )
    coarse_end_ms = cuda_ms(
        torch, lambda: wrappers[end_name](burgers_y, coarse_cfg, coarse_steps)
    )
    log(
        f"time: {end_name} (21^3 x 3, {coarse_steps} coarse steps: one "
        f"slice of the coarse sweep): kernel {coarse_end_ms:.3f} ms"
        f"{before('coarse end')} [{card}]"
    )
    del slices
    torch.cuda.empty_cache()

    # -- phase 16: device busy time and idle share (torch.profiler) ------
    for label, run in runs.items():
        busy_ms, top = device_busy_ms(torch, run)
        if busy_ms is None:
            # the profiler at times reports no device event for a run of
            # one long kernel: ask once more
            busy_ms, top = device_busy_ms(torch, run, reps=1)
        if busy_ms is None:
            log(f"profile: {label}: not measured (no device events)")
            continue
        log(
            f"profile: {label}: device busy {busy_ms:.3f} ms of "
            f"{run_ms[label]:.3f} ms, idle share "
            f"{1.0 - busy_ms / run_ms[label]:.3f}; top: {top} [{card}]"
        )
    return entries


def k9_split_phase(
    torch, prml, device, card, cuda_ms, once_ms, device_busy_ms
):
    """Phase 37: K9's step split on the main path's two volumes
    (tools/k9_step_split.py) and its plans in turns: the chosen plan
    against the 8- and 4-block plans of the same kernel on the 21^3 and
    31^3 trajectories and the B = 8 fine ends (tools/k9_plan_sweep.py).
    No kernel entry of its own."""
    load_tool("k9_step_split").run(device, card, log)
    load_tool("k9_plan_sweep").turns(device, card, log)
    return []


def wave_example(prml):
    """examples/wave_2d_fdm.py's problem: the wave equation (c = 1) on
    [-5, 5]^2 at d_x 0.1 (101^2), Dirichlet 0 on every face, a Gaussian of
    amplitude 3 at (0, 2.5) in y0, to T = 20 (``WAVE_T_END``) at d_t 0.01
    (2,000 steps). Returns the problem and its d_t."""
    zero = prml.DirichletBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = prml.ConstrainedProblem(
        prml.WaveEquation(2),
        prml.Mesh([(-5.0, 5.0), (-5.0, 5.0)], [0.1, 0.1]),
        [(zero, zero)] * 2,
    )
    ic = prml.GaussianInitialCondition(
        cp, [(np.array([0.0, 2.5]), 0.1 * np.eye(2))] * 2, [3.0, 0.0]
    )
    return prml.InitialValueProblem(cp, (0.0, WAVE_T_END), ic), 0.01


def shallow_water_example(prml):
    """examples/shallow_water_fdm.py's problem: shallow water (h = 0.5) on
    [-5, 5] x [0, 5] at d_x 0.1 (101 x 51), zero-flux faces for the height
    alone, a Gaussian of amplitude 1 at (2.5, 1.25) in the height, to T =
    20 (``SHALLOW_WATER_T_END``) at d_t 0.0025 (8,000 steps). Returns the
    problem and its d_t."""
    flux = prml.NeumannBoundaryCondition(
        prml.vectorize_bc_function(lambda x, t: (0.0, None, None)),
        is_static=True,
    )
    cp = prml.ConstrainedProblem(
        prml.ShallowWaterEquation(0.5),
        prml.Mesh([(-5.0, 5.0), (0.0, 5.0)], [0.1, 0.1]),
        [(flux, flux)] * 2,
    )
    ic = prml.GaussianInitialCondition(
        cp, [(np.array([2.5, 1.25]), 0.25 * np.eye(2))] * 3, [1.0, 0.0, 0.0]
    )
    return prml.InitialValueProblem(cp, (0.0, SHALLOW_WATER_T_END), ic), 0.0025


def cahn_hilliard_2d(torch, prml, n, t_end):
    """examples/cahn_hilliard_2d_fdm.py's problem on [0, (n - 1) / 10]^2:
    Cahn-Hilliard with gamma = 0.01 at d_x 0.1 (n^2; the example's n is
    101), zero-flux faces, y0 a uniform perturbation of amplitude 0.05 from
    numpy seed 0 and y1 its chemical potential, to ``t_end`` (the
    example's is 5, at its d_t 5e-4: 10,000 steps)."""
    from pararealml_tpu_torch.operators.fdm import (
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu_torch.operators.fdm.numerical_differentiator import (
        slice_all_constraint_pairs,
    )

    mesh = prml.Mesh([(0.0, (n - 1) * 0.1)] * 2, [0.1, 0.1])
    flux = prml.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = prml.ConstrainedProblem(
        prml.CahnHilliardEquation(2, gamma=CH_2D_GAMMA),
        mesh,
        [(flux, flux)] * 2,
    )
    np.random.seed(0)
    y_0_0 = 0.05 * np.random.uniform(-1.0, 1.0, mesh.vertices_shape + (1,))
    d_y_constraints = slice_all_constraint_pairs(
        cp.static_boundary_vertex_constraints.d_y, slice(0, 1)
    )
    laplacian = ThreePointCentralDifferenceMethod().laplacian(
        torch.as_tensor(y_0_0), mesh, d_y_constraints
    ).numpy()
    y_0_1 = y_0_0**3 - y_0_0 - CH_2D_GAMMA * laplacian
    ic = prml.DiscreteInitialCondition(
        cp, np.concatenate([y_0_0, y_0_1], axis=-1), True
    )
    return prml.InitialValueProblem(cp, (0.0, t_end), ic)


def burgers_641(prml):
    """bench.py's 2D Burgers problem (``build_burgers_problem``: Re = 100,
    zero-flux faces, Gaussians of covariance 0.75 I at the centre with
    amplitudes 1 and 0.5) on [0, 5]^2 at d_x 5/640 (641^2), over
    ``BURGERS_641_STEPS`` steps of ``BURGERS_641_D_T``."""
    flux = prml.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = prml.ConstrainedProblem(
        prml.BurgersEquation(2, 100.0),
        prml.Mesh([(0.0, 5.0)] * 2, [5.0 / 640] * 2),
        [(flux, flux)] * 2,
    )
    ic = prml.GaussianInitialCondition(
        cp, [(np.full(2, 2.5), 0.75 * np.eye(2))] * 2, [1.0, 0.5]
    )
    return prml.InitialValueProblem(
        cp, (0.0, BURGERS_641_STEPS * BURGERS_641_D_T), ic
    )


def system_problem_2d(prml, family, faces, shape):
    """A small problem of one of the 2D system families
    (tests/test_torch_cuda.py's ``system_problem``): spacing 0.25;
    ``faces`` "dirichlet" is Dirichlet 0.1 on the axis-0 faces and Neumann
    0.05 on the axis-1 faces, "neumann" Neumann 0.05 everywhere,
    "partial" Neumann 0.05 on component 0 alone."""
    equation, n = {
        "wave": (prml.WaveEquation(2, 1.5), 2),
        "burgers": (prml.BurgersEquation(2, 100.0), 2),
        "shallow-water": (prml.ShallowWaterEquation(0.5), 3),
        "cahn-hilliard": (prml.CahnHilliardEquation(2), 2),
    }[family]
    mesh = prml.Mesh([(0.0, (s - 1) * 0.25) for s in shape], [0.25, 0.25])

    def neumann(values):
        return prml.NeumannBoundaryCondition(
            lambda x, t: np.tile(values, (len(x), 1)), is_static=True
        )

    if faces == "dirichlet":
        dirichlet = prml.DirichletBoundaryCondition(
            lambda x, t: np.full((len(x), n), 0.1), is_static=True
        )
        bcs = [(dirichlet, dirichlet), (neumann([0.05] * n),) * 2]
    elif faces == "neumann":
        bcs = [(neumann([0.05] * n),) * 2] * 2
    else:
        bcs = [(neumann([0.05] + [np.nan] * (n - 1)),) * 2] * 2
    return prml.ConstrainedProblem(equation, mesh, bcs)


def smooth_states_2d(torch, device, shape, n, batch=None, seed=0):
    """tests/test_torch_cuda.py's ``states_2d`` on ``device``: per state
    and component an offset and one low Fourier mode."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, np.pi, shape[0])[:, None]
    y = np.linspace(0.0, np.pi, shape[1])[None, :]
    count = 1 if batch is None else batch
    states = np.empty((count,) + tuple(shape) + (n,))
    for index in np.ndindex(count, n):
        offset, amplitude = rng.uniform(-0.3, 0.3), rng.uniform(0.2, 0.6)
        k, m = rng.integers(1, 4, 2)
        states[index[0], ..., index[1]] = offset + amplitude * np.sin(
            k * x
        ) * np.cos(m * y)
    states = torch.as_tensor(states, dtype=torch.float32, device=device)
    return states[0] if batch is None else states


def tiled_system_bound(family, cfg, batch, n_steps, item):
    """The bound of a K8 run: each state (float32) and the face vectors
    (a float value and a byte mask for each of the four face sets) read
    once, every frame (``item`` bytes a value) written once, against the
    family's operations per cell and step."""
    cells = cfg.height * cfg.width
    values = cells * cfg.n
    read = 4 * batch * values + 5 * 4 * cfg.n * (cfg.height + cfg.width)
    written = item * batch * values * n_steps
    return bound(
        read + written, FLOPS_PER_CELL_STEP[family] * batch * n_steps * cells
    )


def system_2d_phases(
    torch, prml, device, card, cuda_ms, once_ms, device_busy_ms
):
    """Phases 17-20: the 2D system path past one CTA (K8) and the wave,
    shallow-water and Cahn-Hilliard families of K4/K5. Returns their
    entries of the JSON line. ``cuda_ms``, ``once_ms`` and
    ``device_busy_ms`` are the timing and profiling functions."""
    from pararealml_tpu_torch.constraint import Constraint
    from pararealml_tpu_torch.operators.fdm import (
        RK4,
        FDMOperator,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu_torch.operators.parareal import PararealOperator
    from pararealml_tpu_torch.ops import fused_system as fs
    from pararealml_tpu_torch.ops import packed_system as ps
    from pararealml_tpu_torch.ops import tiled_system as ts

    k8 = getattr(ts, TILED_SYSTEM_KERNEL)
    k8_plain = ts.tiled_system_rk4_trajectory_reference
    modules = {"fused_system": fs, "packed_system": ps}
    family_wrappers = {
        name: getattr(modules[module], name)
        for name, module, _, _ in SYSTEM_KERNELS
    }
    family_plain = {
        name: getattr(modules[module], f"{name}_reference")
        for name, module, _, _ in SYSTEM_KERNELS
    }
    errors = {}
    f32, bf16 = torch.float32, torch.bfloat16

    def check(key, what, kernel, plain):
        torch.cuda.synchronize()
        assert kernel.shape == plain.shape, (key, what)
        assert kernel.dtype == plain.dtype, (key, what)
        abs_err = float((kernel.float() - plain.float()).abs().max())
        rel_err = abs_err / float(plain.float().abs().max())
        errors[key] = max(errors.get(key, 0.0), abs_err)
        if not rel_err <= KERNEL_REL_TOL:
            raise AssertionError(
                f"{key} disagrees with its plain version ({what}): "
                f"{rel_err:.3e}"
            )
        return rel_err

    # -- phase 17: K8, K5 and K4 against their plain versions ------------
    families = ("wave", "burgers", "shallow-water", "cahn-hilliard")
    height, width = SYSTEM_SMALL_SHAPE
    for family in families:
        worst, cases = 0.0, 0
        for faces in ("dirichlet", "partial"):
            cp = system_problem_2d(prml, family, faces, SYSTEM_SMALL_SHAPE)
            cfg = ts._TiledSystemConfig(cp, 2e-3)
            ys = smooth_states_2d(
                torch, device, SYSTEM_SMALL_SHAPE, cfg.n, batch=2
            )
            halo = cfg.halo
            # the plan's tiles (the last row and column of tiles clamped),
            # tiles of 3 x 5 cells (42 of them), one tile over the grid
            plans = (
                cfg.plan,
                cfg.plan._replace(rows=2 * halo + 3, cols=2 * halo + 5),
                cfg.plan._replace(
                    rows=2 * halo + height, cols=2 * halo + width
                ),
            )
            for storage in (f32, bf16):
                expected = k8_plain(ys, cfg, SYSTEM_SMALL_STEPS, storage)
                for plan in plans:
                    kernel = k8(
                        ys, cfg, SYSTEM_SMALL_STEPS, storage, plan=plan
                    )
                    worst = max(
                        worst,
                        check(
                            TILED_SYSTEM_KERNEL,
                            f"{family}, {faces}, {storage}, {plan.blocks} "
                            "tiles",
                            kernel,
                            expected,
                        ),
                    )
                    cases += 1
        log(
            f"kernels: K8 {family}: {cases} cases (Dirichlet/Neumann and "
            f"partial Neumann faces; float32 and bfloat16 storage; "
            f"{', '.join(str(plan.blocks) for plan in plans)} tiles of a "
            f"17 x 33 grid, batch of 2, {SYSTEM_SMALL_STEPS} steps) "
            f"max|d|/max|y| = {worst:.3e}"
        )
    for family, faces in (
        ("wave", "dirichlet"),
        ("shallow-water", "partial"),
        ("cahn-hilliard", "neumann"),
    ):
        cp = system_problem_2d(prml, family, faces, K5_FAMILY_SHAPE)
        cfg = fs._SystemKernelConfig(cp, 1e-3)
        y = smooth_states_2d(torch, device, K5_FAMILY_SHAPE, cfg.n)
        ys = smooth_states_2d(
            torch, device, K5_FAMILY_SHAPE, cfg.n, batch=4, seed=1
        )
        steps = K5_FAMILY_STEPS
        worst = 0.0
        for name, args in (
            ("fused_system_rk4_trajectory", (y, cfg, steps)),
            ("fused_system_rk4_end", (ys, cfg, steps)),
            ("fused_system_rk4_step", (ys, cfg)),
            ("packed_system_rk4_ends", (ys, cfg, steps)),
            ("packed_system_rk4_trajectory", (ys, cfg, steps)),
        ):
            worst = max(
                worst,
                check(
                    f"{name}:{family}",
                    faces,
                    family_wrappers[name](*args),
                    family_plain[name](*args),
                ),
            )
        log(
            f"kernels: K5/K4 {family}: trajectory, B=4 end, step, B=4 K4 "
            f"ends and trajectory on {K5_FAMILY_SHAPE}, {steps} steps, "
            f"{faces} faces: max|d|/max|y| = {worst:.3e}"
        )
    # what K8 does not take raises before any launch
    cp = system_problem_2d(prml, "burgers", "dirichlet", SYSTEM_SMALL_SHAPE)
    cfg = ts._TiledSystemConfig(cp, 1e-3)
    ys = smooth_states_2d(torch, device, SYSTEM_SMALL_SHAPE, 2, batch=2)
    interior = system_problem_2d(prml, "wave", "dirichlet", SYSTEM_SMALL_SHAPE)
    old = interior.static_y_vertex_constraints
    mask = old.mask.numpy().reshape(height, width, 2).copy()
    values = np.where(mask, old.values.numpy().reshape(mask.shape), 0.0)
    mask[height // 2, width // 2] = True
    interior._y_vertex_constraints = Constraint(
        values.reshape(old.values.shape), mask.reshape(old.mask.shape)
    )
    thin = system_problem_2d(prml, "burgers", "neumann", (2, 9))
    launches = k8.launches
    refusals = (
        (lambda: ts.build_tiled_system_rk4_trajectory(thin, 1e-3, 2), "range"),
        (lambda: ts.build_tiled_system_rk4_trajectory(interior, 1e-3, 2),
         "interior"),
        (lambda: k8(ys, cfg, 2, plan=cfg.plan._replace(halo=1)), "tile plan"),
    )
    for refusal, match in refusals:
        try:
            refusal()
        except ValueError as error:
            assert match in str(error), error
        else:
            raise AssertionError(f"K8 ran where it must refuse ({match})")
    assert k8.launches == launches
    log(
        "kernels: K8 refuses a 2 x 9 grid (no plan), interior Dirichlet "
        "constraints and a plan with a halo of 1 for RK4, before any launch"
    )
    torch.cuda.empty_cache()
    log("phase 2d system kernels: ok")

    # -- phase 18: the path at full width, counted -----------------------
    def fdm(d_t, **kwargs):
        # no device argument: the entry points run on the card
        return FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), d_t, **kwargs
        )

    def initial(ivp):
        return torch.as_tensor(
            ivp.initial_condition.discrete_y_0(True),
            dtype=torch.float32,
            device=device,
        )

    # label: (family, problem, d_t, initial state)
    examples = {}
    for label, family, (ivp, d_t) in (
        ("wave 101^2 x 2", "wave", wave_example(prml)),
        (
            "shallow water 101 x 51 x 3",
            "shallow-water",
            shallow_water_example(prml),
        ),
        (
            "cahn-hilliard 101^2 x 2",
            "cahn-hilliard",
            (cahn_hilliard_2d(torch, prml, 101, CH_2D_T_END), 5e-4),
        ),
    ):
        examples[label] = (family, ivp, d_t, initial(ivp))
    burgers_ivp = burgers_641(prml)
    burgers_cp = burgers_ivp.constrained_problem
    # kernel_storage_dtype takes effect past the JAX package's VMEM cap
    # only, as there: 641^2 lies past it, so the bfloat16 run keeps
    # bfloat16 storage (the dtype check below)
    assert not fs.fits_reference_vmem(burgers_cp)
    burgers_y = initial(burgers_ivp)
    burgers_t = (0.0, BURGERS_641_STEPS * BURGERS_641_D_T)
    burgers_fns = {
        storage: fdm(
            BURGERS_641_D_T, kernel_storage_dtype=storage
        ).trajectory_function(burgers_cp, burgers_t)[0]
        for storage in (f32, bf16)
    }
    assert all(fn.fused for fn in burgers_fns.values())
    ch_ivp = cahn_hilliard_2d(
        torch, prml, CH_PARAREAL_N, CH_PARAREAL_T_END
    )
    ch_cp = ch_ivp.constrained_problem
    ch_y = initial(ch_ivp)
    parareal = PararealOperator(
        fdm(CH_PARAREAL_FINE_D_T),
        fdm(CH_PARAREAL_COARSE_D_T),
        CH_PARAREAL_TOLERANCE,
        num_time_slices=CH_PARAREAL_SLICES,
    )
    # the generic path builds its step with allow_fused=False; count those
    # builds over the K8 runs
    generic_builds = []
    build_step = FDMOperator._build_step_function

    def counting_build(self, cp, allow_fused=True, dtype=None):
        if not allow_fused:
            generic_builds.append(cp)
        return build_step(self, cp, allow_fused, dtype)

    mode = fs.cluster_system_rk4_trajectory
    wrappers = dict(
        family_wrappers, **{TILED_SYSTEM_KERNEL: k8, CLUSTER_KERNEL: mode}
    )
    for wrapper in wrappers.values():
        wrapper.launches = 0
    FDMOperator._build_step_function = counting_build
    try:
        solutions = {
            label: fdm(d_t).solve(ivp).discrete_y()
            for label, (_, ivp, d_t, _) in examples.items()
        }
        burgers_ys = {
            storage: fn(burgers_y, 0.0) for storage, fn in burgers_fns.items()
        }
    finally:
        FDMOperator._build_step_function = build_step
    k8_runs = {name: w.launches for name, w in wrappers.items()}
    parareal_ys = parareal.solve(ch_ivp).discrete_y()
    launches = {name: w.launches for name, w in wrappers.items()}
    iterations = parareal.last_iterations
    log(
        f"2d system main-path launches: {launches} (the three examples' "
        f"solves on the cluster-resident mode and the two 641^2 "
        f"trajectories on K8: {k8_runs}; the generic path was built "
        f"{len(generic_builds)} times in them); Parareal {iterations} "
        f"iterations"
    )
    assert not generic_builds, "a kernel run took the generic path"
    assert k8_runs == dict(
        {name: 0 for name in family_wrappers},
        **{TILED_SYSTEM_KERNEL: 2, CLUSTER_KERNEL: 3},
    ), k8_runs
    # Parareal: each iteration's fine ends on K4, the final expansion on
    # K4, the whole-domain coarse roll-out on the K5 trajectory and the
    # coarse sweeps on the single-state K5 end
    assert launches["packed_system_rk4_ends"] == iterations, launches
    assert launches["packed_system_rk4_trajectory"] == 1, launches
    assert launches["fused_system_rk4_trajectory"] >= 1, launches
    assert launches["fused_system_rk4_end"] >= 1, launches
    assert launches[TILED_SYSTEM_KERNEL] == 2, launches

    head = SYSTEM_HEAD_STEPS
    heads = {}
    for label, (_, ivp, d_t, y_0) in examples.items():
        cp = ivp.constrained_problem
        ys = solutions[label]
        steps = round(ivp.t_interval[1] / d_t)
        assert ys.shape == (steps,) + tuple(y_0.shape), (label, ys.shape)
        assert np.isfinite(ys).all(), label
        heads[label] = (
            cp, d_t, y_0, torch.as_tensor(ys[:head], device=device)
        )
    for storage, ys in burgers_ys.items():
        assert tuple(ys.shape) == (BURGERS_641_STEPS,) + tuple(
            burgers_y.shape
        )
        assert ys.dtype == storage
        assert bool(torch.isfinite(ys[-1].float()).all())
    heads["burgers 641^2 x 2"] = (
        burgers_cp,
        BURGERS_641_D_T,
        burgers_y,
        burgers_ys[f32][:head].double(),
    )
    for label, (cp, d_t, y_0, frames) in heads.items():
        # the examples' grids run on the cluster-resident mode (its plain
        # version is K5's), 641^2 on K8
        on_mode = fs.cluster_system_applicable(cp)
        key = CLUSTER_KERNEL if on_mode else TILED_SYSTEM_KERNEL
        if on_mode:
            cfg = fs._SystemKernelConfig(cp, d_t)
            route = f"the mode, a cluster of {fs.cluster_plan(cfg).cluster_size}"
            plain = fs.fused_system_rk4_trajectory_reference(
                y_0, cfg, head
            ).double()
        else:
            cfg = ts._TiledSystemConfig(cp, d_t)
            route = (
                f"K8, {cfg.plan.blocks} blocks of {cfg.plan.rows} x "
                f"{cfg.plan.cols}"
            )
            plain = k8_plain(y_0, cfg, head).double()
        rel = float((frames - plain).abs().max()) / float(plain.abs().max())
        errors[key] = max(
            errors.get(key, 0.0), float((frames - plain).abs().max())
        )
        generic_fn, _ = fdm(d_t, fused_kernels=False).trajectory_function(
            cp, (0.0, head * d_t)
        )
        assert not generic_fn.fused
        generic = generic_fn(y_0, 0.0).double()
        difference = (frames - generic).abs()
        log(
            f"phase 2d system path: {label} ({route}): first {head} frames "
            f"against the plain version max|d|/max|y| = {rel:.3e}, against "
            f"the generic path max|d| = {float(difference.max()):.3e} "
            f"(atol = rtol = 1e-4)"
        )
        assert rel <= KERNEL_REL_TOL, (label, rel)
        assert bool((difference <= 1e-4 + 1e-4 * generic.abs()).all()), label
    burgers_cfg = ts._TiledSystemConfig(burgers_cp, BURGERS_641_D_T)
    plain_bf16 = k8_plain(burgers_y, burgers_cfg, head, bf16)
    check(
        TILED_SYSTEM_KERNEL,
        "641^2 Burgers, bfloat16 storage, first frames",
        burgers_ys[bf16][:head],
        plain_bf16,
    )
    scale = float(burgers_ys[f32][-1].abs().max())
    bf16_head = float(
        (burgers_ys[bf16][:BF16_HEAD_STEPS].float()
         - burgers_ys[f32][:BF16_HEAD_STEPS]).abs().max()
    ) / float(burgers_ys[f32][:BF16_HEAD_STEPS].abs().max())
    bf16_last = float(
        (burgers_ys[bf16][-1].float() - burgers_ys[f32][-1]).abs().max()
    ) / scale
    log(
        f"phase 2d system bfloat16: 641^2 Burgers with bfloat16 storage: "
        f"first {head} frames equal to the plain version; against float32, "
        f"of the largest value, {bf16_head:.3e} over the first "
        f"{BF16_HEAD_STEPS} frames (bound {TILED_BF16_TOL:g}) and "
        f"{bf16_last:.3e} on frame {BURGERS_641_STEPS}, printed, not gated "
        f"(one rounding a step: increments under half a bfloat16 step are "
        f"lost, through the JAX generic step too; tests/"
        f"test_torch_tiled_system.py::test_bfloat16_drift_comes_from_the_"
        f"once_a_step_rounding)"
    )
    assert bf16_head <= TILED_BF16_TOL, bf16_head
    assert np.isfinite(bf16_last)
    del burgers_ys, solutions, heads, plain_bf16
    torch.cuda.empty_cache()

    # Cahn-Hilliard Parareal against its fine trajectory
    fine_fn, _ = fdm(CH_PARAREAL_FINE_D_T).trajectory_function(
        ch_cp, (0.0, CH_PARAREAL_T_END)
    )
    coarse_fn, _ = fdm(CH_PARAREAL_COARSE_D_T).trajectory_function(
        ch_cp, (0.0, CH_PARAREAL_T_END)
    )
    assert fine_fn.fused and coarse_fn.fused
    fine_ys = fine_fn(ch_y, 0.0)
    coarse_ys = coarse_fn(ch_y, 0.0)
    ratio = round(CH_PARAREAL_COARSE_D_T / CH_PARAREAL_FINE_D_T)
    coarse_diff = float(
        (coarse_ys - fine_ys[ratio - 1:: ratio]).abs().max()
    )
    slice_steps = round(
        CH_PARAREAL_T_END / CH_PARAREAL_SLICES / CH_PARAREAL_FINE_D_T
    )
    coarse_steps = slice_steps // ratio
    ch_cfg = fs._SystemKernelConfig(ch_cp, CH_PARAREAL_COARSE_D_T)
    slice_starts = torch.cat(
        [ch_y[None], fine_ys[slice_steps - 1: -1: slice_steps]]
    ).contiguous()
    slice_miss = float(
        (
            fs.fused_system_rk4_end(slice_starts, ch_cfg, coarse_steps)
            - fine_ys[slice_steps - 1:: slice_steps]
        )
        .abs()
        .max()
    )
    parareal_diff = float(
        (torch.as_tensor(parareal_ys, device=device) - fine_ys.double())
        .abs()
        .max()
    )
    gate = 2 * CH_PARAREAL_TOLERANCE
    log(
        f"phase 2d system parareal: Cahn-Hilliard {CH_PARAREAL_N}^2, "
        f"{CH_PARAREAL_SLICES} slices, fine d_t {CH_PARAREAL_FINE_D_T:g}, "
        f"coarse d_t {CH_PARAREAL_COARSE_D_T:g}, tolerance "
        f"{CH_PARAREAL_TOLERANCE:g}: {iterations} iterations, max diff vs "
        f"fine {parareal_diff:.3e} (gate {gate:g}); the coarse trajectory "
        f"alone misses the fine one by {coarse_diff:.3e}, the coarse "
        f"operator the fine slice ends from the fine starts by "
        f"{slice_miss:.3e}; max|y| {float(fine_ys.abs().max()):.4f}"
    )
    assert parareal_ys.shape == tuple(fine_ys.shape)
    assert parareal_diff <= gate, parareal_diff
    # the gate can see a missing correction only if the coarse operator
    # alone fails it, and then a correction must have run
    assert coarse_diff > gate and slice_miss > gate, (coarse_diff, slice_miss)
    assert iterations >= 2, iterations
    del fine_ys, coarse_ys, parareal_ys, slice_starts
    torch.cuda.empty_cache()

    # -- phase 19: times -------------------------------------------------
    runs, run_ms = {}, {}
    # label, family, problem, d_t, steps, initial state, trajectory
    timed_runs = []
    for label, (family, ivp, d_t, y_0) in examples.items():
        cp = ivp.constrained_problem
        fn, t = fdm(d_t).trajectory_function(cp, ivp.t_interval)
        timed_runs.append((label, family, cp, d_t, len(t), y_0, fn))
    for storage, fn in burgers_fns.items():
        label = "burgers 641^2 x 2" + (", bfloat16" if storage == bf16 else "")
        timed_runs.append(
            (label, "burgers", burgers_cp, BURGERS_641_D_T,
             BURGERS_641_STEPS, burgers_y, fn)
        )
    for label, family, cp, d_t, steps, y_0, fn in timed_runs:
        cfg = ts._TiledSystemConfig(cp, d_t)
        runs[label] = lambda fn=fn, y_0=y_0: fn(y_0, 0.0)
        run_ms[label] = cuda_ms(torch, runs[label], reps=3)
        item = 2 if label.endswith("bfloat16") else 4
        bound_ms, bound_by = tiled_system_bound(family, cfg, 1, steps, item)
        route = (
            "the cluster-resident mode"
            if fs.cluster_system_applicable(cp)
            else f"K8 trajectory ({cfg.plan.blocks} blocks)"
        )
        log(
            f"time: {label}, {route}, "
            f"{steps} steps: {run_ms[label]:.3f} ms "
            f"({1e3 * run_ms[label] / steps:.3f} us a step), bound "
            f"{bound_ms:.3f} ms ({bound_by}) [{card}]"
        )
        if label.endswith("bfloat16"):
            continue
        generic_fn, _ = fdm(d_t, fused_kernels=False).trajectory_function(
            cp, (0.0, SYSTEM_TIMED_STEPS * d_t)
        )
        generic_ms = cuda_ms(torch, lambda: generic_fn(y_0, 0.0), reps=3)
        scaled_ms = generic_ms * steps / SYSTEM_TIMED_STEPS
        log(
            f"time: generic path {label}, {SYSTEM_TIMED_STEPS} steps: "
            f"{generic_ms:.3f} ms (median of 3), scaled to {steps} steps "
            f"{scaled_ms:.3f} ms (scaled, not run): the kernel "
            f"{scaled_ms / run_ms[label]:.3f}x faster [{card}]"
        )
    # the plan's tiles against two other tilings, through the K8 wrapper
    for label, others, steps in (
        ("wave 101^2 x 2", ((16, 32), (12, 24)), 500),
        ("shallow water 101 x 51 x 3", ((16, 32), (12, 24)), 500),
        ("cahn-hilliard 101^2 x 2", ((16, 32), (8, 24)), 500),
        ("burgers 641^2 x 2", ((32, 64), (48, 64)), 100),
    ):
        if label in examples:
            _, ivp, d_t, y_0 = examples[label]
            cfg = ts._TiledSystemConfig(ivp.constrained_problem, d_t)
        else:
            cfg, y_0 = burgers_cfg, burgers_y
        tilings = []
        for rows, cols in ((cfg.plan.rows, cfg.plan.cols),) + others:
            plan = cfg.plan._replace(rows=rows, cols=cols)
            ms = cuda_ms(torch, lambda: k8(y_0, cfg, steps, plan=plan))
            tilings.append(f"{rows} x {cols} {1e3 * ms / steps:.3f}")
        log(
            f"time: K8 tilings, {label}, {steps} steps, us a step: the "
            f"plan's {tilings[0]}; others {', '.join(tilings[1:])} [{card}]"
        )
    fine_run, _ = fdm(CH_PARAREAL_FINE_D_T).trajectory_function(
        ch_cp, (0.0, CH_PARAREAL_T_END)
    )
    program, _ = parareal.trajectory_function(ch_cp, (0.0, CH_PARAREAL_T_END))
    runs["cahn-hilliard 41^2 fine"] = lambda: fine_run(ch_y, 0.0)
    runs["cahn-hilliard 41^2 parareal"] = lambda: program(ch_y)
    for label in ("cahn-hilliard 41^2 fine", "cahn-hilliard 41^2 parareal"):
        run_ms[label] = cuda_ms(torch, runs[label])
    fine_ms = run_ms["cahn-hilliard 41^2 fine"]
    parareal_ms = run_ms["cahn-hilliard 41^2 parareal"]
    log(
        f"time: cahn-hilliard 41^2 fine solve (K5 trajectory, "
        f"{slice_steps * CH_PARAREAL_SLICES} steps): {fine_ms:.3f} ms"
        + before_redesign(
            "cahn-hilliard 41^2 fine",
            f"{slice_steps * CH_PARAREAL_SLICES} steps",
        )
        + "; "
        f"Parareal, {CH_PARAREAL_SLICES} slices: {parareal_ms:.3f} ms, "
        f"Parareal, {CH_PARAREAL_SLICES} slices: {parareal_ms:.3f} ms, "
        f"speedup {fine_ms / parareal_ms:.3f}x, "
        f"{parareal.last_iterations} iterations [{card}]"
    )

    # each kernel function at the shapes of its path, beside its plain
    # version (one run where it takes seconds) and its bound
    cells_641 = burgers_cfg.height * burgers_cfg.width
    ch_fine_cfg = fs._SystemKernelConfig(ch_cp, CH_PARAREAL_FINE_D_T)
    ch_cells = CH_PARAREAL_N * CH_PARAREAL_N
    ch_slices = torch.stack(
        [ch_y * (1.0 - 0.01 * i) for i in range(CH_PARAREAL_SLICES)]
    ).contiguous()
    coarse_total = coarse_steps * CH_PARAREAL_SLICES
    b = CH_PARAREAL_SLICES
    timings = [
        (TILED_SYSTEM_KERNEL, TILED_SYSTEM_KERNEL, k8, k8_plain,
         f"641^2 x 2 Burgers, {SYSTEM_TIMED_STEPS} steps",
         (burgers_y, burgers_cfg, SYSTEM_TIMED_STEPS),
         tiled_system_bound("burgers", burgers_cfg, 1, SYSTEM_TIMED_STEPS, 4),
         True, TILED_SYSTEM_SOURCE, TILED_SYSTEM_REPLACES),
    ]
    replaced = {name: replaces for name, _, replaces, _ in SYSTEM_KERNELS}
    for name, what, args, (n_steps, batch, trajectory) in (
        ("packed_system_rk4_ends",
         f"B={b} x 41^2 x 2 Cahn-Hilliard, {slice_steps} steps (one "
         "iteration's fine ends)",
         (ch_slices, ch_fine_cfg, slice_steps), (slice_steps, b, False)),
        ("packed_system_rk4_trajectory",
         f"B={b} x 41^2 x 2 Cahn-Hilliard, {slice_steps} steps (the final "
         "expansion)",
         (ch_slices, ch_fine_cfg, slice_steps), (slice_steps, b, True)),
        ("fused_system_rk4_trajectory",
         f"41^2 x 2 Cahn-Hilliard, {coarse_total} coarse steps (the coarse "
         "roll-out)",
         (ch_y, ch_cfg, coarse_total), (coarse_total, 1, True)),
        ("fused_system_rk4_end",
         f"41^2 x 2 Cahn-Hilliard, {coarse_steps} coarse steps (one slice "
         "of a coarse sweep)",
         (ch_y, ch_cfg, coarse_steps), (coarse_steps, 1, False)),
    ):
        timings.append(
            (f"{name}:cahn-hilliard", name, family_wrappers[name],
             family_plain[name], what, args,
             stencil_bound("cahn-hilliard", batch, n_steps, ch_cells, 2,
                           trajectory),
             True, SYSTEM_SOURCE, replaced[name])
        )
    for family in ("wave", "shallow-water"):
        cp = system_problem_2d(
            prml, family, "dirichlet" if family == "wave" else "partial",
            K5_FAMILY_SHAPE,
        )
        cfg = fs._SystemKernelConfig(cp, 1e-3)
        y = smooth_states_2d(torch, device, K5_FAMILY_SHAPE, cfg.n)
        name = "fused_system_rk4_trajectory"
        timings.append(
            (f"{name}:{family}", name, family_wrappers[name],
             family_plain[name],
             f"{K5_FAMILY_SHAPE[0]} x {K5_FAMILY_SHAPE[1]} x {cfg.n} "
             f"{family}, {K5_FAMILY_STEPS} steps",
             (y, cfg, K5_FAMILY_STEPS),
             stencil_bound(family, 1, K5_FAMILY_STEPS,
                           K5_FAMILY_SHAPE[0] * K5_FAMILY_SHAPE[1], cfg.n,
                           True),
             False, SYSTEM_SOURCE, replaced[name])
        )
    entries = []
    for (key, name, wrapper, plain, what, args, (bound_ms, bound_by),
         on_path, source, replaces) in timings:
        kernel_ms = cuda_ms(torch, lambda: wrapper(*args))
        outputs = []
        plain_ms = once_ms(torch, lambda: outputs.append(plain(*args)))
        # the kernel against its plain version at the shapes it is timed
        # on, which are its path's
        rel_err = check(key, f"{what}, timed", wrapper(*args), outputs[0])
        del outputs
        log(
            f"time: {key} ({what}): kernel {kernel_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms (one run), bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}); against the plain version there "
            f"max|d|/max|y| = {rel_err:.3e}{before_redesign(key, what)} "
            f"[{card}]"
        )
        entries.append(
            {
                "name": key,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "on_path": on_path,
                "launches": launches[name] if on_path else 0,
                "max_abs_err": errors.get(key, 0.0),
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_us": bound_ms * 1e3,
                "bound_by": bound_by,
                "library_ms": None,
                "timed": what,
            }
        )
    del ch_slices
    torch.cuda.empty_cache()

    # -- phase 20: device busy time and idle share (torch.profiler) ------
    for label, run in runs.items():
        busy_ms, top = device_busy_ms(torch, run, reps=1)
        if busy_ms is None:
            log(f"profile: {label}: not measured (no device events)")
            continue
        log(
            f"profile: {label}: device busy {busy_ms:.3f} ms of "
            f"{run_ms[label]:.3f} ms, idle share "
            f"{1.0 - busy_ms / run_ms[label]:.3f}; top: {top} [{card}]"
        )
    return entries


def shallow_water_polar_example(prml):
    """examples/shallow_water_polar_fdm.py's problem: shallow water (h =
    0.5) on the polar mesh r in [4, 11], theta in [pi / 2, 3 pi / 2] at
    (0.2, pi / 50) (36 x 51), zero-flux faces for the height alone,
    Gaussians of covariance 0.25 I at (-6, 6) with amplitudes (1, 0, 0),
    to T = 10 at d_t 0.0025 (4,000 steps). Returns the problem and its
    d_t."""
    flux = prml.NeumannBoundaryCondition(
        prml.vectorize_bc_function(lambda x, t: (0.0, None, None)),
        is_static=True,
    )
    cp = prml.ConstrainedProblem(
        prml.ShallowWaterEquation(0.5),
        prml.Mesh(
            [(4.0, 11.0), (0.5 * np.pi, 1.5 * np.pi)],
            [0.2, np.pi / 50.0],
            prml.CoordinateSystem.POLAR,
        ),
        [(flux, flux)] * 2,
    )
    ic = prml.GaussianInitialCondition(
        cp,
        [(np.array([-6.0, 6.0]), np.array([[0.25, 0.0], [0.0, 0.25]]))] * 3,
        [1.0, 0.0, 0.0],
    )
    return (
        prml.InitialValueProblem(cp, (0.0, SHALLOW_WATER_POLAR_T_END), ic),
        0.0025,
    )


def wave_polar_example(prml):
    """examples/wave_polar_fdm.py's problem: the wave equation (c = 1) on
    the polar mesh r in [2.5, 7.5], theta in [0, 2 pi] at (0.1, pi / 100)
    (51 x 201), zero-flux faces, Gaussians of covariance 0.1 I at (-5, 0)
    with amplitudes (4, 0), to T = 50 at d_t 0.002 (25,000 steps). Returns
    the problem and its d_t."""
    flux = prml.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = prml.ConstrainedProblem(
        prml.WaveEquation(2),
        prml.Mesh(
            [(2.5, 7.5), (0.0, 2 * np.pi)],
            [0.1, np.pi / 100.0],
            prml.CoordinateSystem.POLAR,
        ),
        [(flux, flux)] * 2,
    )
    ic = prml.GaussianInitialCondition(
        cp,
        [(np.array([-5.0, 0.0]), np.array([[0.1, 0.0], [0.0, 0.1]]))] * 2,
        [4.0, 0.0],
    )
    return prml.InitialValueProblem(cp, (0.0, WAVE_POLAR_T_END), ic), 0.002


def burgers_spherical_example(prml):
    """examples/burgers_3d_fdm.py's problem: viscous Burgers (Re = 100) on
    the spherical mesh r in [1, 5], theta in [0, 2 pi], phi in [pi / 4,
    3 pi / 4] at (0.5, pi / 10, pi / 10) (9 x 21 x 6), zero-flux faces,
    y = (1 / r^2, 0, 0), to T = 100 at d_t 0.5 (200 steps). Returns the
    problem and its d_t."""
    flux = prml.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 3)), is_static=True
    )
    cp = prml.ConstrainedProblem(
        prml.BurgersEquation(3, 100),
        prml.Mesh(
            [(1.0, 5.0), (0.0, 2.0 * np.pi), (0.25 * np.pi, 0.75 * np.pi)],
            [0.5, np.pi / 10.0, np.pi / 10.0],
            prml.CoordinateSystem.SPHERICAL,
        ),
        [(flux, flux)] * 3,
    )
    ic = prml.ContinuousInitialCondition(
        cp,
        lambda x: np.stack(
            [
                1.0 / x[:, 0] ** 2,
                np.zeros_like(x[:, 1]),
                np.zeros_like(x[:, 1]),
            ],
            axis=-1,
        ),
    )
    return prml.InitialValueProblem(cp, (0.0, SPHERICAL_T_END), ic), 0.5


def polar_problem_2d(prml, family, faces):
    """A polar problem of one of the 2D system families on the JAX tests'
    polar mesh (tests/test_fused_system.py ``_polar_cp``: r in [2.5,
    7.5] at 0.25, theta in [0, 2 pi] at pi / 20, 21 x 41); ``faces``
    "neumann" is Neumann 0.05 on every face, "dirichlet" Dirichlet 0.1 on
    the r faces and Neumann 0.05 on the theta faces."""
    equation, n = {
        "wave": (prml.WaveEquation(2), 2),
        "burgers": (prml.BurgersEquation(2, 100.0), 2),
        "shallow-water": (prml.ShallowWaterEquation(0.5), 3),
        "cahn-hilliard": (prml.CahnHilliardEquation(2), 2),
    }[family]
    mesh = prml.Mesh(
        [(2.5, 7.5), (0.0, 2 * np.pi)],
        [0.25, np.pi / 20.0],
        prml.CoordinateSystem.POLAR,
    )
    neumann = prml.NeumannBoundaryCondition(
        lambda x, t: np.full((len(x), n), 0.05), is_static=True
    )
    if faces == "dirichlet":
        dirichlet = prml.DirichletBoundaryCondition(
            lambda x, t: np.full((len(x), n), 0.1), is_static=True
        )
        bcs = [(dirichlet, dirichlet), (neumann, neumann)]
    else:
        bcs = [(neumann, neumann)] * 2
    return prml.ConstrainedProblem(equation, mesh, bcs)


def generic_end_on_card(torch, operator, cp, y_0, steps, chunk=100):
    """The generic path's state after ``steps`` steps of ``operator`` from
    ``y_0`` on the card, the reference for a kernel's last frame: the
    eager loop launches each of a step's hundreds of small operations from
    Python (milliseconds a step), so ``chunk`` steps are captured once in a
    CUDA graph and replayed. Returns the state and how it was computed;
    where the capture fails, the eager loop runs instead."""
    step = operator._build_step_function(cp, allow_fused=False)
    if steps % chunk:
        chunk = 1
    state = y_0.clone()
    # a warm step on a side stream first: the constraint tensors reach the
    # card before the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(state, 0, 0.0)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = state
            for k in range(chunk):
                y = step(y, k, 0.0)
        out = y
    except RuntimeError as error:
        torch.cuda.synchronize()
        y = y_0
        for k in range(steps):
            y = step(y, k, 0.0)
        return y, f"eager ({error.__class__.__name__}: capture refused)"
    for _ in range(steps // chunk):
        graph.replay()
        state.copy_(out)
    torch.cuda.synchronize()
    del graph
    return state, f"{steps // chunk} replays of a CUDA graph of {chunk} steps"


def polar_phases(
    torch, prml, device, card, cuda_ms, once_ms, device_busy_ms
):
    """Phases 21-24: the curvilinear path (polar K5 in one CTA, polar K8
    past it, the spherical generic path) and K4's bfloat16 frames. Returns
    their entries of the JSON line. ``cuda_ms``, ``once_ms`` and
    ``device_busy_ms`` are the timing and profiling functions."""
    from pararealml_tpu_torch.operators.fdm import (
        RK4,
        FDMOperator,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu_torch.ops import fused_system as fs
    from pararealml_tpu_torch.ops import fused_system_3d as f3
    from pararealml_tpu_torch.ops import packed_system as ps
    from pararealml_tpu_torch.ops import tiled_system as ts

    modules = {"fused_system": fs, "tiled_system": ts}
    wrappers = {
        name: getattr(modules[module], name)
        for name, module, _, _ in POLAR_KERNELS
    }
    plains = {
        name: getattr(modules[module], f"{name}_reference")
        for name, module, _, _ in POLAR_KERNELS
    }
    k8 = wrappers[TILED_SYSTEM_KERNEL]
    k4_trajectory = ps.packed_system_rk4_trajectory
    errors = {}
    started = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16

    def check(key, what, kernel, plain):
        torch.cuda.synchronize()
        assert kernel.shape == plain.shape, (key, what)
        assert kernel.dtype == plain.dtype, (key, what)
        abs_err = float((kernel.float() - plain.float()).abs().max())
        rel_err = abs_err / float(plain.float().abs().max())
        errors[key] = max(errors.get(key, 0.0), abs_err)
        if not rel_err <= KERNEL_REL_TOL:
            raise AssertionError(
                f"{key} disagrees with its plain version ({what}): "
                f"{rel_err:.3e}"
            )
        return rel_err

    # -- phase 21: polar K5, polar K8 and K4's bfloat16 frames -------------
    families = ("wave", "burgers", "shallow-water", "cahn-hilliard")
    for family in families:
        faces = "dirichlet" if family in ("wave", "shallow-water") else (
            "neumann"
        )
        cp = polar_problem_2d(prml, family, faces)
        shape = cp.mesh.vertices_shape
        cfg = fs._SystemKernelConfig(cp, 1e-3)
        assert cfg.polar and fs.fits_one_block(cp)
        y = smooth_states_2d(torch, device, shape, cfg.n)
        ys = smooth_states_2d(torch, device, shape, cfg.n, batch=4, seed=1)
        steps = POLAR_SMALL_STEPS
        worst = 0.0
        for name, args in (
            ("fused_system_rk4_trajectory", (y, cfg, steps)),
            ("fused_system_rk4_end", (ys, cfg, steps)),
            ("fused_system_rk4_step", (ys, cfg)),
        ):
            worst = max(
                worst,
                check(
                    f"{name}:polar",
                    f"{family}, {faces}",
                    wrappers[name](*args),
                    plains[name](*args),
                ),
            )
        tcfg = ts._TiledSystemConfig(cp, 1e-3)
        halo = tcfg.halo
        plans = (
            tcfg.plan,
            tcfg.plan._replace(rows=2 * halo + 3, cols=2 * halo + 5),
            tcfg.plan._replace(
                rows=2 * halo + shape[0], cols=2 * halo + shape[1]
            ),
        )
        pair = ys[:2].contiguous()
        tiled_worst = 0.0
        for storage in (f32, bf16):
            expected = plains[TILED_SYSTEM_KERNEL](
                pair, tcfg, SYSTEM_SMALL_STEPS, storage
            )
            for plan in plans:
                tiled_worst = max(
                    tiled_worst,
                    check(
                        f"{TILED_SYSTEM_KERNEL}:polar",
                        f"{family}, {faces}, {storage}, {plan.blocks} tiles",
                        k8(pair, tcfg, SYSTEM_SMALL_STEPS, storage, plan=plan),
                        expected,
                    ),
                )
        # polar K8 keeps polar K5's order of operations: equal frames
        k5_frames = wrappers["fused_system_rk4_trajectory"](
            pair, cfg, SYSTEM_SMALL_STEPS
        )
        k8_frames = k8(pair, tcfg, SYSTEM_SMALL_STEPS)
        torch.cuda.synchronize()
        k8_vs_k5 = float((k8_frames - k5_frames).abs().max())
        log(
            f"kernels: polar {family} on {shape[0]} x {shape[1]}, {faces} "
            f"faces: K5 trajectory, B=4 end and step over {steps} steps "
            f"max|d|/max|y| = {worst:.3e}; K8 on {len(plans)} tilings "
            f"({', '.join(str(plan.blocks) for plan in plans)} tiles), "
            f"float32 and bfloat16 storage, {SYSTEM_SMALL_STEPS} steps "
            f"{tiled_worst:.3e}; K8 against K5 max|d| = {k8_vs_k5:.3e}"
        )
        assert k8_vs_k5 <= KERNEL_REL_TOL * float(k5_frames.abs().max())
    # K4's frames in the snapshot dtype (bfloat16 over the float32 state,
    # cast back), as Parareal's final expansion stores them when the fine
    # operator asks for kernel_traj_dtype=bfloat16
    cp = system_problem_2d(prml, "burgers", "dirichlet", K5_FAMILY_SHAPE)
    k4_cfg = fs._SystemKernelConfig(cp, 1e-3)
    k4_ys = smooth_states_2d(
        torch, device, K5_FAMILY_SHAPE, 2, batch=4, seed=2
    )
    k4_args = (k4_ys, k4_cfg, K5_FAMILY_STEPS, bf16)
    k4_key = "packed_system_rk4_trajectory:bfloat16-frames"
    rounded = k4_trajectory(*k4_args)
    exact = k4_trajectory(*k4_args[:3])
    rel = check(
        k4_key,
        "Burgers, B=4",
        rounded,
        ps.packed_system_rk4_trajectory_reference(*k4_args),
    )
    assert rounded.dtype == f32
    assert torch.equal(rounded, exact.to(bf16).to(f32))
    log(
        f"kernels: K4 trajectory with bfloat16 frames (B=4 x "
        f"{K5_FAMILY_SHAPE[0]} x {K5_FAMILY_SHAPE[1]} Burgers, "
        f"{K5_FAMILY_STEPS} steps): max|d|/max|y| = {rel:.3e} against its "
        "plain version, and each frame the float32 frame rounded once"
    )
    del rounded, exact
    torch.cuda.empty_cache()
    log(f"phase polar kernels: ok ({time.perf_counter() - started:.1f} s)")

    # -- phase 22: the path at full width, counted -----------------------
    def fdm(d_t, **kwargs):
        # no device argument: the entry points run on the card
        return FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), d_t, **kwargs
        )

    def initial(ivp, dtype=f32, on=device):
        return torch.as_tensor(
            ivp.initial_condition.discrete_y_0(True), dtype=dtype, device=on
        )

    # label: (family, problem, d_t, initial state, kernel)
    examples = {}
    for label, family, kernel, (ivp, d_t) in (
        ("shallow water polar 36 x 51 x 3", "polar-shallow-water",
         "fused_system_rk4_trajectory", shallow_water_polar_example(prml)),
        ("wave polar 51 x 201 x 2", "polar-wave", CLUSTER_KERNEL,
         wave_polar_example(prml)),
    ):
        examples[label] = (family, ivp, d_t, initial(ivp), kernel)
    sw_cp = examples["shallow water polar 36 x 51 x 3"][1].constrained_problem
    wave_cp = examples["wave polar 51 x 201 x 2"][1].constrained_problem
    assert fs.fits_one_block(sw_cp) and not fs.fits_one_block(wave_cp)
    assert fs.fits_reference_vmem(wave_cp)
    assert fs.cluster_system_applicable(wave_cp)
    spherical_ivp, spherical_d_t = burgers_spherical_example(prml)
    k9_wrappers = {
        name: getattr(f3, name)
        for name in (
            "fused_system_3d_rk4_trajectory",
            "fused_system_3d_rk4_end",
            "fused_system_3d_rk4_step",
        )
    }
    counted = dict(
        wrappers,
        **k9_wrappers,
        packed_system_rk4_ends=ps.packed_system_rk4_ends,
        packed_system_rk4_trajectory=k4_trajectory,
        **{CLUSTER_KERNEL: fs.cluster_system_rk4_trajectory},
    )
    generic_builds = []
    build_step = FDMOperator._build_step_function

    def counting_build(self, cp, allow_fused=True, dtype=None):
        if not allow_fused:
            generic_builds.append(cp)
        return build_step(self, cp, allow_fused, dtype)

    for wrapper in counted.values():
        wrapper.launches = 0
    FDMOperator._build_step_function = counting_build
    try:
        solutions = {
            label: fdm(d_t).solve(ivp).discrete_y()
            for label, (_, ivp, d_t, _, _) in examples.items()
        }
        polar_builds = len(generic_builds)
        spherical = fdm(spherical_d_t).solve(spherical_ivp).discrete_y()
    finally:
        FDMOperator._build_step_function = build_step
    launches = {name: w.launches for name, w in counted.items()}
    log(
        f"polar main-path launches: {launches} (the two polar examples' "
        f"solves built the generic step {polar_builds} times; the "
        f"spherical solve {len(generic_builds) - polar_builds})"
    )
    assert polar_builds == 0, "a polar example took the generic path"
    # the polar wave example runs on the cluster-resident mode, polar K8
    # no more
    assert launches == dict(
        {name: 0 for name in counted},
        fused_system_rk4_trajectory=1,
        **{CLUSTER_KERNEL: 1},
    ), launches
    # the spherical problem has no kernel in either package: generic
    assert len(generic_builds) - polar_builds >= 1

    head = SYSTEM_HEAD_STEPS
    for label, (family, ivp, d_t, y_0, kernel) in examples.items():
        cp = ivp.constrained_problem
        ys = solutions[label]
        steps = round(ivp.t_interval[1] / d_t)
        assert ys.shape == (steps,) + tuple(y_0.shape), (label, ys.shape)
        assert np.isfinite(ys).all(), label
        frames = torch.as_tensor(ys[:head], device=device)
        # both K5's plain version: the mode computes what K5 computes
        plain = fs.fused_system_rk4_trajectory_reference(
            y_0, fs._SystemKernelConfig(cp, d_t), head
        )
        plain = plain.double()
        rel = float((frames - plain).abs().max()) / float(plain.abs().max())
        errors[f"{kernel}:polar"] = max(
            errors.get(f"{kernel}:polar", 0.0),
            float((frames - plain).abs().max()),
        )
        generic_fn, _ = fdm(d_t, fused_kernels=False).trajectory_function(
            cp, (0.0, head * d_t)
        )
        assert not generic_fn.fused
        generic = generic_fn(y_0, 0.0).double()
        difference = (frames - generic).abs()
        # the last frame against the generic path over the whole horizon
        last_generic, how = generic_end_on_card(
            torch, fdm(d_t, fused_kernels=False), cp, y_0, steps
        )
        last_generic = last_generic.double()
        last = torch.as_tensor(ys[-1], device=device)
        scale = float(last_generic.abs().max())
        last_rel = float((last - last_generic).abs().max()) / scale
        log(
            f"phase polar path: {label} ({kernel}, {steps} steps): first "
            f"{head} frames against the plain version max|d|/max|y| = "
            f"{rel:.3e}, against the generic path max|d| = "
            f"{float(difference.max()):.3e} (atol = rtol = 1e-4); frame "
            f"{steps} against the generic path (float32, run over the "
            f"whole horizon: {how}) max|d|/max|y| = {last_rel:.3e} (limit "
            f"{POLAR_LAST_TOL:g}; max|y| {scale:.4f})"
        )
        assert rel <= KERNEL_REL_TOL, (label, rel)
        assert bool((difference <= 1e-4 + 1e-4 * generic.abs()).all()), label
        assert last_rel <= POLAR_LAST_TOL, (label, last_rel)
    del solutions
    torch.cuda.empty_cache()
    # the spherical problem: the card's generic path (float32) against the
    # port's CPU float64 solve
    steps = round(SPHERICAL_T_END / spherical_d_t)
    assert spherical.shape == (steps, 9, 21, 6, 3), spherical.shape
    cpu = (
        FDMOperator(
            RK4(),
            ThreePointCentralDifferenceMethod(),
            spherical_d_t,
            device="cpu",
            dtype=torch.float64,
        )
        .solve(spherical_ivp)
        .discrete_y()
    )
    spherical_rel = float(np.abs(spherical - cpu).max()) / float(
        np.abs(cpu).max()
    )
    log(
        f"phase polar spherical: Burgers 9 x 21 x 6 x 3, {steps} steps, "
        f"generic path on the card (float32) against the CPU (float64): "
        f"max|d|/max|y| = {spherical_rel:.3e} (limit {SPHERICAL_TOL:g})"
    )
    assert np.isfinite(spherical).all()
    assert spherical_rel <= SPHERICAL_TOL, spherical_rel
    log(f"phase polar path: ok ({time.perf_counter() - started:.1f} s)")

    # -- phase 23: times -------------------------------------------------
    runs, run_ms = {}, {}
    for label, (family, ivp, d_t, y_0, kernel) in examples.items():
        cp = ivp.constrained_problem
        fn, t = fdm(d_t).trajectory_function(cp, ivp.t_interval)
        steps = len(t)
        runs[label] = lambda fn=fn, y_0=y_0: fn(y_0, 0.0)
        run_ms[label] = cuda_ms(torch, runs[label], reps=3)
        kcfg = fs._SystemKernelConfig(cp, d_t)
        bound_ms, bound_by = stencil_bound(
            family, 1, steps, kcfg.height * kcfg.width, kcfg.n, True
        )
        if kernel == CLUSTER_KERNEL:
            what = (
                "the cluster-resident mode, a cluster of "
                f"{fs.cluster_plan(kcfg).cluster_size} blocks"
            )
        else:
            clusters = fs.k5_cluster_size(kcfg)
            what = (
                "K5, one CTA" if clusters == 1
                else f"K5, a cluster of {clusters} blocks"
            )
        generic_fn, _ = fdm(d_t, fused_kernels=False).trajectory_function(
            cp, (0.0, SYSTEM_TIMED_STEPS * d_t)
        )
        generic_ms = cuda_ms(torch, lambda: generic_fn(y_0, 0.0), reps=3)
        scaled_ms = generic_ms * steps / SYSTEM_TIMED_STEPS
        log(
            f"time: {label}, {what} trajectory, {steps} steps: "
            f"{run_ms[label]:.3f} ms ({1e3 * run_ms[label] / steps:.3f} us "
            f"a step), bound {bound_ms * 1e3:.3f} us ({bound_by}); generic "
            f"path "
            f"{SYSTEM_TIMED_STEPS} steps {generic_ms:.3f} ms, scaled to "
            f"{steps} steps {scaled_ms:.3f} ms (scaled, not run): "
            f"{scaled_ms / run_ms[label]:.3f}x"
            f"{before_redesign(label, f'{steps} steps')} [{card}]"
        )
    spherical_fn, spherical_t = fdm(spherical_d_t).trajectory_function(
        spherical_ivp.constrained_problem, spherical_ivp.t_interval
    )
    spherical_y = initial(spherical_ivp)
    # the solve above warmed the path: one run (seconds of eager steps)
    ms = once_ms(torch, lambda: spherical_fn(spherical_y, 0.0))
    log(
        f"time: burgers spherical 9 x 21 x 6 x 3, generic path, "
        f"{len(spherical_t)} steps: {ms:.3f} ms (one run; "
        f"{1e3 * ms / len(spherical_t):.3f} us a step) [{card}]"
    )
    # profiled over its first SYSTEM_TIMED_STEPS steps
    spherical_head, _ = fdm(spherical_d_t).trajectory_function(
        spherical_ivp.constrained_problem,
        (0.0, SYSTEM_TIMED_STEPS * spherical_d_t),
    )
    label = f"burgers spherical, first {SYSTEM_TIMED_STEPS} steps"
    runs[label] = lambda: spherical_head(spherical_y, 0.0)
    run_ms[label] = once_ms(torch, runs[label])

    # each polar kernel function at its path's grid, beside its plain
    # version (one run) and its bound
    sw_ivp, sw_d_t = shallow_water_polar_example(prml)
    wave_ivp, wave_d_t = wave_polar_example(prml)
    sw_cfg = fs._SystemKernelConfig(sw_ivp.constrained_problem, sw_d_t)
    wave_cfg = ts._TiledSystemConfig(wave_ivp.constrained_problem, wave_d_t)
    sw_y = examples["shallow water polar 36 x 51 x 3"][3]
    wave_y = examples["wave polar 51 x 201 x 2"][3]
    sw_cells = sw_cfg.height * sw_cfg.width
    steps = POLAR_TIMED_STEPS
    sources = {name: (source, replaces) for name, _, source, replaces in (
        POLAR_KERNELS
    )}
    timings = [
        ("fused_system_rk4_trajectory",
         f"36 x 51 x 3 polar shallow water, {steps} steps",
         (sw_y, sw_cfg, steps),
         stencil_bound("polar-shallow-water", 1, steps, sw_cells, 3, True),
         True),
        ("fused_system_rk4_end",
         f"36 x 51 x 3 polar shallow water, {steps} steps",
         (sw_y, sw_cfg, steps),
         stencil_bound("polar-shallow-water", 1, steps, sw_cells, 3, False),
         False),
        ("fused_system_rk4_step", "36 x 51 x 3 polar shallow water, 1 step",
         (sw_y, sw_cfg),
         stencil_bound("polar-shallow-water", 1, 1, sw_cells, 3, True),
         False),
        # polar K8 left the polar wave example's path for the
        # cluster-resident mode (phases 33-36)
        (TILED_SYSTEM_KERNEL, f"51 x 201 x 2 polar wave, {steps} steps",
         (wave_y, wave_cfg, steps),
         tiled_system_bound("polar-wave", wave_cfg, 1, steps, 4), False),
    ]
    entries = []
    for name, what, args, (bound_ms, bound_by), on_path in timings:
        key = f"{name}:polar"
        kernel_ms = cuda_ms(torch, lambda: wrappers[name](*args))
        outputs = []
        plain_ms = once_ms(torch, lambda: outputs.append(plains[name](*args)))
        rel_err = check(key, f"{what}, timed", wrappers[name](*args),
                        outputs[0])
        del outputs
        log(
            f"time: {key} ({what}): kernel {kernel_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms (one run), bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}); against the plain version there "
            f"max|d|/max|y| = {rel_err:.3e}{before_redesign(key, what)} "
            f"[{card}]"
        )
        source, replaces = sources[name]
        entries.append(
            {
                "name": key,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "on_path": on_path,
                "launches": launches[name] if on_path else 0,
                "max_abs_err": errors.get(key, 0.0),
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_us": bound_ms * 1e3,
                "bound_by": bound_by,
                "library_ms": None,
                "timed": what,
            }
        )
    # K4's bfloat16 frames against its float32 frames, same call
    k4_ms = cuda_ms(torch, lambda: k4_trajectory(*k4_args))
    k4_f32_ms = cuda_ms(torch, lambda: k4_trajectory(*k4_args[:3]))
    outputs = []
    k4_plain_ms = once_ms(
        torch,
        lambda: outputs.append(
            ps.packed_system_rk4_trajectory_reference(*k4_args)
        ),
    )
    del outputs
    # stencil_bound's reads, and bfloat16 frames: 2 bytes a value
    k4_cells = K5_FAMILY_SHAPE[0] * K5_FAMILY_SHAPE[1]
    k4_values = 2 * k4_cells
    k4_bound = bound(
        4 * 4 * k4_values
        + 5 * k4_values
        + 2 * 4 * k4_values * K5_FAMILY_STEPS,
        FLOPS_PER_CELL_STEP["burgers"] * 4 * K5_FAMILY_STEPS * k4_cells,
    )
    log(
        f"time: {k4_key} (B=4 x {K5_FAMILY_SHAPE[0]} x {K5_FAMILY_SHAPE[1]} "
        f"Burgers, {K5_FAMILY_STEPS} steps): kernel {k4_ms:.3f} ms, with "
        f"float32 frames {k4_f32_ms:.3f} ms, plain {k4_plain_ms:.3f} ms (one "
        f"run), bound {k4_bound[0] * 1e3:.3f} us ({k4_bound[1]}) [{card}]"
    )
    entries.append(
        {
            "name": k4_key,
            "route": "cuda",
            "source": SYSTEM_SOURCE,
            "replaces": "pararealml_tpu/ops/packed_system.py:559",
            "on_path": False,
            "launches": 0,
            "max_abs_err": errors.get(k4_key, 0.0),
            "ms": k4_ms,
            "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound[0],
            "bound_us": k4_bound[0] * 1e3,
            "bound_by": k4_bound[1],
            "library_ms": None,
            "timed": f"B=4 x {K5_FAMILY_SHAPE[0]} x {K5_FAMILY_SHAPE[1]} "
            f"Burgers, {K5_FAMILY_STEPS} steps, bfloat16 frames",
        }
    )
    torch.cuda.empty_cache()
    log(f"phase polar times: ok ({time.perf_counter() - started:.1f} s)")

    # -- phase 24: device busy time and idle share (torch.profiler) ------
    for label, run in runs.items():
        busy_ms, top = device_busy_ms(torch, run, reps=1)
        if busy_ms is None:
            log(f"profile: {label}: not measured (no device events)")
            continue
        log(
            f"profile: {label}: device busy {busy_ms:.3f} ms of "
            f"{run_ms[label]:.3f} ms, idle share "
            f"{1.0 - busy_ms / run_ms[label]:.3f}; top: {top} [{card}]"
        )
    return entries


@contextlib.contextmanager
def navier_stokes_groups_of_one(ns, enabled=True):
    """Within the block (where ``enabled``), every Navier-Stokes kernel
    launch runs its plan with groups of one Jacobi sweep: the measured
    plans' comparison in turns, reached through the wrappers' plan hook
    (``ns._plan``) and nowhere else."""
    choose = ns._plan

    def groups_of_one(cfg, batch, cluster_size, plan):
        return choose(cfg, batch, cluster_size, plan)._replace(group=1)

    if enabled:
        ns._plan = groups_of_one
    try:
        yield
    finally:
        ns._plan = choose


def navier_stokes_problem(prml, example=True):
    """examples/navier_stokes_fdm.py's problem: Navier-Stokes at Re 5000
    on [-2.5, 2.5] x [0, 4] at (0.05, 0.05) (101 x 81 x 4), from rest to
    ``NS_T_END``; or, without ``example``, the constrained problem of
    tests/test_fused_system.py's ``_navier_stokes_cp`` (Re 500 on [-1, 1]
    x [0, 2] at 0.125: 17 x 17). Both have Dirichlet (w, psi) = (1, 0.1)
    on the lower axis-0 face and (0, 0) on the others, the velocities
    unconstrained."""
    def dirichlet(w, psi):
        return prml.DirichletBoundaryCondition(
            prml.vectorize_bc_function(lambda x, t: [w, psi, None, None]),
            is_static=True,
        )

    re, mesh = (
        (5000.0, prml.Mesh([(-2.5, 2.5), (0.0, 4.0)], [0.05, 0.05]))
        if example
        else (500.0, prml.Mesh([(-1.0, 1.0), (0.0, 2.0)], [0.125, 0.125]))
    )
    cp = prml.ConstrainedProblem(
        prml.NavierStokesEquation(re),
        mesh,
        [
            (dirichlet(1.0, 0.1), dirichlet(0.0, 0.0)),
            (dirichlet(0.0, 0.0), dirichlet(0.0, 0.0)),
        ],
    )
    if not example:
        return cp
    ic = prml.ContinuousInitialCondition(
        cp, lambda x: np.zeros((len(x), 4))
    )
    return prml.InitialValueProblem(cp, (0.0, NS_T_END), ic)


def navier_stokes_phases(
    torch, prml, device, card, cuda_ms, once_ms, device_busy_ms
):
    """Phases 25-28: the Navier-Stokes path (K5's Navier-Stokes family in
    a thread block cluster, the generic anti-Laplacian as its oracle).
    Returns its entries of the JSON line. ``cuda_ms``, ``once_ms`` and
    ``device_busy_ms`` are the timing and profiling functions."""
    from pararealml_tpu_torch.operators.fdm import (
        RK4,
        FDMOperator,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu_torch.operators.parareal import PararealOperator
    from pararealml_tpu_torch.ops import fused_navier_stokes as ns

    wrappers = {name: getattr(ns, name) for name, _ in NS_KERNELS}
    plains = {name: getattr(ns, f"{name}_reference") for name, _ in NS_KERNELS}
    errors = {name: 0.0 for name in wrappers}
    sweep_totals = {}
    started = time.perf_counter()

    def check(name, what, args, cluster_size=None, plan=None):
        """Runs the kernel and its plain version on ``args``; returns
        max|d|/max|y| (0.0: both evaluate the same operations in the same
        order) and both sweep totals."""
        kernel = wrappers[name](*args, cluster_size=cluster_size, plan=plan)
        plain, plain_sweeps = plains[name](*args)
        torch.cuda.synchronize()
        assert kernel.shape == plain.shape, (name, what)
        abs_err = float((kernel - plain).abs().max())
        rel_err = abs_err / float(plain.abs().max())
        errors[name] = max(errors[name], abs_err)
        sweeps = (
            int(wrappers[name].sweeps.sum()),
            int(plain_sweeps.sum()),
        )
        if not abs_err == 0.0:
            raise AssertionError(
                f"{name} disagrees with its plain version ({what}): "
                f"{rel_err:.3e}"
            )
        return rel_err, sweeps

    # -- phase 25: the kernel against its plain version --------------------
    small = ns._NavierStokesConfig(
        navier_stokes_problem(prml, example=False), NS_D_T
    )
    assert small.plan.cluster_size == 1
    rng = np.random.default_rng(0)
    y = torch.as_tensor(
        rng.uniform(-0.5, 0.5, (17, 17, 4)), dtype=torch.float32,
        device=device,
    )
    ys = torch.as_tensor(
        rng.uniform(-0.5, 0.5, (4, 17, 17, 4)), dtype=torch.float32,
        device=device,
    )
    for name, args in (
        ("fused_navier_stokes_rk4_trajectory", (y, small, NS_SMALL_STEPS)),
        ("fused_navier_stokes_rk4_end", (ys, small, NS_SMALL_STEPS)),
        ("fused_navier_stokes_rk4_step", (ys, small)),
    ):
        rel, sweeps = check(name, "17 x 17", args, 1)
        log(
            f"kernels: navier-stokes 17 x 17 (Re 500), one block: {name} "
            f"max|d|/max|y| = {rel:.3e}; Jacobi sweeps kernel {sweeps[0]}, "
            f"plain {sweeps[1]}"
        )
        assert sweeps[0] == sweeps[1], (name, sweeps)

    ivp = navier_stokes_problem(prml)
    cp = ivp.constrained_problem
    cfg = ns._NavierStokesConfig(cp, NS_D_T)
    assert (cfg.height, cfg.width) == (101, 81)
    y_0 = torch.as_tensor(
        ivp.initial_condition.discrete_y_0(True), dtype=torch.float32,
        device=device,
    )
    prefix, prefix_sweeps = ns.fused_navier_stokes_rk4_trajectory_reference(
        y_0, cfg, NS_PREFIX_STEPS
    )
    # the end's batch: four states of the prefix, each its own solve
    stride = NS_PREFIX_STEPS // 5
    batch = prefix[stride - 1::stride][:4].contiguous()
    sizes = [
        size
        for size in ns.CLUSTER_SIZES
        if ns.cluster_plan_2d(101, 81, size, 1).fits
    ]
    assert sizes == [2, 4, 8], sizes
    plans = list(
        dict.fromkeys(
            [cfg.plan, cfg.plan._replace(group=1)]
            + [ns.cluster_plan_2d(101, 81, size) for size in sizes]
        )
    )
    for plan in plans:
        kernel = wrappers["fused_navier_stokes_rk4_trajectory"](
            y_0, cfg, NS_PREFIX_STEPS, plan=plan
        )
        torch.cuda.synchronize()
        abs_err = float((kernel - prefix).abs().max())
        rel = abs_err / float(prefix.abs().max())
        kernel_sweeps = int(ns.fused_navier_stokes_rk4_trajectory.sweeps)
        errors["fused_navier_stokes_rk4_trajectory"] = max(
            errors["fused_navier_stokes_rk4_trajectory"], abs_err
        )
        rel_end, end_sweeps = check(
            "fused_navier_stokes_rk4_end", "101 x 81, B=4",
            (batch, cfg, NS_PREFIX_STEPS), plan=plan,
        )
        rel_step, step_sweeps = check(
            "fused_navier_stokes_rk4_step", "101 x 81, B=4", (batch, cfg),
            plan=plan,
        )
        log(
            f"kernels: navier-stokes 101 x 81 (the example), a cluster of "
            f"{plan.cluster_size} blocks ({plan.slab} rows and "
            f"{plan.block_threads} threads of {plan.block_cells} cells a "
            f"block), groups of {plan.group} sweeps: trajectory over "
            f"{NS_PREFIX_STEPS} steps "
            f"from rest max|d|/max|y| = {rel:.3e}, Jacobi sweeps kernel "
            f"{kernel_sweeps}, plain {int(prefix_sweeps)}; B=4 end over "
            f"{NS_PREFIX_STEPS} steps {rel_end:.3e}, sweeps {end_sweeps[0]} "
            f"and {end_sweeps[1]}; B=4 step {rel_step:.3e}, sweeps "
            f"{step_sweeps[0]} and {step_sweeps[1]}"
        )
        assert abs_err == 0.0, (plan, abs_err)
        assert kernel_sweeps == int(prefix_sweeps), plan
        assert end_sweeps[0] == end_sweeps[1], (plan, end_sweeps)
        assert step_sweeps[0] == step_sweeps[1], (plan, step_sweeps)
    sweep_totals["prefix"] = (kernel_sweeps, int(prefix_sweeps))
    del prefix, kernel
    log(f"phase navier-stokes kernels: ok "
        f"({time.perf_counter() - started:.1f} s)")

    # -- phase 26: the path at full width, counted -------------------------
    def fdm(d_t, **kwargs):
        # no device argument: the entry points run on the card
        return FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), d_t, **kwargs
        )

    parareal_ivp = prml.InitialValueProblem(
        cp, (0.0, NS_PARAREAL_T_END), ivp.initial_condition
    )
    parareal = PararealOperator(
        fdm(NS_D_T),
        fdm(NS_PARAREAL_COARSE_D_T),
        NS_PARAREAL_TOLERANCE,
        num_time_slices=NS_PARAREAL_SLICES,
    )
    generic_builds = []
    build_step = FDMOperator._build_step_function

    def counting_build(self, cp, allow_fused=True, dtype=None):
        if not allow_fused:
            generic_builds.append(cp)
        return build_step(self, cp, allow_fused, dtype)

    # the batch of each end kernel launch, seen where the wrappers launch
    end_batches = []
    run = ns._run

    def recording_run(wrapper, y, *args):
        if wrapper is wrappers["fused_navier_stokes_rk4_end"]:
            end_batches.append(int(y.shape[0]) if y.ndim == 4 else 1)
        return run(wrapper, y, *args)

    for wrapper in wrappers.values():
        wrapper.launches = 0
    FDMOperator._build_step_function = counting_build
    ns._run = recording_run
    try:
        solution = fdm(NS_D_T).solve(ivp).discrete_y()
        solve_launches = {
            name: w.launches for name, w in wrappers.items()
        }
        solve_sweeps = int(wrappers[NS_KERNELS[0][0]].sweeps)
        solve_builds = len(generic_builds)
        parareal_ys = parareal.solve(parareal_ivp).discrete_y()
    finally:
        FDMOperator._build_step_function = build_step
        ns._run = run
    launches = {name: w.launches for name, w in wrappers.items()}
    log(
        f"navier-stokes main-path launches: {launches} (the solve alone: "
        f"{solve_launches}; the end kernel's batches {end_batches}; the "
        f"solve built the generic step {solve_builds} times, Parareal "
        f"{len(generic_builds) - solve_builds}); the solve's Jacobi sweeps "
        f"{solve_sweeps}"
    )
    assert solve_builds == 0, "the example took the generic path"
    assert solve_launches == dict(
        {name: 0 for name in wrappers}, fused_navier_stokes_rk4_trajectory=1
    ), solve_launches
    assert launches["fused_navier_stokes_rk4_end"] >= 1
    assert NS_PARAREAL_SLICES in end_batches, end_batches
    steps = round(NS_T_END / NS_D_T)
    assert solution.shape == (steps, 101, 81, 4), solution.shape
    assert np.isfinite(solution).all()
    frames = torch.as_tensor(solution[:NS_HEAD_STEPS], device=device)
    generic_fn, _ = fdm(NS_D_T, fused_kernels=False).trajectory_function(
        cp, (0.0, NS_HEAD_STEPS * NS_D_T)
    )
    assert not generic_fn.fused
    generic = generic_fn(y_0, 0.0).double()
    head_rel = float((frames - generic).abs().max()) / float(
        generic.abs().max()
    )
    log(
        f"phase navier-stokes path: the example through FDMOperator.solve "
        f"({steps} steps, one kernel launch, {solve_sweeps} Jacobi sweeps): "
        f"first {NS_HEAD_STEPS} frames against the generic path (float32, "
        f"on the card) max|d|/max|y| = {head_rel:.3e} (limit "
        f"{NS_HEAD_TOL:g}; max|y| {float(generic.abs().max()):.4f})"
    )
    assert head_rel <= NS_HEAD_TOL, head_rel
    del frames, generic
    # the last frame against the generic path over the whole horizon
    # (recorded, not held: float32 rounding in two orders and the Jacobi
    # stopping points they move, over 2,000 steps)
    last_started = time.perf_counter()
    generic_end = fdm(NS_D_T, fused_kernels=False).ends_function(
        cp, ivp.t_interval
    )
    last_generic = generic_end(y_0, 0.0).double()
    torch.cuda.synchronize()
    last = torch.as_tensor(solution[-1], device=device)
    last_rel = float((last - last_generic).abs().max()) / float(
        last_generic.abs().max()
    )
    log(
        f"phase navier-stokes path: frame {steps} against the generic path "
        f"run over the whole horizon (float32, eager, "
        f"{time.perf_counter() - last_started:.1f} s): max|d|/max|y| = "
        f"{last_rel:.3e} (recorded, not held; max|y| "
        f"{float(last_generic.abs().max()):.4f})"
    )
    fine_steps = round(NS_PARAREAL_T_END / NS_D_T)
    parareal_diff = float(np.abs(parareal_ys - solution[:fine_steps]).max())
    log(
        f"phase navier-stokes parareal: {NS_PARAREAL_SLICES} slices over "
        f"T = {NS_PARAREAL_T_END} (fine d_t {NS_D_T}, coarse "
        f"{NS_PARAREAL_COARSE_D_T}), {parareal.last_iterations} "
        f"iterations, max diff vs the fine solve {parareal_diff:.3e} "
        f"(tolerance {NS_PARAREAL_TOLERANCE:g})"
    )
    assert parareal_ys.shape == (fine_steps, 101, 81, 4)
    assert np.isfinite(parareal_ys).all()
    log(f"phase navier-stokes path: ok "
        f"({time.perf_counter() - started:.1f} s)")

    # -- phase 27: times ---------------------------------------------------
    solve_fn, _ = fdm(NS_D_T).trajectory_function(cp, ivp.t_interval)
    parareal_fn, _ = parareal.trajectory_function(
        cp, parareal_ivp.t_interval
    )
    runs = {
        "navier-stokes solve": lambda: solve_fn(y_0),
        "navier-stokes parareal": lambda: parareal_fn(y_0),
    }
    run_ms = {
        label: cuda_ms(torch, run, reps=3) for label, run in runs.items()
    }
    cells = cfg.height * cfg.width
    solve_bound = navier_stokes_bound(cells, 1, steps, solve_sweeps, True)
    mid = torch.as_tensor(
        solution[NS_HEAD_STEPS - 1], dtype=torch.float32, device=device
    )
    generic_steps_fn, _ = fdm(
        NS_D_T, fused_kernels=False
    ).trajectory_function(cp, (0.0, NS_GENERIC_TIMED_STEPS * NS_D_T))
    generic_ms = cuda_ms(torch, lambda: generic_steps_fn(mid, 0.0), reps=3)
    scaled_ms = generic_ms * steps / NS_GENERIC_TIMED_STEPS
    solve_ms = run_ms["navier-stokes solve"]
    log(
        f"time: navier-stokes 101 x 81 x 4 solve, one cluster ({cfg.plan}), "
        f"{steps} steps: {solve_ms:.3f} ms "
        f"({1e3 * solve_ms / steps:.3f} us a step, "
        f"{1e3 * solve_ms / (solve_sweeps + 4 * steps):.3f} us a sweep or "
        f"stage), bound {solve_bound[0] * 1e3:.3f} us ({solve_bound[1]}, "
        f"from {solve_sweeps} counted sweeps); generic path "
        f"{NS_GENERIC_TIMED_STEPS} steps from frame {NS_HEAD_STEPS} "
        f"{generic_ms:.3f} ms, scaled to {steps} steps {scaled_ms:.3f} ms "
        f"(scaled, not run): {scaled_ms / solve_ms:.3f}x [{card}]"
    )
    log(
        f"time: navier-stokes parareal, {NS_PARAREAL_SLICES} slices over T "
        f"= {NS_PARAREAL_T_END}: {run_ms['navier-stokes parareal']:.3f} ms, "
        f"{parareal.last_iterations} iterations [{card}]"
    )
    # each kernel function at its path's shapes beside its plain version
    # (one run) and its bound from this run's counted sweeps
    slice_steps = fine_steps // NS_PARAREAL_SLICES
    slice_starts = torch.as_tensor(
        np.concatenate(
            [
                ivp.initial_condition.discrete_y_0(True)[None],
                solution[slice_steps - 1: fine_steps - 1: slice_steps],
            ]
        ),
        dtype=torch.float32,
        device=device,
    ).contiguous()
    timings = [
        ("fused_navier_stokes_rk4_trajectory",
         f"101 x 81 x 4, {NS_TIMED_STEPS} steps from frame {NS_HEAD_STEPS}",
         (mid, cfg, NS_TIMED_STEPS), True, True),
        ("fused_navier_stokes_rk4_end",
         f"B={NS_PARAREAL_SLICES} x 101 x 81 x 4, {slice_steps} steps "
         "(one iteration's fine ends)",
         (slice_starts, cfg, slice_steps), False, True),
        ("fused_navier_stokes_rk4_step",
         f"101 x 81 x 4, 1 step from frame {NS_HEAD_STEPS}",
         (mid, cfg), True, False),
    ]
    entries = []
    for (name, what, args, trajectory, on_path), (_, replaces) in zip(
        timings, NS_KERNELS
    ):
        kernel_ms = cuda_ms(torch, lambda: wrappers[name](*args), reps=3)
        kernel_sweeps = int(wrappers[name].sweeps.sum())
        outputs = []
        plain_ms = once_ms(torch, lambda: outputs.append(plains[name](*args)))
        plain, plain_sweeps = outputs[0]
        kernel = wrappers[name](*args)
        torch.cuda.synchronize()
        abs_err = float((kernel - plain).abs().max())
        rel_err = abs_err / float(plain.abs().max())
        errors[name] = max(errors[name], abs_err)
        assert abs_err == 0.0, (name, rel_err)
        del outputs, plain, kernel
        state_batch = args[0].shape[0] if args[0].ndim == 4 else 1
        n_steps = args[2] if len(args) > 2 else 1
        bound_ms, bound_by = navier_stokes_bound(
            cells, state_batch, n_steps, kernel_sweeps, trajectory
        )
        log(
            f"time: {name} ({what}): kernel {kernel_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms (one run), bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}, from {kernel_sweeps} counted sweeps; the plain "
            f"version counted {int(plain_sweeps.sum())}); against the plain "
            f"version there max|d|/max|y| = {rel_err:.3e} [{card}]"
        )
        entries.append(
            {
                "name": name,
                "route": "cuda",
                "source": NS_SOURCE,
                "replaces": replaces,
                "on_path": on_path,
                "launches": launches[name] if on_path else 0,
                "max_abs_err": errors[name],
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_us": bound_ms * 1e3,
                "bound_by": bound_by,
                "library_ms": None,
                "sweeps": kernel_sweeps,
                "plain_sweeps": int(plain_sweeps.sum()),
                "timed": what,
                "plan": str(ns._plan(cfg, state_batch, None, None)),
            }
        )
    # the measured plans against the same plans with groups of one sweep
    # (one norm a sweep), in turns: the solve, one iteration's fine ends,
    # the Parareal
    ends = wrappers["fused_navier_stokes_rk4_end"]
    in_turns = {
        "solve": lambda: solve_fn(y_0),
        f"B={NS_PARAREAL_SLICES} fine ends": lambda: ends(
            slice_starts, cfg, slice_steps
        ),
        "parareal": lambda: parareal_fn(y_0),
    }
    turns = {label: {"measured": [], "groups of 1": []} for label in in_turns}
    for order in (("measured", "groups of 1"), ("groups of 1", "measured")):
        for plans_of in order:
            with navier_stokes_groups_of_one(ns, plans_of == "groups of 1"):
                for label, run in in_turns.items():
                    turns[label][plans_of].append(
                        cuda_ms(torch, run, reps=3)
                    )
    for label, times in turns.items():
        measured = statistics.mean(times["measured"])
        of_one = statistics.mean(times["groups of 1"])
        log(
            f"time: navier-stokes {label} in turns: the measured plans "
            f"{measured:.3f} ms ({times['measured']}), groups of one sweep "
            f"{of_one:.3f} ms ({times['groups of 1']}): "
            f"{of_one / measured:.3f}x [{card}]"
        )
        for entry in entries:
            if label == "solve" and entry["name"] == NS_KERNELS[0][0] or (
                label.endswith("fine ends")
                and entry["name"] == NS_KERNELS[1][0]
            ):
                entry["in_turns"] = {
                    "timed": label,
                    "measured_ms": measured,
                    "groups_of_one_ms": of_one,
                }
    # a Jacobi sweep and a stage split into their segments
    split = load_tool("ns_sweep_split").run(device, card, log)
    log(
        "ns sweep split: "
        + json.dumps(
            [
                dict(
                    plan=result["plan"],
                    step_us=result["step_us"],
                    sweep_us=result["sweep_us"],
                    stage_us=result["stage_us"],
                    counts=result["counts"],
                    segments_us={
                        row["segment"]: row["us"]
                        for row in result["segments"]
                    },
                )
                for result in split
            ]
        )
    )
    torch.cuda.empty_cache()
    log(f"phase navier-stokes times: ok "
        f"({time.perf_counter() - started:.1f} s)")

    # -- phase 28: device busy time and idle share (torch.profiler) --------
    for label, run in runs.items():
        busy_ms, top = device_busy_ms(torch, run, reps=1)
        if busy_ms is None:
            log(f"profile: {label}: not measured (no device events)")
            continue
        log(
            f"profile: {label}: device busy {busy_ms:.3f} ms of "
            f"{run_ms[label]:.3f} ms, idle share "
            f"{1.0 - busy_ms / run_ms[label]:.3f}; top: {top} [{card}]"
        )
    return entries


def interior_square(prml, cp, value):
    """Adds a Dirichlet square of ``value`` over the middle ninth of a
    one-component problem's grid to its static y constraints (the face
    ones stay): constraints inside the grid, which K7 applies after every
    stage and the tiled kernel K6 refuses."""
    from pararealml_tpu_torch.constraint import Constraint

    height, width = cp.mesh.vertices_shape
    old = cp.static_y_vertex_constraints
    mask = np.asarray(old.mask).reshape(height, width).copy()
    values = np.where(mask, np.asarray(old.values).reshape(height, width), 0.0)
    rows = slice(height // 3, 2 * height // 3)
    cols = slice(width // 3, 2 * width // 3)
    mask[rows, cols] = True
    values[rows, cols] = value
    cp._y_vertex_constraints = Constraint(
        values.reshape(np.asarray(old.values).shape),
        mask.reshape(np.asarray(old.mask).shape),
    )
    return cp


def end_bound(family, cells, n, batch, n_steps, flops_per_cell_step=None):
    """The bound of an end-mode run: each state and its constraint data
    (a float value and a byte mask a value) read once and the end state
    written once, against the family's operations per cell and step."""
    values = cells * n
    read = 4 * batch * values + 5 * values
    written = 4 * batch * values
    if flops_per_cell_step is None:
        flops_per_cell_step = FLOPS_PER_CELL_STEP[family]
    return bound(read + written, flops_per_cell_step * batch * n_steps * cells)


def load_tool(name):
    """The module ``tools/<name>.py`` of this checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name,
        os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py"
        ),
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def end_mode_phases(
    torch, prml, device, card, cuda_ms, once_ms, device_busy_ms
):
    """Phases 29-32: the end states past one CTA (K8's and K7's end
    modes, K7 with Dirichlet constraints inside the grid) and the K5 step
    split. Returns their entries of the JSON line. ``cuda_ms``,
    ``once_ms`` and ``device_busy_ms`` are the timing and profiling
    functions."""
    from pararealml_tpu_torch.operators.fdm import (
        RK4,
        FDMOperator,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu_torch.operators.parareal import PararealOperator
    from pararealml_tpu_torch.ops import resident_diffusion as rd
    from pararealml_tpu_torch.ops import tiled_diffusion as td
    from pararealml_tpu_torch.ops import tiled_system as ts

    from pararealml_tpu_torch.ops import fused_system as fs

    started = time.perf_counter()
    k8_end, k7_end = ts.tiled_system_rk4_end, rd.resident_diffusion_rk4_end
    counted = {
        "tiled_system_rk4_end": k8_end,
        "tiled_system_rk4_trajectory": ts.tiled_system_rk4_trajectory,
        "cluster_system_rk4_end": fs.cluster_system_rk4_end,
        CLUSTER_KERNEL: fs.cluster_system_rk4_trajectory,
        "resident_diffusion_rk4_end": k7_end,
        "resident_diffusion_rk4_trajectory": (
            rd.resident_diffusion_rk4_trajectory
        ),
    }
    errors = {}

    def check(key, what, kernel, plain, tolerance=KERNEL_REL_TOL):
        torch.cuda.synchronize()
        assert kernel.shape == plain.shape, (key, what)
        assert kernel.dtype == plain.dtype, (key, what)
        abs_err = float((kernel.float() - plain.float()).abs().max())
        rel_err = abs_err / float(plain.float().abs().max())
        errors[key] = max(errors.get(key, 0.0), abs_err)
        log(f"kernels: {key} ({what}): max|d|/max|y| = {rel_err:.3e}")
        if not rel_err <= tolerance:
            raise AssertionError(
                f"{key} disagrees with its plain version ({what}): "
                f"{rel_err:.3e}"
            )
        return rel_err

    def fdm(d_t, **kwargs):
        return FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), d_t, **kwargs
        )

    # -- phase 29: the end modes against their plain versions ------------
    for family in ("wave", "burgers", "shallow-water", "cahn-hilliard"):
        cp = system_problem_2d(prml, family, "dirichlet", END_K8_SHAPE)
        cfg = ts._TiledSystemConfig(cp, 1e-3)
        ys = smooth_states_2d(torch, device, END_K8_SHAPE, cfg.n, batch=3)
        plain = ts.tiled_system_rk4_end_reference(ys, cfg, END_SMALL_STEPS)
        batched = k8_end(ys, cfg, END_SMALL_STEPS)
        check("tiled_system_rk4_end", f"{family} 101^2, B=3", batched, plain)
        check(
            "tiled_system_rk4_end",
            f"{family} 101^2, single",
            k8_end(ys[1], cfg, END_SMALL_STEPS),
            plain[1],
        )
        # the end mode is the trajectory without its frames
        frames = ts.tiled_system_rk4_trajectory(ys, cfg, END_SMALL_STEPS)
        assert torch.equal(batched, frames[:, -1]), family
    polar_ivp, polar_d_t = wave_polar_example(prml)
    polar_cp = polar_ivp.constrained_problem
    polar_cfg = ts._TiledSystemConfig(polar_cp, polar_d_t)
    polar_shape = polar_cp.mesh.vertices_shape
    ys = smooth_states_2d(torch, device, polar_shape, 2, batch=2)
    plain = ts.tiled_system_rk4_end_reference(ys, polar_cfg, END_SMALL_STEPS)
    check(
        "tiled_system_rk4_end:polar",
        "polar wave 51 x 201, B=2",
        k8_end(ys, polar_cfg, END_SMALL_STEPS),
        plain,
    )
    check(
        "tiled_system_rk4_end:polar",
        "polar wave 51 x 201, single",
        k8_end(ys[0], polar_cfg, END_SMALL_STEPS),
        plain[0],
    )
    try:
        k8_end(ys, polar_cfg, 2, plan=polar_cfg.plan._replace(halo=0))
    except ValueError:
        pass
    else:
        raise AssertionError("K8's end mode took a plan without a halo")

    diffusion_ivp = bench_diffusion(
        prml, END_K7_N, END_K7_STEPS, END_K7_D_T
    )
    interior_cp = interior_square(
        prml, diffusion_ivp.constrained_problem, END_K7_SQUARE
    )
    faces_cp = bench_diffusion(
        prml, END_K7_N, END_K7_STEPS, END_K7_D_T
    ).constrained_problem
    y_k7 = torch.as_tensor(
        diffusion_ivp.initial_condition.discrete_y_0(True)[..., 0],
        dtype=torch.float32,
        device=device,
    ).contiguous()
    ys_k7 = torch.stack([y_k7, 0.5 * y_k7 + 0.75]).contiguous()
    for label, cp in (("faces", faces_cp), ("interior square", interior_cp)):
        cfg = td._HornerConfig(cp, END_K7_D_T, resident=True)
        assert cfg.interior_dirichlet == (cp is interior_cp)
        plain = rd.resident_diffusion_rk4_end_reference(
            ys_k7, cfg, END_SMALL_STEPS
        )
        end = k7_end(ys_k7, cfg, END_SMALL_STEPS)
        check("resident_diffusion_rk4_end", f"201^2 {label}, B=2", end, plain)
        frames = rd.resident_diffusion_rk4_trajectory(
            y_k7, cfg, END_SMALL_STEPS
        )
        assert torch.equal(end[0], frames[-1]), label
        check(
            "resident_diffusion_rk4_trajectory:interior",
            f"201^2 {label}",
            frames,
            rd.resident_diffusion_rk4_trajectory_reference(
                y_k7, cfg, END_SMALL_STEPS
            ),
        )
    log(f"phase end-mode kernels: ok ({time.perf_counter() - started:.1f} s)")

    # -- phase 30: the main paths, counted --------------------------------
    wave_ivp, wave_d_t = wave_example(prml)
    wave_cp = wave_ivp.constrained_problem
    wave_parareal_ivp = prml.InitialValueProblem(
        wave_cp, (0.0, WAVE_PARAREAL_T_END), wave_ivp.initial_condition
    )
    parareal = PararealOperator(
        fdm(wave_d_t),
        fdm(WAVE_PARAREAL_COARSE_D_T),
        WAVE_PARAREAL_TOLERANCE,
        num_time_slices=WAVE_PARAREAL_SLICES,
    )
    diffusion = fdm(END_K7_D_T)
    k7_interval = (0.0, END_K7_STEPS * END_K7_D_T)
    # an initial condition made on the problem with the square applies it
    k7_ivp = prml.InitialValueProblem(
        interior_cp,
        k7_interval,
        prml.DiscreteInitialCondition(
            interior_cp,
            diffusion_ivp.initial_condition.discrete_y_0(True),
            True,
        ),
    )
    # 641^2 Burgers, past the JAX package's VMEM cap: K8's end mode
    burgers_ivp = burgers_641(prml)
    burgers_cp = burgers_ivp.constrained_problem
    burgers_interval = (0.0, END_K8_641_STEPS * BURGERS_641_D_T)
    burgers_ends = fdm(BURGERS_641_D_T).ends_function(
        burgers_cp, burgers_interval
    )
    burgers_y0 = torch.as_tensor(
        burgers_ivp.initial_condition.discrete_y_0(True),
        dtype=torch.float32,
        device=device,
    )
    for wrapper in counted.values():
        wrapper.launches = 0
    parareal_ys = parareal.solve(wave_parareal_ivp).discrete_y()
    iterations = parareal.last_iterations
    burgers_end = burgers_ends(burgers_y0, 0.0)
    k7_ends = diffusion.ends_function(interior_cp, k7_interval)
    k7_y0 = torch.as_tensor(
        k7_ivp.initial_condition.discrete_y_0(True),
        dtype=torch.float32,
        device=device,
    )
    k7_end_state = k7_ends(k7_y0, 0.0)
    k7_solution = diffusion.solve(k7_ivp).discrete_y()
    launches = {name: w.launches for name, w in counted.items()}
    log(
        f"end-mode main-path launches: {launches}; wave parareal "
        f"{iterations} iterations [{card}]"
    )
    assert k7_ends.fused and k7_ends.vmappable is False
    # the wave example's 101^2 on the cluster-resident mode: every
    # iteration's fine ends (B = 8), at least one coarse end and the
    # expansion; K8's end mode on 641^2 Burgers alone
    assert launches["cluster_system_rk4_end"] > iterations
    assert launches[CLUSTER_KERNEL] >= 1
    assert launches["tiled_system_rk4_end"] == 1
    assert launches["tiled_system_rk4_trajectory"] == 0
    assert bool(torch.isfinite(burgers_end).all())
    assert launches["resident_diffusion_rk4_end"] == 1
    assert launches["resident_diffusion_rk4_trajectory"] == 1
    wave_fine = fdm(wave_d_t).solve(wave_parareal_ivp).discrete_y()
    assert parareal_ys.shape == wave_fine.shape
    assert np.isfinite(parareal_ys).all()
    parareal_diff = float(np.abs(parareal_ys - wave_fine).max())
    log(
        f"phase end-mode parareal: wave 101^2, {WAVE_PARAREAL_SLICES} "
        f"slices over T = {WAVE_PARAREAL_T_END:g}, {iterations} iterations, "
        f"max diff vs fine {parareal_diff:.3e} (gate "
        f"{2 * WAVE_PARAREAL_TOLERANCE:g})"
    )
    assert parareal_diff <= 2 * WAVE_PARAREAL_TOLERANCE
    # the K7 end: the trajectory's last frame, the square held; the
    # trajectory's first frames against the generic path
    k7_end_np = k7_end_state.double().cpu().numpy()
    assert np.array_equal(k7_end_np, k7_solution[-1])
    middle = slice(END_K7_N // 3, 2 * END_K7_N // 3)
    square = k7_end_np[middle, middle]
    assert np.all(square == END_K7_SQUARE)
    generic_fn, _ = fdm(END_K7_D_T, fused_kernels=False).trajectory_function(
        interior_cp, (0.0, SYSTEM_HEAD_STEPS * END_K7_D_T)
    )
    generic = generic_fn(k7_y0, 0.0).double().cpu().numpy()
    assert np.allclose(
        k7_solution[:SYSTEM_HEAD_STEPS], generic, atol=1e-4, rtol=1e-4
    )
    log(
        f"phase end-mode diffusion: 201^2 with a Dirichlet square inside, "
        f"{END_K7_STEPS} steps: K7 end equals K7's last frame, square "
        f"held at {END_K7_SQUARE:g}, first {SYSTEM_HEAD_STEPS} frames within "
        f"atol = rtol = 1e-4 of the generic path "
        f"({time.perf_counter() - started:.1f} s)"
    )
    del parareal_ys, wave_fine, k7_solution

    # -- phase 31: times ---------------------------------------------------
    runs, run_ms = {}, {}
    slice_steps = round(WAVE_PARAREAL_T_END / WAVE_PARAREAL_SLICES / wave_d_t)
    program, _ = parareal.trajectory_function(
        wave_cp, (0.0, WAVE_PARAREAL_T_END)
    )
    wave_y0 = torch.as_tensor(
        wave_ivp.initial_condition.discrete_y_0(True),
        dtype=torch.float32,
        device=device,
    )
    fine_fn, _ = fdm(wave_d_t).trajectory_function(
        wave_cp, (0.0, WAVE_PARAREAL_T_END)
    )
    runs["wave 101^2 parareal"] = lambda: program(wave_y0)
    runs["wave 101^2 fine"] = lambda: fine_fn(wave_y0, 0.0)
    for label in runs:
        run_ms[label] = cuda_ms(torch, runs[label], reps=3)
    log(
        f"time: wave 101^2 parareal, {WAVE_PARAREAL_SLICES} slices: "
        f"{run_ms['wave 101^2 parareal']:.3f} ms, {parareal.last_iterations} "
        f"iterations; its fine solve (K8 trajectory, "
        f"{slice_steps * WAVE_PARAREAL_SLICES} steps) "
        f"{run_ms['wave 101^2 fine']:.3f} ms [{card}]"
    )
    # one iteration's fine ends: the mode's batched end against the
    # generic carry-only loop, on the same borders
    borders = torch.stack(
        [wave_y0 * (1.0 - 0.05 * i) for i in range(WAVE_PARAREAL_SLICES)]
    ).contiguous()
    fine_ends = fdm(wave_d_t).ends_function(
        wave_cp, (0.0, slice_steps * wave_d_t), batch=WAVE_PARAREAL_SLICES
    )
    generic_ends = fdm(wave_d_t, fused_kernels=False).ends_function(
        wave_cp, (0.0, slice_steps * wave_d_t)
    )
    assert fine_ends.fused and not generic_ends.fused
    fused_ms = cuda_ms(torch, lambda: fine_ends(borders, 0.0))
    generic_out = []
    generic_ms = once_ms(
        torch, lambda: generic_out.append(generic_ends(borders, 0.0))
    )
    ends_diff = float(
        (fine_ends(borders, 0.0) - generic_out[0]).abs().max()
        / generic_out[0].abs().max()
    )
    del generic_out
    log(
        f"time: wave 101^2 parareal fine ends (B={WAVE_PARAREAL_SLICES}, "
        f"{slice_steps} steps: one iteration): the mode's batched end "
        f"{fused_ms:.3f} ms, generic carry-only loop {generic_ms:.3f} ms "
        f"(one run), {generic_ms / fused_ms:.1f}x; max|d|/max|y| "
        f"{ends_diff:.3e} [{card}]"
    )
    assert ends_diff <= 1e-4
    k7_generic_ends = fdm(END_K7_D_T, fused_kernels=False).ends_function(
        interior_cp, k7_interval
    )
    k7_ends_ms = cuda_ms(torch, lambda: k7_ends(k7_y0, 0.0))
    generic_out = []
    k7_generic_ms = once_ms(
        torch, lambda: generic_out.append(k7_generic_ends(k7_y0, 0.0))
    )
    k7_diff = float(
        (k7_ends(k7_y0, 0.0) - generic_out[0]).abs().max()
        / generic_out[0].abs().max()
    )
    del generic_out
    log(
        f"time: diffusion 201^2 with a Dirichlet square, ends_function over "
        f"{END_K7_STEPS} steps: K7 end {k7_ends_ms:.3f} ms, generic "
        f"carry-only loop {k7_generic_ms:.3f} ms (one run), "
        f"{k7_generic_ms / k7_ends_ms:.1f}x; max|d|/max|y| {k7_diff:.3e} "
        f"[{card}]"
    )
    assert k7_diff <= 1e-4

    interior_cfg = td._HornerConfig(interior_cp, END_K7_D_T, resident=True)
    cells_k7 = END_K7_N * END_K7_N
    burgers_cfg = ts._TiledSystemConfig(burgers_cp, BURGERS_641_D_T)
    timings = (
        ("tiled_system_rk4_end", "tiled_system_rk4_end",
         f"641^2 x 2 Burgers, {END_K8_641_STEPS} steps",
         (burgers_y0, burgers_cfg, END_K8_641_STEPS),
         ts.tiled_system_rk4_end_reference,
         end_bound("burgers", burgers_cfg.height * burgers_cfg.width, 2, 1,
                   END_K8_641_STEPS),
         ts.tiled_system_rk4_end),
        ("tiled_system_rk4_end:polar", "tiled_system_rk4_end",
         f"51 x 201 x 2 polar wave, {POLAR_TIMED_STEPS} steps",
         (ys[0], polar_cfg, POLAR_TIMED_STEPS),
         ts.tiled_system_rk4_end_reference,
         end_bound("polar-wave", polar_shape[0] * polar_shape[1], 2, 1,
                   POLAR_TIMED_STEPS),
         ts.tiled_system_rk4_end),
        ("resident_diffusion_rk4_end", "resident_diffusion_rk4_end",
         f"201^2 with a Dirichlet square, {END_K7_STEPS} steps",
         (y_k7, interior_cfg, END_K7_STEPS),
         rd.resident_diffusion_rk4_end_reference,
         end_bound("diffusion", cells_k7, 1, 1, END_K7_STEPS,
                   interior_cfg.flops_per_cell_step),
         rd.resident_diffusion_rk4_end),
    )
    entries = []
    for key, name, what, args, plain, (bound_ms, bound_by), wrapper in (
        timings
    ):
        kernel_ms = cuda_ms(torch, lambda: wrapper(*args))
        outputs = []
        plain_ms = once_ms(torch, lambda: outputs.append(plain(*args)))
        rel_err = check(key, f"{what}, timed", wrapper(*args), outputs[0])
        del outputs
        log(
            f"time: {key} ({what}): kernel {kernel_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms (one run), bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}); against the plain version there max|d|/max|y| "
            f"= {rel_err:.3e} [{card}]"
        )
        entries.append(
            {
                "name": key,
                "route": "cuda",
                "source": (
                    TILED_SYSTEM_SOURCE if name.startswith("tiled")
                    else LARGE_SOURCE
                ),
                "replaces": END_REPLACES[key],
                "on_path": key != "tiled_system_rk4_end:polar",
                "launches": (
                    launches[name] if key != "tiled_system_rk4_end:polar"
                    else 0
                ),
                "max_abs_err": errors.get(key, 0.0),
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_us": bound_ms * 1e3,
                "bound_by": bound_by,
                "library_ms": None,
                "timed": what,
            }
        )
    log(f"phase end-mode times: ok ({time.perf_counter() - started:.1f} s)")

    # -- phase 32: the K5 step split and the profiles ---------------------
    for result in load_tool("k5_step_split").run(device, card, log):
        barrier = sum(
            row["cycles"] for row in result["segments"]
            if row["segment"].startswith("barrier")
        )
        stages = sum(
            row["cycles"] for row in result["segments"]
            if row["segment"].startswith("stage")
        )
        log(
            f"k5 split: {result['case']}: a step {stages:.0f} cycles in the "
            f"stages and {barrier:.0f} at the barriers (the mean warp) "
            f"[{card}]"
        )
    for label, run in runs.items():
        busy_ms, top = device_busy_ms(torch, run, reps=1)
        if busy_ms is None:
            log(f"profile: {label}: not measured (no device events)")
            continue
        log(
            f"profile: {label}: device busy {busy_ms:.3f} ms of "
            f"{run_ms[label]:.3f} ms, idle share "
            f"{1.0 - busy_ms / run_ms[label]:.3f}; top: {top} [{card}]"
        )
    return entries


def cluster_mode_phases(
    torch, prml, device, card, cuda_ms, once_ms, device_busy_ms
):
    """Phases 33-36: the cluster-resident mode on the 2D examples' grids
    (K8's examples' regime redesigned: one launch a solve, one cluster a
    state) against its plain version, its main paths counted, per-step K8
    and the mode timed in turns, K8's step split and the profiles.
    Returns their entries of the JSON line. ``cuda_ms``, ``once_ms`` and
    ``device_busy_ms`` are the timing and profiling functions."""
    from pararealml_tpu_torch.operators.fdm import (
        RK4,
        FDMOperator,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu_torch.operators.parareal import PararealOperator
    from pararealml_tpu_torch.ops import fused_system as fs
    from pararealml_tpu_torch.ops import packed_system as ps
    from pararealml_tpu_torch.ops import tiled_system as ts

    started = time.perf_counter()
    mode, mode_end = fs.cluster_system_rk4_trajectory, fs.cluster_system_rk4_end
    k5_plain = fs.fused_system_rk4_trajectory_reference
    errors = {}

    def check(key, what, kernel, plain):
        torch.cuda.synchronize()
        assert kernel.shape == plain.shape, (key, what)
        assert kernel.dtype == plain.dtype, (key, what)
        abs_err = float((kernel.float() - plain.float()).abs().max())
        rel_err = abs_err / float(plain.float().abs().max())
        errors[key] = max(errors.get(key, 0.0), abs_err)
        if not rel_err <= KERNEL_REL_TOL:
            raise AssertionError(
                f"{key} disagrees with its plain version ({what}): "
                f"{rel_err:.3e}"
            )
        return rel_err

    def fdm(d_t):
        # no device argument: the entry points run on the card
        return FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), d_t)

    def initial(ivp):
        return torch.as_tensor(
            ivp.initial_condition.discrete_y_0(True),
            dtype=torch.float32,
            device=device,
        )

    # key: (label, family for the operation count, problem, d_t)
    examples = {}
    for key, label, family, (ivp, d_t) in (
        (CLUSTER_KERNEL, "wave 101^2 x 2", "wave", wave_example(prml)),
        (f"{CLUSTER_KERNEL}:shallow-water", "shallow water 101 x 51 x 3",
         "shallow-water", shallow_water_example(prml)),
        (f"{CLUSTER_KERNEL}:cahn-hilliard", "cahn-hilliard 101^2 x 2",
         "cahn-hilliard",
         (cahn_hilliard_2d(torch, prml, 101, CH_2D_T_END), 5e-4)),
        (f"{CLUSTER_KERNEL}:polar", "wave polar 51 x 201 x 2", "polar-wave",
         wave_polar_example(prml)),
    ):
        examples[key] = (label, family, ivp, d_t)

    # -- phase 33: the mode against its plain version ----------------------
    sizes_run = set()
    for key, (label, _, ivp, d_t) in examples.items():
        cp = ivp.constrained_problem
        assert fs.cluster_system_applicable(cp), label
        cfg = fs._SystemKernelConfig(cp, d_t)
        shape = cp.mesh.vertices_shape
        ys = smooth_states_2d(torch, device, shape, cfg.n, batch=2)
        expected = k5_plain(ys, cfg, MODE_SMALL_STEPS)
        plans = [
            plan
            for plan in (
                fs.ClusterPlan(*shape, cfg.n, cfg.polar, size, cells)
                for size in range(2, fs.MAX_CLUSTER_SIZE + 1)
                for cells in fs._CLUSTER_CELLS
            )
            if plan.fits
        ]
        active = fs.card_active_clusters(cfg, True)
        chosen = [fs.cluster_plan(cfg, batch, None, active) for batch in (1, 8)]
        assert all(plan in plans for plan in chosen), (label, chosen)
        for plan in plans:
            check(
                key,
                f"{label}, a cluster of {plan.cluster_size}, {plan.cells} "
                "cells a thread",
                mode(ys, cfg, MODE_SMALL_STEPS, plan=plan),
                expected,
            )
            sizes_run.add(plan.cluster_size)
        check(
            "cluster_system_rk4_end",
            f"{label}, B=2",
            mode_end(ys, cfg, MODE_SMALL_STEPS),
            expected[:, -1],
        )
        frames = mode(ys, cfg, MODE_SMALL_STEPS, frame_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(frames, expected.to(torch.bfloat16)), label
        log(
            f"kernels: the cluster-resident mode, {label}: {len(plans)} plans "
            f"(clusters of {plans[0].cluster_size} to "
            f"{plans[-1].cluster_size}, 1 to 4 cells a thread; the plan "
            f"takes {chosen[0].cluster_size} x {chosen[0].cells} for one "
            f"state and {chosen[1].cluster_size} x {chosen[1].cells} for "
            f"B=8), B=2 trajectory and end, bfloat16 frames, "
            f"{MODE_SMALL_STEPS} steps: max|d| = {errors[key]:.3e} against "
            f"the plain version (K5's)"
        )
    assert 16 in sizes_run
    # a cluster past the card's 16 blocks is refused before any launch
    label, _, ivp, d_t = examples[CLUSTER_KERNEL]
    cfg = fs._SystemKernelConfig(ivp.constrained_problem, d_t)
    ys = smooth_states_2d(torch, device, (101, 101), 2, batch=2)
    out = torch.full((2, 2, 101, 101, 2), float("nan"), device=device)
    launches = mode.launches
    try:
        fs.launch_cluster(
            ys, out, cfg, 2, True, fs.cluster_plan(cfg)._replace(
                cluster_size=17
            )
        )
    except RuntimeError as error:
        log(f"kernels: a cluster of 17 blocks is refused: {error}")
    else:
        raise AssertionError("the mode launched a cluster of 17 blocks")
    torch.cuda.synchronize()
    assert bool(torch.isnan(out).all()) and mode.launches == launches
    del ys, out, expected, frames
    log(f"phase cluster kernels: ok ({time.perf_counter() - started:.1f} s)")

    # -- phase 34: the main paths, counted ---------------------------------
    counted = {
        CLUSTER_KERNEL: mode,
        "cluster_system_rk4_end": mode_end,
        TILED_SYSTEM_KERNEL: ts.tiled_system_rk4_trajectory,
        "tiled_system_rk4_end": ts.tiled_system_rk4_end,
        "fused_system_rk4_trajectory": fs.fused_system_rk4_trajectory,
        "fused_system_rk4_end": fs.fused_system_rk4_end,
        "packed_system_rk4_ends": ps.packed_system_rk4_ends,
    }
    path_launches = {}
    for key, (label, _, ivp, d_t) in examples.items():
        for wrapper in counted.values():
            wrapper.launches = 0
        ys = fdm(d_t).solve(ivp).discrete_y()
        launches = {name: w.launches for name, w in counted.items()}
        path_launches[key] = launches[CLUSTER_KERNEL]
        steps = round(ivp.t_interval[1] / d_t)
        assert ys.shape[0] == steps and np.isfinite(ys).all(), label
        log(f"cluster main-path launches: {label} solve, {steps} steps: "
            f"{launches}")
        assert launches == dict(
            {name: 0 for name in counted}, **{CLUSTER_KERNEL: 1}
        ), (label, launches)
        del ys
    wave_ivp, wave_d_t = wave_example(prml)
    wave_cp = wave_ivp.constrained_problem
    parareal_ivp = prml.InitialValueProblem(
        wave_cp, (0.0, WAVE_PARAREAL_T_END), wave_ivp.initial_condition
    )
    parareal = PararealOperator(
        fdm(wave_d_t),
        fdm(WAVE_PARAREAL_COARSE_D_T),
        WAVE_PARAREAL_TOLERANCE,
        num_time_slices=WAVE_PARAREAL_SLICES,
    )
    for wrapper in counted.values():
        wrapper.launches = 0
    parareal_ys = parareal.solve(parareal_ivp).discrete_y()
    launches = {name: w.launches for name, w in counted.items()}
    iterations = parareal.last_iterations
    path_launches["cluster_system_rk4_end"] = launches["cluster_system_rk4_end"]
    log(
        f"cluster main-path launches: wave 101^2 Parareal, "
        f"{WAVE_PARAREAL_SLICES} slices, {iterations} iterations: {launches}"
    )
    # every iteration's fine ends (B = 8) and the coarse ends on the mode's
    # end, the expansion (and a coarse roll-out) on its trajectory; no K8
    assert launches["cluster_system_rk4_end"] > iterations, launches
    assert launches[CLUSTER_KERNEL] >= 1, launches
    assert all(
        launches[name] == 0
        for name in counted
        if name not in (CLUSTER_KERNEL, "cluster_system_rk4_end")
    ), launches
    wave_fine = fdm(wave_d_t).solve(parareal_ivp).discrete_y()
    parareal_diff = float(np.abs(parareal_ys - wave_fine).max())
    log(
        f"phase cluster parareal: wave 101^2, {iterations} iterations, max "
        f"diff vs fine {parareal_diff:.3e} (gate "
        f"{2 * WAVE_PARAREAL_TOLERANCE:g})"
    )
    assert parareal_diff <= 2 * WAVE_PARAREAL_TOLERANCE
    del parareal_ys, wave_fine

    # the mode against per-step K8 over each example's horizon: the first
    # frames held to float32 rounding in two orders, the last recorded
    for key, (label, _, ivp, d_t) in examples.items():
        cp = ivp.constrained_problem
        y_0 = initial(ivp)
        steps = round(ivp.t_interval[1] / d_t)
        cfg = fs._SystemKernelConfig(cp, d_t)
        tcfg = ts._TiledSystemConfig(cp, d_t)
        frames = mode(y_0, cfg, steps)
        k8_frames = ts.tiled_system_rk4_trajectory(y_0, tcfg, steps)
        head = MODE_HEAD_STEPS
        scale = float(k8_frames[:head].abs().max())
        head_rel = float((frames[:head] - k8_frames[:head]).abs().max()) / scale
        last_rel = float((frames[-1] - k8_frames[-1]).abs().max()) / float(
            k8_frames[-1].abs().max()
        )
        log(
            f"phase cluster path: {label}: the mode against per-step K8, "
            f"first {head} frames max|d|/max|y| = {head_rel:.3e} (limit "
            f"{MODE_K8_TOL:g}); frame {steps} {last_rel:.3e} (recorded)"
        )
        assert head_rel <= MODE_K8_TOL, (label, head_rel)
        assert np.isfinite(last_rel)
        del frames, k8_frames
    torch.cuda.empty_cache()
    log(f"phase cluster path: ok ({time.perf_counter() - started:.1f} s)")

    # -- phase 35: times, per-step K8 and the mode in turns ----------------
    rows = []
    for key, (label, family, ivp, d_t) in examples.items():
        cp = ivp.constrained_problem
        steps = round(ivp.t_interval[1] / d_t)
        y_0 = initial(ivp)
        cfg = fs._SystemKernelConfig(cp, d_t)
        tcfg = ts._TiledSystemConfig(cp, d_t)
        rows.append(
            (key, label, family, 1, steps, True, cfg, y_0,
             lambda y_0=y_0, cfg=cfg, steps=steps: mode(y_0, cfg, steps),
             lambda y_0=y_0, tcfg=tcfg, steps=steps: (
                 ts.tiled_system_rk4_trajectory(y_0, tcfg, steps)
             ))
        )
    slice_steps = round(WAVE_PARAREAL_T_END / WAVE_PARAREAL_SLICES / wave_d_t)
    wave_cfg = fs._SystemKernelConfig(wave_cp, wave_d_t)
    wave_tcfg = ts._TiledSystemConfig(wave_cp, wave_d_t)
    wave_y0 = initial(wave_ivp)
    borders = torch.stack(
        [wave_y0 * (1.0 - 0.05 * i) for i in range(WAVE_PARAREAL_SLICES)]
    ).contiguous()
    rows.append(
        ("cluster_system_rk4_end",
         f"B={WAVE_PARAREAL_SLICES} x 101^2 x 2 wave ends", "wave",
         WAVE_PARAREAL_SLICES, slice_steps, False, wave_cfg, borders,
         lambda: mode_end(borders, wave_cfg, slice_steps),
         lambda: ts.tiled_system_rk4_end(borders, wave_tcfg, slice_steps))
    )
    entries = []
    turns = {}
    for (key, label, family, batch, steps, trajectory, cfg, y_0, run_mode,
         run_k8) in rows:
        run_k8()
        run_mode()
        # in turns: K8, the mode, the mode, K8
        k8_a = once_ms(torch, run_k8)
        mode_a = once_ms(torch, run_mode)
        mode_b = once_ms(torch, run_mode)
        k8_b = once_ms(torch, run_k8)
        mode_ms, k8_ms = 0.5 * (mode_a + mode_b), 0.5 * (k8_a + k8_b)
        turns[label] = (mode_ms, k8_ms, steps)
        cells = cfg.height * cfg.width
        bound_ms, bound_by = stencil_bound(
            family, batch, steps, cells, cfg.n, trajectory
        )
        plan = fs.cluster_plan(cfg, batch, None, fs.card_active_clusters(
            cfg, trajectory
        ))
        log(
            f"time: {label}, {steps} steps, in turns (K8, mode, mode, K8): "
            f"the cluster-resident mode (a cluster of {plan.cluster_size}, "
            f"{plan.cells} cells a thread) {mode_a:.3f} / {mode_b:.3f} ms "
            f"({1e3 * mode_ms / steps:.3f} us a step), per-step K8 "
            f"{k8_a:.3f} / {k8_b:.3f} ms ({1e3 * k8_ms / steps:.3f} us a "
            f"step): {k8_ms / mode_ms:.3f}x; bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}) [{card}]"
        )
        # the function's entry: the kernel and its plain version on the
        # same inputs over MODE_TIMED_STEPS steps (the plain version takes
        # milliseconds a step)
        timed = min(steps, MODE_TIMED_STEPS)
        if trajectory:
            args = (y_0, cfg, timed)
            wrapper, plain = mode, k5_plain
        else:
            args = (y_0, cfg, steps)
            wrapper, plain = mode_end, fs.fused_system_rk4_end_reference
            timed = steps
        kernel_ms = cuda_ms(torch, lambda: wrapper(*args))
        outputs = []
        plain_ms = once_ms(torch, lambda: outputs.append(plain(*args)))
        rel_err = check(key, f"{label}, {timed} steps, timed",
                        wrapper(*args), outputs[0])
        del outputs
        entry_bound_ms, entry_bound_by = stencil_bound(
            family, batch, timed, cells, cfg.n, trajectory
        )
        what = f"{label}, {timed} steps"
        log(
            f"time: {key} ({what}): kernel {kernel_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms (one run), bound {entry_bound_ms * 1e3:.3f} "
            f"us ({entry_bound_by}); against the plain version there "
            f"max|d|/max|y| = {rel_err:.3e} [{card}]"
        )
        entries.append(
            {
                "name": key,
                "route": "cuda",
                "source": CLUSTER_SOURCE,
                "replaces": (
                    "pararealml_tpu/ops/fused_system.py:822" if trajectory
                    else "pararealml_tpu/ops/fused_system.py:964"
                ),
                "on_path": True,
                "launches": path_launches[key],
                "max_abs_err": errors.get(key, 0.0),
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": entry_bound_ms,
                "bound_us": entry_bound_ms * 1e3,
                "bound_by": entry_bound_by,
                "library_ms": None,
                "timed": what,
                "path_ms": mode_ms,
                "path_k8_ms": k8_ms,
                "path_steps": steps,
            }
        )
    log(f"phase cluster times: ok ({time.perf_counter() - started:.1f} s)")

    # -- phase 36: K8's step split and the profiles ------------------------
    for result in load_tool("k8_step_split").run(device, card, log):
        log(
            "k8 split: {case}: a step {step_us:.3f} us: launch gap "
            "{launch_gap:.3f}, tile load {load:.3f}, stages {stages:.3f}, "
            "barriers {barriers:.3f}, store {store:.3f} us; K5 on a cluster "
            "of {k5_cluster_size} {k5_step_us:.3f} us [{card}]".format(
                card=card, **result, **result["parts_us"]
            )
        )
    for (key, label, _, _, _, _, _, _, run_mode, run_k8) in rows:
        mode_ms, k8_ms, _ = turns[label]
        for route, run, wall in (
            ("the mode", run_mode, mode_ms),
            ("per-step K8", run_k8, k8_ms),
        ):
            busy_ms, top = device_busy_ms(torch, run, reps=1)
            if busy_ms is None:
                log(f"profile: {label}, {route}: not measured (no device "
                    "events)")
                continue
            log(
                f"profile: {label}, {route}: device busy {busy_ms:.3f} ms "
                f"of {wall:.3f} ms, idle share {1.0 - busy_ms / wall:.3f}; "
                f"top: {top} [{card}]"
            )
    return entries


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

    from pararealml_tpu_torch.ops import (
        fused_navier_stokes,
        fused_system,
        fused_system_3d,
        tiled_diffusion,
        tiled_system,
    )

    start = time.perf_counter()
    # one nvcc per source, all started together, the step and sweep
    # splits' instrumented copies (phases 4, 27, 32, 36 and 37) too
    sources = (
        "fused_diffusion",
        "fused_system",
        "tiled_diffusion",
        "fused_system_3d",
        "tiled_system",
        "fused_navier_stokes",
        "cluster_system",
    )
    split_builds = [
        threading.Thread(target=load_tool(name).build_split_library)
        for name in (
            "k1_step_split",
            "k5_step_split",
            "k8_step_split",
            "ns_sweep_split",
            "k9_step_split",
        )
    ]
    for thread in split_builds:
        thread.start()
    cuda_library.build_libraries(sources)
    for thread in split_builds:
        thread.join()
    fd.load_kernels()
    fused_system.load_kernels()
    tiled_diffusion.load_kernels()
    fused_system_3d.load_kernels()
    tiled_system.load_kernels()
    fused_navier_stokes.load_kernels()
    fused_system.load_cluster_kernels()
    log(
        f"kernel libraries ready in {time.perf_counter() - start:.2f} s "
        f"(nvcc, in parallel: {cuda_library.build_seconds})"
    )
    for source in sources:
        build_log = cuda_library.build_logs.get(source, "")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {source}: {line.strip()}")

    names = [name for name, _ in KERNELS] + [STEP_KERNEL]
    wrappers = {name: getattr(fd, name) for name in names}
    errors = {name: 0.0 for name in names}

    # -- phase 1: every kernel against its plain version -----------------
    # at the plan the wrappers pick and at every plan of the measured
    # table that covers the grid, on the three problems and on the
    # table's other grids (3 x 3 among them)
    problems, initial = kernel_problems(prml)
    rng = np.random.default_rng(0)
    for height, width in sorted({key[:2] for key in fd._MEASURED_PLANS}):
        if (height, width) not in ((21, 21), (17, 17)):
            problems[f"grid {height}x{width}"] = grid_problem(
                prml, height, width
            )
    for label, cp in problems.items():
        cfg = fd._KernelConfig(cp, FINE_D_T)
        if label in initial:
            y = torch.as_tensor(
                initial[label].discrete_y_0(True)[..., 0],
                dtype=torch.float32,
                device=device,
            ).contiguous()
        else:
            y = torch.as_tensor(
                rng.uniform(0.0, 2.0, (cfg.height, cfg.width)),
                dtype=torch.float32,
                device=device,
            )
        batch = torch.stack(
            [y * (0.5 + 0.125 * i) + 0.1 * i for i in range(8)]
        ).contiguous()
        # the table's other grids for fewer steps: their plain versions
        # take up to 3 ms a step
        steps = 200 if label in initial else 50
        checks = [
            ("fused_diffusion_rk4_trajectory", y, f"{steps} steps", steps),
            ("fused_diffusion_rk4_end", y, f"single, {steps} steps", steps),
            ("fused_diffusion_rk4_end", batch, f"B=8, {steps} steps", steps),
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
        table = sorted(
            {
                plan
                for plan in fd._MEASURED_PLANS.values()
                if plan.covers(cfg.height, cfg.width)
            },
            key=str,
        )
        for name, state, what, n_steps in checks:
            args = (state, cfg) if n_steps is None else (state, cfg, n_steps)
            plain = getattr(fd, f"{name}_reference")(*args)
            # the wrappers' own plan, then every table plan (main-path
            # shapes: the wrappers' plan alone)
            plans = [None] + (table if n_steps in (None, steps) else [])
            for plan in plans:
                kernel = wrappers[name](*args, plan=plan)
                torch.cuda.synchronize()
                assert kernel.shape == plain.shape, (name, what)
                abs_err = float((kernel - plain).abs().max())
                rel_err = abs_err / float(plain.abs().max())
                errors[name] = max(errors[name], abs_err)
                shown = cfg.plan(state.shape[0] if state.ndim == 3 else 1)
                log(
                    f"kernels: {label:10s} {name} ({what}) on "
                    f"{plan if plan is not None else f'its plan, {shown}'}: "
                    f"max|d|/max|y| = {rel_err:.3e}"
                )
                if not rel_err <= KERNEL_REL_TOL:
                    raise AssertionError(
                        f"{name} disagrees with its plain version on {label}"
                        f" ({plan})"
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
    fine_bound_ms, fine_bound_by = stencil_bound(
        "diffusion", 1, round(T_END / FINE_D_T), 21 * 21, 1, True
    )
    cfg = fd._KernelConfig(cp, FINE_D_T)
    log(
        f"time: fine solve, K1 kernel ({cfg.plan(1)}), 40000 steps: "
        f"{fine_ms:.3f} ms{before_k1_redesign('fine solve')}, bound "
        f"{fine_bound_ms * 1e3:.3f} us ({fine_bound_by}) [{card}]"
    )

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
            f"time: {name} ({what}, {cfg.plan(1)}): kernel "
            f"{kernel_ms[name][0]:.3f} ms{before_k1_redesign(name)}, plain "
            f"{kernel_ms[name][1]:.3f} ms [{card}]"
        )
    batched_end_ms = cuda_ms(
        torch, lambda: fd.fused_diffusion_rk4_end(slice_batch, cfg, 5000)
    )
    log(
        "time: fused_diffusion_rk4_end (B=8, 5000 steps: one iteration's "
        f"fine ends, {cfg.plan(8)}): kernel {batched_end_ms:.3f} ms"
        f"{before_k1_redesign('fused_diffusion_rk4_end B=8')} [{card}]"
    )
    for (label, parareal), diff in zip(parareals, diffs):
        program, _ = parareal.trajectory_function(cp, (0.0, T_END))
        runs[label] = lambda program=program: program(y_0)
        run_ms[label] = ms = cuda_ms(torch, runs[label])
        check = float((program(y_0) - fine_device).abs().max())
        assert abs(check - diff) <= 1e-3, (check, diff)
        log(
            f"time: parareal {label}: {ms:.3f} ms"
            f"{before_k1_redesign(label)}, speedup vs fused fine "
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

    cells = cfg.height * cfg.width
    flagship_bounds = {
        "fused_diffusion_rk4_trajectory": stencil_bound(
            "diffusion", 1, 2000, cells, 1, True
        ),
        "fused_diffusion_rk4_end": stencil_bound(
            "diffusion", 1, 500, cells, 1, False
        ),
        STEP_KERNEL: stencil_bound("diffusion", 1, 1, cells, 1, True),
    }
    kernels = []
    for name, replaces in KERNELS + ((STEP_KERNEL, f"{JAX_KERNELS}:671"),):
        bound_ms, bound_by = flagship_bounds[name]
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": SOURCE,
                "replaces": replaces,
                "on_path": name != STEP_KERNEL,
                "launches": launches[name],
                "max_abs_err": errors[name],
                "ms": kernel_ms[name][0],
                "plain_ms": kernel_ms[name][1],
                "bound_ms": bound_ms,
                "bound_us": bound_ms * 1e3,
                "bound_by": bound_by,
                "library_ms": None,
                "timed": timings[name][0],
                "plan": str(cfg.plan(1)),
                "plan_b8": str(cfg.plan(8)),
            }
        )
        log(
            f"bound: {name} ({timings[name][0]}): {bound_ms * 1e3:.3f} us "
            f"({bound_by}) [{card}]"
        )
    # the split of a K1 step on the wrappers' plans (after the redesign)
    load_tool("k1_step_split").run(device, card, log)

    log(f"phases 1-4 done at {time.perf_counter() - start:.1f} s")
    for label, phases, timing in (
        ("5-8", burgers_phases, (cuda_ms, once_ms, device_busy_ms)),
        ("9-12", large_grid_phases, (cuda_ms, once_ms, device_busy_ms)),
        ("13-16", three_d_phases, (cuda_ms, once_ms, device_busy_ms)),
        ("17-20", system_2d_phases, (cuda_ms, once_ms, device_busy_ms)),
        ("21-24", polar_phases, (cuda_ms, once_ms, device_busy_ms)),
        ("25-28", navier_stokes_phases, (cuda_ms, once_ms, device_busy_ms)),
        ("29-32", end_mode_phases, (cuda_ms, once_ms, device_busy_ms)),
        ("33-36", cluster_mode_phases, (cuda_ms, once_ms, device_busy_ms)),
        ("37", k9_split_phase, (cuda_ms, once_ms, device_busy_ms)),
    ):
        kernels += phases(torch, prml, device, card, *timing)
        log(f"phases {label} done at {time.perf_counter() - start:.1f} s")
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
