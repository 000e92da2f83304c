"""Batched RK4 kernels over Parareal's slices (K4).

Port of the JAX package's ``ops/packed_system.py`` for the wave, viscous
Burgers, shallow-water and Cahn-Hilliard systems. On the TPU, the B slice
states of a Parareal iteration are packed side by side along the vector
lanes of one plane set, so that small grids fill the vector unit, and one
kernel program advances them all. On Hopper that packing has no purpose:
the batch is the grid of the same CUDA kernel template as K5
(``csrc/fused_system.cu``), one CTA per slice, so 100 slices of a 21 x 21
grid run side by side on 100 SMs. The lane packing, its gap columns and
multi-hot edge masks are not carried over.

- ``packed_system_rk4_ends`` (every iteration's fine end states) and
  ``packed_system_rk4_trajectory`` (the final expansion of every slice's
  trajectory) are the wrappers: they launch the kernel for a CUDA tensor
  or run the plain version for a CPU tensor, and count their launches in
  ``launches``.
- ``packed_system_rk4_{ends,trajectory}_reference`` are the plain
  versions (those of K5 over the batch).

The trajectory takes the JAX kernel's snapshot dtype (``traj_dtype``,
which the JAX Parareal takes from the fine operator's
``kernel_traj_dtype``): frames rounded to bfloat16 over the float32 state
that the steps carry, so the rounding touches the stored frames only,
and returned cast back to float32, as the JAX kernel returns them. The
CUDA kernel rounds in its store and writes bfloat16 frames.

Shapes are the JAX package's: ``(B, H, W, n) -> (B, H, W, n)`` and
``(B, H, W, n) -> (B, n_steps, H, W, n)``.

Applicability (:func:`packed_system_applicable`): K5's gate for one of
its four families on a Cartesian mesh (the JAX package's packed kernels
cover neither Navier-Stokes, whose Parareal fine ends take the batched
cluster kernel of ``ops/fused_navier_stokes.py``, nor polar meshes, whose
fine ends take the batched K5 end), static boundary conditions, RK4,
float32,
a grid that fits one CTA's shared memory (past it Parareal's fine ends
take K8's batched end mode and its expansion the batched K8 trajectory;
the JAX package's packed kernels have a VMEM budget instead) and a batch
of at least two slices. K4 runs one CTA per slice (never a cluster: its
batches measured fastest so).
The JAX package's packed diffusion family is not ported (ROADMAP.md,
Queue 2); the port serves it with the batched K2 launch of
``ops/fused_diffusion.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from pararealml_tpu_torch.constrained_problem import ConstrainedProblem
from pararealml_tpu_torch.differential_equation import NavierStokesEquation
from pararealml_tpu_torch.mesh import CoordinateSystem
from pararealml_tpu_torch.ops.fused_system import (
    _SystemKernelConfig,
    fused_system_rk4_end_reference,
    fused_system_rk4_trajectory_reference,
    fits_one_block,
    fused_system_step_applicable,
    k5_cluster_size,
    launch,
    states,
    trajectory_buffer,
)


def packed_system_applicable(
    cp: ConstrainedProblem,
    integrator,
    batch: int,
    dtype: Optional[torch.dtype] = None,
) -> bool:
    """Whether the batched kernels reproduce ``batch`` generic-path
    sub-solves for this problem (and, when ``dtype`` is given, for
    states of that dtype)."""
    return (
        batch >= 2
        and cp.mesh is not None
        and type(cp.differential_equation) is not NavierStokesEquation
        and cp.mesh.coordinate_system_type == CoordinateSystem.CARTESIAN
        and fused_system_step_applicable(cp, integrator, dtype)
        and fits_one_block(cp)
    )


def _snapshot_dtype(traj_dtype) -> torch.dtype:
    traj_dtype = traj_dtype or torch.float32
    if traj_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"traj_dtype must be float32 or bfloat16, got {traj_dtype}"
        )
    return traj_dtype


def packed_system_rk4_ends_reference(
    y: torch.Tensor, cfg: _SystemKernelConfig, n_steps: int
) -> torch.Tensor:
    """Plain version of the K4 ends: ``(B, H, W, n) -> (B, H, W, n)``."""
    return fused_system_rk4_end_reference(y, cfg, n_steps)


def packed_system_rk4_trajectory_reference(
    y: torch.Tensor, cfg: _SystemKernelConfig, n_steps: int, traj_dtype=None
) -> torch.Tensor:
    """Plain version of the K4 trajectory: ``(B, H, W, n) -> (B,
    n_steps, H, W, n)``, each frame rounded to ``traj_dtype`` and cast
    back to ``y``'s dtype."""
    frames = fused_system_rk4_trajectory_reference(y, cfg, n_steps)
    if _snapshot_dtype(traj_dtype) == torch.float32:
        return frames
    return frames.to(traj_dtype).to(y.dtype)


def packed_system_rk4_ends(
    y: torch.Tensor, cfg: _SystemKernelConfig, n_steps: int
) -> torch.Tensor:
    """K4 ends: every state of the batch advanced by ``n_steps`` RK4
    steps, end states only, ``(B, H, W, n) -> (B, H, W, n)`` (one CTA
    per slice)."""
    cfg.check_state(y, batched=True)
    if y.device.type == "cpu":
        return packed_system_rk4_ends_reference(y, cfg, n_steps)
    out = torch.empty_like(y)
    launch(
        y,
        out,
        cfg,
        n_steps,
        write_trajectory=False,
        cluster_size=k5_cluster_size(cfg, one_block=True),
    )
    packed_system_rk4_ends.launches += 1
    return out


def packed_system_rk4_trajectory(
    y: torch.Tensor, cfg: _SystemKernelConfig, n_steps: int, traj_dtype=None
) -> torch.Tensor:
    """K4 trajectory: every state of the batch advanced by ``n_steps``
    RK4 steps with every step stored, ``(B, H, W, n) -> (B, n_steps, H,
    W, n)`` in float32 (one CTA per slice); with ``traj_dtype`` bfloat16
    the kernel stores bfloat16 frames, returned cast back to float32."""
    cfg.check_state(y, batched=True)
    snapshot_dtype = _snapshot_dtype(traj_dtype)
    if y.device.type == "cpu":
        return packed_system_rk4_trajectory_reference(
            y, cfg, n_steps, snapshot_dtype
        )
    out = trajectory_buffer(y, cfg, n_steps, snapshot_dtype)
    launch(
        y,
        out,
        cfg,
        n_steps,
        write_trajectory=True,
        cluster_size=k5_cluster_size(cfg, one_block=True),
    )
    packed_system_rk4_trajectory.launches += 1
    return out.to(torch.float32)


packed_system_rk4_ends.launches = 0
packed_system_rk4_trajectory.launches = 0


def _batch(y: torch.Tensor, cfg: _SystemKernelConfig, batch: int):
    lead, stacked = states(y, cfg)
    if lead != (batch,):
        raise ValueError(f"expected leading shape ({batch},), got {lead}")
    return stacked


def build_packed_system_rk4_ends(
    cp: ConstrainedProblem, d_t: float, n_steps: int, batch: int
):
    """Builds ``ends(y) -> y_final`` advancing every one of ``batch``
    stacked sub-states ``(B, H, W, n)`` by ``n_steps`` fused RK4 steps in
    one launch, returning only the final states."""
    cfg = _SystemKernelConfig(cp, d_t)

    def ends(y: torch.Tensor) -> torch.Tensor:
        return packed_system_rk4_ends(_batch(y, cfg, batch), cfg, n_steps)

    return ends


def build_packed_system_rk4_trajectory(
    cp: ConstrainedProblem,
    d_t: float,
    n_steps: int,
    batch: int,
    traj_dtype=None,
):
    """Builds ``trajectory(y) -> ys`` computing all ``batch`` stacked
    sub-trajectories ``(B, H, W, n) -> (B, n_steps, H, W, n)`` in one
    launch, the frames rounded to ``traj_dtype`` (float32 when None or
    float32; bfloat16) and returned in float32."""
    cfg = _SystemKernelConfig(cp, d_t)
    snapshot_dtype = _snapshot_dtype(traj_dtype)

    def trajectory(y: torch.Tensor) -> torch.Tensor:
        return packed_system_rk4_trajectory(
            _batch(y, cfg, batch), cfg, n_steps, snapshot_dtype
        )

    return trajectory
