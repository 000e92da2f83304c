from pararealml_tpu_torch.ops.fused_diffusion import (
    build_fused_diffusion_rk4_end,
    build_fused_diffusion_rk4_step,
    build_fused_diffusion_rk4_trajectory,
    fused_diffusion_rk4_end,
    fused_diffusion_rk4_end_reference,
    fused_diffusion_rk4_step,
    fused_diffusion_rk4_step_reference,
    fused_diffusion_rk4_trajectory,
    fused_diffusion_rk4_trajectory_reference,
    fused_diffusion_step_applicable,
)
from pararealml_tpu_torch.ops.linear_propagator import (
    build_linear_propagator_trajectory,
    equation_system_is_affine,
    linear_propagator_applicable,
    probe_affine_step,
)

__all__ = [
    "build_fused_diffusion_rk4_end",
    "build_fused_diffusion_rk4_step",
    "build_fused_diffusion_rk4_trajectory",
    "fused_diffusion_rk4_end",
    "fused_diffusion_rk4_end_reference",
    "fused_diffusion_rk4_step",
    "fused_diffusion_rk4_step_reference",
    "fused_diffusion_rk4_trajectory",
    "fused_diffusion_rk4_trajectory_reference",
    "fused_diffusion_step_applicable",
    "build_linear_propagator_trajectory",
    "equation_system_is_affine",
    "linear_propagator_applicable",
    "probe_affine_step",
]
