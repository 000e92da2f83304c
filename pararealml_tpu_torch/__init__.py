"""pararealml_tpu_torch: the PyTorch and CUDA port of the framework.

The second package of this repository, beside the JAX one it is held
against: the same public names and module paths, on PyTorch tensors, with
hand-written CUDA kernels for an NVIDIA H100 (Hopper, ``sm_90a``) where
the JAX package has Pallas TPU kernels. It imports torch, numpy, scipy
and sympy, and nothing of JAX.

Ported so far (ROADMAP.md, Queue 1, slice 1): the problem-definition
layer, the FDM operator for Cartesian meshes with static boundary
conditions, and classic single-device Parareal. Plots are not ported yet
(slice 8), so this root does not export them.
"""

from pararealml_tpu_torch.boundary_condition import (
    BoundaryCondition,
    CauchyBoundaryCondition,
    ConstantBoundaryCondition,
    ConstantFluxBoundaryCondition,
    ConstantValueBoundaryCondition,
    DirichletBoundaryCondition,
    NeumannBoundaryCondition,
    VectorizedBoundaryConditionFunction,
    vectorize_bc_function,
)
from pararealml_tpu_torch.constrained_problem import (
    BoundaryConstraintPair,
    BoundaryConstraints,
    ConstrainedProblem,
)
from pararealml_tpu_torch.constraint import (
    Constraint,
    apply_constraints_along_last_axis,
)
from pararealml_tpu_torch.differential_equation import (
    LHS,
    BurgersEquation,
    CahnHilliardEquation,
    ConvectionDiffusionEquation,
    DifferentialEquation,
    DiffusionEquation,
    LorenzEquation,
    LotkaVolterraEquation,
    NavierStokesEquation,
    NBodyGravitationalEquation,
    PopulationGrowthEquation,
    ShallowWaterEquation,
    SIREquation,
    SymbolicEquationSystem,
    Symbols,
    VanDerPolEquation,
    WaveEquation,
)
from pararealml_tpu_torch.initial_condition import (
    ConstantInitialCondition,
    ContinuousInitialCondition,
    DiscreteInitialCondition,
    GaussianInitialCondition,
    InitialCondition,
    MarginalBetaProductInitialCondition,
    VectorizedInitialConditionFunction,
    vectorize_ic_function,
)
from pararealml_tpu_torch.initial_value_problem import InitialValueProblem
from pararealml_tpu_torch.operator import (
    Operator,
    TorchOperator,
    discretize_time_domain,
)
from pararealml_tpu_torch.mesh import (
    CoordinateSystem,
    Mesh,
    from_cartesian_coordinates,
    to_cartesian_coordinates,
    unit_vectors_at,
)
from pararealml_tpu_torch.solution import Diffs, Solution

__version__ = "0.1.0"

__all__ = [
    "BoundaryCondition",
    "DirichletBoundaryCondition",
    "NeumannBoundaryCondition",
    "CauchyBoundaryCondition",
    "ConstantBoundaryCondition",
    "ConstantValueBoundaryCondition",
    "ConstantFluxBoundaryCondition",
    "VectorizedBoundaryConditionFunction",
    "vectorize_bc_function",
    "ConstrainedProblem",
    "BoundaryConstraintPair",
    "BoundaryConstraints",
    "apply_constraints_along_last_axis",
    "Constraint",
    "Symbols",
    "LHS",
    "SymbolicEquationSystem",
    "DifferentialEquation",
    "PopulationGrowthEquation",
    "LotkaVolterraEquation",
    "LorenzEquation",
    "SIREquation",
    "VanDerPolEquation",
    "NBodyGravitationalEquation",
    "DiffusionEquation",
    "ConvectionDiffusionEquation",
    "WaveEquation",
    "CahnHilliardEquation",
    "BurgersEquation",
    "ShallowWaterEquation",
    "NavierStokesEquation",
    "InitialCondition",
    "DiscreteInitialCondition",
    "ConstantInitialCondition",
    "ContinuousInitialCondition",
    "GaussianInitialCondition",
    "MarginalBetaProductInitialCondition",
    "VectorizedInitialConditionFunction",
    "vectorize_ic_function",
    "InitialValueProblem",
    "CoordinateSystem",
    "Mesh",
    "to_cartesian_coordinates",
    "from_cartesian_coordinates",
    "unit_vectors_at",
    "Operator",
    "TorchOperator",
    "discretize_time_domain",
    "Diffs",
    "Solution",
]
