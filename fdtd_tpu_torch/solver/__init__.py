from .boundary import BoundaryConditions, Dirichlet, Neumann, default_boundaries
from .cpml import Cpml
from .cuda_cpml_blocked import BlockedPlan, blocked_plan, cuda_cpml_blocked_stepk_fn
from .cuda_cpml_gb import cuda_cpml_gb_stepk_fn, gb_plan
from .cuda_cpml_k import cuda_cpml_stepk_fn, supports_cpml_k
from .cuda_cpml_xz import XzPlan, cuda_cpml_xz_stepk_fn, xz_plan
from .engine import EngineState, build_step, init_engine_state
from .pml import GradedPmlSpec
from .pml_region import DensePml, dense_pml_from_depth, depth_from_contains
from .sources import (
    ContinuousWave,
    GaussianDerivative,
    GaussianPulse,
    PointSource,
    Ricker,
    SourceSet,
)
from .simulation import Simulation
from .state import SimState, state_from_stacked, zero_state
from .tfsf import Tfsf
from .tfsf_oblique import ObliqueTfsf
from .step import (
    CellCoefficients,
    curl_backward,
    curl_forward,
    divergence,
    field_energy,
    step,
    step_fn,
)

__all__ = [
    "BoundaryConditions",
    "Dirichlet",
    "Neumann",
    "default_boundaries",
    "Cpml",
    "cuda_cpml_stepk_fn",
    "supports_cpml_k",
    "cuda_cpml_gb_stepk_fn",
    "gb_plan",
    "cuda_cpml_xz_stepk_fn",
    "xz_plan",
    "XzPlan",
    "cuda_cpml_blocked_stepk_fn",
    "blocked_plan",
    "BlockedPlan",
    "EngineState",
    "build_step",
    "init_engine_state",
    "GradedPmlSpec",
    "Tfsf",
    "ObliqueTfsf",
    "DensePml",
    "dense_pml_from_depth",
    "depth_from_contains",
    "ContinuousWave",
    "GaussianDerivative",
    "GaussianPulse",
    "PointSource",
    "Ricker",
    "SourceSet",
    "Simulation",
    "SimState",
    "state_from_stacked",
    "zero_state",
    "CellCoefficients",
    "curl_backward",
    "curl_forward",
    "divergence",
    "field_energy",
    "step",
    "step_fn",
]
