from .boundary import BoundaryConditions, Dirichlet, Neumann, default_boundaries
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
