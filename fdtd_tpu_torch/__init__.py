"""fdtd-tpu on PyTorch and CUDA: the port of ``fdtd_tpu`` to one NVIDIA GPU.

The same Yee-lattice FDTD as the JAX package, with the same module paths
and public names: grids, materials, coefficient tables, point sources, the
leapfrog step, probes and the ``Simulation`` time loop. Its plain path is
PyTorch on any device; on a CUDA device the time loop runs hand-written
kernels (``solver/cuda_step.py``, ``solver/cuda_stepk.py``, sources in
``csrc/``), built with nvcc on first use. It imports no JAX: the JAX
package stays the reference the tests hold this one to.
"""

from .constants import REDUCED, SI, PhysicalConstants
from .coefficients import coefficient_table, update_coefficients
from .grid import Grid, Resolution, Strider, courant_number
from .material import PEC, VACUUM, Material, MaterialTable
from .solver import (
    BoundaryConditions,
    CellCoefficients,
    ContinuousWave,
    Dirichlet,
    GaussianDerivative,
    GaussianPulse,
    Neumann,
    PointSource,
    Ricker,
    SimState,
    Simulation,
    SourceSet,
    state_from_stacked,
    step,
    step_fn,
    zero_state,
)

__version__ = "0.1.0"
