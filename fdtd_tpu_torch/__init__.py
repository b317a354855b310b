"""fdtd-tpu on PyTorch and CUDA: the port of ``fdtd_tpu`` to one NVIDIA GPU.

The same Yee-lattice FDTD as the JAX package, with the same module paths
and public names: grids, materials, coefficient tables, point sources, the
leapfrog step, CPML absorbers, volumetric DensePml regions and TF/SF plane
waves, axis-aligned or oblique (the absorbing engine),
probes and accumulators (DFT planes, the BoxDft near-to-far-field box),
the ``Simulation`` time loop, scene compilation (``scene``), the
scattering workflow (``models.scattering_cross_section``) and the
free-space lattice split over a mesh of devices (``parallel``). Its plain path is PyTorch on any
device; on a CUDA device the time loop runs hand-written kernels
(``solver/cuda_step.py``, ``solver/cuda_stepk.py``, ``solver/cuda_cpml.py``,
``solver/cuda_cpml_k.py``, sources in ``csrc/``), built with nvcc on first
use. Entry points run on the CUDA card unless given ``device="cpu"``. It imports no JAX: the JAX
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
    Cpml,
    DensePml,
    Dirichlet,
    EngineState,
    GaussianDerivative,
    GaussianPulse,
    Neumann,
    ObliqueTfsf,
    PointSource,
    Ricker,
    SimState,
    Simulation,
    SourceSet,
    Tfsf,
    build_step,
    dense_pml_from_depth,
    depth_from_contains,
    init_engine_state,
    state_from_stacked,
    step,
    step_fn,
    zero_state,
)

__version__ = "0.1.0"
