"""Convolutional PML absorbing boundaries: configuration and profiles.

Counterpart of ``fdtd_tpu.solver.cpml`` (Taflove ch. 7 / Roden & Gedney
CPML). For each lattice axis with an absorbing slab, every spatial
derivative along that axis is replaced by

    psi    <- b * psi + c * dF          (recurrence, per tick)
    dF~    =  dF / kappa + psi          (stretched derivative)

with (b, c) from solver/pml.py, graded polynomially over the slab depth and
sampled at the Yee stagger: H-update derivatives of E at integer positions,
E-update derivatives of H at half positions. ``Cpml`` and ``_profiles_1d``
are NumPy, as in the JAX package; the recurrence itself runs in
solver/engine.py (plain PyTorch) and in the CUDA kernels
(solver/cuda_cpml.py, solver/cuda_cpml_k.py), all on the engine's
slab-resident psi layout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..constants import SI, PhysicalConstants
from .boundary import BoundaryConditions
from .pml import GradedPmlSpec, graded_profiles, pml_bc

__all__ = ["Cpml"]


def _profiles_1d(
    n: int,
    lo: int,
    hi: int,
    spec: GradedPmlSpec,
    dx: float,
    dt: float,
    constants: PhysicalConstants,
    half: bool,
):
    """1D (inv_kappa, b, c) profiles along an axis of length n with slab
    thicknesses lo/hi (cells). ``half`` shifts sample positions by +0.5
    (E-update stagger)."""
    pos = np.arange(n, dtype=np.float64) + (0.5 if half else 0.0)
    depth = np.zeros(n, np.float64)
    if lo > 0:
        depth = np.maximum(depth, (lo - pos) / lo)
    if hi > 0:
        depth = np.maximum(depth, (pos - (n - 1 - hi)) / hi)
    depth = np.clip(depth, 0.0, 1.0)
    in_slab = depth > 0
    sigma, kappa, a = graded_profiles(depth, spec, dx, constants)
    b, c = pml_bc(sigma, kappa, a, dt, constants)
    inv_kappa = 1.0 / kappa
    # outside the slabs: identity stretch, psi forced to 0
    b = np.where(in_slab, b, 0.0)
    c = np.where(in_slab, c, 0.0)
    return inv_kappa, b, c


@dataclasses.dataclass(frozen=True)
class Cpml:
    """CPML configuration: slab thickness in cells per axis edge.

    thickness[(axis)] = (lo_cells, hi_cells); 0 disables that edge.
    Hashable.
    """

    thickness: Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]
    spec: GradedPmlSpec = GradedPmlSpec()

    @classmethod
    def uniform(cls, cells: int, spec: GradedPmlSpec = GradedPmlSpec()) -> "Cpml":
        t = (cells, cells)
        return cls(thickness=(t, t, t), spec=spec)

    def active_axes(self) -> Tuple[int, ...]:
        return tuple(
            a for a in range(3) if self.thickness[a][0] > 0 or self.thickness[a][1] > 0
        )

    def init_state(self, shape, dtype=torch.float32, device="cuda"):
        from .engine import init_engine_state

        return init_engine_state(shape, dtype, cpml=self, device=device)

    def step_fn(
        self,
        shape: Tuple[int, int, int],
        *,
        inv_dx: Tuple[float, float, float],
        dt: float,
        bc: BoundaryConditions = BoundaryConditions(),
        constants: PhysicalConstants = SI,
        dtype=torch.float32,
    ):
        from .engine import build_step

        return build_step(
            shape, inv_dx=inv_dx, dt=dt, bc=bc, constants=constants,
            dtype=dtype, cpml=self,
        )
