"""Materials and the compressed material table.

A copy of ``fdtd_tpu.material``: the port cannot import the JAX package, and
tests/port/test_torch_core.py holds the two copies equal.

Counterpart of the reference's ``Material`` (cem-solver/src/material.rs:105-130)
plus the material-index compression its README lists as a TODO
(the reference's README.md:25-28): instead of storing four f32/f64 update
coefficients per cell, the lattice stores a small integer index per cell into
a table of unique materials. The solver gathers coefficients from the table,
cutting the per-cell coefficient traffic from 16 B to 1-2 B.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = ["Material", "VACUUM", "PEC", "MaterialTable"]


@dataclasses.dataclass(frozen=True)
class Material:
    """Linear, isotropic, lossy material.

    Mirrors cem-solver/src/material.rs:105-130 (field-for-field: mu_r,
    sigma_m, eps_r, sigma).
    """

    relative_permeability: float = 1.0  # mu_r
    magnetic_conductivity: float = 0.0  # sigma_m
    relative_permittivity: float = 1.0  # eps_r
    electrical_conductivity: float = 0.0  # sigma

    def is_pec(self) -> bool:
        return math.isinf(self.electrical_conductivity)


#: cem-solver/src/material.rs:118-123.
VACUUM = Material()

#: Perfect electric conductor. The reference has no PEC; NEC antenna wires
#: need one. Modeled as c_a = -1? No: PEC forces E = 0, i.e. c_a = 0, c_b = 0
#: (see coefficients.py), which pins the tangential E field to zero exactly.
PEC = Material(electrical_conductivity=float("inf"))


class MaterialTable:
    """Deduplicating table of materials -> small integer ids.

    ``register`` returns a stable id for each distinct material; ``unique``
    materials are kept in insertion order with id 0 reserved for the default
    (background) material.
    """

    def __init__(self, default: Material = VACUUM):
        self._materials: list[Material] = [default]
        self._ids: dict[Material, int] = {default: 0}

    def register(self, material: Material) -> int:
        mid = self._ids.get(material)
        if mid is None:
            mid = len(self._materials)
            self._materials.append(material)
            self._ids[material] = mid
        return mid

    @property
    def materials(self) -> Sequence[Material]:
        return tuple(self._materials)

    def __len__(self) -> int:
        return len(self._materials)

    def index_dtype(self) -> np.dtype:
        return np.dtype(np.uint8 if len(self._materials) <= 256 else np.uint16)
