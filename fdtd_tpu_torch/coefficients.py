"""Lossy-medium leapfrog update coefficients.

A copy of ``fdtd_tpu.coefficients``: the port cannot import the JAX package, and
tests/port/test_torch_core.py holds the two copies equal.

Counterpart of ``UpdateCoefficients::new`` (cem-solver/src/fdtd/util.rs:98-128):

    half = 0.5 * sigma * dt / perm
    a = (1 - half) / (1 + half)
    b = dt / (perm * (1 + half))

computed for the electric pair (C_a, C_b) with perm = eps_r*eps0,
sigma = electrical conductivity, and the magnetic pair (D_a, D_b) with
perm = mu_r*mu0, sigma = magnetic conductivity. Note the reference folds the
1/dx of the spatial derivative into the curl, not into b
(cem-solver/src/fdtd/cpu/mod.rs:417-419) — we keep that convention.

All math is float64; the packed table is cast to the solver dtype at the end
so the f32 path sees correctly-rounded coefficients.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .constants import PhysicalConstants
from .grid import Resolution
from .material import Material

__all__ = ["update_coefficients", "coefficient_table"]


def update_coefficients(
    material: Material,
    resolution: Resolution,
    constants: PhysicalConstants,
) -> Tuple[float, float, float, float]:
    """Return (c_a, c_b, d_a, d_b) in float64.

    PEC (sigma = inf) maps to c_a = c_b = 0, pinning E to zero — the limit of
    the lossy formula as sigma -> inf of `a -> -1`? No: a -> -1 flips sign each
    step (unstable oscillation at finite dt is avoided by the exact limit):
    both (1-h)/(1+h) -> -1 and b -> 0 as h -> inf, but the physically correct
    PEC behavior is E = 0 inside the conductor, so we special-case to (0, 0).
    """

    dt = resolution.temporal

    def pair(perm: float, sigma: float) -> Tuple[float, float]:
        if np.isinf(sigma):
            return (0.0, 0.0)
        half = 0.5 * sigma * dt / perm
        a = (1.0 - half) / (1.0 + half)
        b = dt / (perm * (1.0 + half))
        if np.isnan(a) or np.isnan(b):
            raise ValueError(
                f"NaN update coefficient for perm={perm}, sigma={sigma}, dt={dt}"
            )
        return (a, b)

    c_a, c_b = pair(
        material.relative_permittivity * constants.vacuum_permittivity,
        material.electrical_conductivity,
    )
    d_a, d_b = pair(
        material.relative_permeability * constants.vacuum_permeability,
        material.magnetic_conductivity,
    )
    return (c_a, c_b, d_a, d_b)


def coefficient_table(
    materials: Sequence[Material],
    resolution: Resolution,
    constants: PhysicalConstants,
    dtype=np.float32,
) -> np.ndarray:
    """Pack per-material coefficients into a (num_materials, 4) table.

    Columns: c_a, c_b, d_a, d_b. The solver gathers rows by the per-cell
    material index (the compressed material buffer the reference's README
    lists as a TODO, the reference's README.md:25-28).
    """
    rows = [update_coefficients(m, resolution, constants) for m in materials]
    return np.asarray(rows, dtype=np.float64).astype(dtype)
