"""CPML coefficient math (Taflove/Gedney convolutional PML).

A copy of ``fdtd_tpu.solver.pml``: the port cannot import the JAX package,
and tests/port/test_torch_core.py holds the two copies equal.

Counterpart of cem-solver/src/fdtd/pml.rs:33-87, which computes (CE p.304):

    b = exp(-(sigma/(eps0*kappa) + a/eps0) * dt)          (eq. 7.102)
    c = sigma * (b - 1) / (sigma*kappa + kappa^2 * a)     (eq. 7.99)

with polynomial grading  sigma = sigma_max * d^m,
kappa = 1 + (kappa_max - 1) * d^m,  a = a_max * (1 - d)^m_a  for normalized
depth d in [0, 1].

The reference allocates psi buffers but never applies them
(cem-solver/src/fdtd/cpu/mod.rs:424-425); fdtd_tpu implements the full CPML
recurrence in solver/cpml.py using these coefficients (the port: its
solver/engine.py and the CPML kernels).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from ..constants import PhysicalConstants

__all__ = ["GradedPmlSpec", "pml_bc", "graded_profiles", "sigma_max_optimal"]


@dataclasses.dataclass(frozen=True)
class GradedPmlSpec:
    """Grading parameters (counterpart of the GradedPml component,
    pml.rs:11-20, minus the scene-embedding normal).

    Typical values (pml.rs:72-78): m ~ 3-5, m_a ~ 1-5, kappa_max ~ 1-5,
    a_max ~ 0.1. sigma_max <= 0 means "use the optimal estimate".
    """

    m: float = 3.0
    m_a: float = 1.0
    sigma_max: float = -1.0
    kappa_max: float = 1.0
    a_max: float = 0.05


def sigma_max_optimal(
    m: float, dx: float, constants: PhysicalConstants, eps_r: float = 1.0
) -> float:
    """Gedney's optimal grading amplitude: 0.8*(m+1)/(eta0*dx*sqrt(eps_r))."""
    eta = constants.vacuum_impedance
    return 0.8 * (m + 1.0) / (eta * dx * math.sqrt(eps_r))


def pml_bc(
    sigma: np.ndarray,
    kappa: np.ndarray,
    a: np.ndarray,
    dt: float,
    constants: PhysicalConstants,
) -> Tuple[np.ndarray, np.ndarray]:
    """(b, c) per sample from graded (sigma, kappa, a) arrays (pml.rs:33-57)."""
    eps0 = constants.vacuum_permittivity
    b = np.exp(-(sigma / (eps0 * kappa) + a / eps0) * dt)
    denom = sigma * kappa + kappa**2 * a
    # where sigma == 0 and a == 0 the reference's formula is 0/0; the CPML
    # limit there is c = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(denom > 0, sigma * (b - 1.0) / np.where(denom > 0, denom, 1.0), 0.0)
    return b, c


def graded_profiles(
    depth: np.ndarray, spec: GradedPmlSpec, dx: float, constants: PhysicalConstants
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sigma, kappa, a) from normalized depth in [0, 1] (pml.rs:60-86:
    g1 = d^m, g2 = (1-d)^m_a)."""
    d = np.clip(depth, 0.0, 1.0)
    sigma_max = spec.sigma_max
    if sigma_max <= 0:
        sigma_max = sigma_max_optimal(spec.m, dx, constants)
    g1 = d**spec.m
    g2 = (1.0 - d) ** spec.m_a
    sigma = sigma_max * g1
    kappa = 1.0 + (spec.kappa_max - 1.0) * g1
    a = spec.a_max * g2
    return sigma, kappa, a
