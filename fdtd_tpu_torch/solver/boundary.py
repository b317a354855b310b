"""Lattice-edge boundary conditions.

A copy of ``fdtd_tpu.solver.boundary``: the port cannot import the JAX package, and
tests/port/test_torch_core.py holds the two copies equal.

Counterpart of cem-solver/src/fdtd/boundary_condition.rs: the stencil's
one-sided differences at the lattice edge are closed by either a Neumann
condition (the missing *difference* is replaced by a constant — note the
reference substitutes the raw difference, not difference/dx; see the fixme at
boundary_condition.rs:192 and we match that behavior bit-for-bit) or a
Dirichlet condition (the missing *field value* is replaced by a constant).

Default = Neumann(0) on all three axes (boundary_condition.rs:70-80), i.e.
zero-derivative at the edge, exactly like the reference CPU backend and the
WGSL shader (update.wgsl:155-177).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["Neumann", "Dirichlet", "BoundaryConditions", "default_boundaries"]

_ZERO3 = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Neumann:
    """Missing one-sided difference is replaced by alpha (low edge) / beta
    (high edge), per field component."""

    alpha: Tuple[float, float, float] = _ZERO3
    beta: Tuple[float, float, float] = _ZERO3

    kind = "neumann"


@dataclasses.dataclass(frozen=True)
class Dirichlet:
    """Missing field value is replaced by alpha (low edge) / beta (high
    edge): df = f1 - alpha at the low edge, beta - f0 at the high edge."""

    alpha: Tuple[float, float, float] = _ZERO3
    beta: Tuple[float, float, float] = _ZERO3

    kind = "dirichlet"


@dataclasses.dataclass(frozen=True)
class BoundaryConditions:
    """One condition per lattice axis (applies to both edges of that axis)."""

    x: "Neumann | Dirichlet" = Neumann()
    y: "Neumann | Dirichlet" = Neumann()
    z: "Neumann | Dirichlet" = Neumann()

    def axis(self, i: int):
        return (self.x, self.y, self.z)[i]


def default_boundaries() -> BoundaryConditions:
    return BoundaryConditions()
