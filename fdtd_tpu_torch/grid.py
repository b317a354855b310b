"""Yee-lattice geometry: resolution, grid sizing, Courant condition.

A copy of ``fdtd_tpu.grid``: the port cannot import the JAX package, and
tests/port/test_torch_core.py holds the two copies equal.

Counterpart of the reference's ``FdtdSolverConfig``/``Resolution``
(cem-solver/src/fdtd/mod.rs:18-93) and ``Strider``
(cem-solver/src/fdtd/strider.rs).

Yee convention (cem-solver/src/fdtd/cpu/util.rs:139-166): the E field is
staggered +(0.5, 0.5, 0.5) cells relative to H. Cell (0,0,0) of the lattice
stores E at physical offset (0.5, 0.5, 0.5)*dx and H at (0,0,0). The H update
therefore uses the *backward* difference of E and the E update the *forward*
difference of H.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from .constants import SI, PhysicalConstants

__all__ = [
    "Resolution",
    "Grid",
    "courant_number",
    "estimate_temporal_from_spatial_resolution",
    "estimate_spatial_from_temporal_resolution",
    "estimate_spatial_resolution_from_min_wavelength",
    "estimate_temporal_resolution_from_max_frequency",
]

_SQRT3 = math.sqrt(3.0)


def estimate_temporal_from_spatial_resolution(
    speed_of_light: float, spatial: Tuple[float, float, float]
) -> float:
    """Courant-stable dt = min(dx)/(c*sqrt(3)) (cem-solver/src/fdtd/mod.rs:40-45)."""
    return min(spatial) / (speed_of_light * _SQRT3)


def estimate_spatial_from_temporal_resolution(
    speed_of_light: float, temporal: float
) -> Tuple[float, float, float]:
    """Inverse of the Courant estimate (cem-solver/src/fdtd/mod.rs:47-52)."""
    dx = temporal * speed_of_light * _SQRT3
    return (dx, dx, dx)


def estimate_spatial_resolution_from_min_wavelength(
    min_wavelength: float,
) -> Tuple[float, float, float]:
    """lambda_min/(9*sqrt(3)) spatial rule (cem-solver/src/fdtd/mod.rs:54-56)."""
    dx = min_wavelength / (9.0 * _SQRT3)
    return (dx, dx, dx)


def estimate_temporal_resolution_from_max_frequency(max_frequency: float) -> float:
    """1/(27*f_max) rule (cem-solver/src/fdtd/mod.rs:58-60)."""
    return 1.0 / (9.0 * 3.0 * max_frequency)


def courant_number(
    spatial: Tuple[float, float, float], temporal: float, speed_of_light: float
) -> float:
    """S = c*dt*sqrt(sum(1/dx_i^2)); stable iff S <= 1."""
    return (
        speed_of_light
        * temporal
        * math.sqrt(sum(1.0 / (dx * dx) for dx in spatial))
    )


@dataclasses.dataclass(frozen=True)
class Resolution:
    """Spatial cell size per axis + timestep (cem-solver/src/fdtd/mod.rs:62-93)."""

    spatial: Tuple[float, float, float]
    temporal: float

    @classmethod
    def from_min_wavelength(
        cls, min_wavelength: float, constants: PhysicalConstants = SI
    ) -> "Resolution":
        spatial = estimate_spatial_resolution_from_min_wavelength(min_wavelength)
        temporal = estimate_temporal_from_spatial_resolution(
            constants.speed_of_light, spatial
        )
        return cls(spatial=spatial, temporal=temporal)

    @classmethod
    def from_max_frequency(
        cls, max_frequency: float, constants: PhysicalConstants = SI
    ) -> "Resolution":
        temporal = estimate_temporal_resolution_from_max_frequency(max_frequency)
        spatial = estimate_spatial_from_temporal_resolution(
            constants.speed_of_light, temporal
        )
        return cls(spatial=spatial, temporal=temporal)

    @classmethod
    def uniform(cls, dx: float, dt: float) -> "Resolution":
        return cls(spatial=(dx, dx, dx), temporal=dt)

    @classmethod
    def courant(
        cls, dx: float, constants: PhysicalConstants = SI, safety: float = 1.0
    ) -> "Resolution":
        """Uniform spacing with the Courant-stable dt (optionally scaled down)."""
        spatial = (dx, dx, dx)
        dt = safety * estimate_temporal_from_spatial_resolution(
            constants.speed_of_light, spatial
        )
        return cls(spatial=spatial, temporal=dt)

    def courant_number(self, constants: PhysicalConstants = SI) -> float:
        return courant_number(self.spatial, self.temporal, constants.speed_of_light)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Lattice shape + resolution + unit system.

    Counterpart of ``FdtdSolverConfig`` (cem-solver/src/fdtd/mod.rs:18-38):
    a physical domain size is converted to a lattice shape by
    ceil(size/dx), min 1 per axis.
    """

    shape: Tuple[int, int, int]
    resolution: Resolution
    constants: PhysicalConstants = SI

    @classmethod
    def from_domain_size(
        cls,
        size: Tuple[float, float, float],
        resolution: Resolution,
        constants: PhysicalConstants = SI,
    ) -> "Grid":
        # cem-solver/src/fdtd/mod.rs:25-29: ceil(size/dx).max(1)
        shape = tuple(
            max(1, int(math.ceil(s / dx))) for s, dx in zip(size, resolution.spatial)
        )
        return cls(shape=shape, resolution=resolution, constants=constants)

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    @property
    def dt(self) -> float:
        return self.resolution.temporal

    @property
    def dx(self) -> Tuple[float, float, float]:
        return self.resolution.spatial

    def courant_number(self) -> float:
        return self.resolution.courant_number(self.constants)

    def is_courant_stable(self) -> bool:
        return self.courant_number() <= 1.0 + 1e-12

    def memory_required(self, dtype_bytes: int = 4, index_bytes: int = 1) -> int:
        """Device-memory estimate in bytes for the in-place solver.

        E + H (3 components each) + material index per cell. The reference's
        GPU backend needs 64 B/cell (cem-solver/src/fdtd/wgpu/mod.rs:129-133)
        because it double-buffers fields and stores 4 coefficients per cell;
        the in-place + compressed-index design needs 25 B/cell at f32.
        """
        return self.num_cells * (6 * dtype_bytes + index_bytes)

    def cell_centers(self, dtype=np.float64) -> np.ndarray:
        """Physical coordinates of E-sample points, shape (3, nx, ny, nz).

        E lives at (i+0.5)*dx per the staggering convention
        (cem-solver/src/fdtd/cpu/util.rs:146-154).
        """
        axes = [
            (np.arange(n, dtype=dtype) + 0.5) * d
            for n, d in zip(self.shape, self.resolution.spatial)
        ]
        return np.stack(np.meshgrid(*axes, indexing="ij"), axis=0)


class Strider:
    """3D <-> linear index mapping (cem-solver/src/fdtd/strider.rs:18-154).

    The reference uses x-fastest strides; our device arrays are C-order
    (z-fastest), so the stride order is a constructor choice. Used for
    contiguous-range detection in field readback.
    """

    def __init__(self, shape: Tuple[int, int, int], order: str = "C"):
        self.shape = tuple(shape)
        nx, ny, nz = self.shape
        if order == "C":  # z fastest (row-major over (x, y, z))
            self.strides = (ny * nz, nz, 1)
        elif order == "F":  # x fastest, like the reference (strider.rs:147-154)
            self.strides = (1, nx, nx * ny)
        else:
            raise ValueError(f"unknown order {order!r}")

    def index(self, point: Tuple[int, int, int]) -> int:
        if not all(0 <= p < n for p, n in zip(point, self.shape)):
            raise IndexError(f"point {point} outside lattice {self.shape}")
        return sum(p * s for p, s in zip(point, self.strides))

    def point(self, index: int) -> Tuple[int, int, int]:
        out = [0, 0, 0]
        rem = index
        for axis in sorted(range(3), key=lambda a: -self.strides[a]):
            out[axis], rem = divmod(rem, self.strides[axis])
        if rem or not all(0 <= p < n for p, n in zip(out, self.shape)):
            raise IndexError(f"index {index} outside lattice {self.shape}")
        return tuple(out)

    def contiguous_index_range(self, start, end) -> "tuple[int, int] | None":
        """Linear [lo, hi) covering the box [start, end) iff it is contiguous
        in memory (cem-solver/src/fdtd/strider.rs:78-121)."""
        extent = tuple(e - s for s, e in zip(start, end))
        if any(x <= 0 for x in extent):
            return (0, 0)
        # A box is contiguous iff every axis with extent > 1 except the
        # outermost-varying one spans the full lattice along all
        # faster-varying axes.
        order = sorted(range(3), key=lambda a: self.strides[a])  # fastest first
        full_prefix = True
        for axis in order:
            if not full_prefix and extent[axis] > 1:
                return None
            if extent[axis] != self.shape[axis]:
                full_prefix = False
        lo = self.index(tuple(start))
        n = extent[0] * extent[1] * extent[2]
        return (lo, lo + n)
