"""Analytic shapes: vectorized containment, signed distance, ray casting.

TPU-first replacement for the reference's parry3d colliders + BVH point
queries (cem-scene/src/spatial/, cem-render/src/mesh/parry.rs:44-152,
cem-app/src/composer/shape/flat.rs): instead of per-cell BVH queries in a
voxelization loop (cem-app/src/solver/runner.rs:616-631), every shape
evaluates containment/distance over the whole cell-center grid at once with
NumPy, making voxelization a handful of vector ops.

Shape coverage matches the reference: Ball, Cuboid, Cylinder
(mesh/parry.rs:44-152), HalfSpace and Quad (shape/flat.rs:45-344).

All shapes are defined in LOCAL frame; ``Entity`` composes them with an
``Isometry`` pose. ``ray_cast`` supports the PML-depth query
(runner.rs:633-676).

A copy of ``fdtd_tpu.scene.shapes`` (NumPy only), held equal by
tests/port/test_torch_core.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

__all__ = ["Ball", "Cuboid", "Cylinder", "HalfSpace", "Quad", "Shape"]


class Shape:
    """Interface: local-frame containment / SDF / AABB / ray cast."""

    def contains(self, points: np.ndarray) -> np.ndarray:
        """points (3, ...) -> bool (...)."""
        return self.sdf(points) <= 0.0

    def sdf(self, points: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def local_aabb(self) -> Tuple[np.ndarray, np.ndarray]:
        """(mins(3,), maxs(3,)) in local frame."""
        raise NotImplementedError

    def ray_exit_distance(
        self, origin: np.ndarray, direction: np.ndarray, max_dist: float
    ) -> Optional[float]:
        """Distance along ``direction`` (unit) from ``origin`` (inside or on
        the shape) to the boundary; None if the ray never hits. Used for the
        PML depth query (counterpart of Collider::cast_ray,
        cem-scene/src/spatial/bvh.rs:54-130)."""
        # generic bisection fallback on the SDF
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        ts = np.linspace(0.0, max_dist, 257)
        pts = o[:, None] + d[:, None] * ts[None, :]
        inside = self.sdf(pts) <= 0.0
        if not inside[0]:
            return None
        idx = np.argmin(inside)  # first False
        if inside[idx]:
            return None  # never exits within max_dist
        lo, hi = ts[idx - 1], ts[idx]
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            if self.sdf((o + d * mid).reshape(3, 1))[0] <= 0.0:
                lo = mid
            else:
                hi = mid
        return float(0.5 * (lo + hi))


@dataclasses.dataclass(frozen=True)
class Ball(Shape):
    """Sphere of given radius (parry Ball, mesh/parry.rs:44-76)."""

    radius: float

    def sdf(self, points: np.ndarray) -> np.ndarray:
        return np.sqrt(np.sum(points * points, axis=0)) - self.radius

    def local_aabb(self):
        r = np.full(3, self.radius)
        return (-r, r)

    def ray_exit_distance(self, origin, direction, max_dist):
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        b = float(o @ d)
        c = float(o @ o) - self.radius**2
        disc = b * b - c
        if disc < 0:
            return None
        t = -b + math.sqrt(disc)
        return t if 0.0 <= t <= max_dist else None


@dataclasses.dataclass(frozen=True)
class Cuboid(Shape):
    """Axis-aligned box by half-extents (parry Cuboid, mesh/parry.rs:78-108)."""

    half_extents: Tuple[float, float, float]

    def sdf(self, points: np.ndarray) -> np.ndarray:
        he = np.asarray(self.half_extents, np.float64).reshape(
            3, *([1] * (points.ndim - 1))
        )
        q = np.abs(points) - he
        outside = np.sqrt(np.sum(np.maximum(q, 0.0) ** 2, axis=0))
        inside = np.minimum(np.max(q, axis=0), 0.0)
        return outside + inside

    def local_aabb(self):
        he = np.asarray(self.half_extents, np.float64)
        return (-he, he)


@dataclasses.dataclass(frozen=True)
class Cylinder(Shape):
    """Y-axis-aligned cylinder (parry convention, mesh/parry.rs:110-152)."""

    half_height: float
    radius: float

    def sdf(self, points: np.ndarray) -> np.ndarray:
        r_xz = np.sqrt(points[0] ** 2 + points[2] ** 2) - self.radius
        d_y = np.abs(points[1]) - self.half_height
        outside = np.sqrt(np.maximum(r_xz, 0.0) ** 2 + np.maximum(d_y, 0.0) ** 2)
        inside = np.minimum(np.maximum(r_xz, d_y), 0.0)
        return outside + inside

    def local_aabb(self):
        return (
            np.array([-self.radius, -self.half_height, -self.radius]),
            np.array([self.radius, self.half_height, self.radius]),
        )


@dataclasses.dataclass(frozen=True)
class HalfSpace(Shape):
    """Half-space below the plane with the given outward normal through the
    origin (shape/flat.rs HalfSpace; the reference's unbounded collider)."""

    normal: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    def sdf(self, points: np.ndarray) -> np.ndarray:
        n = np.asarray(self.normal, np.float64)
        n = n / np.linalg.norm(n)
        return np.tensordot(n, points, axes=(0, 0))

    def local_aabb(self):
        big = np.full(3, np.inf)
        return (-big, big)

    def ray_exit_distance(self, origin, direction, max_dist):
        n = np.asarray(self.normal, np.float64)
        n = n / np.linalg.norm(n)
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        dn = float(d @ n)
        h = float(o @ n)
        if h > 0:
            return None  # outside
        if dn <= 0:
            return None  # never exits
        t = -h / dn
        return t if t <= max_dist else None


@dataclasses.dataclass(frozen=True)
class Quad(Shape):
    """Flat rectangle in the local XY plane with a containment thickness
    (shape/flat.rs:45-200): a zero-thickness shape voxelizes to nothing, so a
    half-thickness of ~dx/2 captures one cell layer, like the reference's
    flat-collider margin."""

    half_extents: Tuple[float, float]
    half_thickness: float = 0.0

    def sdf(self, points: np.ndarray) -> np.ndarray:
        hx, hy = self.half_extents
        q = np.stack(
            [
                np.abs(points[0]) - hx,
                np.abs(points[1]) - hy,
                np.abs(points[2]) - self.half_thickness,
            ]
        )
        outside = np.sqrt(np.sum(np.maximum(q, 0.0) ** 2, axis=0))
        inside = np.minimum(np.max(q, axis=0), 0.0)
        return outside + inside

    def local_aabb(self):
        hx, hy = self.half_extents
        return (
            np.array([-hx, -hy, -self.half_thickness]),
            np.array([hx, hy, self.half_thickness]),
        )
