"""Rigid transforms and world <-> lattice coordinate maps.

Counterpart of the reference's isometry-based transforms
(cem-scene/src/transform/local.rs:29-97) and ``CoordinateTransformations``
(cem-app/src/solver/runner.rs:871-931): solver lattice coordinates map to
world coordinates via scale-by-dx then rotate+translate from the domain
AABB min corner.

All host-side, NumPy float64 (these run once at scene-compile time; the
device never sees them).

A copy of ``fdtd_tpu.scene.transform``, held equal by
tests/port/test_torch_core.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

__all__ = ["Isometry", "CoordinateTransforms"]


def _quat_to_matrix(q: Tuple[float, float, float, float]) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    n = math.sqrt(w * w + x * x + y * y + z * z)
    if n == 0:
        raise ValueError("zero quaternion")
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


@dataclasses.dataclass(frozen=True)
class Isometry:
    """Rotation (unit quaternion, w-first) + translation."""

    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)

    @classmethod
    def identity(cls) -> "Isometry":
        return cls()

    @classmethod
    def from_translation(cls, t) -> "Isometry":
        return cls(translation=tuple(float(v) for v in t))

    @classmethod
    def from_axis_angle(cls, axis, angle: float, translation=(0, 0, 0)) -> "Isometry":
        ax = np.asarray(axis, np.float64)
        ax = ax / np.linalg.norm(ax)
        h = angle / 2.0
        s = math.sin(h)
        return cls(
            translation=tuple(float(v) for v in translation),
            rotation=(math.cos(h), ax[0] * s, ax[1] * s, ax[2] * s),
        )

    @property
    def matrix(self) -> np.ndarray:
        return _quat_to_matrix(self.rotation)

    def apply(self, points: np.ndarray) -> np.ndarray:
        """Transform points, shape (3, ...)."""
        r = self.matrix
        t = np.asarray(self.translation, np.float64).reshape(3, *([1] * (points.ndim - 1)))
        return np.tensordot(r, points, axes=(1, 0)) + t

    def inverse_apply(self, points: np.ndarray) -> np.ndarray:
        r = self.matrix
        t = np.asarray(self.translation, np.float64).reshape(3, *([1] * (points.ndim - 1)))
        return np.tensordot(r.T, points - t, axes=(1, 0))

    def compose(self, other: "Isometry") -> "Isometry":
        """self ∘ other (apply other first)."""
        r1, r2 = self.matrix, other.matrix
        r = r1 @ r2
        t = self.apply(np.asarray(other.translation, np.float64).reshape(3, 1))[:, 0]
        # matrix -> quaternion
        tr = np.trace(r)
        if tr > 0:
            s = math.sqrt(tr + 1.0) * 2
            q = (0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                 (r[1, 0] - r[0, 1]) / s)
        else:
            i = int(np.argmax(np.diag(r)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = math.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 0.0)) * 2
            qv = [0.0, 0.0, 0.0]
            qv[i] = 0.25 * s
            qv[j] = (r[j, i] + r[i, j]) / s
            qv[k] = (r[k, i] + r[i, k]) / s
            q = ((r[k, j] - r[j, k]) / s, *qv)
        return Isometry(translation=tuple(t), rotation=tuple(q))


@dataclasses.dataclass(frozen=True)
class CoordinateTransforms:
    """World <-> solver-lattice homogeneous maps
    (cem-app/src/solver/runner.rs:871-931).

    solver -> world: p_w = R * (p_s * dx) + aabb_min
    world -> solver: p_s = (R^T * (p_w - aabb_min)) / dx
    """

    spatial: Tuple[float, float, float]
    origin: Tuple[float, float, float]  # world position of lattice (0,0,0)
    rotation: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    lattice_size: Tuple[int, int, int] = (0, 0, 0)

    @property
    def _r(self) -> np.ndarray:
        return _quat_to_matrix(self.rotation)

    def solver_to_world(self, points: np.ndarray) -> np.ndarray:
        """points: (3, ...) lattice coordinates (may be fractional)."""
        dx = np.asarray(self.spatial, np.float64).reshape(3, *([1] * (points.ndim - 1)))
        o = np.asarray(self.origin, np.float64).reshape(3, *([1] * (points.ndim - 1)))
        return np.tensordot(self._r, points * dx, axes=(1, 0)) + o

    def world_to_solver(self, points: np.ndarray) -> np.ndarray:
        dx = np.asarray(self.spatial, np.float64).reshape(3, *([1] * (points.ndim - 1)))
        o = np.asarray(self.origin, np.float64).reshape(3, *([1] * (points.ndim - 1)))
        return np.tensordot(self._r.T, points - o, axes=(1, 0)) / dx

    def world_point_to_lattice(self, point) -> Optional[Tuple[int, int, int]]:
        """Round a world point to the nearest lattice cell; None if outside
        (runner.rs:908-931: round + bounds check)."""
        p = self.world_to_solver(np.asarray(point, np.float64).reshape(3, 1))[:, 0]
        idx = np.round(p).astype(np.int64)
        if np.any(idx < 0) or np.any(idx >= np.asarray(self.lattice_size)):
            return None
        return (int(idx[0]), int(idx[1]), int(idx[2]))

    def cell_centers_world(self) -> np.ndarray:
        """World coordinates of all lattice points, shape (3, nx, ny, nz).

        Lattice integer coordinates ARE the sample points (the reference
        transforms integer lattice points to world for material queries,
        runner.rs:616-631)."""
        axes = [np.arange(n, dtype=np.float64) for n in self.lattice_size]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=0)
        return self.solver_to_world(pts)
