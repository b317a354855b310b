"""Volumetric (per-cell) uniaxial CPML regions: absorbers of ANY shape,
anywhere in the domain.

A copy of ``fdtd_tpu.solver.pml_region`` (NumPy only; held equal to it by
tests/port/test_torch_core.py). The engine (solver/engine.py) and the CUDA
CPML kernels take the region as it is built here: its box of any extent
and offset, no tile padding (``pad_dense_to_tiles`` is kept for parity with
the JAX package, whose Mosaic kernels need it).

Counterpart of the reference's arbitrary-entity PML depth query
(cem-app/src/solver/runner.rs:633-676): for every lattice point inside a
PML entity it casts a ray along the entity's normal against the collider
and grades PmlCoefficients by the hit distance (pml.rs:60-86). Two
divergences, both deliberate:

- The reference passes the RAW time-of-impact as the grading depth, but
  ``new_graded`` exponentiates it as if normalized to [0, 1]
  (pml.rs:80-81: ``depth.powf(m)``, ``(1-depth).powf(m_a)`` — negative
  bases for depth > 1). Here depth is normalized per cell as
  d_in / (d_in + d_out): distance from the entry interface over the local
  chord length along the normal, which reduces exactly to the boundary
  slab profile for slab shapes.
- The reference never applies its per-cell coefficients (psi stays zero,
  cpu/mod.rs:424-425); here the region feeds real psi recurrences in the
  engine (solver/engine.py) and the CPML kernels, restricted to the
  region's AABB subgrid.

The depth query is VECTORIZED marching on the shape's containment function
over the whole AABB at once (no per-cell host loop), and the runtime cost
is confined to the AABB: the engine and the kernels update psi and the
stretched derivative on the box alone.

The normal must be axis-aligned: a uniaxial stretch along an oblique
direction is not representable in the per-axis Yee curl (the reference
stores an oblique b*normal vector but, since psi is never applied, has no
semantics for it either).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np

from ..constants import PhysicalConstants
from .pml import GradedPmlSpec, graded_profiles, pml_bc

__all__ = ["DensePml", "dense_pml_from_depth", "depth_from_contains",
           "pad_dense_to_tiles"]

Box = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class DensePml:
    """Per-cell uniaxial CPML on an AABB subgrid.

    ``coeffs_h``/``coeffs_e`` are (inv_kappa, b, c) float32 volumes of the
    box shape, sampled at the H (integer) and E (axis +0.5) staggers.
    Outside the absorber (depth <= 0) they are (1, 0, 0): identity stretch,
    psi frozen at zero."""

    axis: int
    box: Box
    coeffs_h: Tuple[Any, Any, Any]
    coeffs_e: Tuple[Any, Any, Any]
    # The LIVE (possibly non-identity) extent when ``box`` has been
    # tile-padded (pad_dense_to_tiles); None means box itself. Padded
    # cells carry the exact identity stretch (ik=1, b=c=0) — a no-op in
    # every consumer — so boundary-slab-overlap checks test this extent,
    # not the padded box.
    live_box: Any = None

    @property
    def live(self) -> Box:
        return self.live_box if self.live_box is not None else self.box

    @property
    def box_shape(self) -> Tuple[int, int, int]:
        return tuple(b1 - b0 for b0, b1 in self.box)

    def validate(self, shape: Tuple[int, int, int]) -> None:
        if not 0 <= self.axis <= 2:
            raise ValueError(f"axis must be 0..2, got {self.axis}")
        for a, ((b0, b1), n) in enumerate(zip(self.box, shape)):
            if not (0 <= b0 < b1 <= n):
                raise ValueError(
                    f"box axis {a}: [{b0}, {b1}) outside grid of {n}"
                )
        for c in (*self.coeffs_h, *self.coeffs_e):
            if tuple(np.shape(c)) != self.box_shape:
                raise ValueError(
                    f"coefficient shape {np.shape(c)} != box {self.box_shape}"
                )


def dense_pml_from_depth(
    axis: int,
    box: Box,
    depth_h: np.ndarray,
    depth_e: np.ndarray,
    *,
    spec: GradedPmlSpec,
    dx: float,
    dt: float,
    constants: PhysicalConstants,
) -> DensePml:
    """Build a region from normalized per-cell depths (<= 0 -> outside).

    ``depth_h`` samples cell positions i (H-update derivative centering),
    ``depth_e`` positions i+0.5 along ``axis`` (E update) — the same
    stagger split as the boundary slabs (cpml.py::_profiles_1d)."""

    def coeffs(depth):
        depth = np.asarray(depth, np.float64)
        inside = depth > 0.0
        sigma, kappa, a = graded_profiles(np.clip(depth, 0.0, 1.0), spec,
                                          dx, constants)
        b, c = pml_bc(sigma, kappa, a, dt, constants)
        ik = np.where(inside, 1.0 / kappa, 1.0)
        b = np.where(inside, b, 0.0)
        c = np.where(inside, c, 0.0)
        return (np.asarray(ik, np.float32), np.asarray(b, np.float32),
                np.asarray(c, np.float32))

    region = DensePml(axis=axis, box=tuple(tuple(b) for b in box),
                      coeffs_h=coeffs(depth_h), coeffs_e=coeffs(depth_e))
    return region


def pad_dense_to_tiles(dense: DensePml, shape) -> DensePml:
    """Expand a region's lateral box to TPU tile alignment — OFFSETS
    down-aligned (y to 8, z to 128) and extents grown to tile multiples —
    padding the coefficient volumes with the identity stretch (ik=1,
    b=c=0). The Pallas kernels' region blocks must be tile-complete AND
    the in-plane stitching slices tile-aligned (Mosaic rejects
    concatenation of sub-tile-offset slices). No-op when already aligned;
    the x extent is untouched (blocked per plane). Raises when the grid
    is too small to hold an aligned box."""
    (x0, x1), (y0, y1), (z0, z1) = dense.box
    ny, nz = shape[1], shape[2]

    def grow(a0, a1, mult, n):
        a0n = (a0 // mult) * mult
        size = -(-(a1 - a0n) // mult) * mult
        if size > n:
            raise ValueError(
                f"cannot tile-align region extent [{a0}, {a1}) to {mult} "
                f"within a grid of {n}"
            )
        a1n = a0n + size
        if a1n > n:
            # kernel-eligible grids have n % mult == 0, so shifting the
            # aligned window left keeps both ends aligned
            a1n = n
            a0n = n - size
        return a0n, a1n

    ny0, ny1 = grow(y0, y1, 8, ny)
    nz0, nz1 = grow(z0, z1, 128, nz)
    if (ny0, ny1, nz0, nz1) == (y0, y1, z0, z1):
        return dense

    def pad(cofs):
        out = []
        for j, c in enumerate(cofs):
            base = np.zeros((x1 - x0, ny1 - ny0, nz1 - nz0), np.float32)
            if j == 0:
                base[:] = 1.0  # 1/kappa identity
            base[:, y0 - ny0: y1 - ny0, z0 - nz0: z1 - nz0] = np.asarray(c)
            out.append(base)
        return tuple(out)

    return DensePml(
        axis=dense.axis,
        box=((x0, x1), (ny0, ny1), (nz0, nz1)),
        coeffs_h=pad(dense.coeffs_h),
        coeffs_e=pad(dense.coeffs_e),
        live_box=dense.live,
    )


def depth_from_contains(
    contains: Callable[[np.ndarray], np.ndarray],
    box: Box,
    axis: int,
    sign: int,
    *,
    to_world: Callable[[np.ndarray], np.ndarray] = lambda p: p,
    step_frac: float = 0.25,
    max_chord_cells: int = 4096,
) -> Tuple[np.ndarray, np.ndarray]:
    """(depth_h, depth_e) normalized [0, 1] per-cell depth volumes.

    For every staggered sample point p in ``box`` (LATTICE coordinates —
    mapped through ``to_world`` before each containment test, e.g.
    ``CoordinateTransforms.solver_to_world``), marches along the entity
    normal (lattice axis ``axis``, direction ``sign``) in steps of
    ``step_frac`` cells to find d_in (distance back to the entry
    interface, against the normal) and d_out (forward to the exit), then
    depth = d_in / (d_in + d_out) — the ray-cast of runner.rs:650-659,
    vectorized over the whole box. The ratio is scale-invariant along a
    fixed direction, so marching in lattice units needs no dx. Points not
    inside get depth 0."""
    (x0, x1), (y0, y1), (z0, z1) = box
    xs = np.arange(x0, x1, dtype=np.float64)
    ys = np.arange(y0, y1, dtype=np.float64)
    zs = np.arange(z0, z1, dtype=np.float64)

    def grid_points(half: bool) -> np.ndarray:
        off = [0.0, 0.0, 0.0]
        if half:
            off[axis] = 0.5
        gx, gy, gz = np.meshgrid(xs + off[0], ys + off[1], zs + off[2],
                                 indexing="ij")
        return np.stack([gx, gy, gz])

    n_hat = np.zeros(3)
    n_hat[axis] = float(np.sign(sign) or 1.0)
    h = step_frac
    # enough marching to cross the box along the axis (plus one cell slack)
    n_steps = min(
        int(np.ceil((box[axis][1] - box[axis][0]) / step_frac)) + 4,
        max_chord_cells,
    )

    def march(pts: np.ndarray, direction: np.ndarray) -> np.ndarray:
        """Distance from each point to the first outside sample along
        ``direction`` (0 for points already outside)."""
        flat = pts.reshape(3, -1)
        still = contains(to_world(flat))
        d = np.zeros(flat.shape[1])
        for k in range(1, n_steps + 1):
            q = flat + direction[:, None] * (k * h)
            still = still & contains(to_world(q))
            if not still.any():
                break
            d += still * h
        return d.reshape(pts.shape[1:])

    out = []
    for half in (False, True):
        pts = grid_points(half)
        inside = contains(to_world(pts.reshape(3, -1))).reshape(
            pts.shape[1:]
        )
        d_out = march(pts, n_hat)
        d_in = march(pts, -n_hat)
        chord = d_in + d_out
        with np.errstate(invalid="ignore", divide="ignore"):
            depth = np.where(chord > 0, d_in / np.maximum(chord, 1e-300), 0.0)
        out.append(np.where(inside, depth, 0.0))
    return out[0], out[1]
