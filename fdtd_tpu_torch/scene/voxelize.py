"""Vectorized scene voxelization -> compressed material-index buffer.

Replaces the reference's per-cell BVH point-query loop
(cem-app/src/solver/runner.rs:566-676 + cem-solver/src/fdtd/cpu/mod.rs:244-264)
with whole-grid vector evaluation: each material entity tests containment of
every cell center at once; the first-inserted entity claims contested cells
(deterministic version of "first material found", runner.rs:616-631). The
result is the compressed uint8/uint16 index buffer into a (K, 4) coefficient
table — the reference's own TODO (its README).

Voxelization is chunked along x to bound host memory on large lattices.

A copy of ``fdtd_tpu.scene.voxelize`` (NumPy only), held equal by
tests/port/test_torch_core.py, without its native C++ fast path
(``fdtd_tpu.native``, not ported): the NumPy path is the reference's
correctness oracle and gives the same index buffer.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..material import Material, MaterialTable, VACUUM
from .scene import Scene
from .transform import CoordinateTransforms

__all__ = ["voxelize_materials"]

_CHUNK_CELLS = 8_000_000


def voxelize_materials(
    scene: Scene,
    transforms: CoordinateTransforms,
    default_material: Material = VACUUM,
) -> Tuple[np.ndarray, MaterialTable]:
    """Return (matid array (nx, ny, nz), material table).

    Cell sample positions are the integer lattice points mapped to world
    space, exactly like the reference's per-cell queries (runner.rs:616-631).
    """
    nx, ny, nz = transforms.lattice_size
    table = MaterialTable(default_material)
    entities = scene.materials()
    mat_ids = [table.register(e.material) for e in entities]

    matid = np.zeros((nx, ny, nz), np.uint16)

    # each entity's solver-space AABB (corner-mapped: exact under the
    # lattice rotation) -> integer cell sub-box; the containment test
    # runs ONLY there. With many small entities (NEC decks: hundreds of
    # thin wires) this collapses the per-entity cost from O(chunk) to
    # O(entity volume) — the counterpart of the reference's BVH-backed
    # per-cell point query (runner.rs:616-631 over spatial/bvh.rs).
    import itertools

    def solver_box(e):
        ab = e.world_aabb()
        if ab is None:
            return ((0, nx), (0, ny), (0, nz))
        corners = np.array(list(itertools.product(*zip(ab[0], ab[1])))).T
        s = transforms.world_to_solver(corners)
        lo = np.floor(s.min(axis=1)).astype(np.int64)
        hi = np.ceil(s.max(axis=1)).astype(np.int64) + 1
        return tuple(
            (max(0, int(l)), min(n, int(h)))
            for l, h, n in zip(lo, hi, (nx, ny, nz))
        )

    boxes = [solver_box(e) for e in entities]

    chunk_x = max(1, _CHUNK_CELLS // max(ny * nz, 1))
    ys = np.arange(ny, dtype=np.float64)
    zs = np.arange(nz, dtype=np.float64)
    for x0 in range(0, nx, chunk_x):
        x1 = min(x0 + chunk_x, nx)
        xs = np.arange(x0, x1, dtype=np.float64)
        pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=0)
        world = transforms.solver_to_world(pts)
        assigned = np.zeros(world.shape[1:], bool)
        out = matid[x0:x1]
        for (e, mid), ((bx0, bx1), (by0, by1), (bz0, bz1)) in zip(
            zip(entities, mat_ids), boxes
        ):
            cx0, cx1 = max(bx0, x0) - x0, min(bx1, x1) - x0
            if cx1 <= cx0 or by1 <= by0 or bz1 <= bz0:
                continue
            sub = (slice(cx0, cx1), slice(by0, by1), slice(bz0, bz1))
            mask = e.contains_world(world[(slice(None),) + sub])
            mask &= ~assigned[sub]
            out[sub][mask] = mid
            assigned[sub] |= mask

    if len(table) <= 256:
        matid = matid.astype(np.uint8)
    return matid, table
