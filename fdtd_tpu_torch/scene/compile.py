"""Scene -> device-ready simulation compilation.

Counterpart of ``fdtd_tpu.scene.compile``, building the port's
``Simulation`` on a device (the CUDA card unless ``device`` names another).
Mirrors the reference's solver-launch flow (RunFdtd::run_fdtd_with_backend,
cem-app/src/solver/runner.rs:247-380): resolve the domain volume (fixed or
scene-AABB + margin, solver/config.rs:98-171), derive the lattice + Courant
check, build world<->solver transforms, voxelize materials into the
compressed index buffer, gather sources from posed entities, and resolve
observers to lattice slice planes. Output is an immutable CompiledScene
wrapping a ready `Simulation`.

Scene-embedded GradedPml entities become boundary CPML slabs or, for an
interior or bounded shape, one volumetric DensePml region per scene
(solver/pml_region.py), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..coefficients import coefficient_table
from ..constants import SI, PhysicalConstants
from ..grid import Grid, Resolution
from ..material import Material, MaterialTable, VACUUM
from ..probes import FieldComponent, SliceProbe
from ..solver.boundary import BoundaryConditions
from ..solver.simulation import Simulation
from ..solver.sources import PointSource, SourceSet
from ..solver.state import DEFAULT_DEVICE
from ..solver.step import CellCoefficients
from .scene import Entity, Scene
from .transform import CoordinateTransforms, Isometry
from .voxelize import voxelize_materials


def _cpml_from_scene_pml(scene: Scene, transforms: CoordinateTransforms, grid: Grid):
    """Map scene-embedded GradedPml entities onto (boundary CPML or None,
    volumetric DensePml region or None).

    The reference computes per-cell PML coefficients from such entities by
    collider ray-cast (cem-app/src/solver/runner.rs:633-676) but never
    applies the psi fields (cem-solver/src/fdtd/cpu/mod.rs:424-425), so
    they are physically inert there. The JAX package makes them REAL
    absorbers along two routes, and so does the port:

    - an axis-aligned slab covering a full domain face -> boundary CPML
      (the fast path: slab thickness in cells + the entity's grading spec);
    - any other bounded shape with an axis-aligned normal, inside the
      volume -> a volumetric per-cell region (solver/pml_region.py): depth
      from the entity's containment query, graded with its spec. One
      region per scene; extras warn and are skipped.

    Non-axis-aligned normals warn and are skipped: an oblique uniaxial
    stretch is not representable in the per-axis Yee curl (the reference
    stores an oblique b-vector but, with psi never applied, gives it no
    semantics either).
    """
    import warnings

    from ..solver.cpml import Cpml
    from ..solver.pml_region import dense_pml_from_depth, depth_from_contains
    from .transform import _quat_to_matrix

    pmls = scene.pmls()
    if not pmls:
        return None, None
    thickness = [[0, 0], [0, 0], [0, 0]]
    spec = None
    dense = None
    for e in pmls:
        normal = np.asarray(e.pml.normal, np.float64)
        normal = normal / np.linalg.norm(normal)
        # into-the-absorber normal in lattice frame
        r = _quat_to_matrix(transforms.rotation)
        n_lat = r.T @ normal
        axis = int(np.argmax(np.abs(n_lat)))
        if abs(abs(n_lat[axis]) - 1.0) > 1e-6:
            warnings.warn(
                f"GradedPml entity {e.name!r}: non-axis-aligned normal not "
                f"supported; ignoring", stacklevel=2,
            )
            continue
        ab = e.world_aabb()
        if ab is None:
            warnings.warn(
                f"GradedPml entity {e.name!r}: unbounded shape; ignoring",
                stacklevel=2,
            )
            continue
        lo = transforms.world_to_solver(ab[0].reshape(3, 1))[:, 0]
        hi = transforms.world_to_solver(ab[1].reshape(3, 1))[:, 0]
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
        sign = 1 if n_lat[axis] > 0 else -1

        # edge slab: touches the matching domain face and spans the full
        # cross-section -> boundary CPML profile
        others = [a for a in range(3) if a != axis]
        spans_cross = all(
            lo[a] <= 0.5 and hi[a] >= grid.shape[a] - 1.5 for a in others
        )
        at_edge = (lo[axis] <= 0.5) if sign > 0 else (
            hi[axis] >= grid.shape[axis] - 1.5
        )
        if spans_cross and at_edge:
            cells = max(1, int(round(hi[axis] - lo[axis])))
            side = 0 if sign > 0 else 1
            thickness[axis][side] = max(thickness[axis][side], cells)
            spec = e.pml.spec
            continue

        # volumetric region (arbitrary shape / interior placement)
        if dense is not None:
            warnings.warn(
                f"GradedPml entity {e.name!r}: only one volumetric PML "
                f"region per scene is supported; ignoring extras",
                stacklevel=2,
            )
            continue
        box = tuple(
            (max(0, int(np.floor(lo[a]))),
             min(grid.shape[a], int(np.ceil(hi[a])) + 1))
            for a in range(3)
        )
        if any(b1 <= b0 for b0, b1 in box):
            warnings.warn(
                f"GradedPml entity {e.name!r}: outside the simulation "
                f"volume; ignoring", stacklevel=2,
            )
            continue
        d_h, d_e = depth_from_contains(
            e.contains_world, box, axis, sign,
            to_world=transforms.solver_to_world,
        )
        dense = dense_pml_from_depth(
            axis, box, d_h, d_e, spec=e.pml.spec,
            dx=grid.resolution.spatial[axis], dt=grid.dt,
            constants=grid.constants,
        )
    cpml = (Cpml(thickness=tuple(tuple(t) for t in thickness), spec=spec)
            if spec is not None else None)
    return cpml, dense

__all__ = ["Volume", "CompiledScene", "compile_scene", "ResolvedObserver"]


@dataclasses.dataclass(frozen=True)
class Volume:
    """Simulation volume (solver/config.rs:98-171): either fixed
    (pose + half-extents) or derived from the scene AABB with a margin."""

    half_extents: Optional[Tuple[float, float, float]] = None
    pose: Isometry = Isometry()
    margin: float = 0.0

    @classmethod
    def fixed(cls, half_extents, pose: Isometry = Isometry()) -> "Volume":
        return cls(half_extents=tuple(float(v) for v in half_extents), pose=pose)

    @classmethod
    def scene_aabb(cls, margin: float = 0.0) -> "Volume":
        return cls(margin=margin)

    def resolve(self, scene: Scene) -> Tuple[np.ndarray, np.ndarray]:
        """(aabb_min, size) in world coordinates (axis-aligned; rotation of
        fixed volumes is carried separately into CoordinateTransforms)."""
        if self.half_extents is not None:
            he = np.asarray(self.half_extents, np.float64)
            c = np.asarray(self.pose.translation, np.float64)
            return (c - he, 2 * he)
        ab = scene.world_aabb(lambda e: e.material is not None or e.source is not None)
        if ab is None:
            raise ValueError("scene has no bounded entities to derive a volume from")
        mins, maxs = ab
        mins = mins - self.margin
        maxs = maxs + self.margin
        return (mins, maxs - mins)


@dataclasses.dataclass(frozen=True)
class ResolvedObserver:
    """An observer mapped onto a lattice slice plane + its probe."""

    entity: Entity
    axis: int
    index: int
    probe: SliceProbe


def _resolve_observer(
    e: Entity, transforms: CoordinateTransforms
) -> Optional[ResolvedObserver]:
    """Map an observer quad's plane normal (local +z) to the dominant lattice
    axis and its center to a plane index."""
    normal_world = e.global_pose().matrix @ np.array([0.0, 0.0, 1.0])
    # lattice axes in world space are the rows of R^T
    from .transform import _quat_to_matrix

    r = _quat_to_matrix(transforms.rotation)
    comps = np.abs(r.T @ normal_world)
    axis = int(np.argmax(comps))
    center = transforms.world_to_solver(
        np.asarray(e.global_pose().translation, np.float64).reshape(3, 1)
    )[:, 0]
    index = int(np.clip(round(center[axis]), 0, transforms.lattice_size[axis] - 1))
    component = FieldComponent.E if e.observer.field == "e" else FieldComponent.H
    return ResolvedObserver(
        entity=e, axis=axis, index=index,
        probe=SliceProbe(axis=axis, index=index, component=component),
    )


@dataclasses.dataclass(frozen=True)
class CompiledScene:
    """Everything the run loop needs, device-ready."""

    simulation: Simulation
    grid: Grid
    transforms: CoordinateTransforms
    matid: np.ndarray
    table: MaterialTable
    observers: Tuple[ResolvedObserver, ...]
    sources: SourceSet

    @property
    def num_materials(self) -> int:
        return len(self.table)


def compile_scene(
    scene: Scene,
    resolution: Resolution,
    *,
    constants: PhysicalConstants = SI,
    volume: Volume = Volume.scene_aabb(),
    default_material: Material = VACUUM,
    bc: BoundaryConditions = BoundaryConditions(),
    cpml: Any = None,
    dtype=torch.float32,
    memory_limit_bytes: Optional[int] = None,
    check_courant: bool = True,
    device=DEFAULT_DEVICE,
) -> CompiledScene:
    """The voxelization + setup pipeline (runner.rs:247-380); the
    Simulation lives on ``device``."""
    aabb_min, size = volume.resolve(scene)
    grid = Grid.from_domain_size(tuple(size), resolution, constants)

    if check_courant and not grid.is_courant_stable():
        # the reference only warns (runner.rs:283-291); we raise, callers can
        # pass check_courant=False to mirror the warning-only behavior
        raise ValueError(
            f"Courant number {grid.courant_number():.4f} > 1 for dt="
            f"{resolution.temporal}, dx={resolution.spatial}"
        )

    transforms = CoordinateTransforms(
        spatial=resolution.spatial,
        origin=tuple(aabb_min),
        rotation=volume.pose.rotation,
        lattice_size=grid.shape,
    )

    # memory guard (runner.rs:319-330)
    required = grid.memory_required(dtype_bytes=torch.empty((), dtype=dtype).element_size())
    if memory_limit_bytes is not None and required > memory_limit_bytes:
        raise MemoryError(
            f"simulation needs {required / 1e6:.1f} MB > limit "
            f"{memory_limit_bytes / 1e6:.1f} MB"
        )

    # scene-embedded GradedPml entities -> boundary CPML and/or a
    # volumetric per-cell region (unless the caller already supplied one)
    dense_pml = None
    if cpml is None:
        cpml, dense_pml = _cpml_from_scene_pml(scene, transforms, grid)

    matid, table = voxelize_materials(scene, transforms, default_material)
    ctable = coefficient_table(table.materials, resolution, constants)
    if len(table) == 1:
        coeffs = CellCoefficients.uniform(ctable[0], dtype, device=device)
        sim_matid = sim_table = None
    else:
        # compressed form only: the CUDA kernels stream the 1 B/cell
        # index; the plain path gathers dense coefficients once
        # (Simulation._dense_coeffs)
        coeffs = None
        sim_matid, sim_table = matid, ctable

    # sources: posed entities -> nearest lattice cell (runner.rs:820-869)
    point_sources: List[PointSource] = []
    for e in scene.sources():
        cell = transforms.world_point_to_lattice(e.global_pose().translation)
        if cell is None:
            # the reference silently drops these (world_point_to_lattice
            # None-filter); a dropped feed is a debugging trap, so warn
            import warnings

            warnings.warn(
                f"source entity {e.name!r} at {e.pose.translation} lies "
                f"outside the simulation volume and was dropped",
                stacklevel=2,
            )
            continue
        point_sources.append(
            PointSource(cell, e.source.waveform, j=e.source.j, m=e.source.m)
        )
    sources = SourceSet.build(point_sources, dtype=dtype, device=device)

    observers = tuple(
        o
        for o in (_resolve_observer(e, transforms) for e in scene.observers())
        if o is not None
    )

    sim = Simulation(
        grid=grid, coeffs=coeffs, sources=sources, bc=bc, dtype=dtype,
        cpml=cpml, dense_pml=dense_pml, matid=sim_matid, table=sim_table,
        device=device,
    )
    return CompiledScene(
        simulation=sim,
        grid=grid,
        transforms=transforms,
        matid=matid,
        table=table,
        observers=observers,
        sources=sources,
    )
