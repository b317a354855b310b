"""Scene graph: entities composing shapes with physics/observer components.

Counterpart of the reference's bevy-ECS scene (cem-scene/src/lib.rs:46-156)
reduced to what the solver pipeline actually consumes: entities carrying a
shape (collider), a pose, and components — Material (cem-solver material.rs),
Source (source.rs:99-110), GradedPml (pml.rs:11-20), Observer
(cem-app/src/solver/observer.rs:50-57). The interactive-editor components
(selection, outlines, trees) are out of scope for a TPU framework; scenes
are built in Python and compiled to device buffers.

Spatial queries (point_query / ray_cast / world AABB) are vectorized over
analytic shapes instead of going through a BVH (cem-scene/src/spatial/);
first-inserted entity wins material conflicts, a deterministic version of
the reference's "first material found" (runner.rs:616-631).

A copy of ``fdtd_tpu.scene.scene`` (NumPy only), held equal by
tests/port/test_torch_core.py. The BVH-backed queries (``bvh``,
``point_query``, ``cast_ray``) wait for the port of ``scene/bvh.py``
(ROADMAP.md, queue 1 item 8); scene compilation does not use them.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..material import Material
from ..solver.pml import GradedPmlSpec
from .shapes import Shape
from .transform import Isometry

__all__ = ["Entity", "Plugin", "Scene", "SourceSpec", "GradedPmlComponent", "Observer"]


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """Waveform + J/M amplitudes; the entity's pose places it
    (setup_sources_system, cem-app/src/solver/runner.rs:820-869)."""

    waveform: object  # GaussianPulse | ContinuousWave | Ricker | ...
    j: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    m: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class GradedPmlComponent:
    """Scene-embedded PML slab (GradedPml, cem-solver/src/fdtd/pml.rs:11-20).
    ``normal`` points from the absorber INTO the domain interior (a slab at
    the low-x edge has normal +x), matching the reference's depth ray cast
    along +normal. Prefer solver.cpml.Cpml boundary slabs for production
    runs; this exists for reference-scene parity."""

    spec: GradedPmlSpec
    normal: Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Observer:
    """Field-slice observer (cem-app/src/solver/observer.rs:50-57): a plane
    that projects a field component slice through a color map during the run.
    ``color_map`` is the reference's Matrix4 linear field->RGBA map
    (project.rs:43-68)."""

    field: str = "e"  # "e" | "h"
    color_map: Optional[Tuple[Tuple[float, ...], ...]] = None
    write_to_gif: Optional[str] = None  # path
    display_as_texture: bool = True
    half_extents: Tuple[float, float] = (1.0, 1.0)


@dataclasses.dataclass
class Entity:
    """A named bundle of components (the ECS entity analog).

    ``parent`` composes poses hierarchically (the counterpart of
    LocalTransform/GlobalTransform propagation,
    cem-scene/src/transform/systems.rs:15-80): ``pose`` is LOCAL when a
    parent is set; Scene.global_pose resolves the world pose.
    """

    name: str = ""
    shape: Optional[Shape] = None
    pose: Isometry = Isometry()
    material: Optional[Material] = None
    source: Optional[SourceSpec] = None
    pml: Optional[GradedPmlComponent] = None
    observer: Optional[Observer] = None
    parent: Optional["Entity"] = None
    # Visual (render) material, distinct from the EM `material` above —
    # the counterpart of attaching cem-render's Material component to an
    # entity (cem-render/src/material.rs:99-130). Typed loosely to keep
    # scene free of viz imports; viz.pbr.PbrMaterial is the expected type.
    visual: Optional[object] = None

    def global_pose(self) -> Isometry:
        """World pose with parent chains composed (GlobalTransform analog)."""
        if self.parent is None:
            return self.pose
        return self.parent.global_pose().compose(self.pose)

    def world_aabb(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self.shape is None:
            return None
        mins, maxs = self.shape.local_aabb()
        if not np.all(np.isfinite(mins)) or not np.all(np.isfinite(maxs)):
            return None  # unbounded (HalfSpace), tracked separately like
            # the reference's unbounded colliders (spatial/bvh.rs:38,63-75)
        corners = np.array(list(itertools.product(*zip(mins, maxs)))).T  # (3, 8)
        w = self.global_pose().apply(corners)
        return (w.min(axis=1), w.max(axis=1))

    def contains_world(self, points: np.ndarray) -> np.ndarray:
        """Vectorized world-frame containment, points (3, ...)."""
        if self.shape is None:
            return np.zeros(points.shape[1:], bool)
        return self.shape.contains(self.global_pose().inverse_apply(points))


class Plugin:
    """Scene-population plugin (counterpart of cem-scene's Plugin/
    PluginRegistry, plugin.rs:18-59, and the PopulateScene trait,
    lib.rs:152-156): ``setup(scene)`` adds entities/configuration. Plugins
    are deduplicated by type, like the reference's type-id registry."""

    def setup(self, scene: "Scene") -> None:  # pragma: no cover - interface
        raise NotImplementedError


class Scene:
    """Ordered entity container with vectorized spatial queries."""

    def __init__(self, entities: Iterable[Entity] = ()):
        self.entities: List[Entity] = list(entities)
        self._plugins: set = set()

    def add(self, entity: Entity) -> Entity:
        self.entities.append(entity)
        return entity

    def spawn(self, **kwargs) -> Entity:
        return self.add(Entity(**kwargs))

    def add_plugin(self, plugin: Plugin) -> bool:
        """Run a plugin once per type (PluginRegistry dedup, plugin.rs:26-59).
        Returns False if a plugin of this type already ran."""
        if type(plugin) in self._plugins:
            return False
        self._plugins.add(type(plugin))
        plugin.setup(self)
        return True

    # -- queries (counterpart of cem-scene/src/spatial/queries.rs) ----------

    def shaped_entities(self) -> List[Entity]:
        return [e for e in self.entities if e.shape is not None]

    def world_aabb(
        self, predicate=lambda e: True
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Union AABB of bounded entities passing ``predicate``
        (counterpart of WorldAabb, spatial/queries.rs:34-184)."""
        mins, maxs = None, None
        for e in self.entities:
            if not predicate(e):
                continue
            ab = e.world_aabb()
            if ab is None:
                continue
            mins = ab[0] if mins is None else np.minimum(mins, ab[0])
            maxs = ab[1] if maxs is None else np.maximum(maxs, ab[1])
        if mins is None:
            return None
        return (mins, maxs)

    def materials(self) -> Sequence[Entity]:
        return [e for e in self.entities if e.material is not None and e.shape is not None]

    def sources(self) -> Sequence[Entity]:
        return [e for e in self.entities if e.source is not None]

    def observers(self) -> Sequence[Entity]:
        return [e for e in self.entities if e.observer is not None]

    def pmls(self) -> Sequence[Entity]:
        return [e for e in self.entities if e.pml is not None and e.shape is not None]
