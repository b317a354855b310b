from .compile import CompiledScene, ResolvedObserver, Volume, compile_scene
from .scene import Entity, GradedPmlComponent, Observer, Plugin, Scene, SourceSpec
from .shapes import Ball, Cuboid, Cylinder, HalfSpace, Quad, Shape
from .transform import CoordinateTransforms, Isometry
from .voxelize import voxelize_materials

__all__ = [
    "CompiledScene",
    "ResolvedObserver",
    "Volume",
    "compile_scene",
    "Entity",
    "Plugin",
    "GradedPmlComponent",
    "Observer",
    "Scene",
    "SourceSpec",
    "Ball",
    "Cuboid",
    "Cylinder",
    "HalfSpace",
    "Quad",
    "Shape",
    "CoordinateTransforms",
    "Isometry",
    "voxelize_materials",
]
