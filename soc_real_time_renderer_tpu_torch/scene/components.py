"""ECS components (host numpy).

Counterpart of the JAX package's ``scene/components.py``
(``components.{hpp,cpp}``): UUID, Tag, Relationship, Transform, Mesh,
PointLight and SpotLight over a plain-Python registry.  The ImGui
``draw()`` methods become ``ui_schema()`` descriptors, ``{property:
(kind, value)}``, which the viewer's scene panel (:mod:`..ui`) serves.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

import numpy as np

from ..utils import mathutil as mu


def make_uuid() -> int:
    """Random u64 (uuid.cpp:6-11: mt19937_64)."""
    return random.getrandbits(64)


@dataclass
class UUIDComponent:
    uuid: int = field(default_factory=make_uuid)


@dataclass
class TagComponent:
    tag: str = "entity"


@dataclass
class RelationshipComponent:
    parent: int | None = None          # entity id
    children: list[int] = field(default_factory=list)


@dataclass
class TransformComponent:
    """TRS -> model/normal matrices, recomputed when dirty
    (scene.cpp:51-83)."""
    position: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))  # degrees
    scale: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32))
    model_matrix: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    normal_matrix: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    is_dirty: bool = True

    def set_position(self, p):
        self.position = np.asarray(p, np.float32)
        self.is_dirty = True

    def set_rotation(self, r):
        self.rotation = np.asarray(r, np.float32)
        self.is_dirty = True

    def set_scale(self, s):
        self.scale = np.asarray(s, np.float32)
        self.is_dirty = True

    def update(self):
        if self.is_dirty:
            self.model_matrix = mu.compose_trs(self.position, self.rotation,
                                               self.scale)
            self.normal_matrix = mu.normal_matrix(self.model_matrix)
            self.is_dirty = False
            return True
        return False

    def ui_schema(self):
        return {"position": ("vec3", self.position),
                "rotation": ("vec3", self.rotation),
                "scale": ("vec3", self.scale)}


@dataclass
class MeshComponent:
    """Holds a model (models.gltf.ModelData)."""
    model: object = None

    def ui_schema(self):
        n = 0 if self.model is None else len(self.model.triangles)
        return {"triangles": ("u64", n)}


@dataclass
class PointLightComponent:
    color: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32))
    intensity: float = 16.0            # components.hpp:57

    def ui_schema(self):
        return {"color": ("color3", self.color),
                "intensity": ("f32", self.intensity)}


@dataclass
class SpotLightComponent:
    color: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32))
    intensity: float = 16.0
    cut_off: float = 20.0              # degrees (cos taken at gather,
    outer_cut_off: float = 30.0        # scene.cpp:112-113)

    def ui_schema(self):
        return {"color": ("color3", self.color),
                "intensity": ("f32", self.intensity),
                "cut_off": ("f32", self.cut_off),
                "outer_cut_off": ("f32", self.outer_cut_off)}
