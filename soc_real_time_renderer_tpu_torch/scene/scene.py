"""Scene: the entity registry + per-frame update (host numpy).

Counterpart of the JAX package's ``scene/scene.py``
(``scene.{hpp,cpp}`` without EnTT): ``create_entity`` attaches UUID +
Tag + Relationship; ``update(dt)`` recomputes dirty TRS matrices and
gathers point/spot lights into the fixed 128-slot arrays (spot
direction = (0,-1,0) rotated by the entity's Euler rotation, cutoffs
stored as cosines); ``transform_matrices`` stacks the (E, 4, 4) model
and normal matrices of the mesh entities.  The returned
:class:`LightArrays` holds numpy leaves; ``ShaderGlobals.create`` moves
them to the frame's device.
"""
from __future__ import annotations

import numpy as np

from ..config import MAX_POINT_LIGHTS, MAX_SPOT_LIGHTS, LightArrays
from ..utils import mathutil as mu
from .components import (MeshComponent, PointLightComponent,
                         RelationshipComponent, SpotLightComponent,
                         TagComponent, TransformComponent, UUIDComponent)
from .entity import Entity


class Scene:
    def __init__(self, name: str = "scene"):
        self.name = name
        self._components: dict[int, dict] = {}
        self._next_id = 1

    def create_entity(self, name: str = "entity") -> Entity:
        eid = self._next_id
        self._next_id += 1
        self._components[eid] = {}
        e = Entity(eid, self)
        e.add_component(UUIDComponent())
        e.add_component(TagComponent(tag=name))
        e.add_component(RelationshipComponent())
        return e

    def destroy_entity(self, entity: Entity):
        self._components.pop(entity.eid, None)

    def iterate(self, fn):
        for eid in list(self._components):
            fn(Entity(eid, self))

    def entities(self):
        return [Entity(eid, self) for eid in self._components]

    def update(self, delta_time: float) -> LightArrays:
        """Recompute transforms; gather lights (scene.cpp:47-118) over
        entities that also have a transform."""
        lights = {"pp": [], "pc": [], "pi": [],
                  "sp": [], "sd": [], "sc": [], "si": [], "sco": [], "soco": []}

        def visit(entity: Entity):
            has_t = entity.has_component(TransformComponent)
            if has_t:
                entity.get_component(TransformComponent).update()
            if has_t and entity.has_component(PointLightComponent):
                lc = entity.get_component(PointLightComponent)
                tc = entity.get_component(TransformComponent)
                lights["pp"].append(tc.position)
                lights["pc"].append(lc.color)
                lights["pi"].append(lc.intensity)
            if has_t and entity.has_component(SpotLightComponent):
                lc = entity.get_component(SpotLightComponent)
                tc = entity.get_component(TransformComponent)
                d = np.array([0.0, -1.0, 0.0], np.float32)
                d = mu.rotate_x(d, np.radians(tc.rotation[0]))
                d = mu.rotate_y(d, np.radians(tc.rotation[1]))
                d = mu.rotate_z(d, np.radians(tc.rotation[2]))
                lights["sp"].append(tc.position)
                lights["sd"].append(d)
                lights["sc"].append(lc.color)
                lights["si"].append(lc.intensity)
                lights["sco"].append(np.cos(np.radians(lc.cut_off)))
                lights["soco"].append(np.cos(np.radians(lc.outer_cut_off)))

        self.iterate(visit)

        def pack(rows, n, dim):
            out = np.zeros((n, dim) if dim > 1 else (n,), np.float32)
            for i, r in enumerate(rows[:n]):
                out[i] = r
            return out

        return LightArrays(
            point_position=pack(lights["pp"], MAX_POINT_LIGHTS, 3),
            point_color=pack(lights["pc"], MAX_POINT_LIGHTS, 3),
            point_intensity=pack(lights["pi"], MAX_POINT_LIGHTS, 1),
            point_count=np.int32(min(len(lights["pp"]), MAX_POINT_LIGHTS)),
            spot_position=pack(lights["sp"], MAX_SPOT_LIGHTS, 3),
            spot_direction=pack(lights["sd"], MAX_SPOT_LIGHTS, 3),
            spot_color=pack(lights["sc"], MAX_SPOT_LIGHTS, 3),
            spot_intensity=pack(lights["si"], MAX_SPOT_LIGHTS, 1),
            spot_cut_off=pack(lights["sco"], MAX_SPOT_LIGHTS, 1),
            spot_outer_cut_off=pack(lights["soco"], MAX_SPOT_LIGHTS, 1),
            spot_count=np.int32(min(len(lights["sp"]), MAX_SPOT_LIGHTS)),
        )

    def mesh_entities(self):
        """Entities with Transform + a loaded Mesh, in creation order (1:1
        with build_scene_batch's model list)."""
        return [Entity(eid, self) for eid, comps in self._components.items()
                if MeshComponent in comps and TransformComponent in comps
                and comps[MeshComponent].model is not None]

    def transform_matrices(self):
        """Stacked (E, 4, 4) model + normal matrices of the mesh
        entities (numpy float32)."""
        ms, ns = [], []
        for e in self.mesh_entities():
            tc = e.get_component(TransformComponent)
            tc.update()
            ms.append(tc.model_matrix)
            ns.append(tc.normal_matrix)
        if not ms:
            return (np.zeros((0, 4, 4), np.float32),) * 2
        return np.stack(ms), np.stack(ns)
