"""Scene hierarchy panel.

Counterpart of the JAX package's ``ui/scene_panel.py``, the analog of
the reference's ``src/ui/editor/scene_hiearchy_panel.{hpp,cpp}`` (sic,
the reference's spelling kept): the entity tree by parent/child
relationship, selection, create/destroy entity, per-component property
editing and an add-component menu, as JSON schema + mutation commands
for the web viewer.  Stale ids, unknown types and duplicate adds are
no-ops: a browser can re-send a command before its schema refresh lands.
"""
from __future__ import annotations

import numpy as np

from ..scene.components import (MeshComponent, PointLightComponent,
                                RelationshipComponent, SpotLightComponent,
                                TagComponent, TransformComponent,
                                UUIDComponent)
from ..scene.entity import Entity
from ..scene.scene import Scene

_ADDABLE = {
    "TransformComponent": TransformComponent,
    "MeshComponent": MeshComponent,
    "PointLightComponent": PointLightComponent,
    "SpotLightComponent": SpotLightComponent,
}


class SceneHiearchyPanel:
    def __init__(self, scene: Scene, model_loader=None):
        self.scene = scene
        self.selected: int | None = None
        # called when a MeshComponent is added, so that the entity is
        # renderable at once (the reference's add-mesh workflow); None
        # leaves the model unset (the entity contributes nothing)
        self.model_loader = model_loader

    # -- queries ----------------------------------------------------------
    def tree(self):
        """Entity tree by RelationshipComponent parent/children
        (scene_hiearchy_panel.cpp:74-136)."""
        nodes = {}
        roots = []
        for e in self.scene.entities():
            rel = e.get_component(RelationshipComponent)
            tag = e.get_component(TagComponent)
            uid = e.get_component(UUIDComponent)
            nodes[e.eid] = {"id": e.eid, "uuid": str(uid.uuid),
                            "tag": tag.tag, "children": rel.children,
                            "selected": e.eid == self.selected}
            if rel.parent is None:
                roots.append(e.eid)
        return {"nodes": nodes, "roots": roots}

    def components_schema(self, eid: int):
        e = Entity(eid, self.scene)
        if not e:
            return {}
        out = {}
        comps = self.scene._components[eid]
        for ctype, comp in comps.items():
            if hasattr(comp, "ui_schema"):
                out[ctype.__name__] = comp.ui_schema()
            elif isinstance(comp, TagComponent):
                out["TagComponent"] = {"tag": ("string", comp.tag)}
            elif isinstance(comp, UUIDComponent):
                out["UUIDComponent"] = {"uuid": ("u64", comp.uuid)}
        out["_addable"] = [n for n, t in _ADDABLE.items()
                           if t not in comps]
        return out

    # -- mutations --------------------------------------------------------
    def select(self, eid: int | None):
        self.selected = eid

    def create_entity(self, name="empty entity"):
        return self.scene.create_entity(name).eid

    def destroy_entity(self, eid: int) -> bool:
        if eid not in self.scene._components:       # stale id
            return False
        self.scene.destroy_entity(Entity(eid, self.scene))
        if self.selected == eid:
            self.selected = None
        return True

    def add_component(self, eid: int, type_name: str):
        ctype = _ADDABLE.get(type_name)
        if ctype is None or eid not in self.scene._components:
            return None
        ent = Entity(eid, self.scene)
        if ent.has_component(ctype):
            return None
        comp = ent.add_component(ctype())
        if isinstance(comp, MeshComponent) and self.model_loader:
            comp.model = self.model_loader()
        return comp

    def set_property(self, eid: int, comp_name: str, prop: str, value):
        comps = self.scene._components.get(eid)
        if comps is None:       # destroyed under a concurrent editor
            return False
        for ctype, comp in comps.items():
            if ctype.__name__ != comp_name:
                continue
            if isinstance(comp, TransformComponent):
                setter = {"position": comp.set_position,
                          "rotation": comp.set_rotation,
                          "scale": comp.set_scale}.get(prop)
                if setter:
                    setter(value)
                    return True
            cur = getattr(comp, prop, None)
            if cur is not None:
                if isinstance(cur, np.ndarray):
                    setattr(comp, prop, np.asarray(value, np.float32))
                else:
                    setattr(comp, prop, type(cur)(value))
                return True
        return False
