"""Entity handle over the scene registry.

Counterpart of the JAX package's ``scene/entity.py``
(``entity.hpp:27-53``): a typed handle with add/get/has/remove component
operations.
"""
from __future__ import annotations


class Entity:
    def __init__(self, eid: int, scene):
        self.eid = eid
        self.scene = scene

    def __bool__(self):
        return self.eid in self.scene._components

    def __eq__(self, other):
        return isinstance(other, Entity) and self.eid == other.eid \
            and self.scene is other.scene

    def __hash__(self):
        return hash(self.eid)

    def add_component(self, comp):
        t = type(comp)
        comps = self.scene._components[self.eid]
        if t in comps:
            raise ValueError(f"entity already has component {t.__name__}")
        comps[t] = comp
        return comp

    def get_component(self, ctype):
        return self.scene._components[self.eid][ctype]

    def has_component(self, ctype) -> bool:
        return ctype in self.scene._components.get(self.eid, {})

    def remove_component(self, ctype):
        self.scene._components[self.eid].pop(ctype, None)
