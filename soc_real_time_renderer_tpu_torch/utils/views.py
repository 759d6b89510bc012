"""The view axis in planar code.

A frame of B views carries every per-view array with a leading view
axis: images (B, C, H, W), depth (B, H, W), ShaderGlobals leaves (B, ...)
(``parallel/mesh.batched_globals``).  Planar code keeps its components
on the LEADING axis (utils/vec.py), so inside an op an image is moved to
(C, B, H, W) and a per-pixel value is (B, H, W): the view axis is then
one more pixel axis, and a per-view value broadcasts against it once it
is shaped (B, 1, 1).  One frame's arrays have no view axis and pass
through unchanged, so the same code serves both.

:func:`planar` gives a ShaderGlobals in that shape: a leaf (*V, *C)
(*V the view axis or none, *C its own components) reads as (*C, *V, 1,
..., 1) with `rank` trailing ones, the number of pixel axes of the
arrays it meets.  ``planar(g, 2).camera.view[0, 1]`` is then a (B, 1, 1)
(or (1, 1)) factor for a (B, h, w) (or (h, w)) plane, and
``planar(g, 1).camera.position`` a (3, B, 1) (or (3, 1)) column for
(3, B, P) points.
"""
from __future__ import annotations

import dataclasses

import torch


def leaf(x, nv: int, rank: int):
    """(*V, *C) with nv view axes -> (*C, *V, 1 x rank)."""
    if nv:
        x = x.movedim(tuple(range(nv)), tuple(range(x.dim() - nv, x.dim())))
    return x.reshape(x.shape + (1,) * rank)


def mat(m, rank: int):
    """A (4, 4) or (*V, 4, 4) matrix -> (4, 4, *V, 1 x rank): m[i, j]
    then broadcasts against (*V, *pixels) arrays of `rank` pixel axes."""
    return leaf(m, m.dim() - 2, rank)


def column(x, nv: int):
    """A shared planar array (C, *pixels) -> (C, 1 x nv, *pixels), so
    that it broadcasts against (C, *V, *pixels) arrays of nv view axes
    (it would otherwise align its C with the view axis)."""
    return x.reshape(x.shape[:1] + (1,) * nv + x.shape[1:])


def to_planar(img, nv: int):
    """(*V, C, ...) -> (C, *V, ...)."""
    return img.movedim(nv, 0) if nv else img


def from_planar(img, nv: int):
    """(C, *V, ...) -> (*V, C, ...)."""
    return img.movedim(0, nv) if nv else img


class _Planar:
    """Read-only view of a dataclass tree whose tensor leaves read in
    planar shape (see :func:`planar`); each leaf is shaped at its first
    read and kept."""

    def __init__(self, obj, nv: int, rank: int):
        self._obj, self._nv, self._rank = obj, nv, rank

    def __getattr__(self, name):          # called for unread names only
        v = getattr(self._obj, name)
        if dataclasses.is_dataclass(v):
            v = _Planar(v, self._nv, self._rank)
        elif isinstance(v, torch.Tensor):
            v = leaf(v, self._nv, self._rank)
        setattr(self, name, v)
        return v


def planar(g, rank: int):
    """ShaderGlobals `g` (one frame's, or batched) with every leaf read
    as (*C, *V, 1 x rank)."""
    return _Planar(g, g.frame_counter.dim(), rank)
