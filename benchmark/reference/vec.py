"""Planar vector math: xyz components on the LEADING axis, as in the
JAX package (so every op keeps its counterpart's operation order)."""
from __future__ import annotations

import torch


def dot3(a, b):
    """(3, ...) . (3, ...) -> (...)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def norm3(a, eps=0.0):
    return torch.sqrt(torch.clamp(dot3(a, a), min=eps))


def normalize3(a, eps=1e-8):
    return a / torch.clamp(norm3(a), min=eps)


def mat_vec3(m, v, translate=None):
    """m: (3, 3) @ v: (3, ...) (+ translate (3,)).  m and translate may
    also come in planar shape (utils/views.py: (3, 3, *V, 1, ...) and
    (3, *V, 1, ...)), one per view."""
    out = torch.stack([m[0, 0] * v[0] + m[0, 1] * v[1] + m[0, 2] * v[2],
                       m[1, 0] * v[0] + m[1, 1] * v[1] + m[1, 2] * v[2],
                       m[2, 0] * v[0] + m[2, 1] * v[1] + m[2, 2] * v[2]])
    if translate is not None:
        if translate.dim() == 1:
            translate = translate.reshape(3, *([1] * (v.dim() - 1)))
        out = out + translate
    return out
