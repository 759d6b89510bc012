"""Temporal anti-aliasing, counterpart of the JAX package's ``ops/taa.py``
in its exact form (``taa(impl="xla")``, ``temporal_antialiasing.inl:
120-199``): 3x3 neighbourhood with Gaussian blur and min/max AABB,
closest-depth velocity dilation, history reprojection at
``uv - velocity`` with AABB clamping, blend ``accum = min(0.1,
frame_counter)`` (1.0 when the reprojected uv is off-screen), and the
velocity-disocclusion fallback to the blurred colour.  The reference's
``color = neighbors[5]`` off-by-one (the (x=+1, y=0) texel) is kept.

This file is the benchmark's frozen copy of the port's plain version
(``ops/taa.py`` with K3's plain history fetch, :func:`reproject_plain`,
and without the row-band path): the reference that decides ``correct``.
"""
from __future__ import annotations

import torch

from . import sampling
from . import views

GAUSS = [1 / 16, 1 / 8, 1 / 16,
         1 / 8, 1 / 4, 1 / 8,
         1 / 16, 1 / 8, 1 / 16]


def reproject_plain(history, velocity, row0: int = 0):
    """Bilinear clamp-to-edge sample of (*V, C, H, W) history (any float
    dtype, read as float32) at uv - velocity; velocity (*V, 2, h, W) f32
    of the screen rows [row0, row0 + h) (the whole screen: row0 = 0, h =
    H).  Returns (*V, C, h, W) f32."""
    H, W = history.shape[-2:]
    nv = history.dim() - 3
    uv = sampling.grid_uv(velocity.shape[-2], W, velocity.device, row0, H)
    out = sampling.sample_screen(
        history.to(torch.float32),
        torch.stack([uv[0] - velocity[..., 0, :, :],
                     uv[1] - velocity[..., 1, :, :]]), views=nv > 0)
    return views.from_planar(out, nv)


def neighbourhood(color, depth, velocity):
    """The 3x3 pass: (blurred, min_c, max_c, center, velocity_s) —
    Gaussian blur, colour AABB, the neighbors[5] quirk texel and the
    closest-depth-dilated velocity that K3 reprojects with."""
    blurred = torch.zeros_like(color)
    min_c = torch.full_like(color, 1e6)
    max_c = torch.full_like(color, -1e6)
    closest_depth = torch.ones_like(depth)
    dilate_dx = torch.zeros_like(depth)
    dilate_dy = torch.zeros_like(depth)
    center = None
    # shader loop order (y: 1..-1, x: 1..-1): "closest == depth" favours
    # the latest minimum
    for y in (1, 0, -1):
        for x in (1, 0, -1):
            index = (y + 1) * 3 + (x + 1)
            c = sampling.shift(color, x, y)
            d = sampling.shift(depth, x, y)
            upd = d <= closest_depth
            closest_depth = torch.minimum(closest_depth, d)
            dilate_dx = torch.where(upd, float(x), dilate_dx)
            dilate_dy = torch.where(upd, float(y), dilate_dy)
            min_c = torch.minimum(min_c, c)
            max_c = torch.maximum(max_c, c)
            blurred = blurred + GAUSS[index] * c
            if index == 5:
                center = c   # reference quirk (see module docstring)

    velocity_s = torch.zeros_like(velocity)
    for y in (1, 0, -1):
        for x in (1, 0, -1):
            m = (dilate_dx == float(x)) & (dilate_dy == float(y))
            velocity_s = torch.where(m.unsqueeze(-3),
                                     sampling.shift(velocity, x, y),
                                     velocity_s)
    return blurred, min_c, max_c, center, velocity_s


def taa(color, depth, velocity, prev_color, prev_velocity, frame_counter):
    """color: (3, H, W) f32; depth: (H, W); velocity: (2, H, W) f32;
    prev_color/prev_velocity: (3|2, H, W) bf16 history; frame_counter:
    () int32.  Returns resolved (3, H, W)."""
    packed = torch.cat([prev_color, prev_velocity], dim=-3)
    return _resolve(color, depth, velocity, packed, frame_counter)


def _resolve(color, depth, velocity, packed, frame_counter,
             row0: int = 0, crop: int = 0):
    """The TAA resolve of the rows of (color, depth, velocity), whose
    first row is screen row `row0`, against the packed history (*V, 5,
    H, W) of the whole screen; the neighbourhood reads every row, the
    output drops `crop` rows at either end (a band's halo)."""
    H, W = depth.shape[-2:]
    blurred, min_c, max_c, center, velocity_s = (
        x[..., crop:H - crop, :] for x in neighbourhood(color, depth,
                                                        velocity))
    row0, H = row0 + crop, H - 2 * crop
    uv = sampling.grid_uv(H, W, depth.device, row0, packed.shape[-2])

    accum = torch.clamp(frame_counter.to(torch.float32), max=0.1)
    accum = accum.reshape(*accum.shape, 1, 1)
    shift_u = uv[0] - velocity_s[..., 0, :, :]
    shift_v = uv[1] - velocity_s[..., 1, :, :]
    off = (shift_u < 0) | (shift_v < 0) | (shift_u > 1) | (shift_v > 1)
    accum = torch.where(off, 1.0, accum).unsqueeze(-3)

    hist = reproject_plain(packed, velocity_s, row0)
    acc_color = torch.minimum(torch.maximum(hist[..., :3, :, :], min_c),
                              max_c)
    out = center * accum + acc_color * (1.0 - accum)

    dv = hist[..., 3:5, :, :] - velocity_s
    vel_len = torch.sqrt(dv[..., 0, :, :] * dv[..., 0, :, :]
                         + dv[..., 1, :, :] * dv[..., 1, :, :])
    disocc = torch.clamp((vel_len - 0.001) * 10.0, 0.0, 1.0)
    return out + (blurred - out) * disocc.unsqueeze(-3)
