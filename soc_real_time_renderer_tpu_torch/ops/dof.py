"""Depth of field (off by default, as in the reference), counterpart of
the JAX package's ``ops/dof.py`` (``depth_of_field.inl:159-202``): a
circle of confusion from aperture / focal_length / plane_in_focus,
sampled as four axis-offset ``textureGrad`` taps from a mip chain of the
colour image (the reference's BlitImageToImage + MipMapping tasks become
:func:`build_mips_device`).  ``RenderConfig.enable_depth_of_field``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import sampling
from ..utils import views


def build_mips_device(color):
    """Mip chain of (..., H, W) by 2x2 mean down to a 1-texel side (odd
    sizes drop their last row / column); whatever leads the last two
    axes (channels, views) is one axis of the (C, h, w) chain."""
    lead = color.shape[:-2]
    levels = [color.reshape(-1, *color.shape[-2:])]
    while min(levels[-1].shape[1:]) > 1:
        c, h, w = levels[-1].shape
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        x = levels[-1][:, :h2 * 2, :w2 * 2]
        levels.append(x.reshape(c, h2, 2, w2, 2).mean(dim=(2, 4)))
    return [lv.reshape(*lead, *lv.shape[1:]) for lv in levels]


def _sample_mip(levels, uv, lod, nv: int):
    """Trilinear sample across the mip list of (*V, 3, h, w) levels; uv
    planar (2, 1 x nv, H, W), lod (*V, H, W).  Returns (3, *V, H, W)."""
    n = len(levels)
    lod = torch.clamp(lod, 0.0, n - 1.0)
    l0 = torch.floor(lod).to(torch.int32)
    f = (lod - l0.to(torch.float32))[None]
    l1 = torch.clamp(l0 + 1, max=n - 1)
    out0 = torch.zeros((3,) + lod.shape, dtype=torch.float32,
                       device=uv.device)
    out1 = torch.zeros_like(out0)
    for k in range(n):
        s = sampling.sample_screen(levels[k], uv, views=nv > 0)
        out0 = torch.where((l0 == k)[None], s, out0)
        out1 = torch.where((l1 == k)[None], s, out1)
    return out0 * (1 - f) + out1 * f


def depth_of_field(color, depth, g):
    """color: (*V, 3, H, W); depth: (*V, H, W); g one frame's globals, or
    batched ones for a leading view axis (*V): each view's CoC from its
    own clip planes, focus and aperture, its taps from its own mip
    chain.  Returns (*V, 3, H, W)."""
    V = depth.shape[:-2]
    nv = len(V)
    H, W = depth.shape[-2:]
    uv = views.column(sampling.grid_uv(H, W, depth.device), nv)
    gp = views.planar(g, 2)

    far, near = gp.camera_far_clip, gp.camera_near_clip
    obj = -far * near / (depth * (far - near) - far)
    num = gp.focal_length * (obj - gp.plane_in_focus)
    den = obj * (gp.plane_in_focus - gp.focal_length)
    den = torch.where(den != 0, den, 1e-6)
    coc = torch.abs(gp.aperture * num / den)
    max_num = gp.focal_length * (far - gp.plane_in_focus)
    max_coc = torch.abs(gp.aperture * max_num / den)
    coc = coc / torch.clamp(max_coc, min=1e-6)

    # textureGrad with ddx = ddy = (coc, coc) in uv units
    # (depth_of_field.inl:191-194): rho = coc * sqrt(W^2 + H^2) texels,
    # lambda = log2(rho)
    lod = torch.log2(torch.clamp(coc * float(math.hypot(W, H)), min=1e-6))
    levels = build_mips_device(color)

    def offs(dx, dy):
        return torch.stack([uv[0] + dx, uv[1] + dy])

    # 1 / W and 1 / H rounded to f32 first, as the reference's constants
    dx, dy = float(np.float32(1.0 / W)), float(np.float32(1.0 / H))
    acc = (_sample_mip(levels, offs(dx, 0.0), lod, nv)
           + _sample_mip(levels, offs(-dx, 0.0), lod, nv)
           + _sample_mip(levels, offs(0.0, dy), lod, nv)
           + _sample_mip(levels, offs(0.0, -dy), lod, nv)) * 0.25
    # the sky branch samples colour at the pixel centre: the identity
    return views.from_planar(
        torch.where((depth < 1.0)[None], acc, views.to_planar(color, nv)),
        nv)


def display_attachment(image, out_h, out_w):
    """Debug pass (display_attachment.inl:67-91): nearest-blit any
    intermediate to the output size."""
    if image.dim() == 2:
        image = image[None]
    uv = sampling.grid_uv(out_h, out_w, image.device)
    return sampling.sample_screen(image, uv, method="nearest")
