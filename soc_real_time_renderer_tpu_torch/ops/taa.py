"""Temporal anti-aliasing, counterpart of the JAX package's ``ops/taa.py``
in its exact form (``taa(impl="xla")``, ``temporal_antialiasing.inl:
120-199``): 3x3 neighbourhood with Gaussian blur and min/max AABB,
closest-depth velocity dilation, history reprojection at
``uv - velocity`` with AABB clamping, blend ``accum = min(0.1,
frame_counter)`` (1.0 when the reprojected uv is off-screen), and the
velocity-disocclusion fallback to the blurred colour.  The reference's
``color = neighbors[5]`` off-by-one (the (x=+1, y=0) texel) is kept.

The history fetch is kernel K3 (``kernels/csrc/taa.cu``), which replaces
the TPU's windowed ``_taa_kernel`` (ops/taa_pallas.py);
:func:`reproject_plain` is the same fetch in plain PyTorch.  The 3x3
resolve around it stays plain PyTorch.  Every array may carry a leading
view axis (B, ...): the neighbourhood is per view, and one K3 launch
fetches every view's history.
"""
from __future__ import annotations

import torch

from . import sampling
from ..kernels import build as kb
from ..utils import views

GAUSS = [1 / 16, 1 / 8, 1 / 16,
         1 / 8, 1 / 4, 1 / 8,
         1 / 16, 1 / 8, 1 / 16]


def reproject_plain(history, velocity):
    """Bilinear clamp-to-edge sample of (*V, C, H, W) history (any float
    dtype, read as float32) at uv - velocity; velocity (*V, 2, H, W)
    f32.  Returns (*V, C, H, W) f32."""
    H, W = history.shape[-2:]
    nv = history.dim() - 3
    uv = sampling.grid_uv(H, W, velocity.device)
    out = sampling.sample_screen(
        history.to(torch.float32),
        torch.stack([uv[0] - velocity[..., 0, :, :],
                     uv[1] - velocity[..., 1, :, :]]), views=nv > 0)
    return views.from_planar(out, nv)


def reproject_history(history, velocity, impl: str | None = None):
    """K3 dispatch: the CUDA kernel for CUDA tensors (history bf16), the
    plain version for CPU tensors (or impl="plain").  history
    (*V, C, H, W), velocity (*V, 2, H, W): one launch for every view.
    Returns (*V, C, H, W) float32."""
    if kb.choose(impl, history, velocity) == "plain":
        return reproject_plain(history, velocity)
    lib = kb.library()
    *V, C, H, W = history.shape
    if history.dtype != torch.bfloat16 or velocity.dtype != torch.float32:
        raise TypeError("reproject_history takes bf16 history and f32 "
                        "velocity")
    if velocity.shape != (*V, 2, H, W) or len(V) > 1:
        raise ValueError(f"velocity {tuple(velocity.shape)} vs history "
                         f"{tuple(history.shape)}")
    history = history.contiguous()
    velocity = velocity.contiguous()
    out = torch.empty(history.shape, dtype=torch.float32,
                      device=history.device)
    code = lib.taa_reproject_launch(history.data_ptr(), velocity.data_ptr(),
                                    out.data_ptr(), C, H, W,
                                    V[0] if V else 1, kb.stream_ptr(history))
    kb.launches["taa_reproject"] += 1
    kb.check(code, "taa_reproject")
    return out


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


def taa(color, depth, velocity, prev_color, prev_velocity, frame_counter,
        impl: str | None = None):
    """color: (3, H, W) f32; depth: (H, W); velocity: (2, H, W) f32;
    prev_color/prev_velocity: (3|2, H, W) bf16 history; frame_counter:
    () int32.  Returns resolved (3, H, W).  Each may carry a leading view
    axis (B, ...), frame_counter then (B,)."""
    H, W = depth.shape[-2:]
    uv = sampling.grid_uv(H, W, depth.device)
    blurred, min_c, max_c, center, velocity_s = neighbourhood(
        color, depth, velocity)

    accum = torch.clamp(frame_counter.to(torch.float32), max=0.1)
    accum = accum.reshape(*accum.shape, 1, 1)
    shift_u = uv[0] - velocity_s[..., 0, :, :]
    shift_v = uv[1] - velocity_s[..., 1, :, :]
    off = (shift_u < 0) | (shift_v < 0) | (shift_u > 1) | (shift_v > 1)
    accum = torch.where(off, 1.0, accum).unsqueeze(-3)

    packed = torch.cat([prev_color, prev_velocity], dim=-3)
    hist = reproject_history(packed, velocity_s, impl=impl)
    acc_color = torch.minimum(torch.maximum(hist[..., :3, :, :], min_c),
                              max_c)
    out = center * accum + acc_color * (1.0 - accum)

    dv = hist[..., 3:5, :, :] - velocity_s
    vel_len = torch.sqrt(dv[..., 0, :, :] * dv[..., 0, :, :]
                         + dv[..., 1, :, :] * dv[..., 1, :, :])
    disocc = torch.clamp((vel_len - 0.001) * 10.0, 0.0, 1.0)
    return out + (blurred - out) * disocc.unsqueeze(-3)
