"""Temporal anti-aliasing, counterpart of the JAX package's ``ops/taa.py``
in its exact form (``taa(impl="xla")``, ``temporal_antialiasing.inl:
120-199``): 3x3 neighbourhood with Gaussian blur and min/max AABB,
closest-depth velocity dilation, history reprojection at
``uv - velocity`` with AABB clamping, blend ``accum = min(0.1,
frame_counter)`` (1.0 when the reprojected uv is off-screen), and the
velocity-disocclusion fallback to the blurred colour.  The reference's
``color = neighbors[5]`` off-by-one (the (x=+1, y=0) texel) is kept.

On the card the whole resolve is one launch of ``taa_resolve_kernel``
(``kernels/csrc/taa.cu``): the 3x3 pass, the history fetch and the blend
fused, the frame counter read on the card.  Its plain version is
:func:`neighbourhood` + :func:`reproject_plain` + the blend
(``_resolve_plain``), which the CPU runs.  The history fetch alone is
kernel K3 (:func:`reproject_history`), which replaces the TPU's windowed
``_taa_kernel`` (ops/taa_pallas.py); the fused kernel calls the same
device functions.  Every array may carry a leading view axis (B, ...):
the neighbourhood is per view, and one launch resolves every view.

Row bands (``taa(..., shard=(mesh, axis))``, the row split of one frame
over a mesh): each band's colour, depth and velocity come with a 1-row
halo, and its resolve fetches from the whole previous colour and
velocity, gathered to the band's device, at the band's screen rows
(``row0`` / ``full_h``, the JAX kernel's, taa_pallas.py:44-64), clamping
at the screen's edges: each band equals the unsplit frame's rows.
"""
from __future__ import annotations

import torch

from . import sampling
from ..kernels import build as kb
from ..parallel import halo
from ..utils import views

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


def reproject_history(history, velocity, impl: str | None = None,
                      row0: int = 0):
    """K3 dispatch: the CUDA kernel for CUDA tensors (history bf16), the
    plain version for CPU tensors (or impl="plain").  history
    (*V, C, H, W), velocity (*V, 2, h, W) of the screen rows [row0, row0
    + h) (h = H, row0 = 0 for the whole screen): one launch for every
    view.  Returns (*V, C, h, W) float32."""
    *V, C, H, W = history.shape
    h = velocity.shape[-2]
    if velocity.shape != (*V, 2, h, W) or len(V) > 1 or row0 < 0 \
            or row0 + h > H:
        raise ValueError(f"velocity {tuple(velocity.shape)} at row {row0} "
                         f"vs history {tuple(history.shape)}")
    if kb.choose(impl, history, velocity) == "plain":
        return reproject_plain(history, velocity, row0)
    lib = kb.library()
    if history.dtype != torch.bfloat16 or velocity.dtype != torch.float32:
        raise TypeError("reproject_history takes bf16 history and f32 "
                        "velocity")
    history = history.contiguous()
    velocity = velocity.contiguous()
    out = torch.empty((*V, C, h, W), dtype=torch.float32,
                      device=history.device)
    code = lib.taa_reproject_launch(history.data_ptr(), velocity.data_ptr(),
                                    out.data_ptr(), C, h, W,
                                    V[0] if V else 1, row0, H,
                                    kb.stream_ptr(history))
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
        impl: str | None = None, shard=None):
    """color: (3, H, W) f32; depth: (H, W); velocity: (2, H, W) f32;
    prev_color/prev_velocity: (3|2, H, W) bf16 history; frame_counter:
    () int32.  Returns resolved (3, H, W).  Each may carry a leading view
    axis (B, ...), frame_counter then (B,).

    shard: (mesh, axis) — every image is a list of row bands on the
    axis's devices (parallel/halo.py), frame_counter a tensor or its
    replicas; returns the resolved bands (see the module docstring)."""
    if shard is not None:
        return _taa_bands(shard, color, depth, velocity, prev_color,
                          prev_velocity, frame_counter, impl)
    return _resolve(color, depth, velocity, prev_color, prev_velocity,
                    frame_counter, impl=impl)


def _taa_bands(shard, color, depth, velocity, prev_color, prev_velocity,
               frame_counter, impl):
    mesh, axis = shard
    devices = mesh.band_devices(axis)
    prev_c, prev_v = halo.gather(prev_color), halo.gather(prev_velocity)
    fc = halo.replicate(frame_counter, devices)
    padded = zip(*(halo.exchange_row_halos(x, 1, 1)
                   for x in (color, depth, velocity)))
    return [_resolve(c, d, v, prev_c[dev], prev_v[dev], fc[dev], impl=impl,
                     row0=s - 1, crop=1)
            for (c, d, v), dev, s in zip(padded, devices,
                                         halo.starts_of(depth))]


def _resolve(color, depth, velocity, prev_color, prev_velocity,
             frame_counter, impl: str | None = None, row0: int = 0,
             crop: int = 0):
    """The TAA resolve of the rows of (color, depth, velocity), whose
    first row is screen row `row0`, against the previous colour and
    velocity (*V, 3|2, H, W) of the whole screen; the neighbourhood reads
    every row, the output drops `crop` rows at either end (a band's
    halo).  The fused kernel for CUDA tensors, the plain version for CPU
    tensors (or impl="plain")."""
    *V, H, W = depth.shape
    full_h = prev_color.shape[-2]
    shapes = {"color": (color, 3, H), "velocity": (velocity, 2, H),
              "prev_color": (prev_color, 3, full_h),
              "prev_velocity": (prev_velocity, 2, full_h)}
    bad = [n for n, (x, c, h) in shapes.items()
           if tuple(x.shape) != (*V, c, h, W)]
    if bad or len(V) > 1 or crop < 0 or row0 + crop < 0 \
            or row0 + H - crop > full_h:
        raise ValueError(f"taa: {bad or 'rows'} of {tuple(depth.shape)} at "
                         f"row {row0} (crop {crop}) against a "
                         f"{full_h}-row history")
    if kb.choose(impl, color, depth, velocity, prev_color,
                 prev_velocity) == "plain":
        return _resolve_plain(color, depth, velocity, prev_color,
                              prev_velocity, frame_counter, row0, crop)
    return _resolve_cuda(color, depth, velocity, prev_color, prev_velocity,
                         frame_counter, row0, crop)


def _resolve_plain(color, depth, velocity, prev_color, prev_velocity,
                   frame_counter, row0, crop):
    H, W = depth.shape[-2:]
    blurred, min_c, max_c, center, velocity_s = (
        x[..., crop:H - crop, :] for x in neighbourhood(color, depth,
                                                        velocity))
    row0, H = row0 + crop, H - 2 * crop
    full_h = prev_color.shape[-2]
    uv = sampling.grid_uv(H, W, depth.device, row0, full_h)

    accum = torch.clamp(frame_counter.to(torch.float32), max=0.1)
    accum = accum.reshape(*accum.shape, 1, 1)
    shift_u = uv[0] - velocity_s[..., 0, :, :]
    shift_v = uv[1] - velocity_s[..., 1, :, :]
    off = (shift_u < 0) | (shift_v < 0) | (shift_u > 1) | (shift_v > 1)
    accum = torch.where(off, 1.0, accum).unsqueeze(-3)

    hist = reproject_plain(torch.cat([prev_color, prev_velocity], dim=-3),
                           velocity_s, row0)
    acc_color = torch.minimum(torch.maximum(hist[..., :3, :, :], min_c),
                              max_c)
    out = center * accum + acc_color * (1.0 - accum)

    dv = hist[..., 3:5, :, :] - velocity_s
    vel_len = torch.sqrt(dv[..., 0, :, :] * dv[..., 0, :, :]
                         + dv[..., 1, :, :] * dv[..., 1, :, :])
    disocc = torch.clamp((vel_len - 0.001) * 10.0, 0.0, 1.0)
    return out + (blurred - out) * disocc.unsqueeze(-3)


def _dense(x, nv: int):
    """(x with each view's planes dense, its view stride in elements: 0
    without a view axis; the launch takes it as a C int)."""
    inner = x[0] if nv else x
    if not inner.is_contiguous():
        x = x.contiguous()
    stride = x.stride(0) if nv else 0
    if stride >= 2 ** 31:
        raise ValueError(f"a view of {inner.numel()} elements is past the "
                         f"kernel's int strides")
    return x, stride


def _resolve_cuda(color, depth, velocity, prev_color, prev_velocity,
                  frame_counter, row0, crop):
    lib = kb.library()
    if (prev_color.dtype, prev_velocity.dtype) != (torch.bfloat16,) * 2 \
            or {color.dtype, depth.dtype, velocity.dtype} != {torch.float32}:
        raise TypeError("taa takes f32 colour, depth and velocity and a "
                        "bf16 history")
    nv = depth.dim() - 2
    *V, H, W = depth.shape
    views = V[0] if V else 1
    fc = frame_counter.to(device=depth.device, dtype=torch.int32)
    if fc.numel() not in (1, views):
        raise ValueError(f"frame_counter {tuple(fc.shape)} for {views} "
                         f"views")
    fc = fc.contiguous()
    args = [_dense(x, nv) for x in (color, depth, velocity, prev_color,
                                    prev_velocity)]
    out = torch.empty((*V, 3, H - 2 * crop, W), dtype=torch.float32,
                      device=depth.device)
    code = lib.taa_resolve_launch(
        *(x.data_ptr() for x, _ in args), fc.data_ptr(), out.data_ptr(), H,
        W, crop, row0 + crop, prev_color.shape[-2], views,
        *(vs for _, vs in args), 0 if fc.numel() == 1 else 1,
        kb.stream_ptr(depth))
    kb.launches["taa_resolve"] += 1
    kb.check(code, "taa_resolve")
    return out
