"""SSAO: 26-sample hemisphere occlusion + 4x4 box blur, half resolution.

Counterpart of the JAX package's ``ops/ssao.py`` with the semantics of
its exact tail ``ssao_generate`` (``ssao_generation.inl:71-217``): view
position + procedural-noise TBN from the half-res bilinear taps
(:func:`_preamble`, plain PyTorch), then per pixel 26 hemisphere taps
with the occluder point-sampled from the full-res depth, smoothstep
range check and bias, ``1 - sum / 26``.

This file is the benchmark's frozen copy of the port's plain version
(``ops/ssao.py`` with K2's plain taps, :func:`ssao_taps_plain`, and
without the row-band path): the reference that decides ``correct``.
"""
from __future__ import annotations

import math

import torch

from . import sampling
from .composition import view_from_depth
from . import views
from .vec import cross3, dot3, normalize3

KERNEL = (  # ssao_generation.inl:76-103 (26 samples)
    (0.2196607, 0.9032637, 0.2254677),
    (0.05916681, 0.2201506, 0.1430302),
    (-0.4152246, 0.1320857, 0.7036734),
    (-0.3790807, 0.1454145, 0.100605),
    (0.3149606, -0.1294581, 0.7044517),
    (-0.1108412, 0.2162839, 0.1336278),
    (0.658012, -0.4395972, 0.2919373),
    (0.5377914, 0.3112189, 0.426864),
    (-0.2752537, 0.07625949, 0.1273409),
    (-0.1915639, -0.4973421, 0.3129629),
    (-0.2634767, 0.5277923, 0.1107446),
    (0.8242752, 0.02434147, 0.06049098),
    (0.06262707, -0.2128643, 0.03671562),
    (-0.1795662, -0.3543862, 0.07924347),
    (0.06039629, 0.24629, 0.4501176),
    (-0.7786345, -0.3814852, 0.2391262),
    (0.2792919, 0.2487278, 0.05185341),
    (0.1841383, 0.1696993, 0.8936281),
    (-0.3479781, 0.4725766, 0.719685),
    (-0.1365018, -0.2513416, 0.470937),
    (0.1280388, -0.563242, 0.3419276),
    (-0.4800232, -0.1899473, 0.2398808),
    (0.6389147, 0.1191014, 0.5271206),
    (0.1932822, -0.3692099, 0.6060588),
    (-0.3465451, -0.1654651, 0.6746758),
    (0.2448421, -0.1610962, 0.1289366))


MAX_TAPS = 64        # K2's shared-memory table (kernels/csrc/ssao.cu)


def kernel_vectors(kernel_size: int, device):
    """The first `kernel_size` hemisphere vectors, (k, 3) f32 on
    `device`, made once per (size, device) (sampling.constant)."""
    if not 1 <= kernel_size <= len(KERNEL):
        raise ValueError(f"ssao kernel_size {kernel_size}: want 1 to "
                         f"{len(KERNEL)}")
    return sampling.constant(KERNEL[:kernel_size], device)


def _rand(cu, cv):
    """ssao_generation.inl:139-141 (planar components)."""
    return sampling.mod(torch.sin(cu * 12.9898 + cv * 78.233) * 43758.5453,
                        1.0)


def _noise(u, v, freq):
    """Value noise, ssao_generation.inl:143-156 (planar components)."""
    unit = 2560.0 / freq
    iu = torch.floor(u / unit)
    iv = torch.floor(v / unit)
    xu = sampling.mod(u, unit) / unit
    xv = sampling.mod(v, unit) / unit
    xu = 0.5 * (1.0 - torch.cos(math.pi * xu))
    xv = 0.5 * (1.0 - torch.cos(math.pi * xv))
    a = _rand(iu, iv)
    b = _rand(iu + 1.0, iv)
    c = _rand(iu, iv + 1.0)
    d = _rand(iu + 1.0, iv + 1.0)
    x1 = a + (b - a) * xu
    x2 = c + (d - c) * xu
    return x1 + (x2 - x1) * xv


def _preamble(depth, normal, g, row0_half: int = 0,
              full_h: int | None = None):
    """Per-half-res-pixel setup (ssao_generation.inl:174-192): view-space
    fragment position + procedural-noise TBN.  Returns
    (frag_pos, tangent, bitangent, normal_v), each (3, h, w), or
    (3, B, h, w) for depth (B, H, W), normal (B, 3, H, W) and batched
    globals.

    row0_half / full_h (the JAX ``_preamble``'s, ssao.py:70-96): depth
    and normal are the full-res rows [2 row0_half, 2 row0_half + H) of a
    `full_h`-row screen; the half-res pixels' uv, their bilinear taps
    (rows 2j and 2j + 1, inside the band) and the noise hash are in
    screen coordinates, so each pixel equals the whole screen's."""
    H, W = depth.shape[-2:]
    Hf = full_h or H
    nv = depth.dim() - 2
    h, w = H // 2, W // 2
    uv = sampling.grid_uv(h, w, depth.device, row0_half, Hf // 2)
    band = dict(row0=2 * row0_half, full_h=Hf)
    # every view taps the same points: the views ride the channel axis
    d = sampling.sample_screen(depth.reshape(-1, H, W), uv, **band).reshape(
        *depth.shape[:-2], h, w)
    n_half = views.to_planar(sampling.sample_screen(
        normal.reshape(-1, H, W), uv, **band).reshape(
            *normal.shape[:-2], h, w), nv)
    gp = views.planar(g, 2)
    frag_pos = view_from_depth(uv, d, gp.camera.inv_projection)
    n_world = normalize3(n_half)
    vm = gp.camera.view[:3, :3]
    normal_v = torch.stack([
        vm[0, 0] * n_world[0] + vm[0, 1] * n_world[1] + vm[0, 2] * n_world[2],
        vm[1, 0] * n_world[0] + vm[1, 1] * n_world[1] + vm[1, 2] * n_world[2],
        vm[2, 0] * n_world[0] + vm[2, 1] * n_world[1] + vm[2, 2] * n_world[2]])

    # random vector (ssao_generation.inl:184-192); noise_dim = full width
    rx = _noise(uv[0], uv[1], W * 2.0)
    ry = _noise(uv[0] ** 1.1, uv[1] ** 1.1,
                torch.pow(sampling.constant(W * 4.2, depth.device),
                          1.5 + uv[0] / 10.0))
    rv = normalize3(torch.stack([rx, ry, torch.zeros_like(rx)]))
    rv = views.column(rv, nv)          # (3, 1, h, w): shared by the views

    tangent = normalize3(rv - normal_v * dot3(rv, normal_v)[None])
    bitangent = cross3(tangent, normal_v)
    return frag_pos, tangent, bitangent, normal_v


def ssao_taps_plain(planes, depth, proj, inv_proj, radius, bias, kern):
    """The 26-tap loop in plain PyTorch (K2's reference).

    planes: (12, h, w) [frag_pos | tangent | bitangent | normal_v];
    depth: (H, W) full res; kern: (K, 3).  Returns (h, w).  With a
    leading view axis on planes, depth, the matrices, radius and bias:
    (B, h, w), each view tapping its own depth."""
    nviews = depth.dim() - 2
    planes = views.to_planar(planes, nviews)
    proj, inv_proj = views.mat(proj, 2), views.mat(inv_proj, 2)
    radius = views.leaf(radius, 0, 2)
    bias = views.leaf(bias, 0, 2)
    frag, tan, bit, nv = planes[0:3], planes[3:6], planes[6:9], planes[9:12]
    k = kern.reshape(*kern.shape, *(1,) * (nviews + 2))   # (K, 3, 1.., 1)
    sx = frag[0][None] + (tan[0][None] * k[:, 0] + bit[0][None] * k[:, 1]
                          + nv[0][None] * k[:, 2]) * radius
    sy = frag[1][None] + (tan[1][None] * k[:, 0] + bit[1][None] * k[:, 1]
                          + nv[1][None] * k[:, 2]) * radius
    sz = frag[2][None] + (tan[2][None] * k[:, 0] + bit[2][None] * k[:, 1]
                          + nv[2][None] * k[:, 2]) * radius
    P = proj
    ox = P[0, 0] * sx + P[0, 1] * sy + P[0, 2] * sz + P[0, 3]
    oy = P[1, 0] * sx + P[1, 1] * sy + P[1, 2] * sz + P[1, 3]
    ow = P[3, 0] * sx + P[3, 1] * sy + P[3, 2] * sz + P[3, 3]
    ows = torch.where(ow != 0, ow, 1.0)
    ou = ox / ows * 0.5 + 0.5
    ov = oy / ows * 0.5 + 0.5

    Hf, Wf = depth.shape[-2:]
    xi = sampling.index_of(ou * Wf - 0.5, Wf)
    yi = sampling.index_of(ov * Hf - 0.5, Hf)
    base = (torch.arange(depth[..., 0, 0].numel(), device=depth.device)
            * (Hf * Wf)).reshape(*depth.shape[:-2], 1, 1)
    sd = depth.reshape(-1)[(yi * Wf + xi).long() + base]     # (K, *V, h, w)

    Q = inv_proj
    nx = ou * 2.0 - 1.0
    ny = ov * 2.0 - 1.0
    vz = Q[2, 0] * nx + Q[2, 1] * ny + Q[2, 2] * sd + Q[2, 3]
    vw = Q[3, 0] * nx + Q[3, 1] * ny + Q[3, 2] * sd + Q[3, 3]
    sample_depth = vz / torch.where(vw != 0, vw, 1.0)

    denom = torch.clamp(torch.abs(frag[2][None] - sample_depth), min=1e-8)
    t = torch.clamp(radius / denom, 0.0, 1.0)
    range_check = t * t * (3.0 - 2.0 * t)
    hit = sample_depth >= sz + bias
    occ = torch.zeros_like(frag[2])
    for i in range(kern.shape[0]):       # tap order, as the kernel sums
        occ = occ + torch.where(hit[i], range_check[i], 0.0)
    return 1.0 - sampling.div(occ, float(kern.shape[0]))


def ssao_generate(depth, normal, g, kernel_size: int = 26, row0: int = 0,
                  depth_full=None):
    """depth: (*V, H, W) full res; normal: (*V, 3, H, W) world normals
    -> (*V, H/2, W/2) occlusion.

    A row band: depth and normal are the screen rows [row0, row0 + H)
    (row0 even) and depth_full the whole screen's depth, which K2's taps
    read (a tap lands anywhere on the screen); the output is the band's
    half-res rows."""
    if depth_full is None:
        depth_full = depth
    if row0 % 2:
        raise ValueError(f"an SSAO band starts at odd row {row0}")
    frag_pos, tangent, bitangent, normal_v = _preamble(
        depth, normal, g, row0 // 2, depth_full.shape[-2])
    planes = views.from_planar(
        torch.cat([frag_pos, tangent, bitangent, normal_v], dim=0),
        depth.dim() - 2)
    return ssao_taps_plain(planes, depth_full, g.camera.projection,
                           g.camera.inv_projection, g.ssao_radius,
                           g.ssao_bias, kernel_vectors(kernel_size,
                                                       depth.device))


def ssao_blur(ssao):
    """4x4 box blur, offsets [-2, 1] at own-res texel steps
    (ssao_blur.inl:91-105)."""
    acc = torch.zeros_like(ssao)
    for x in range(-2, 2):
        for y in range(-2, 2):
            acc = acc + sampling.shift(ssao, x, y)
    return acc / 16.0
