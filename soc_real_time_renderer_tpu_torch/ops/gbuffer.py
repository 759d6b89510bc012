"""Deferred G-buffer resolve from the visibility buffer.

Counterpart of the JAX package's ``ops/gbuffer.py``
(``g_buffer_generation.inl:152-233``) on its exact-gather path: per
pixel one shading-record fetch by triangle id, perspective-correct
barycentric interpolation with analytic derivatives, uv/lod, one packed
atlas tap, TBN normal mapping, velocity against the previous camera,
the terrain path (normal map as world normal, zero velocity) and the
sky clear on no-hit pixels.  Records are the f32 layout only.

On a card the whole resolve is one hand kernel, K9
(``kernels/csrc/gbuffer.cu``), which computes the plain version below
bit for bit and taps the atlas through K5's device code
(``texsample.cuh``); the plain version (CPU tensors, ``impl="plain"``)
taps through ``texsample.sample_atlas``, which computes
``sample_packed_atlas`` exactly.  K5 beats the gather on a
single-material atlas as well (PERF.md), so the TPU package's
material-count crossover has no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import build as kb
from ..utils import views
from ..utils.vec import cross3, normalize3
from . import sampling
from .raster2 import PlanarSetup, VisibilityBuffer

SKY_CLEAR = (0.2, 0.4, 1.0)  # g_buffer_generation.inl:80
# K9's filter modes: K5's, and the probe "none"
FILTER_MODES = {"nearest": 0, "bilinear": 1, "trilinear": 2, "none": 3}
SHADING_ROWS = 40  # rows of build_shading_records' records


@dataclass(frozen=True)
class GBuffer:
    """The reference's 5 MRT targets, planar (with a leading view axis
    *V when the frame renders several views)."""
    albedo: torch.Tensor               # (*V, 3, H, W)
    emissive: torch.Tensor             # (*V, 3, H, W)
    normal: torch.Tensor               # (*V, 3, H, W)
    metallic_roughness: torch.Tensor   # (*V, 2, H, W): R=rough, G=metal
    velocity: torch.Tensor             # (*V, 2, H, W) uv-space
    depth: torch.Tensor                # (*V, H, W)


def build_shading_records(setup: PlanarSetup, world_pos, world_nrm,
                          tri_uv, static_rows):
    """(40, *V, T+1) f32 per-triangle shading records [adj 9 | wpos 9 |
    wnrm 9 | uv 6 | material_id, has_normal, has_mr, has_emissive,
    is_terrain | 2 pad]; column T is the sentinel.  The setup's adjugate
    rows are per view (*V); the rest is the scene's, shared."""
    T = setup.adj.shape[-1]
    V = setup.adj.shape[1:-1]

    def shared(x, n):
        return x.reshape(n, *(1,) * len(V), T).expand(n, *V, T)

    rec = torch.cat([
        setup.adj,
        shared(world_pos, 9),
        shared(world_nrm, 9),
        shared(tri_uv, 6),
        shared(static_rows, 5),
        torch.zeros((2, *V, T), dtype=torch.float32,
                    device=setup.adj.device),
    ], dim=0)
    return torch.cat([rec, torch.zeros_like(rec[..., :1])], dim=-1)


def _srgb_to_linear(x):
    return torch.where(x <= 0.04045, x / 12.92,
                       ((x + 0.055) / 1.055) ** 2.4)


def sample_packed_atlas(atlas, mid, uv, lod, *, size: int,
                        layer_stride: int, n_levels: int,
                        filter_mode: str = "bilinear"):
    """Sample all 4 material textures at once from the packed (N, 12)
    int32 atlas (11 channels x 4 u32-packed bilinear corners per texel
    row).  mid: (P,) int32; uv: (2, P); lod: (P,).  Returns (11, P) f32
    in [0, 1].  level_off(l) = (4S^2 - 4(S>>l)^2)/3."""
    uvw = uv - torch.floor(uv)
    base_m = mid.to(torch.int64) * layer_stride

    def level_fetch(lv, bilinear):
        s = torch.bitwise_right_shift(
            torch.full_like(lv, size), lv).to(torch.int64)
        off = torch.div(4 * size * size - 4 * s * s, 3,
                        rounding_mode="floor")
        sf = s.to(torch.float32)
        x = uvw[0] * sf - 0.5
        y = uvw[1] * sf - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0

        def tap_idx(xi, yi):
            return base_m + off + torch.remainder(yi, s) * s \
                + torch.remainder(xi, s)

        if not bilinear:
            c = atlas[tap_idx(torch.round(x).to(torch.int64),
                              torch.round(y).to(torch.int64))][:, :11].T
            return (c & 255).to(torch.float32) / 255.0
        c = atlas[tap_idx(x0.to(torch.int64), y0.to(torch.int64))][:, :11].T
        c00 = (c & 255).to(torch.float32)
        c10 = ((c >> 8) & 255).to(torch.float32)
        c01 = ((c >> 16) & 255).to(torch.float32)
        c11 = ((c >> 24) & 255).to(torch.float32)
        return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
                + (c01 * (1 - fx) + c11 * fx) * fy) / 255.0

    lod = torch.clamp(lod, 0.0, float(n_levels - 1))
    if filter_mode == "nearest":
        return level_fetch(torch.round(lod).to(torch.int32), bilinear=False)
    if filter_mode == "bilinear":
        return level_fetch(torch.round(lod).to(torch.int32), bilinear=True)
    if filter_mode != "trilinear":
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=n_levels - 1)
    f = lod - l0.to(torch.float32)
    return level_fetch(l0, True) * (1 - f) + level_fetch(l1, True) * f


def resolve_gbuffer(vis: VisibilityBuffer, shading_records, atlas,
                    prev_view_proj, *, atlas_size: int, layer_stride: int,
                    n_levels: int, filter_mode: str = "bilinear",
                    impl: str | None = None, row0: int = 0,
                    full_h: int | None = None) -> GBuffer:
    """Shade the visibility buffer into the 5-target G-buffer.  CUDA
    tensors launch K9 (one launch for every view; the material tap is
    K5's device code), CPU tensors or impl="plain" take the plain
    version, whose tap is texsample.sample_atlas.  With a leading view
    axis (vis (B, H, W), records (40, B, T+1), prev_view_proj (B, 4, 4))
    every target gains it, and the plain version's taps of all views go
    through one sample_atlas call (the views fold into its pixel axis).

    A row band (the JAX ``resolve_gbuffer(shard=)`` band, gbuffer.py:
    340-392): vis holds rows [row0, row0 + H) of a `full_h`-row screen.
    Every pixel is shaded at its screen centre (the edge functions, the
    velocity against camera_prev), and its material tap is per pixel, so
    the band needs no halo and each pixel equals the whole screen's.

    filter_mode "none" is an attribution probe (tools/bench_toggle.py,
    the JAX gbuffer.py:176-178): a constant texel, no atlas tap; not a
    rendering mode."""
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if kb.choose(impl, vis.tri_id, shading_records, atlas,
                 prev_view_proj) == "cuda":
        return _resolve_cuda(vis, shading_records, atlas, prev_view_proj,
                             atlas_size=atlas_size,
                             layer_stride=layer_stride, n_levels=n_levels,
                             filter_mode=filter_mode, row0=row0,
                             full_h=full_h)
    H, W = vis.depth.shape[-2:]
    Hf = full_h or H
    V = vis.depth.shape[:-2]
    dev = vis.depth.device
    T = shading_records.shape[-1] - 1

    tri = vis.tri_id.reshape(*V, -1)
    miss = tri < 0
    t = torch.where(miss, T, tri).long()

    px = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :]
    py = (torch.arange(row0, row0 + H, dtype=torch.float32, device=dev)
          + 0.5)[:, None]
    px = px.expand(H, W).reshape(-1)
    py = py.expand(H, W).reshape(-1)

    rec = torch.gather(shading_records, -1,
                       t[None].expand(shading_records.shape[0], *t.shape))
    #                                                   (40, *V, P)

    # edge values + derivatives (de/dx = adj col 0, de/dy = col 1)
    e = torch.stack([rec[0] * px + rec[1] * py + rec[2],
                     rec[3] * px + rec[4] * py + rec[5],
                     rec[6] * px + rec[7] * py + rec[8]])
    ex = torch.stack([rec[0], rec[3], rec[6]])
    ey = torch.stack([rec[1], rec[4], rec[7]])
    D = e[0] + e[1] + e[2]
    Dx = ex[0] + ex[1] + ex[2]
    Dy = ey[0] + ey[1] + ey[2]
    invD = 1.0 / torch.where(D != 0, D, 1.0)

    def interp(r0, r1, r2):
        """Perspective-correct value + d/dx + d/dy of a per-vertex
        attribute."""
        N = e[0] * r0 + e[1] * r1 + e[2] * r2
        Nx = ex[0] * r0 + ex[1] * r1 + ex[2] * r2
        Ny = ey[0] * r0 + ey[1] * r1 + ey[2] * r2
        val = N * invD
        return val, (Nx - val * Dx) * invD, (Ny - val * Dy) * invD

    def interp3(base):
        vals, dxs, dys = [], [], []
        for c in range(3):
            v, dx, dy = interp(rec[base + c], rec[base + 3 + c],
                               rec[base + 6 + c])
            vals.append(v)
            dxs.append(dx)
            dys.append(dy)
        return torch.stack(vals), torch.stack(dxs), torch.stack(dys)

    pos, pos_dx, pos_dy = interp3(9)
    nrm, _, _ = interp3(18)
    uv_u, du_dx, du_dy = interp(rec[27], rec[29], rec[31])
    uv_v, dv_dx, dv_dy = interp(rec[28], rec[30], rec[32])
    uv = torch.stack([uv_u, uv_v])

    mid = torch.round(rec[33]).to(torch.int32)
    has_n = rec[34]
    has_mr = rec[35]
    has_e = rec[36]
    is_ter = rec[37]

    lod_sq = torch.maximum(du_dx ** 2 + dv_dx ** 2,
                           du_dy ** 2 + dv_dy ** 2) * (atlas_size ** 2)
    lod = 0.5 * torch.log2(torch.clamp(lod_sq, min=1e-12))

    if filter_mode == "none":
        tex = torch.full((11, *mid.shape), 0.5, device=dev)
    else:
        from .texsample import sample_atlas
        tex = sample_atlas(atlas, mid.reshape(-1), uv.reshape(2, -1),
                           lod.reshape(-1), size=atlas_size,
                           layer_stride=layer_stride, n_levels=n_levels,
                           filter_mode=filter_mode, impl=impl).reshape(
                               11, *mid.shape)            # (11, *V, P)
    albedo_t = _srgb_to_linear(tex[0:3])
    normal_t = tex[3:6]
    mr_gb = tex[6:8]
    emissive_t = _srgb_to_linear(tex[8:11])

    emissive = emissive_t * has_e
    albedo = albedo_t + emissive                       # inl:194
    mr = mr_gb * has_mr

    # normal mapping (inl:198-213)
    n = normalize3(nrm)
    tn = normal_t * 2.0 - 1.0
    tvec = normalize3(pos_dx * dv_dy - pos_dy * dv_dx)
    bvec = normalize3(cross3(n, tvec))
    mapped = normalize3(tvec * tn[0] + bvec * tn[1] + n * tn[2])
    normal = mapped * has_n + n * (1.0 - has_n)
    # terrain path: the normal map IS the world normal (decoded), no TBN
    normal = normalize3(tn) * is_ter + normal * (1.0 - is_ter)

    # velocity (inl:226-229)
    m = views.mat(prev_view_proj, 1)
    cur_u = px / W
    cur_v = py / Hf
    pc_x = m[0, 0] * pos[0] + m[0, 1] * pos[1] + m[0, 2] * pos[2] + m[0, 3]
    pc_y = m[1, 0] * pos[0] + m[1, 1] * pos[1] + m[1, 2] * pos[2] + m[1, 3]
    pc_w = m[3, 0] * pos[0] + m[3, 1] * pos[1] + m[3, 2] * pos[2] + m[3, 3]
    wsafe = torch.where(pc_w != 0, pc_w, 1.0)
    vel_u = cur_u - (pc_x / wsafe * 0.5 + 0.5)
    vel_v = cur_v - (pc_y / wsafe * 0.5 + 0.5)
    not_ter = 1.0 - is_ter                 # terrain velocity = 0 (:220)
    velocity = torch.stack([vel_u, vel_v]) * not_ter

    live = (~miss).to(torch.float32)
    sky = sampling.constant(SKY_CLEAR, dev).reshape(3, *(1,) * live.dim())
    albedo = albedo * live + sky * (1.0 - live)
    emissive = emissive * live
    normal = normal * live
    mr = mr * live
    velocity = velocity * live

    def plane(x):
        return views.from_planar(x.reshape(x.shape[0], *V, H, W), len(V))

    return GBuffer(albedo=plane(albedo), emissive=plane(emissive),
                   normal=plane(normal), metallic_roughness=plane(mr),
                   velocity=plane(velocity), depth=vis.depth)


def _resolve_cuda(vis, records, atlas, prev_view_proj, *, atlas_size,
                  layer_stride, n_levels, filter_mode, row0, full_h):
    """K9 on the card: the inputs checked and made contiguous, the five
    targets allocated planar and dense, (C, *V, H, W), and handed out as
    the plain version hands its out (views.from_planar); one launch for
    every view."""
    tri = vis.tri_id
    *V, H, W = tri.shape
    if len(V) > 1:
        raise ValueError(f"tri_id {tuple(tri.shape)}: one view axis at most")
    n_views = V[0] if V else 1
    if (tri.dtype, records.dtype, atlas.dtype, prev_view_proj.dtype) != (
            torch.int32, torch.float32, torch.int32, torch.float32):
        raise TypeError("resolve_gbuffer takes an int32 tri_id and atlas, "
                        "float32 records and prev_view_proj")
    if records.shape[:-1] != (SHADING_ROWS, *V) or atlas.dim() != 2 \
            or atlas.shape[1] != 12 \
            or prev_view_proj.shape not in ((4, 4), (*V, 4, 4)):
        raise ValueError(f"records {tuple(records.shape)}, atlas "
                         f"{tuple(atlas.shape)}, prev_view_proj "
                         f"{tuple(prev_view_proj.shape)} for tri_id "
                         f"{tuple(tri.shape)}: want ({SHADING_ROWS}, *V, "
                         f"T+1), (N, 12), (*V, 4, 4) or (4, 4)")
    if atlas.shape[0] >= 2 ** 31 // 3:
        raise ValueError("atlas rows overflow the kernel's int32 index")
    tri, records, atlas, vp = (x.contiguous() for x in (
        tri, records, atlas, prev_view_proj))
    outs = [torch.empty((c, *V, H, W), dtype=torch.float32,
                        device=tri.device) for c in (3, 3, 3, 2, 2)]
    code = kb.library().gbuffer_resolve_launch(
        tri.data_ptr(), records.data_ptr(), atlas.data_ptr(), vp.data_ptr(),
        *(o.data_ptr() for o in outs), H, W, n_views, records.shape[-1],
        row0, full_h or H, 16 if vp.dim() == 3 else 0, atlas.shape[0],
        atlas_size, layer_stride, n_levels, FILTER_MODES[filter_mode],
        kb.stream_ptr(tri))
    kb.launches["gbuffer_resolve"] += 1
    kb.check(code, "gbuffer_resolve")
    albedo, emissive, normal, mr, velocity = (
        views.from_planar(o, len(V)) for o in outs)
    return GBuffer(albedo=albedo, emissive=emissive, normal=normal,
                   metallic_roughness=mr, velocity=velocity,
                   depth=vis.depth)
