"""The card's peaks and the least time each hand-kernel job can take.

A frozen copy of ``chip_smoke.py``'s bound arithmetic: the peaks of one
NVIDIA H100 SXM (data sheet, 700 W), the f32 operations counted per unit
of work from each kernel's source, and each job's bytes from the frame's
shapes (each input byte read once, each output byte written once).  A
job's bound is max(bytes / HBM_BPS, f32 operations / F32_OPS).  It counts
the work, whatever kernel does it, so a job fused into another kernel
keeps its count.

The jobs of one frame (:func:`frame_jobs`) are read off the reference's
own computation of that frame: the raster's covered (triangle, pixel)
pairs and boxes, the material tap's (mid, uv, lod), the sky march's
positions, and the shapes.
"""
from __future__ import annotations

import math

import torch

HBM_BPS = 3.35e12
F32_OPS = 67e12

RESOLVE_OPS = 30       # per covered (pair, pixel): 3 edge functions, 3
#                        sign tests, ez, ew, ew > 0, z = ez / ew, range, min
SSAO_OPS = 80          # per tap: sample point, projection, occluder, range
TAA_OPS_PIXEL = 10     # uv - velocity, floor, weights
TAA_OPS_CHANNEL = 9    # bilinear blend of one channel
TEX_OPS_CHANNEL = 10   # unpack 4 corners, bilinear blend, / 255
SKY_OPS_ATMOS = 3400   # atmosphere of one texel: 16 x (8 + 1) samples
SKY_OPS_DENSITY = 250  # one cloud density: 4 octaves x 2 slices x 4 taps
SKY_OPS_SAMPLE = 40    # one march sample's phase, powder, scatter terms
SSR_BYTES_PIXEL = 44   # depth 4, albedo 12, normal 12, metallic 4 in;
#                        the reflection 12 out
SSR_OPS_RAY = 127      # a ray's start, reflection and hit colour
SSR_OPS_PROBE = 80     # one iteration of the march

# the binned resolve's bins (the main view: 64x32, in groups of 2 across;
# the shadow view: 128x128): its input is the (bin, triangle) pair stream
MAIN_BINS = (64, 32, 2)
SHADOW_BINS = (128, 128, 1)


def bound_ms(nbytes, ops) -> float:
    return max(nbytes / HBM_BPS, ops / F32_OPS) * 1e3


def _cdiv(a, b):
    return -(-a // b)


def resolve_job(pairs: int, covered: int, width: int, height: int,
                bins=MAIN_BINS, ids: bool = True):
    """(bytes, ops) of the binned resolve (K1; K4 with ids=False): the
    starts table, 16 (K4: 15) f32 a pair, depth (and id) a pixel of the
    bin grid, and RESOLVE_OPS per covered (pair, pixel)."""
    bw, bh, group = bins
    bx = _cdiv(width, bw * group) * group
    by = _cdiv(height, bh)
    pix = bx * bw * by * bh
    nbytes = (bx * by + 1) * 4 + (16 if ids else 15) * pairs * 4 \
        + pix * (8 if ids else 4)
    return nbytes, covered * RESOLVE_OPS


def pair_count(bbox, valid, width: int, height: int, bins=MAIN_BINS) -> int:
    """The (bin, triangle) pairs a binned resolve reads: each valid
    triangle once per bin its pixel box touches."""
    bw, bh, group = bins
    bx_n = _cdiv(width, bw * group) * group
    by_n = _cdiv(height, bh)

    def bin_of(v, size, n):
        return torch.clamp(torch.div(v, size, rounding_mode="floor")
                           .to(torch.int64), 0, n - 1)

    x0, y0, x1, y1 = bbox
    nb = ((bin_of(x1 - 1.0, bw, bx_n) - bin_of(x0, bw, bx_n) + 1)
          * (bin_of(y1 - 1.0, bh, by_n) - bin_of(y0, bh, by_n) + 1))
    return int(torch.where(valid, nb, 0).sum())


def tap_job(pixels: int, rows: int, levels: int = 1):
    """(bytes, ops) of the material tap (K5): mid, uv, lod in, 11 f32
    out a pixel; 48 bytes a distinct atlas row; TEX_OPS_CHANNEL a channel
    a level."""
    return (pixels * (4 + 8 + 4 + 44) + rows * 48,
            pixels * 11 * TEX_OPS_CHANNEL * levels)


def tap_rows(mid, uv, lod, *, size: int, layer_stride: int, n_levels: int,
             filter_mode: str = "bilinear") -> int:
    """The distinct atlas rows the tap reads: the row arithmetic of
    sample_packed_atlas at each level it takes."""
    lodc = torch.clamp(lod, 0.0, float(n_levels - 1))
    if filter_mode == "trilinear":
        l0 = torch.floor(lodc).long()
        levels = [l0, torch.clamp(l0 + 1, max=n_levels - 1)]
    else:
        levels = [torch.round(lodc).long()]
    uvw = uv - torch.floor(uv)
    rows = []
    for lv in levels:
        s = torch.bitwise_right_shift(torch.full_like(lv, size), lv)
        off = torch.div(4 * size * size - 4 * s * s, 3, rounding_mode="floor")
        x = uvw[0] * s.float() - 0.5
        y = uvw[1] * s.float() - 0.5
        if filter_mode == "nearest":
            xi, yi = torch.round(x).long(), torch.round(y).long()
        else:
            xi, yi = torch.floor(x).long(), torch.floor(y).long()
        rows.append(mid.long() * layer_stride + off
                    + torch.remainder(yi, s) * s + torch.remainder(xi, s))
    return int(torch.unique(torch.cat(rows)).numel())


def ssao_job(h2: int, w2: int, height: int, width: int, taps: int = 26,
             planes: int = 12):
    """(bytes, ops) of the SSAO taps (K2): the half-res planes, the
    full-res depth, one f32 out a half-res pixel."""
    return ((planes * h2 * w2 + height * width + h2 * w2) * 4,
            h2 * w2 * taps * SSAO_OPS)


def taa_job(height: int, width: int, channels: int = 5):
    """(bytes, ops) of the TAA history fetch (K3): bf16 history and f32
    velocity in, f32 out."""
    hw = height * width
    return (channels * hw * 2 + 2 * hw * 4 + channels * hw * 4,
            hw * (TAA_OPS_PIXEL + channels * TAA_OPS_CHANNEL))


def sky_job(texels: int, upper: int, hits: int, noise_texels: int,
            steps: int = 24):
    """(bytes, ops) of the sky LUT over the noise texture (K6)."""
    return ((16 + noise_texels + 3 * texels) * 4,
            texels * SKY_OPS_ATMOS + upper * steps * (SKY_OPS_DENSITY
                                                      + SKY_OPS_SAMPLE)
            + hits * 10 * SKY_OPS_DENSITY)


def ssr_job(pixels: int, rays: int, probes: int):
    """(bytes, f32 ops) of the SSR march (T11), counted from
    ``reference/ssr.py``.

    Bytes, SSR_BYTES_PIXEL a pixel: the screen-sized reads, each once
    (depth, albedo, normal, and the metallic channel of
    metallic-roughness: the dielectric test of every pixel), and the
    reflection written.  The march's depth gathers and the hit's albedo
    gather read screens already counted: left out as cache hits (the
    depth screen is 8 MiB at 1920x1088, the L2 50 MB).

    Operations (floating point; the taps' integer index arithmetic is
    left out), SSR_OPS_RAY a ray (a reflective pixel): its view-space
    position (``view_from_depth``: the ndc 4, four rows of 6, the guard
    1, three divisions 3 = 32), its view normal (3x3 product 15,
    ``normalize3`` 11 = 26), the reflected ray (``dot3`` 5, scale 1,
    3 products and 3 differences, ``normalize3`` 11 = 23), the first
    step and point (6), and the hit's bilinear albedo (40: a bilinear
    tap is coordinates 4, floors 2, fractions 4, the weights'
    complements 3 and 9 a channel).  SSR_OPS_PROBE an iteration up to
    and including the hit (a march that stops at its hit does no more):
    the projection's x, y and w rows (18), the guard 1 and the uv (6),
    the bilinear depth tap (one channel: 22), the surface's view z (the
    ndc 4, the z and w rows 12, the guard and the division 2 = 18),
    delta (3), the hit test (2), the sign (1), the step halved or grown
    (3) and the point moved (6)."""
    return (pixels * SSR_BYTES_PIXEL,
            rays * SSR_OPS_RAY + probes * SSR_OPS_PROBE)


def sky_counts(clouds, g, noise, lut_w: int = 256, lut_h: int = 128,
               steps: int = 24):
    """(LUT texels, texels above the horizon, march samples above it that
    hold cloud) of the noise-texture sky LUT for globals `g`, by the
    reference march's positions (`clouds`: the reference's module)."""
    dev = noise.device
    az = ((torch.arange(lut_w, dtype=torch.float32, device=dev) + 0.5)
          / lut_w * 2.0 * math.pi - math.pi)
    el = ((torch.arange(lut_h, dtype=torch.float32, device=dev) + 0.5)
          / lut_h * math.pi - math.pi / 2)
    ce, se = torch.cos(el)[:, None], torch.sin(el)[:, None]
    shape = (lut_h, lut_w)
    ray = torch.stack([(ce * torch.cos(az)[None]).expand(shape),
                       se.expand(shape),
                       (ce * torch.sin(az)[None]).expand(shape)], -1)
    up = clouds._vec([0.0, clouds.EARTH_RADIUS, 0.0], dev)
    _, bottom = clouds._rsi(up, ray, clouds.EARTH_RADIUS + clouds.CLOUD_MIN)
    _, top = clouds._rsi(up, ray, clouds.EARTH_RADIUS + clouds.CLOUD_MAX)
    start = ray * bottom[..., None]
    inc = (ray * top[..., None] - start) / steps
    ii = torch.arange(steps, dtype=torch.float32, device=dev)
    cpos = start + inc * 0.5 + inc * ii.reshape(-1, 1, 1, 1)
    od = clouds._get_clouds(cpos, g.camera.position, g.elapsed_time, noise)
    upper = ray[..., 1] >= 0.0
    return (lut_w * lut_h, int(upper.sum()),
            int(((od > 0.0) & upper[None]).sum()))


def frame_jobs(cfg, scene, g, ref, clouds) -> dict:
    """{job: bound ms} of one frame of the default pass stack, from the
    reference's computation of it (`ref`: reference.frame.render's
    output; `clouds`: the reference's clouds module).  The shadow view's
    depth resolve is not paid where every texel of its map is the clear
    1.0 (the port's build proves that and elides it).  The SSR march's
    job, ``ssr_march``, exists only where ``cfg.enable_ssr``: from the
    pixels, rays and probes of the reference's march."""
    H, W = cfg.height, cfg.width
    counts = ref["counts"]
    setup = counts["setup"]
    jobs = {"resolve": bound_ms(*resolve_job(
        pair_count(setup.bbox, setup.valid, W, H), counts["covered"], W, H))}
    if counts.get("shadow_covered"):
        S = cfg.shadow_resolution
        ss = counts["shadow_setup"]
        jobs["resolve_depth"] = bound_ms(*resolve_job(
            pair_count(ss.bbox, ss.valid, S, S, SHADOW_BINS),
            counts["shadow_covered"], S, S, SHADOW_BINS, ids=False))
    taps = counts["taps"]
    if taps and scene.texture_filter != "none":
        rows = tap_rows(taps["mid"], taps["uv"], taps["lod"],
                        size=scene.atlas_size,
                        layer_stride=scene.atlas_layer_stride,
                        n_levels=scene.atlas_n_levels,
                        filter_mode=scene.texture_filter)
        levels = 2 if scene.texture_filter == "trilinear" else 1
        jobs["texsample"] = bound_ms(*tap_job(taps["mid"].numel(), rows,
                                              levels))
    if cfg.enable_ssao:
        jobs["ssao_taps"] = bound_ms(*ssao_job(
            H // 2, W // 2, H, W, cfg.ssao_kernel_size))
    noise = scene.cloud_noise
    if cfg.enable_clouds and noise is not None \
            and cfg.cloud_noise_mode == "texture":
        jobs["sky_lut"] = bound_ms(*sky_job(*sky_counts(clouds, g, noise),
                                            noise.numel()))
    if cfg.enable_ssr:
        c = counts["ssr"]
        jobs["ssr_march"] = bound_ms(*ssr_job(c["pixels"], c["rays"],
                                              c["probes"]))
    if cfg.enable_taa:
        jobs["taa_reproject"] = bound_ms(*taa_job(H, W))
    return jobs
