"""Deferred lighting composition, counterpart of the JAX package's
``ops/composition.py`` (``composition.inl:82-228``) with its quirks: the
sun term carries no intensity or albedo factor, local lights multiply
albedo twice, the exponential shadow factor, the force-zeroed
volumetric march behind ``enable_volumetric``, sky pixels (depth == 1)
take the clouds image.

The sun shadow is taken from the rendered depth map (the K4 shadow
view, full or through the proved crop) or, where the build proved the
map empty, against the constant 1.0; so is the volumetric march's
comparison tap (``sampling.sample_shadow_cmp`` over the full map).

The point and spot lights are K7 (``kernels/csrc/lights.cu``) on the
card, their plain version (:func:`_local_lights_plain`) on the CPU or
with ``impl="plain"``: span ``compose.lights``, counters
``light_pairs``, ``spot_light_pairs`` and ``light_pixels``
(``utils/trace``).
"""
from __future__ import annotations

import math

import torch

from . import sampling
from ..kernels import build as kb
from ..utils import trace, views
from ..utils.vec import dot3, mat_vec3, normalize3

DITHER_PATTERN = (  # composition.inl:104-108 (row = x%4, col = y%4)
    (0.0, 0.5, 0.125, 0.625),
    (0.75, 0.22, 0.875, 0.375),
    (0.1875, 0.6875, 0.0625, 0.5625),
    (0.9375, 0.4375, 0.8125, 0.3125))

HG_G = 0.7  # composition.inl:102


def view_from_depth(uv, depth, inv_projection):
    ndc_x = uv[0] * 2.0 - 1.0
    ndc_y = uv[1] * 2.0 - 1.0
    P = inv_projection
    vx = P[0, 0] * ndc_x + P[0, 1] * ndc_y + P[0, 2] * depth + P[0, 3]
    vy = P[1, 0] * ndc_x + P[1, 1] * ndc_y + P[1, 2] * depth + P[1, 3]
    vz = P[2, 0] * ndc_x + P[2, 1] * ndc_y + P[2, 2] * depth + P[2, 3]
    vw = P[3, 0] * ndc_x + P[3, 1] * ndc_y + P[3, 2] * depth + P[3, 3]
    vw = torch.where(vw != 0, vw, 1.0)
    return torch.stack([vx / vw, vy / vw, vz / vw])


def world_from_depth(uv, depth, inv_projection, inv_view):
    """composition.inl:114-122 planar: uv (2, ...), depth (...)."""
    view = view_from_depth(uv, depth, inv_projection)
    return mat_vec3(inv_view[:3, :3], view, inv_view[:3, 3])


def _henyey_greenstein(cos_theta, g=HG_G):
    return (1.0 - g * g) / (4.0 * math.pi
                            * (1.0 + g * g - 2.0 * g * cos_theta) ** 1.5)


def _project(m, v):
    """(4,4) @ points (3, P) -> ((3, P) ndc, (P,) w)."""
    x = m[0, 0] * v[0] + m[0, 1] * v[1] + m[0, 2] * v[2] + m[0, 3]
    y = m[1, 0] * v[0] + m[1, 1] * v[1] + m[1, 2] * v[2] + m[1, 3]
    z = m[2, 0] * v[0] + m[2, 1] * v[1] + m[2, 2] * v[2] + m[2, 3]
    w = m[3, 0] * v[0] + m[3, 1] * v[1] + m[3, 2] * v[2] + m[3, 3]
    ws = torch.where(w != 0, w, 1.0)
    return torch.stack([x / ws, y / ws, z / ws]), w


def _light_terms(to_l, d2, vdir, normal):
    """(light direction, diffuse + specular) of one light."""
    ldir = to_l / torch.sqrt(d2)
    half = normalize3(ldir + vdir)
    diffuse = torch.clamp(dot3(ldir, normal), min=0.0)
    nh = torch.arccos(torch.clamp(dot3(half, normal), -1.0, 1.0))
    return ldir, diffuse + torch.exp(-(nh * nh))


def _local_lights(g, albedo, normal, position, max_point: int = 128,
                  max_spot: int = 128, impl: str | None = None):
    """Point + spot lights (composition.inl:124-160) of the first
    max_point / max_spot slots: K7 for CUDA tensors; for CPU tensors (or
    impl="plain") K7's plain version, :func:`_local_lights_plain`, which
    masks each slot at or past its kind's live count.  No fallback.  g:
    the frame's globals (one frame's or batched); albedo, normal and
    position (3, *V, P).  Counts, on the host from the plan,
    ``light_pairs`` (the slots bound times the pixels, whatever K7
    skips), ``spot_light_pairs`` (the spot slots' share of them) and
    ``light_pixels``; nothing where both bounds are 0."""
    if max_point == 0 and max_spot == 0:
        return torch.zeros_like(albedo)
    with trace.span("compose.lights"):
        pixels = position[0].numel()
        trace.counters["light_pairs"] += (max_point + max_spot) * pixels
        trace.counters["spot_light_pairs"] += max_spot * pixels
        trace.counters["light_pixels"] += pixels
        if kb.choose(impl, albedo, normal, position) == "plain":
            return _local_lights_plain(views.planar(g, 1), albedo, normal,
                                       position, max_point, max_spot)
        return _local_lights_cuda(g, albedo, normal, position, max_point,
                                  max_spot)


def _local_lights_plain(g, albedo, normal, position, max_point: int,
                        max_spot: int):
    """K7's plain version: a Python loop over the point slots [0,
    max_point), then the spot slots [0, max_spot), each slot's term
    masked by its kind's live count (``count > i``), whole planes per
    op.  g: the globals in planar shape (views.planar(g, 1)); albedo,
    normal and position (3, *V, P)."""
    acc = torch.zeros_like(albedo)
    lt = g.lights
    vdir = normalize3(g.camera.position - position)

    def to_light(lp):
        to_l = lp - position
        return to_l, torch.clamp(dot3(to_l, to_l), min=1e-12)

    count = lt.point_count
    pos_, col_, inten_ = lt.point_position, lt.point_color, \
        lt.point_intensity
    for i in range(max_point):
        on = (count > i).to(torch.float32)
        to_l, d2 = to_light(pos_[i])
        _, lit = _light_terms(to_l, d2, vdir, normal)
        s = lit / d2 * inten_[i] * on
        acc = acc + albedo * (col_[i] * s[None])
    count = lt.spot_count
    pos_, col_, inten_ = lt.spot_position, lt.spot_color, lt.spot_intensity
    dir_, cut_, ocut_ = lt.spot_direction, lt.spot_cut_off, \
        lt.spot_outer_cut_off
    for i in range(max_spot):
        on = (count > i).to(torch.float32)
        cut, ocut = cut_[i], ocut_[i]
        to_l, d2 = to_light(pos_[i])
        ldir, lit = _light_terms(to_l, d2, vdir, normal)
        sd = normalize3(-dir_[i])
        theta = dot3(ldir, sd)
        eps = torch.where(cut - ocut != 0, cut - ocut, 1e-6)
        cone = torch.clamp((theta - ocut) / eps, 0.0, 1.0)
        s = lit / d2 * inten_[i] * cone * on
        acc = acc + albedo * (col_[i] * s[None])
    return acc


def _local_lights_cuda(g, albedo, normal, position, max_point: int,
                       max_spot: int):
    """K7 on the (3, *V, P) planes, which may have any channel and view
    strides (their pixels dense), against the globals' light arrays and
    live counts on the card; returns (3, *V, P)."""
    lib = kb.library()
    lt = g.lights
    nv = g.frame_counter.dim()
    *V, P = albedo.shape[1:]
    views_n = V[0] if V else 1
    leaves = {"camera.position": (g.camera.position, (3,)),
              "point_position": (lt.point_position, (128, 3)),
              "point_color": (lt.point_color, (128, 3)),
              "point_intensity": (lt.point_intensity, (128,)),
              "point_count": (lt.point_count, ()),
              "spot_position": (lt.spot_position, (128, 3)),
              "spot_direction": (lt.spot_direction, (128, 3)),
              "spot_color": (lt.spot_color, (128, 3)),
              "spot_intensity": (lt.spot_intensity, (128,)),
              "spot_cut_off": (lt.spot_cut_off, (128,)),
              "spot_outer_cut_off": (lt.spot_outer_cut_off, (128,)),
              "spot_count": (lt.spot_count, ())}
    bad = [n for n, (x, shape) in leaves.items()
           if tuple(x.shape) != (*V[:nv], *shape) or x.device != albedo.device
           or x.dtype != (torch.int32 if n.endswith("count")
                          else torch.float32)]
    planes = [x if x.stride(-1) == 1 else x.contiguous()
              for x in (albedo, normal, position)]
    if bad or len(V) != nv or nv > 1 or max(max_point, max_spot) > 128 \
            or any(x.shape != albedo.shape or x.dtype != torch.float32
                   for x in planes):
        raise ValueError(f"local lights: {bad or 'planes'} against "
                         f"{tuple(albedo.shape)} planes, {nv} view axes")
    strides = [s for x in planes for s in (x.stride(0),
                                           x.stride(1) if V else 0)]
    if max(strides) >= 2 ** 31 or 3 * albedo[0].numel() >= 2 ** 31:
        raise ValueError(f"local lights: {tuple(albedo.shape)} planes are "
                         f"past the kernel's int strides")
    leaves = [x.contiguous() for x, _ in leaves.values()]
    out = torch.empty((3, *V, P), dtype=torch.float32, device=albedo.device)
    code = lib.local_lights_launch(
        *(x.data_ptr() for x in planes), *(x.data_ptr() for x in leaves),
        out.data_ptr(), P, views_n, max_point, max_spot, nv, *strides,
        kb.stream_ptr(albedo))
    kb.check(code, "local_lights")
    kb.launches["local_lights"] += 1
    return out


def _volumetric(gp, position, uv, d, shadow_map, empty_shadow_map: bool,
                H: int, W: int):
    """The volumetric light term (composition.inl:174-196): gp the
    globals in planar shape (views.planar(g, 1)), position (3, *V, P),
    uv (2, P), depth d (*V, P), shadow_map (*V, S, S) or None with
    empty_shadow_map.  Each view marches from its own camera through its
    own sun's map.  Returns (*V, P)."""
    spv = gp.sun.projection_view
    sp, _ = _project(spv, position)
    scp, _ = _project(spv, gp.camera.position)          # (3, *V, 1)
    V = sp - scp
    step_len = torch.sqrt(torch.clamp(dot3(V, V), min=1e-12)) / 2.0
    step = normalize3(V) * step_len[None]
    xi = (uv[0] * W).to(torch.int64) % 4
    yi = (uv[1] * H).to(torch.int64) % 4
    dither = sampling.constant(DITHER_PATTERN, d.device).reshape(-1)[
        xi * 4 + yi]
    accum = torch.zeros_like(d)
    for i in range(2):  # NUM_STEPS_INT = 2
        pstep = scp + step * float(i) + dither * step
        if empty_shadow_map:
            # comparison-sample of the all-1.0 map (border 1.0 too):
            # the bilinear blend of equal tests is the test itself
            accum = accum + (pstep[2] < 1.0).to(torch.float32)
        else:
            accum = accum + sampling.sample_shadow_cmp(
                shadow_map,
                torch.stack([pstep[0] * 0.5 + 0.5, pstep[1] * 0.5 + 0.5]),
                pstep[2], views=d.dim() > 1)
    vdir = normalize3(position - gp.camera.position)
    return (accum / 2.0) * _henyey_greenstein(
        dot3(vdir, -gp.sun.direction))


def compose(g, depth, albedo, emissive, normal, ssao, shadow_map, clouds,
            *, enable_volumetric: bool = False, enable_shadow: bool = True,
            max_point_lights: int = 128, max_spot_lights: int = 128,
            empty_shadow_map: bool = False,
            shadow_crop: tuple | None = None, row0: int = 0,
            full_h: int | None = None, impl: str | None = None):
    """Full composition pass (planar).

    depth: (H, W); albedo/emissive/normal: (3, H, W); ssao: (H, W);
    shadow_map: (S, S) or None; clouds: (3, H, W) or None.
    empty_shadow_map: the sun shadow map is statically proved to be all
    1.0, so the ESM factor is taken against the constant 1.0 (exact).
    shadow_crop: the proved texel window (x0, y0, w, h) holding every
    texel below 1.0 (FramePlan.shadow_crop): the ESM tap samples the
    crop at the full-map texel coordinates shifted by the integer
    origin, and clamps at the crop edge land on the proved 1.0 ring, so
    the result is bit-identical to the full-map tap.  Returns (3, H, W)
    HDR colour.  With batched globals every array carries a leading view
    axis (B, ...): each view has its own sun, lights and shadow map,
    the volumetric term's too.  A row band: the images
    hold rows [row0, row0 + H) of a `full_h`-row screen; every pixel is
    composed at its screen uv (per pixel, no halo).  impl: the local
    lights' (see _local_lights)."""
    H, W = depth.shape[-2:]
    Hf = full_h or H
    V = depth.shape[:-2]
    nv = len(V)
    uv = sampling.grid_uv(H, W, depth.device, row0, Hf).reshape(2, -1)
    gp = views.planar(g, 1)

    def flat(img):                                  # -> (3, *V, P)
        return views.to_planar(img, nv).reshape(3, *V, -1)

    d = depth.reshape(*V, -1)
    position = world_from_depth(uv, d, gp.camera.inv_projection,
                                gp.camera.inv_view)      # (3, *V, P)
    alb = flat(albedo)
    emi = flat(emissive) * gp.emissive_bloom_strength
    nrm = flat(normal)
    occ = torch.pow(torch.clamp(ssao.reshape(*V, -1), min=0.0),
                    gp.ambient_occlussion_strength)

    # --- sun shadow (composition.inl:164-173)
    if enable_shadow and (shadow_map is not None or empty_shadow_map):
        sp, _ = _project(gp.sun.projection_view, position)
        if empty_shadow_map:
            sdepth = 1.0            # the all-1.0 map, sampled bilinearly
        elif shadow_crop is not None:
            S = shadow_map.shape[-1]
            x0, y0, cw, ch = shadow_crop
            sub = shadow_map[..., y0:y0 + ch, x0:x0 + cw]
            xy = torch.stack([(sp[0] * 0.5 + 0.5) * S - 0.5 - x0,
                              (sp[1] * 0.5 + 0.5) * S - 0.5 - y0])
            sdepth = sampling.sample_screen(sub, xy, texel_coords=True,
                                            views=nv > 0)
        else:
            suv = torch.stack([sp[0] * 0.5 + 0.5, sp[1] * 0.5 + 0.5])
            sdepth = sampling.sample_screen(shadow_map, suv, views=nv > 0)
        sun_shadow = torch.clamp(
            torch.exp(gp.sun.exponential_factor * (sp[2] - sdepth))
            ** gp.sun.darkening_factor, 0.0, 1.0)
    else:
        sun_shadow = torch.ones_like(d)

    direct_s = torch.clamp(dot3(nrm, -gp.sun.direction), min=0.0) \
        * sun_shadow
    direct = direct_s[None].expand_as(alb)
    direct = direct + _local_lights(g, alb, nrm, position, max_point_lights,
                                    max_spot_lights, impl=impl)

    # --- volumetric light (computed-then-zeroed in the reference)
    volumetric = 0.0
    if enable_volumetric and (shadow_map is not None or empty_shadow_map):
        volumetric = _volumetric(gp, position, uv, d, shadow_map,
                                 empty_shadow_map, Hf, W)[None]

    color = ((direct + gp.ambient) * alb * occ[None]
             + volumetric + emi)

    if clouds is not None:
        color = torch.where((d == 1.0)[None], flat(clouds), color)

    return views.from_planar(color.reshape(3, *V, H, W), nv)
