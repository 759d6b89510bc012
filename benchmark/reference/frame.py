"""The reference frame: plain PyTorch, the port's default pass stack.

The pass order and arguments are those of the port's
``graph/frame.render_frame`` for one view (raster, G-buffer with the
material tap, bloom, SSAO, SSR where ``enable_ssr``, sky LUT + lookup,
composition with the SSR mix where ``composite_ssr``, auto exposure,
TAA, AgX), over the frozen copies beside this file, with four
differences that make it a reference and not a second copy of the
program: the raster is :mod:`.raster`'s box test without bins or caps;
the sun's shadow map is always rendered (at ``shadow_resolution``²)
and sampled, where the port elides it when its build proved the map
empty; the SSR march is :mod:`.ssr`'s dense march of every reflective
pixel, with no cap; and the globals come from :mod:`.globals`.  The
HiZ pyramids, which no pass reads, are not built.

The SSR march takes the program's G-buffer (``gbuffer``: its albedo,
normal and metallic-roughness) and depth (``visibility``), and the mix
takes the program's ``ssr`` target, as the passes after the raster take
the program's visibility and TAA its history: a ray that finds another
texel counts once, in ``ssr``, and not again in ``hdr``, ``exposure``,
``history`` and ``color``.  Without SSR neither is read.

``control=True`` computes the frame one precision step below the
configuration's float32 (TF32 off): TF32 for matrix products, and every
pass's output, the depth test included, in bfloat16.  It is the control
that the comparison must refuse.  The SSR march's inputs and its image
are rounded to bfloat16 as every other pass's output is.
"""
from __future__ import annotations

import contextlib

import torch

from . import bloom as bloom_ops
from . import clouds as clouds_ops
from . import composition as comp_ops
from . import exposure as exposure_ops
from . import gbuffer as gbuf_ops
from . import raster
from . import sampling
from . import ssao as ssao_ops
from . import ssr as ssr_ops
from . import taa as taa_ops
from . import tonemap as tonemap_ops


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


@contextlib.contextmanager
def _tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def render(cfg, scene, g, prev_color, prev_velocity, prev_exposure,
           model_mats, normal_mats, visibility=None,
           control: bool = False, gbuffer=None, ssr=None) -> dict:
    """One frame from the scene's data (`scene`: tri_entity, tri_pos,
    tri_nrm, tri_uv, static_rows, atlas_packed, cloud_noise, atlas_size,
    atlas_layer_stride, atlas_n_levels, texture_filter), its globals and
    the previous frame's history.  Returns every target the comparison
    reads, and the counts that the roofline's jobs take.

    visibility: (depth, tri_id) that the passes after the raster shade
    in place of the reference raster's own (the program's, so that each
    pass is held against the reference on the same input, as the
    history is); ``tri_id`` and ``depth`` in the result stay the
    reference raster's.

    gbuffer: {albedo, normal, metallic_roughness} that the SSR march
    reads in place of the reference's own (the program's); ssr: the
    image that the ``composite_ssr`` mix takes in place of the
    reference's own (the program's).  ``ssr`` in the result is the
    reference's march, and ``counts["ssr"]`` its pixels, rays and
    probes (:func:`.ssr.ssr`); neither exists without ``enable_ssr``."""
    q = _bf16 if control else (lambda x: x)
    with _tf32(control), torch.no_grad():
        return _render(cfg, scene, g, prev_color, prev_velocity,
                       prev_exposure, model_mats, normal_mats, visibility,
                       q, control, gbuffer, ssr)


def _render(cfg, scene, g, prev_color, prev_velocity, prev_exposure,
            model_mats, normal_mats, visibility, q, control, program_gbuf,
            program_ssr):
    H, W = cfg.height, cfg.width
    world, wnrm = raster.transform_triangles(scene, model_mats, normal_mats)
    setup = raster.triangle_setup_planar(
        raster.clip_of(world, g.camera.projection_view), W, H, "front")
    own_depth, own_tri_id, covered = raster.resolve(
        setup, W, H, quantize=_bf16 if control else None)
    depth, tri_id = visibility or (own_depth, own_tri_id)
    vis = raster.VisibilityBuffer(depth=depth, tri_id=tri_id,
                                  overflow=None)
    shadow_map, ssetup, shadow_covered = None, None, 0
    if cfg.enable_shadows:
        S = cfg.shadow_resolution
        ssetup = raster.triangle_setup_planar(
            raster.clip_of(world, g.sun.projection_view), S, S, "back")
        shadow_map, _, shadow_covered = raster.resolve(
            ssetup, S, S, quantize=_bf16 if control else None)
    records = q(gbuf_ops.build_shading_records(
        setup, world, wnrm, scene.tri_uv, scene.static_rows))

    taps = {}
    gbuf = gbuf_ops.resolve_gbuffer(
        vis, records, scene.atlas_packed, g.camera_prev.projection_view,
        atlas_size=scene.atlas_size, layer_stride=scene.atlas_layer_stride,
        n_levels=scene.atlas_n_levels, filter_mode=scene.texture_filter,
        taps=taps)
    albedo, normal = q(gbuf.albedo), q(gbuf.normal)
    mr, velocity = q(gbuf.metallic_roughness), q(gbuf.velocity)
    emissive = q(gbuf.emissive)

    out = dict(tri_id=own_tri_id, depth=own_depth, albedo=albedo,
               normal=normal,
               metallic_roughness=mr, velocity=velocity, emissive=emissive)
    bloomed = emissive
    if cfg.enable_bloom:
        bloomed = q(bloom_ops.bloom(emissive, cfg.bloom_mip_count))
        out["bloom"] = bloomed

    if cfg.enable_ssao:
        ssao = q(ssao_ops.ssao_blur(q(ssao_ops.ssao_generate(
            depth, normal, g, cfg.ssao_kernel_size))))
        out["ssao"] = ssao
        ssao_full = q(sampling.upsample_bilinear(ssao, H, W))
    else:
        ssao_full = torch.ones_like(depth)

    ssr_counts = None
    if cfg.enable_ssr:
        src = program_gbuf or dict(albedo=albedo, normal=normal,
                                   metallic_roughness=mr)
        ssr_img, ssr_counts = ssr_ops.ssr(
            q(depth), q(src["albedo"]), q(src["normal"]),
            q(src["metallic_roughness"]), g)
        out["ssr"] = q(ssr_img)

    clouds_full = None
    noise = scene.cloud_noise
    if cfg.enable_clouds:
        quadrant = dict(full_width=None if cfg.cloud_fullscreen_rays else W,
                        full_height=None if cfg.cloud_fullscreen_rays else H)
        textured = cfg.cloud_noise_mode == "texture" and noise is not None
        lut = q(clouds_ops.render_sky_lut(
            g, noise_tex=noise if textured else None))
        half = q(clouds_ops.sky_from_lut(g, lut, depth, W // 2, H // 2,
                                         **quadrant))
        out["sky_lut"], out["clouds"] = lut, half
        clouds_full = q(sampling.upsample_bilinear(half, H, W))

    hdr = q(comp_ops.compose(
        g, depth, albedo, bloomed, normal, ssao_full, shadow_map,
        clouds_full, enable_volumetric=False,
        enable_shadow=cfg.enable_shadows,
        max_point_lights=cfg.max_point_lights,
        max_spot_lights=cfg.max_spot_lights))
    if cfg.composite_ssr and cfg.enable_ssr:
        # graph/frame._ssr_mix: composition.inl:213-216's commented-out mix
        mix = out["ssr"] if program_ssr is None else program_ssr
        hdr = q(hdr + (mix - hdr) * (mr[1] * (1.0 - mr[0]))[None])
    out["hdr"] = hdr
    exposure = (exposure_ops.auto_exposure(hdr, prev_exposure, g)
                if cfg.enable_auto_exposure else prev_exposure)
    out["exposure"] = q(exposure)
    resolved = (q(taa_ops.taa(hdr, depth, velocity, prev_color,
                              prev_velocity, g.frame_counter))
                if cfg.enable_taa else hdr)
    out["history_color"] = resolved.to(torch.bfloat16)
    out["history_velocity"] = velocity.to(torch.bfloat16)
    out["color"] = q(tonemap_ops.tone_map(resolved, out["exposure"], g))
    out["counts"] = dict(covered=covered, setup=setup, taps=taps,
                         shadow_covered=shadow_covered, shadow_setup=ssetup)
    if ssr_counts is not None:
        out["counts"]["ssr"] = ssr_counts
    return out
