"""The reference frame: plain PyTorch, the port's default pass stack.

The pass order and arguments are those of the port's
``graph/frame.render_frame`` for one view (raster, G-buffer with the
material tap, bloom, SSAO, sky LUT + lookup, composition, auto exposure,
TAA, AgX), over the frozen copies beside this file, with three
differences that make it a reference and not a second copy of the
program: the raster is :mod:`.raster`'s box test without bins or caps;
the sun's shadow map is always rendered (at ``shadow_resolution``²)
and sampled, where the port elides it when its build proved the map
empty; and the globals come from :mod:`.globals`.  The HiZ pyramids,
which no pass reads, are not built.

``control=True`` computes the frame one precision step below the
configuration's float32 (TF32 off): TF32 for matrix products, and every
pass's output, the depth test included, in bfloat16.  It is the control
that the comparison must refuse.
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
           control: bool = False) -> dict:
    """One frame from the scene's data (`scene`: tri_entity, tri_pos,
    tri_nrm, tri_uv, static_rows, atlas_packed, cloud_noise, atlas_size,
    atlas_layer_stride, atlas_n_levels, texture_filter), its globals and
    the previous frame's history.  Returns every target the comparison
    reads, and the counts that the roofline's jobs take.

    visibility: (depth, tri_id) that the passes after the raster shade
    in place of the reference raster's own (the program's, so that each
    pass is held against the reference on the same input, as the
    history is); ``tri_id`` and ``depth`` in the result stay the
    reference raster's."""
    q = _bf16 if control else (lambda x: x)
    with _tf32(control), torch.no_grad():
        return _render(cfg, scene, g, prev_color, prev_velocity,
                       prev_exposure, model_mats, normal_mats, visibility,
                       q, control)


def _render(cfg, scene, g, prev_color, prev_velocity, prev_exposure,
            model_mats, normal_mats, visibility, q, control):
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
    return out
