"""The frame: ``render_frame(plan, batch, g, history, ...) -> (outputs,
history')``, counterpart of the JAX package's ``graph/frame.py``.

Pass order matches the reference graph:

  raster (visibility, K1; sun shadow, K4) -> HiZ -> G-buffer (K9) ->
  bloom -> SSAO (K2) + blur -> [SSR (K8)] -> sky LUT (K6 or K6p) + lookup, or
  the per-pixel cloud march -> composition [+ volumetric light] -> [SSR mix]
  -> [depth of field] -> exposure -> TAA (K3f) -> tone mapping

Cross-frame state rides in :class:`RenderHistory` (bf16 colour and
velocity, f32 exposure).  PyTorch runs eagerly: no jit, no
``torch.compile``; the render function of :func:`make_render_fn`
replays each pass as a CUDA graph on a card (``graph/replay.py``), and
``render_frame`` called directly is its eager reference.  The
hand-written kernels on the path: K1 (main-view resolve), K4 (the sun
shadow view's depth resolve, unless the build proved the map empty), K9
(the G-buffer resolve, its material tap K5's device code), K2 (SSAO taps), K6 (the sky LUT over the
cloud-noise texture) or K6p (the sky LUT over the procedural value
noise, where there is no texture), K7 (composition's point and spot
lights, where the plan binds any), K8 (the SSR march, where
``enable_ssr``) and K3f (the TAA resolve, K3's history fetch fused with
its 3x3 neighbourhood and blend).  The bracketed passes are off by
default (``RenderConfig.enable_ssr``, ``composite_ssr``,
``enable_depth_of_field``, ``enable_volumetric_light``,
``cloud_impl="perpixel"``); but for K8 they run as plain PyTorch.

Views: ``render_frame`` also renders B views of one scene at once
(``parallel/mesh.py``), given globals and history whose every leaf has a
leading view axis.  The geometry's world transform is then made once,
everything that reads the globals gains the view axis, each kernel
launches once for the B views, and every output and history target is
(B, ...).  The bracketed passes take the view axis too: each is one
call for the B views, as every pass is one batched operation under the
JAX package's ``vmap``.

Row bands: a plan with ``shard_mesh`` / ``shard_axis`` renders the frame
cut into row bands over the devices of that mesh axis
(``parallel/mesh.make_sharded_shade_fn``, whose docstring says how each
pass runs).  Every image of the outputs and of the history is then a
list of bands (``parallel/halo.py``), band i on the axis's device i.
"""
from __future__ import annotations

import sys
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..config import RenderConfig, ShaderGlobals, resolve_device
from ..models.scene_batch import SceneBatch
from ..ops import bloom as bloom_ops
from ..ops import clouds as clouds_ops
from ..ops import composition as comp_ops
from ..ops import dof as dof_ops
from ..ops import exposure as exposure_ops
from ..ops import gbuffer as gbuf_ops
from ..ops import hiz as hiz_ops
from ..ops import raster2
from ..ops import sampling
from ..ops import sky as sky_ops
from ..ops import ssao as ssao_ops
from ..ops import ssr as ssr_ops
from ..ops import taa as taa_ops
from ..ops import tonemap as tonemap_ops
from ..parallel import halo
from ..utils import trace
from . import replay


@dataclass(frozen=True)
class RenderHistory:
    """Cross-frame carry: resolved colour and velocity in bf16 (the
    RGBA16F history target analog), auto-exposure state in f32; with a
    leading view axis (*V) for a batch of views."""
    previous_color: torch.Tensor      # (*V, 3, H, W) bf16
    previous_velocity: torch.Tensor   # (*V, 2, H, W) bf16
    exposure: torch.Tensor            # (*V,) f32

    @staticmethod
    def create(config: RenderConfig, device=None):
        """Zeroed history on `device` (default: the CUDA card; raises
        without one unless device="cpu")."""
        device = resolve_device(device)
        h, w = config.height, config.width
        return RenderHistory(
            previous_color=torch.zeros((3, h, w), dtype=torch.bfloat16,
                                       device=device),
            previous_velocity=torch.zeros((2, h, w), dtype=torch.bfloat16,
                                          device=device),
            exposure=torch.zeros((), dtype=torch.float32, device=device),
        )


@dataclass(frozen=True)
class FramePlan:
    """Static per-scene/per-config raster grids + atlas metadata (the JAX
    FramePlan without its TPU-only knobs: tile-sampler geometry, record
    packing, attribution stubs, barriers, interpret mode).  shard_mesh /
    shard_axis: the row split of the frame over that axis of a
    parallel/mesh.Mesh (None: one device, the default)."""
    config: RenderConfig
    main_grid: raster2.BinGrid
    shadow_grid: raster2.BinGrid
    atlas_size: int
    atlas_layer_stride: int
    atlas_n_levels: int
    texture_filter: str = "bilinear"
    atlas_num_materials: int = 1
    shadow_statically_empty: bool = False
    proved_sun_pv: tuple | None = None
    shadow_crop: tuple | None = None
    proved_crop_mats: tuple | None = None
    ssr_cap: int = 0
    shard_mesh: object | None = None
    shard_axis: str | None = None

    @staticmethod
    def create(config: RenderConfig, atlas, texture_filter: str = "bilinear"):
        main = raster2.default_grid(config.width, config.height)
        shadow = raster2.default_grid(config.shadow_resolution,
                                      config.shadow_resolution,
                                      kind="shadow")
        return FramePlan(config=config, main_grid=main, shadow_grid=shadow,
                         atlas_size=atlas.size,
                         atlas_layer_stride=atlas.layer_stride,
                         atlas_n_levels=atlas.n_levels,
                         texture_filter=texture_filter,
                         atlas_num_materials=atlas.num_materials)


@dataclass(frozen=True)
class FrameOutputs:
    """All intermediate targets of one frame (each with a leading view
    axis *V when the frame renders a batch of views)."""
    color: torch.Tensor            # (*V, 3, H, W) final tonemapped [0,1]
    hdr: torch.Tensor              # (*V, 3, H, W) pre-tonemap
    gbuffer: gbuf_ops.GBuffer
    shadow_map: torch.Tensor | None  # (*V, S, S)
    ssao: torch.Tensor | None      # (*V, H/2, W/2) blurred
    clouds: torch.Tensor | None    # (*V, 3, H/2, W/2)
    bloom: torch.Tensor | None
    ssr: torch.Tensor | None
    hiz_min: list | None
    hiz_max: list | None
    overflow: torch.Tensor         # (*V,) int32 raster2.OVERFLOW_* bits
    tex_dirty: torch.Tensor        # (*V,) int32, -1: exact texture gather
    ssr_active: torch.Tensor       # (*V,) int32, -1: SSR off


def transform_triangles(batch: SceneBatch, model_mats, normal_mats):
    """World transform of the planar triangle batch: per-triangle entity
    matrices, (3 verts, 3, T) positions and normals."""
    mats = model_mats.reshape(-1, 16)[batch.tri_entity.long()].T   # (16, T)
    nmats = normal_mats.reshape(-1, 16)[batch.tri_entity.long()].T

    def apply(m16, pts, translate):
        out = []
        for v in range(3):
            p = pts[v]
            rows = []
            for i in range(3):
                r = (m16[i * 4 + 0] * p[0] + m16[i * 4 + 1] * p[1]
                     + m16[i * 4 + 2] * p[2])
                if translate:
                    r = r + m16[i * 4 + 3]
                rows.append(r)
            out.append(torch.stack(rows))
        return torch.stack(out)                         # (3, 3, T)

    return apply(mats, batch.tri_pos, True), apply(nmats, batch.tri_nrm,
                                                   False)


def _clip_of(world, view_proj):
    """world (3, 3, T) -> clip (3 verts, 4, T) planar; a (B, 4, 4)
    view_proj (one per view) gives (B, 3, 4, T)."""
    m = view_proj[..., None]                       # (*V, 4, 4, 1)
    outs = []
    for v in range(3):
        p = world[v]
        outs.append(torch.stack([
            m[..., i, 0, :] * p[0] + m[..., i, 1, :] * p[1]
            + m[..., i, 2, :] * p[2] + m[..., i, 3, :] for i in range(4)],
            dim=-2))
    return torch.stack(outs, dim=-3)


def _shard(plan: FramePlan):
    """(mesh, axis) of the plan's row split, or None."""
    if plan.shard_mesh is None or plan.shard_axis is None:
        return None
    return plan.shard_mesh, plan.shard_axis


def raster_stage(plan: FramePlan, batch: SceneBatch, g: ShaderGlobals,
                 model_mats, normal_mats, impl: str | None = None):
    """Geometry half: transform, main-view raster (K1), the sun shadow
    view (back-face culled, depth only: K4) unless the build proved its
    map empty, shading records.  Batched globals: the transform once,
    the rest per view (each view's sun too), one K1 and one K4 launch.

    With the plan's row split: setup, binning and records on the axis's
    first device (`batch` may be halo.replicate's {device: batch}), K1
    and K4 once per band of bin rows (raster2.resolve_row_sharded); the
    visibility buffer comes back cut into the shade's row bands
    (halo.band_starts), the shading records and the whole shadow map as
    {device: tensor} replicas."""
    with trace.span("frame.raster"):
        return replay.run("raster_stage", _raster,
                          (plan, batch, g, model_mats, normal_mats, impl),
                          adopt=(2, 3, 4))


def _raster(plan, batch, g, model_mats, normal_mats, impl):
    cfg = plan.config
    shard = _shard(plan)
    with replay.segment("raster.transform"):
        if shard is not None:
            devices = shard[0].band_devices(shard[1])
            lead = devices[0]
            batch = (batch[lead] if isinstance(batch, dict)
                     else halo.move(batch, lead))
            g = halo.move(g, lead)
            model_mats, normal_mats = (m.to(lead)
                                       for m in (model_mats, normal_mats))
        world, wnrm = transform_triangles(batch, model_mats, normal_mats)
        clip = _clip_of(world, g.camera.projection_view)
    with replay.segment("raster.main"):
        vis, setup = raster2.rasterize(clip, plan.main_grid, cull="front",
                                       impl=impl, shard=shard)
        if shard is not None:
            # the resolve's bands are whole bin rows: cut again into the
            # shade's
            starts = halo.band_starts(cfg.height, len(devices))
            vis = raster2.VisibilityBuffer(**{
                f: [halo.rows_of(getattr(vis, f), a, b, d)
                    for a, b, d in zip(starts, starts[1:], devices)]
                for f in ("depth", "tri_id")}, overflow=vis.overflow)
    shadow_map = None
    overflow = vis.overflow
    if cfg.enable_shadows and not plan.shadow_statically_empty:
        with replay.segment("raster.shadow"):
            with trace.span("shadow.setup"):
                sclip = _clip_of(world, g.sun.projection_view)
                binned = raster2.bin_triangles(sclip, plan.shadow_grid,
                                               cull="back", shard=shard)
            with trace.span("shadow.resolve"):
                svis = raster2.resolve_binned(binned, impl=impl,
                                              depth_only=True, shard=shard)
            trace.counters["shadow_texels"] += _shadow_texels(plan, sclip)
            # split: the ESM tap reads anywhere in the map (or its crop)
            shadow_map = (svis.depth if shard is None
                          else halo.gather(svis.depth))
            overflow = overflow | svis.overflow
    with replay.segment("raster.records"):
        records = gbuf_ops.build_shading_records(
            setup, world, wnrm, batch.tri_uv, batch.static_rows)
        if shard is not None:
            records = halo.replicate(records, devices)
    return vis, records, shadow_map, overflow


def _shadow_texels(plan: FramePlan, sclip) -> int:
    """The texels of the sun's map that the shadow view can cover, over
    its views: the proved crop's area, or the whole map without a crop
    (K4 writes the rest of the map as the 1.0 clear)."""
    views = sclip.shape[0] if sclip.dim() == 4 else 1
    if plan.shadow_crop is not None:
        return views * plan.shadow_crop[2] * plan.shadow_crop[3]
    return views * plan.config.shadow_resolution ** 2


def _ssr_mix(hdr, ssr_img, metallic_roughness):
    """The mix the reference comments out (composition.inl:213-216)."""
    rough = metallic_roughness[..., 0, :, :]
    metal = metallic_roughness[..., 1, :, :]
    return hdr + (ssr_img - hdr) * (metal * (1.0 - rough)).unsqueeze(-3)


def _cloud_args(cfg: RenderConfig, noise, stacklevel: int = 4):
    """(half width, half height, the QUADRANT quirk's full sizes) of the
    clouds pass, after warning where a texture-noise path falls back
    (stacklevel: shade_stage's caller)."""
    if cfg.cloud_noise_mode == "texture" and noise is None:
        warnings.warn(
            "cloud_noise_mode='texture' falling back to the "
            "procedural sky LUT: batch.cloud_noise is missing; "
            "cloud shapes will differ from the reference noise "
            "texture.", stacklevel=stacklevel)
    if cfg.cloud_impl == "perpixel" and noise is None:
        warnings.warn(
            "cloud_impl='perpixel' falling back to the sky-LUT "
            "path: batch.cloud_noise is missing; the exact "
            "per-pixel march needs the noise texture.",
            stacklevel=stacklevel)
    # QUADRANT quirk: pass the FULL resolution so the half-res rays and
    # sky mask span only the top-left frustum quadrant
    quadrant = dict(
        full_width=None if cfg.cloud_fullscreen_rays else cfg.width,
        full_height=None if cfg.cloud_fullscreen_rays else cfg.height)
    return cfg.width // 2, cfg.height // 2, quadrant


def _sky_lut(cfg: RenderConfig, g, noise, impl):
    """The sky LUT of the frame: K6 over the noise texture, or K6p over
    the procedural value noise."""
    return replay.run("_sky_lut", _render_sky_lut, (cfg, g, noise, impl),
                      adopt=(1,))


def _render_sky_lut(cfg: RenderConfig, g, noise, impl):
    with replay.segment("shade.sky_lut"):
        if cfg.cloud_noise_mode == "texture" and noise is not None:
            return sky_ops.render_sky_lut_noise(g, noise, impl=impl)
        return sky_ops.render_sky_lut_procedural(g, impl=impl)


def shade_stage(plan: FramePlan, batch: SceneBatch, g: ShaderGlobals,
                history: RenderHistory, vis, records, shadow_map, overflow,
                impl: str | None = None
                ) -> tuple[FrameOutputs, RenderHistory]:
    """Screen-space half of the frame.  With the plan's row split it runs
    over row bands (parallel/mesh.make_sharded_shade_fn); its inputs may
    then be raster_stage's bands and replicas or whole tensors."""
    args = (plan, batch, g, history, vis, records, shadow_map, overflow,
            impl)
    with trace.span("frame.shade"):
        if _shard(plan) is not None:
            return _shade_sharded(*args)
        return replay.run("shade_stage", _shade, args,
                          adopt=(2, 3, 4, 5, 6, 7))


def _shade(plan, batch, g, history, vis, records, shadow_map, overflow,
           impl):
    """shade_stage on one device."""
    cfg = plan.config
    dev = vis.depth.device
    V = vis.depth.shape[:-2]

    hiz_min = hiz_max = None
    if cfg.enable_hiz:
        with replay.segment("shade.hiz"):
            hiz_min = hiz_ops.build_hiz(vis.depth, "min")
            hiz_max = hiz_ops.build_hiz(vis.depth, "max")

    with replay.segment("shade.gbuffer"):
        gbuf = gbuf_ops.resolve_gbuffer(
            vis, records, batch.atlas_packed, g.camera_prev.projection_view,
            atlas_size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
            n_levels=plan.atlas_n_levels, filter_mode=plan.texture_filter,
            impl=impl)

    emissive = gbuf.emissive
    bloom = None
    if cfg.enable_bloom:
        with replay.segment("shade.bloom"):
            emissive = bloom_ops.bloom(emissive, cfg.bloom_mip_count)
        bloom = emissive

    ssao = None
    with replay.segment("shade.ssao"):
        if cfg.enable_ssao:
            ssao_half = ssao_ops.ssao_generate(vis.depth, gbuf.normal, g,
                                               cfg.ssao_kernel_size,
                                               impl=impl)
            ssao = ssao_ops.ssao_blur(ssao_half)
            ssao_full = sampling.upsample_bilinear(ssao, cfg.height,
                                                   cfg.width)
        else:
            ssao_full = torch.ones_like(vis.depth)

    # SSR: computed, composited only behind composite_ssr (below)
    ssr_img = None
    with replay.segment("shade.ssr"):
        ssr_active = torch.full(V, -1, dtype=torch.int32, device=dev)
        if cfg.enable_ssr:
            ssr_img, ssr_overflow, ssr_active = ssr_ops.ssr(
                vis.depth, gbuf.albedo, gbuf.normal, gbuf.metallic_roughness,
                g, compact_cap=plan.ssr_cap, impl=impl)
            overflow = overflow | ssr_overflow

    clouds_full = None
    clouds_half = None
    if cfg.enable_clouds:
        noise = batch.cloud_noise
        hw, hh, quadrant = _cloud_args(cfg, noise, stacklevel=5)
        # the exact per-pixel march makes no LUT
        march = cfg.cloud_impl == "perpixel" and noise is not None
        lut = None if march else replay.adopt(
            _sky_lut(cfg, g, noise, impl))
        with replay.segment("shade.clouds"):
            if march:
                clouds_half = clouds_ops.render_clouds(g, vis.depth, noise,
                                                       hw, hh, **quadrant)
            else:
                clouds_half = clouds_ops.sky_from_lut(g, lut, vis.depth, hw,
                                                      hh, **quadrant)
            clouds_full = sampling.upsample_bilinear(clouds_half, cfg.height,
                                                     cfg.width)

    with replay.segment("shade.compose"):
        hdr = comp_ops.compose(
            g, vis.depth, gbuf.albedo, emissive, gbuf.normal, ssao_full,
            shadow_map, clouds_full,
            enable_volumetric=cfg.enable_volumetric_light,
            enable_shadow=cfg.enable_shadows,
            max_point_lights=cfg.max_point_lights,
            max_spot_lights=cfg.max_spot_lights,
            empty_shadow_map=(cfg.enable_shadows
                              and plan.shadow_statically_empty),
            shadow_crop=plan.shadow_crop, impl=impl)
        if cfg.composite_ssr and ssr_img is not None:
            hdr = _ssr_mix(hdr, ssr_img, gbuf.metallic_roughness)

    # depth of field blurs the composed colour before the luminance
    # histogram and TAA, so it feeds the history once and does not
    # compound (renderer.cpp:1119-1153)
    if cfg.enable_depth_of_field:
        with replay.segment("shade.dof"):
            hdr = dof_ops.depth_of_field(hdr, vis.depth, g)

    exposure = history.exposure
    if cfg.enable_auto_exposure:
        with replay.segment("shade.exposure"):
            exposure = exposure_ops.auto_exposure(hdr, history.exposure, g)

    velocity = gbuf.velocity
    resolved = hdr
    if cfg.enable_taa:
        with replay.segment("shade.taa"):
            resolved = taa_ops.taa(hdr, vis.depth, velocity,
                                   history.previous_color,
                                   history.previous_velocity,
                                   g.frame_counter, impl=impl)

    with replay.segment("shade.tonemap"):
        color = tonemap_ops.tone_map(resolved, exposure, g)

    with replay.segment("shade.history"):
        new_history = RenderHistory(
            previous_color=resolved.to(torch.bfloat16),
            previous_velocity=velocity.to(torch.bfloat16),
            exposure=exposure,
        )
        outputs = FrameOutputs(
            color=color, hdr=hdr, gbuffer=gbuf, shadow_map=shadow_map,
            ssao=ssao, clouds=clouds_half, bloom=bloom, ssr=ssr_img,
            hiz_min=hiz_min, hiz_max=hiz_max, overflow=overflow,
            tex_dirty=torch.full(V, -1, dtype=torch.int32, device=dev),
            ssr_active=ssr_active)
    return outputs, new_history


def _gbuffer_bands(parts):
    """A GBuffer per band -> one GBuffer of band lists."""
    return gbuf_ops.GBuffer(**{
        f: [getattr(p, f) for p in parts]
        for f in gbuf_ops.GBuffer.__dataclass_fields__})


def _shade_sharded(plan, batch, g, history, vis, records, shadow_map,
                   overflow, impl):
    """shade_stage over row bands: see parallel/mesh.make_sharded_shade_fn
    for how each pass runs."""
    cfg = plan.config
    mesh, axis = shard = _shard(plan)
    devices = mesh.band_devices(axis)
    lead = devices[0]
    H, W = cfg.height, cfg.width
    starts = halo.band_starts(H, len(devices))
    band_rows = list(zip(starts, starts[1:]))

    def bands(x):
        """An image as the shade's bands (a whole tensor is split, other
        bands are cut again)."""
        if isinstance(x, torch.Tensor):
            return halo.split_rows(x, devices, starts)
        if halo.starts_of(x) == starts:
            return [b.to(d) for b, d in zip(x, devices)]
        return [halo.rows_of(x, a, b, d)
                for (a, b), d in zip(band_rows, devices)]

    def whole(x):
        return halo.assemble(x, lead)

    with trace.span("shade.bands"):
        depth, tri_id = bands(vis.depth), bands(vis.tri_id)
        V = depth[0].shape[:-2]
        gs = halo.replicate(g, devices)
        batches = halo.replicate(batch, devices)
        recs = halo.replicate(records, devices)
        smaps = None if shadow_map is None else halo.replicate(shadow_map,
                                                               devices)
        overflow = overflow.to(lead)
        # K2's taps, the clouds' QUADRANT taps and HiZ read the whole
        # screen
        depth_full = halo.gather(depth)

    hiz_min = hiz_max = None
    if cfg.enable_hiz:
        with trace.span("shade.hiz"):
            hiz_min = hiz_ops.build_hiz(depth_full[lead], "min")
            hiz_max = hiz_ops.build_hiz(depth_full[lead], "max")

    with trace.span("shade.gbuffer"):
        gbuf = _gbuffer_bands([gbuf_ops.resolve_gbuffer(
            raster2.VisibilityBuffer(depth=depth[i], tri_id=tri_id[i],
                                     overflow=overflow),
            recs[d], batches[d].atlas_packed,
            gs[d].camera_prev.projection_view, atlas_size=plan.atlas_size,
            layer_stride=plan.atlas_layer_stride,
            n_levels=plan.atlas_n_levels, filter_mode=plan.texture_filter,
            impl=impl, row0=a, full_h=H)
            for i, ((a, _), d) in enumerate(zip(band_rows, devices))])

    emissive = gbuf.emissive
    bloom = None
    if cfg.enable_bloom:
        with trace.span("shade.bloom"):
            # the mip chain's reach grows with each level: the whole screen
            bloom = bloom_ops.bloom(whole(emissive), cfg.bloom_mip_count)
            emissive = bands(bloom)

    with trace.span("shade.ssao"):
        if cfg.enable_ssao:
            ssao_full = ssao_ops.ssao_row_bands(
                mesh, axis, depth, gbuf.normal, depth_full, gs,
                cfg.ssao_kernel_size, impl=impl)
        else:
            ssao_full = [torch.ones_like(d) for d in depth]

    ssr_img = None
    with trace.span("shade.ssr"):
        ssr_active = torch.full(V, -1, dtype=torch.int32, device=lead)
        if cfg.enable_ssr:
            ssr_img, ssr_overflow, ssr_active = ssr_ops.ssr(
                depth_full[lead], whole(gbuf.albedo), whole(gbuf.normal),
                whole(gbuf.metallic_roughness), gs[lead],
                compact_cap=plan.ssr_cap, impl=impl)
            overflow = overflow | ssr_overflow

    clouds_full = [None] * len(devices)
    if cfg.enable_clouds:
        noise = batches[lead].cloud_noise
        hw, hh, quadrant = _cloud_args(cfg, noise)
        march = cfg.cloud_impl == "perpixel" and noise is not None
        # the LUT once per distinct device
        luts = None if march else {
            d: _sky_lut(cfg, gs[d], batches[d].cloud_noise, impl)
            for d in halo.distinct(devices)}
        with trace.span("shade.clouds"):
            if march:
                # the per-pixel march on the whole screen, then cut
                half = clouds_ops.render_clouds(gs[lead], depth_full[lead],
                                                noise, hw, hh, **quadrant)
                clouds_full = bands(sampling.upsample_bilinear(half, H, W))
            else:
                # each band looks up its half-res rows and one more either
                # side for the upsample
                clouds_full = []
                for (a, b), d in zip(band_rows, devices):
                    lo, hi = max(a // 2 - 1, 0), min(b // 2 + 1, hh)
                    half = clouds_ops.sky_from_lut(
                        gs[d], luts[d], depth_full[d], hw, hh, rows=(lo, hi),
                        **quadrant)
                    clouds_full.append(sampling.upsample_bilinear(
                        half, H, W, rows=(a, b), src_row0=lo, src_h=hh))

    with trace.span("shade.compose"):
        hdr = [comp_ops.compose(
            gs[d], depth[i], gbuf.albedo[i], emissive[i], gbuf.normal[i],
            ssao_full[i], None if smaps is None else smaps[d],
            clouds_full[i], enable_volumetric=cfg.enable_volumetric_light,
            enable_shadow=cfg.enable_shadows,
            max_point_lights=cfg.max_point_lights,
            max_spot_lights=cfg.max_spot_lights,
            empty_shadow_map=(cfg.enable_shadows
                              and plan.shadow_statically_empty),
            shadow_crop=plan.shadow_crop, row0=a, full_h=H, impl=impl)
            for i, ((a, _), d) in enumerate(zip(band_rows, devices))]
        if cfg.composite_ssr and ssr_img is not None:
            hdr = [_ssr_mix(*a) for a in zip(hdr, bands(ssr_img),
                                             gbuf.metallic_roughness)]

    if cfg.enable_depth_of_field:
        with trace.span("shade.dof"):
            hdr = bands(dof_ops.depth_of_field(whole(hdr), depth_full[lead],
                                               gs[lead]))

    with trace.span("shade.exposure"):
        exposure = history.exposure.to(lead)
        if cfg.enable_auto_exposure:
            # a sum of the bands' integer histograms: exact
            hist = sum(exposure_ops.luminance_histogram(
                x, gs[d].log_min_luminance, gs[d].log_max_luminance).to(lead)
                for x, d in zip(hdr, devices))
            exposure = exposure_ops.resolve_exposure(hist, exposure,
                                                     gs[lead], H * W)
        exposures = halo.replicate(exposure, devices)

    velocity = gbuf.velocity
    resolved = hdr
    if cfg.enable_taa:
        with trace.span("shade.taa"):
            resolved = taa_ops.taa(
                hdr, depth, velocity, bands(history.previous_color),
                bands(history.previous_velocity),
                {d: gs[d].frame_counter for d in gs}, impl=impl, shard=shard)

    with trace.span("shade.tonemap"):
        color = [tonemap_ops.tone_map(r, exposures[d], gs[d])
                 for r, d in zip(resolved, devices)]
    with trace.span("shade.history"):
        new_history = RenderHistory(
            previous_color=[r.to(torch.bfloat16) for r in resolved],
            previous_velocity=[v.to(torch.bfloat16) for v in velocity],
            exposure=exposure)
        outputs = FrameOutputs(
            color=color, hdr=hdr, gbuffer=gbuf,
            shadow_map=None if smaps is None else smaps[lead], ssao=None,
            clouds=None, bloom=bloom, ssr=ssr_img, hiz_min=hiz_min,
            hiz_max=hiz_max, overflow=overflow,
            tex_dirty=torch.full(V, -1, dtype=torch.int32, device=lead),
            ssr_active=ssr_active)
    return outputs, new_history


def render_frame(plan: FramePlan, batch: SceneBatch, g: ShaderGlobals,
                 history: RenderHistory, model_mats, normal_mats,
                 impl: str | None = None
                 ) -> tuple[FrameOutputs, RenderHistory]:
    """One frame.  impl: None runs each ported kernel on a card (the
    plain PyTorch versions on the CPU); "plain" forces the plain
    versions (comparisons only); "cuda" demands the kernels.  Globals
    and history with a leading view axis render that batch of views
    (see the module docstring; parallel/mesh.make_batched_render_fn)."""
    with trace.span("frame.render", _clock_device(plan, g)):
        with trace.span("frame.proofs"):
            check_sun_proof(plan, g)
            check_shadow_crop(plan, model_mats)
        vis, records, shadow_map, overflow = raster_stage(
            plan, batch, g, model_mats, normal_mats, impl=impl)
        return shade_stage(plan, batch, g, history, vis, records,
                           shadow_map, overflow, impl=impl)


def _clock_device(plan: FramePlan, g: ShaderGlobals):
    """The device whose clock brackets the frame (utils/trace.span): g's,
    but None for a frame split in row bands (several devices) or for the
    call that captures the frame's CUDA graphs."""
    graphs = replay.active()
    if _shard(plan) is not None or (graphs is not None
                                     and not graphs.complete):
        return None
    return g.frame_counter.device


def make_render_fn(plan: FramePlan, impl: str | None = None):
    """(batch, g, history, model_mats, normal_mats) -> render_frame(plan,
    ...), the same outputs, replayed as CUDA graphs where every input is
    on one card, `impl` is not "plain" and the plan has no row split
    (graph/replay.py: the first call of a size, plan or scene batch runs
    eagerly, the second captures each pass, later calls replay them).
    The viewer's render loop (ui/server.py) keeps the JAX loop's
    structure, which makes a new render function for each new plan;
    tests can stub the render function there."""
    graphs = replay.FrameGraphs(sys.modules[__name__])

    def render(batch, g, history, model_mats, normal_mats):
        return graphs.render(plan, impl, batch, g, history, model_mats,
                             normal_mats)
    return render


def check_sun_proof(plan: FramePlan, g: ShaderGlobals):
    """Raise if `plan` elides the sun shadow pass but `g` carries a sun
    the emptiness proof was not run against."""
    if not plan.shadow_statically_empty or plan.proved_sun_pv is None:
        return
    proved = np.asarray(plan.proved_sun_pv, np.float32).reshape(4, 4)
    # (4, 4) or (B, 4, 4): np.allclose broadcasts the proof to each view
    pv = trace.read_back(g.sun.projection_view, "check_sun_proof")
    if not np.allclose(pv, proved, atol=1e-6):
        raise ValueError(
            "FramePlan.shadow_statically_empty was proved for a different "
            "sun projection_view than this frame's g.sun. Rebuild the "
            "scene plan for the new sun or set "
            "shadow_statically_empty=False.")


def check_shadow_crop(plan: FramePlan, model_mats):
    """Raise if `plan` carries a shadow sampling crop proved for
    different model matrices than this frame's."""
    if plan.shadow_crop is None or plan.proved_crop_mats is None:
        return
    proved = np.asarray(plan.proved_crop_mats, np.float32)
    mm = np.asarray(trace.read_back(model_mats, "check_shadow_crop"),
                    np.float32).ravel()
    if mm.shape != proved.shape or not np.allclose(mm, proved, atol=1e-6):
        raise ValueError(
            "FramePlan.shadow_crop was proved for different model "
            "matrices than this frame's. Rebuild the scene plan or set "
            "shadow_crop=None.")
