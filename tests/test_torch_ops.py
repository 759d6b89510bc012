"""Parity of the port's plain-PyTorch passes with their JAX counterparts
on identical inputs (numpy from a seed, or the JAX package's own reduced
terrain frame), one parametrised case per pass.

Bound: max abs <= 1e-5 (relative 1e-5 for HDR values) unless a case
states its own bound and why.  The sky LUT's cloud march is the one pass
that cannot be held that tightly (see test_render_sky_lut).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu import scenes as jscenes
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.models import terrain as jterrain
from soc_real_time_renderer_tpu.ops import bloom as jbloom
from soc_real_time_renderer_tpu.ops import clouds as jclouds
from soc_real_time_renderer_tpu.ops import composition as jcomp
from soc_real_time_renderer_tpu.ops import exposure as jexp
from soc_real_time_renderer_tpu.ops import gbuffer as jgbuf
from soc_real_time_renderer_tpu.ops import hiz as jhiz
from soc_real_time_renderer_tpu.ops import sampling as jsampling
from soc_real_time_renderer_tpu.ops import ssao as jssao
from soc_real_time_renderer_tpu.ops import tonemap as jtone
from soc_real_time_renderer_tpu.scene.components import MeshComponent, \
    TransformComponent
from soc_real_time_renderer_tpu.scene.scene import Scene
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch.ops import bloom as pbloom
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import composition as pcomp
from soc_real_time_renderer_tpu_torch.ops import exposure as pexp
from soc_real_time_renderer_tpu_torch.ops import gbuffer as pgbuf
from soc_real_time_renderer_tpu_torch.ops import hiz as phiz
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster
from soc_real_time_renderer_tpu_torch.ops import sampling as psampling
from soc_real_time_renderer_tpu_torch.ops import ssao as pssao
from soc_real_time_renderer_tpu_torch.ops import tonemap as ptone

W, H = 128, 64


def t(a):
    return convert.to_tensor(np.asarray(a))


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def frame():
    """The JAX package's reduced terrain (64^2 heightmap, tess 1, 64^2
    atlas) rastered and shaded at 128x64 on its exact f32 path."""
    hm = jterrain.procedural_heightmap(64)
    model = jterrain.build_terrain_model(hm, jterrain.default_albedo(hm),
                                         tess_level=1)
    scene = Scene("terrain")
    e = scene.create_entity("terrain")
    e.add_component(TransformComponent())
    e.add_component(MeshComponent()).model = model
    cfg = jcfg.RenderConfig(width=W, height=H, ssao_impl="xla",
                            taa_impl="xla")
    built = jscenes._finish(scene, [model], cfg, camera_pos=[20., 12., 20.],
                            camera_target=[50, 0, 50], atlas_size=64)
    plan = dataclasses.replace(
        built.plan, rec_pack="f32", interpret=True,
        main_grid=dataclasses.replace(built.plan.main_grid, rec_dtype="f32"))
    g, mm, nm = built.frame_globals(1)
    vis, records, _, _ = jax.jit(
        lambda b, g_, m, n: jframe.raster_stage(plan, b, g_, m, n))(
        built.batch, g, mm, nm)
    gbuf, _, _ = jax.jit(lambda v, r, b, g_: jgbuf.resolve_gbuffer(
        v, r, b.atlas_packed, g_.camera_prev.projection_view,
        atlas_size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
        n_levels=plan.atlas_n_levels))(vis, records, built.batch, g)
    return dict(plan=plan, batch=built.batch, g=g, vis=vis,
                records=records, gbuf=gbuf)


def _close(got, want, atol=1e-5, rtol=0.0):
    got, want = npy(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def case_resolve_gbuffer(f):
    plan, vis, g = f["plan"], f["vis"], f["g"]
    pvis = praster.VisibilityBuffer(depth=t(vis.depth),
                                    tri_id=t(vis.tri_id),
                                    overflow=t(vis.overflow))
    got = pgbuf.resolve_gbuffer(
        pvis, t(f["records"]), t(f["batch"].atlas_packed),
        t(g.camera_prev.projection_view), atlas_size=plan.atlas_size,
        layer_stride=plan.atlas_layer_stride, n_levels=plan.atlas_n_levels)
    want = f["gbuf"]
    for name in ("albedo", "emissive", "metallic_roughness", "velocity"):
        _close(getattr(got, name), getattr(want, name))
    # the normal map's mip level is round(lod): where lod sits on a .5
    # boundary one ulp of the uv derivatives selects the other level
    # for the whole pixel, so the normal is held per pixel-share
    dn = np.abs(npy(got.normal) - np.asarray(want.normal)).max(0)
    assert (dn > 1e-5).mean() < 0.01 and dn.max() < 0.05, dn.max()


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "trilinear"])
def test_sample_packed_atlas(frame, mode):
    plan = frame["plan"]
    rng = np.random.default_rng(1)
    n = 4096
    mid = np.zeros(n, np.int32)
    uv = rng.uniform(-2.0, 3.0, (2, n)).astype(np.float32)
    lod = rng.uniform(-1.0, plan.atlas_n_levels + 1.0, n).astype(np.float32)
    kw = dict(size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
              n_levels=plan.atlas_n_levels, filter_mode=mode)
    atlas = frame["batch"].atlas_packed
    want = jax.jit(lambda a, m, u, l: jgbuf.sample_packed_atlas(
        a, m, u, l, **kw))(atlas, mid, uv, lod)
    got = pgbuf.sample_packed_atlas(t(atlas), t(mid), t(uv), t(lod), **kw)
    _close(got, want)


def case_bloom(_):
    rng = np.random.default_rng(2)
    em = (rng.random((3, H, W), dtype=np.float32) ** 4 * 8.0)
    want = jax.jit(jbloom.bloom)(em)
    _close(pbloom.bloom(t(em)), want, atol=0, rtol=1e-5)


def case_build_hiz(f):
    depth = f["vis"].depth
    for op in ("min", "max"):
        want = jhiz.build_hiz(depth, op)
        got = phiz.build_hiz(t(depth), op)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b, atol=0)


def _lut_rays(lut_w=32, lut_h=16):
    az = ((np.arange(lut_w, dtype=np.float32) + 0.5) / lut_w * 2 * np.pi
          - np.pi)
    el = ((np.arange(lut_h, dtype=np.float32) + 0.5) / lut_h * np.pi
          - np.pi / 2)
    ce, se = np.cos(el)[:, None], np.sin(el)[:, None]
    ca, sa = np.cos(az)[None], np.sin(az)[None]
    return np.stack(np.broadcast_arrays(ce * ca, se + 0 * ca, ce * sa),
                    -1).astype(np.float32)


def test_sky_atmosphere(frame):
    """The LUT's single-scattering atmosphere (16x8-step march):
    relative 1e-3 — its ray-sphere intersections subtract ~4e13-sized
    squares, so one ulp there moves a march step by metres, and ~150
    chained exp/sqrt per texel add their own ulp differences."""
    g = frame["g"]
    ray = _lut_rays()
    sun_dir = -np.asarray(g.sun.direction)
    origin = (np.array([0, 6372e3, 0], np.float32)
              + np.asarray(g.camera.position))
    want = jax.jit(lambda r, o, s, e: jclouds._atmosphere(r, o, s, e))(
        ray, origin, sun_dir, g.elapsed_time)
    got = pclouds._atmosphere(t(ray), t(origin), t(sun_dir),
                              t(g.elapsed_time))
    _close(got, want, atol=1e-6, rtol=1e-3)


def test_render_sky_lut(frame):
    """The full 32x16 LUT, held statistically: the cloud march is
    ill-conditioned in float32.  Its ray-shell intersections cancel
    ~4e13-sized squares (XLA's own jit and op-by-op runs differ by
    ~1 m there), and its hash fract(sin(.) * 43758.5453) turns a 1-ulp
    sin difference into ~3e-3 of noise, which the density threshold
    (x20) amplifies.  Most texels agree to float precision; low rays
    crossing long stretches of the cloud layer do not."""
    g = frame["g"]
    want = np.asarray(jax.jit(lambda g_: jclouds.render_sky_lut(
        g_, 32, 16))(g))
    got = npy(pclouds.render_sky_lut(convert.globals_from_numpy(g), 32, 16))
    assert got.shape == want.shape == (3, 16, 32)
    assert np.isfinite(got).all()
    d = np.abs(got - want)
    assert np.median(d) < 1e-5 and d.mean() < 0.05, (np.median(d), d.mean())


def test_render_sky_lut_repeats_and_keeps_its_constants(frame):
    """The procedural LUT's constants are made once per (values, device)
    and shared between calls (ops/clouds._vec): two calls return
    identical tensors, and every cached constant still equals a freshly
    made one bit for bit afterwards (no call wrote one in place)."""
    g = convert.globals_from_numpy(frame["g"])
    first = pclouds.render_sky_lut(g, 32, 16)
    second = pclouds.render_sky_lut(g, 32, 16)
    assert torch.equal(first, second)
    used = [pclouds.RAYLEIGH, pclouds.MIE, [5.5e-6, 13.0e-6, 22.4e-6],
            [0.0, 6372e3, 0.0], [0.0, pclouds.EARTH_RADIUS, 0.0],
            [0.0, 1.0, 0.0], [0.8, 0.8, 0.8], 1.99]
    for v in used:
        cached = pclouds._vec(v, "cpu")
        assert cached is pclouds._vec(v, torch.device("cpu"))
        fresh = torch.tensor(v, dtype=torch.float32)
        assert cached.dtype == torch.float32 and cached.shape == fresh.shape
        assert torch.equal(cached, fresh)


def case_sky_from_lut(f):
    rng = np.random.default_rng(3)
    lut = rng.random((3, 16, 32), dtype=np.float32)
    depth, g = f["vis"].depth, f["g"]
    for full in (None, (W, H)):
        fw, fh = (None, None) if full is None else full
        want = jax.jit(lambda g_, l, d: jclouds.sky_from_lut(
            g_, l, d, W // 2, H // 2, full_width=fw, full_height=fh))(
            g, lut, depth)
        got = pclouds.sky_from_lut(convert.globals_from_numpy(g), t(lut),
                                   t(depth), W // 2, H // 2,
                                   full_width=fw, full_height=fh)
        _close(got, want)


def _lit_globals(g, rng):
    """frame globals + 3 point / 2 spot lights of random placement."""
    la = jcfg.LightArrays.empty()
    pp = np.zeros((128, 3), np.float32)
    pp[:3] = rng.uniform([20, -5, 20], [60, 15, 60], (3, 3))
    sp = np.zeros((128, 3), np.float32)
    sp[:2] = rng.uniform([20, 5, 20], [60, 15, 60], (2, 3))
    sd = np.zeros((128, 3), np.float32)
    sd[:, 1] = -1.0
    cut = np.zeros(128, np.float32)
    cut[:2] = np.cos(np.radians(20.0))
    ocut = np.zeros(128, np.float32)
    ocut[:2] = np.cos(np.radians(30.0))
    la = dataclasses.replace(
        la, point_position=pp, point_color=np.full((128, 3), 0.9,
                                                   np.float32),
        point_intensity=np.full(128, 40.0, np.float32),
        point_count=np.int32(3), spot_position=sp, spot_direction=sd,
        spot_color=np.full((128, 3), 0.7, np.float32),
        spot_intensity=np.full(128, 60.0, np.float32), spot_cut_off=cut,
        spot_outer_cut_off=ocut, spot_count=np.int32(2))
    return dataclasses.replace(g, lights=la)


def _full_lit_globals(g):
    """frame globals + the full_lit preset's 128 point and 128 spot
    lights (scenes.full_lit_lights, gathered by the port's Scene)."""
    from soc_real_time_renderer_tpu_torch import scenes as pscenes
    from soc_real_time_renderer_tpu_torch.scene.scene import Scene as PScene
    scene = PScene("full_lit")
    pscenes.add_lights(scene, pscenes.full_lit_lights())
    la = scene.update(0.0)
    assert (int(la.point_count), int(la.spot_count)) == (128, 128)
    return dataclasses.replace(g, lights=jcfg.LightArrays(**{
        f.name: getattr(la, f.name) for f in dataclasses.fields(la)}))


@pytest.mark.parametrize("lights,volumetric", [(0, False), (4, False),
                                               (0, True), (128, False)])
def test_compose(frame, lights, volumetric):
    """128: every point and spot slot live, in the full_lit layout."""
    rng = np.random.default_rng(4)
    g = frame["g"] if not lights else (
        _lit_globals(frame["g"], rng) if lights == 4
        else _full_lit_globals(frame["g"]))
    gb = frame["gbuf"]
    ssao = rng.random((H, W), dtype=np.float32)
    clouds = rng.random((3, H, W), dtype=np.float32)
    kw = dict(enable_volumetric=volumetric, enable_shadow=True,
              max_point_lights=lights, max_spot_lights=lights,
              empty_shadow_map=True)
    args = (frame["vis"].depth, gb.albedo, gb.emissive, gb.normal, ssao)
    want = jax.jit(lambda g_, *a: jcomp.compose(g_, *a, None, clouds, **kw))(
        g, *args)
    got = pcomp.compose(convert.globals_from_numpy(g),
                        *[t(a) for a in args], None, t(clouds), **kw)
    _close(got, want, atol=1e-6, rtol=1e-5)


def case_auto_exposure(f):
    rng = np.random.default_rng(5)
    hdr = rng.random((3, H, W), dtype=np.float32) ** 3 * 4.0
    hdr[:, :4] = 0.0                        # black pixels -> bin 0
    g = f["g"]
    want = jax.jit(jexp.auto_exposure)(hdr, np.float32(0.3), g)
    got = pexp.auto_exposure(t(hdr), torch.tensor(0.3),
                             convert.globals_from_numpy(g))
    _close(got, want, atol=0, rtol=1e-5)


def case_tone_map(f):
    rng = np.random.default_rng(6)
    hdr = rng.random((3, H, W), dtype=np.float32) ** 2 * 6.0
    g = f["g"]
    want = jax.jit(jtone.tone_map)(hdr, np.float32(0.7), g)
    got = ptone.tone_map(t(hdr), torch.tensor(0.7),
                         convert.globals_from_numpy(g))
    _close(got, want)


def case_ssao_blur(_):
    rng = np.random.default_rng(7)
    s = rng.random((H // 2, W // 2), dtype=np.float32)
    _close(pssao.ssao_blur(t(s)), jssao.ssao_blur(s), atol=1e-6)


def case_sampling(_):
    """Clamp-to-edge bilinear taps (uv past both edges included), the
    separable form, the 2x2 mean and the bilinear upsample."""
    rng = np.random.default_rng(8)
    img = rng.random((3, H, W), dtype=np.float32)
    uv = rng.uniform(-0.1, 1.1, (2, 40, 24)).astype(np.float32)
    _close(psampling.sample_screen(t(img), t(uv)),
           jsampling.sample_screen(img, uv), atol=1e-6)
    u, v = uv[0, 0], uv[1, :, 0]
    _close(psampling.sample_screen_separable(t(img), t(u), t(v)),
           jsampling.sample_screen_separable(img, u, v), atol=1e-6)
    _close(psampling.resize_half(t(img)), jsampling.resize_half(img),
           atol=1e-6)
    half = img[:, :H // 2, :W // 2]
    _close(psampling.upsample_bilinear(t(half), H, W),
           jsampling.upsample_bilinear(half, H, W), atol=1e-6)


CASES = {
    "resolve_gbuffer": case_resolve_gbuffer,
    "bloom": case_bloom,
    "build_hiz": case_build_hiz,
    "sky_from_lut": case_sky_from_lut,
    "auto_exposure": case_auto_exposure,
    "tone_map": case_tone_map,
    "ssao_blur": case_ssao_blur,
    "sampling": case_sampling,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pass_matches_jax(frame, name):
    CASES[name](frame)
