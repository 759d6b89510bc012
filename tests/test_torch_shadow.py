"""The paid sun shadow, port against the JAX package: the shadow view's
depth-only raster (K4's plain version, ``resolve_depth_plain``) and the
composition's ESM tap of a rendered map, full and through the proved
crop.  The scene is the small atrium lifted into the sun's volume
(tests/torch_scene_kit.py), so the emptiness proof fails and the map
holds real depth.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu.ops import composition as jcomp
from soc_real_time_renderer_tpu.ops import raster2 as jraster
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.ops import composition as pcomp
from soc_real_time_renderer_tpu_torch.ops import gbuffer as pgbuf
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster

W, H = 128, 64


def _pair(shadow_resolution, **flags):
    cfg = dict(width=W, height=H, shadow_resolution=shadow_resolution,
               **flags)
    return kit.build_pair("atrium_lifted", jcfg.RenderConfig(**cfg),
                          RenderConfig(**cfg), noise=False)


@pytest.fixture(scope="module")
def shadow_view():
    """(JAX BuiltScene, port BuiltScene, the sun view's clip (3, 4, T)
    of frame 1) at 512^2."""
    jb, pb = _pair(512)
    assert not pb.plan.shadow_statically_empty
    g, mm, nm = pb.frame_globals(1)
    world, _ = pframe.transform_triangles(pb.batch, mm, nm)
    return jb, pb, pframe._clip_of(world, g.sun.projection_view)


def test_shadow_depth_raster_matches_jax(shadow_view):
    """rasterize(cull="back", depth_only=True) on the 512^2 shadow view,
    128-px bins: coverage agreement >= 0.999 and, where both cover,
    depth within 1e-4 (the bound of tools/verify_chip.py:121) on >=
    99.9% of texels, mean abs < 1e-6, max abs < 1e-3.  Not a max bound
    of 1e-4: the sun is nearly overhead, so the atrium's vertical faces
    are slivers a texel wide that span metres of depth, and one ulp of
    the edge functions (XLA contracts them into FMA, the port does not)
    moves which sliver covers such a texel.  Measured: coverage equal
    everywhere, 7 of 77,568 texels above 1e-4, max 1.6e-4."""
    jb, pb, clip = shadow_view
    jgrid = dataclasses.replace(jb.plan.shadow_grid, rec_dtype="f32")
    jvis, _ = jax.jit(lambda c: jraster.rasterize(
        c, jgrid, cull="back", interpret=True, depth_only=True))(
        clip.numpy())
    pvis, _ = praster.rasterize(clip, pb.plan.shadow_grid, cull="back",
                                depth_only=True)
    assert pvis.tri_id is None and jvis.tri_id is None
    jd, pd = np.asarray(jvis.depth), pvis.depth.numpy()
    assert jd.shape == pd.shape == (512, 512)
    assert int(jvis.overflow) == int(pvis.overflow) == 0
    cov_j, cov_p = jd < 1.0, pd < 1.0
    assert (cov_j == cov_p).mean() >= 0.999
    assert 0.1 < cov_p.mean() < 0.9, cov_p.mean()
    d = np.abs(jd - pd)[cov_j & cov_p]
    assert (d <= 1e-4).mean() >= 0.999 and d.mean() < 1e-6, d.mean()
    assert d.max() < 1e-3, d.max()


def test_resolve_depth_plain_chunking_is_exact(shadow_view):
    """The plain K4 chunks its pairs to bound memory; the chunk size
    does not change the result."""
    _, pb, clip = shadow_view
    setup = praster.triangle_setup_planar(clip, 512, 512, "back")
    starts, recs, _, grid = praster.gather_records(setup,
                                                   pb.plan.shadow_grid)
    a = praster.resolve_depth_plain(starts, recs, grid)
    b = praster.resolve_depth_plain(starts, recs, grid,
                                    pixels_per_chunk=16384 * 7)
    assert int(starts[-1]) > 7 and torch.equal(a, b)


@pytest.fixture(scope="module")
def lit():
    """The 1024^2 shadow map (where the proof gives a crop) and the
    G-buffer of frame 1, from the port; the same frame's globals from
    both packages."""
    jb, pb = _pair(1024)
    assert pb.plan.shadow_crop is not None
    jg, _, _ = jb.frame_globals(1)
    g, mm, nm = pb.frame_globals(1)
    vis, records, smap, _ = pframe.raster_stage(pb.plan, pb.batch, g, mm, nm)
    plan = pb.plan
    gb = pgbuf.resolve_gbuffer(
        vis, records, pb.batch.atlas_packed, g.camera_prev.projection_view,
        atlas_size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
        n_levels=plan.atlas_n_levels)
    rng = np.random.default_rng(9)
    inputs = dict(depth=vis.depth.numpy(), albedo=gb.albedo.numpy(),
                  emissive=gb.emissive.numpy(), normal=gb.normal.numpy(),
                  ssao=rng.random((H, W), dtype=np.float32),
                  shadow_map=smap.numpy(),
                  clouds=rng.random((3, H, W), dtype=np.float32))
    return jg, g, plan, inputs


@pytest.mark.parametrize("crop", [False, True])
def test_compose_with_shadow_map_matches_jax(lit, crop):
    """compose with the rendered map, full or through the crop: mean abs
    < 1e-6 and max abs <= 1e-5 against the JAX compose (the same ESM
    tap; ulp-level differences from XLA's FMA contraction)."""
    jg, g, plan, x = lit
    order = ("depth", "albedo", "emissive", "normal", "ssao", "shadow_map",
             "clouds")
    kw = dict(enable_shadow=True, max_point_lights=0, max_spot_lights=0,
              shadow_crop=plan.shadow_crop if crop else None)
    want = np.asarray(jax.jit(lambda g_, *a: jcomp.compose(g_, *a, **kw))(
        jg, *[x[k] for k in order]))
    got = pcomp.compose(g, *[torch.from_numpy(x[k]) for k in order],
                        **kw).numpy()
    d = np.abs(got - want)
    assert d.mean() < 1e-6 and d.max() <= 1e-5, (d.mean(), d.max())
    # the map really shadows part of the frame (columns and crates on
    # the floor)
    free = pcomp.compose(g, *[torch.from_numpy(x[k]) for k in order[:5]],
                         None, torch.from_numpy(x["clouds"]),
                         enable_shadow=False, max_point_lights=0,
                         max_spot_lights=0).numpy()
    assert (np.abs(free - got).max(0) > 1e-3).mean() > 0.005
    # with the volumetric light on, the march's comparison taps read the
    # same map: all but at most 0.1% of the pixels within 1e-5 (a
    # comparison may flip where a sample's depth ties a texel's)
    vkw = dict(kw, enable_volumetric=True)
    vwant = np.asarray(jax.jit(lambda g_, *a: jcomp.compose(g_, *a, **vkw))(
        jg, *[x[k] for k in order]))
    vgot = pcomp.compose(g, *[torch.from_numpy(x[k]) for k in order],
                         **vkw).numpy()
    vd = np.abs(vgot - vwant)
    assert (vd.max(0) > 1e-5).mean() <= 1e-3 and vd.mean() < 1e-5
    assert (np.abs(vgot - got).max(0) > 1e-4).mean() > 0.2


def test_shadow_crop_bit_identical():
    """The port's counterpart of test_shadow_elision.py's crop test: the
    lifted atrium renders bit-identically with the crop on and off."""
    _, pb = _pair(1024, enable_ssao=False, enable_bloom=False,
                  enable_clouds=False, enable_taa=False,
                  enable_auto_exposure=False, enable_hiz=False)
    plan = pb.plan
    assert not plan.shadow_statically_empty
    x0, y0, w, h = plan.shadow_crop
    assert w * h < 1024 * 1024
    g, mm, nm = pb.frame_globals(1)
    out_c, _ = pframe.render_frame(
        plan, pb.batch, g, pframe.RenderHistory.create(plan.config,
                                                       device="cpu"), mm, nm)
    out_f, _ = pframe.render_frame(
        dataclasses.replace(plan, shadow_crop=None), pb.batch, g,
        pframe.RenderHistory.create(plan.config, device="cpu"), mm, nm)
    assert torch.equal(out_c.color, out_f.color)
    assert (out_c.shadow_map < 1.0).float().mean() > 0.05
