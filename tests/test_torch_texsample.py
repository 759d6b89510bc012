"""The material tap of multi-material atlases (K5), port against the JAX
package: ``texsample.sample_atlas`` (the dispatch; its plain version is
``gbuffer.sample_packed_atlas``) against the JAX exact gather and the
JAX tile kernel, and the multi-material ``resolve_gbuffer`` against the
JAX XLA path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.models.texture import (
    PackedMaterialAtlas, expand_atlas_bilinear)
from soc_real_time_renderer_tpu.ops import gbuffer as jgbuf
from soc_real_time_renderer_tpu.ops import texsample as jtex
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.ops import gbuffer as pgbuf
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster
from soc_real_time_renderer_tpu_torch.ops import texsample as ptex

MODES = ["bilinear", "nearest", "trilinear"]


def _toy_atlas(M=3, size=64, seed=0):
    """tests/test_texsample.py's random M-material atlas."""
    rng = np.random.default_rng(seed)
    n_levels = int(np.log2(size)) + 1
    stride = sum((size >> k) ** 2 for k in range(n_levels))
    packed = rng.integers(0, 256, (16, M * stride), dtype=np.uint8)
    return PackedMaterialAtlas(packed=packed, size=size, num_materials=M,
                               layer_stride=stride, n_levels=n_levels)


def _kw(atlas, mode):
    return dict(size=atlas.size, layer_stride=atlas.layer_stride,
                n_levels=atlas.n_levels, filter_mode=mode)


@pytest.mark.parametrize("mode", MODES)
def test_sample_atlas_matches_jax_gather(mode):
    """Random (mid, uv, lod) over 3 materials, uv wrapping through
    negative values, lod past both ends: max abs <= 1e-6 against the JAX
    gather, tighter than the 1e-5 of the single-material case in
    test_torch_ops.py (XLA's CPU jit contracts the bilinear blend into
    FMA, ROADMAP fault C7; measured max 1.8e-7); the dispatch on CPU
    tensors is sample_packed_atlas exactly."""
    atlas = _toy_atlas()
    table = expand_atlas_bilinear(atlas)
    rng = np.random.default_rng(5)
    n = 8192
    mid = rng.integers(0, 3, n).astype(np.int32)
    uv = rng.uniform(-3.0, 4.0, (2, n)).astype(np.float32)
    lod = rng.uniform(-1.0, atlas.n_levels + 1.0, n).astype(np.float32)
    kw = _kw(atlas, mode)
    want = np.asarray(jax.jit(lambda a, m, u, l: jgbuf.sample_packed_atlas(
        a, m, u, l, **kw))(table, mid, uv, lod))
    t = torch.from_numpy
    got = ptex.sample_atlas(t(table), t(mid), t(uv), t(lod), **kw)
    assert torch.equal(got, pgbuf.sample_packed_atlas(
        t(table), t(mid), t(uv), t(lod), **kw))
    assert got.shape == (11, n)
    assert np.abs(got.numpy() - want).max() <= 1e-6


def test_sample_atlas_refuses_a_material_past_the_atlas():
    """A mid past the atlas's last material fails on the CPU as the
    gather's IndexError; on the card the kernel asserts on it
    (test_torch_cuda.py), where a clamp would read another material."""
    atlas = _toy_atlas()
    t = torch.from_numpy
    mid = torch.tensor([0, atlas.num_materials], dtype=torch.int32)
    with pytest.raises(IndexError):
        ptex.sample_atlas(t(expand_atlas_bilinear(atlas)), mid,
                          torch.full((2, 2), 0.25), torch.zeros(2),
                          **_kw(atlas, "bilinear"))


def _smooth_fields(H, W, M, block, seed=1):
    """tests/test_texsample.py's surface-like fields: materials in
    block x block squares, smooth uv at ~1 texel per pixel, mild lod
    gradient, 5% dead pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    lod = 1.0 + 1.5 * xx / W + 0.3 * yy / H
    u = np.cumsum(2.0 ** lod / 64.0, axis=1) + 3.0
    v = np.cumsum(2.0 ** lod / 64.0, axis=0)
    mid = ((yy // block).astype(int) * 2 + (xx // block).astype(int)) % M
    live = rng.random((H, W)) > 0.05
    return (mid.reshape(-1).astype(np.int32),
            np.stack([u.reshape(-1), v.reshape(-1)]).astype(np.float32),
            lod.reshape(-1).astype(np.float32), live.reshape(-1))


@pytest.mark.parametrize("mode", ["bilinear", "trilinear"])
def test_sample_atlas_matches_jax_tile_kernel(mode):
    """Against the TPU tile kernel (interpret mode), which blends in
    bf16: that test's own bounds, mean < 0.002 and max < 0.06, over the
    live pixels."""
    atlas = _toy_atlas()
    table = expand_atlas_bilinear(atlas)
    page = jtex.build_atlas_page(atlas)
    page = jtex.AtlasPageDevice(page=jnp.asarray(page.page),
                                row0=jnp.asarray(page.row0),
                                col0=jnp.asarray(page.col0))
    H = W = 32
    mid, uv, lod, live = _smooth_fields(H, W, atlas.num_materials, 16)
    assert len(np.unique(mid)) == 3
    want, overflow, _ = jtex.sample_atlas_tiled(
        page, jnp.asarray(mid), jnp.asarray(uv), jnp.asarray(lod),
        jnp.asarray(live), jnp.asarray(table), size=atlas.size,
        n_levels=atlas.n_levels, num_materials=atlas.num_materials,
        layer_stride=atlas.layer_stride, filter_mode=mode, interpret=True,
        H=H, W=W)
    assert int(overflow) == 0
    t = torch.from_numpy
    got = ptex.sample_atlas(t(table), t(mid), t(uv), t(lod),
                            **_kw(atlas, mode)).numpy()
    err = np.abs(got - np.asarray(want))[:, live]
    assert err.mean() < 0.002 and err.max() < 0.06, (err.mean(), err.max())


def test_multi_material_resolve_gbuffer_matches_jax():
    """The small full_nohelmet scene (six materials, frame 1): the
    port's resolve_gbuffer with the tap through K5's dispatch against the
    JAX XLA gather path on the same visibility buffer and records.
    Bounds as the single-material case in test_torch_ops.py: 1e-5 on
    albedo, emissive, metallic-roughness and velocity; the normal map's
    round(lod) mip choice may flip on < 1% of pixels (fault C7)."""
    cfg = dict(width=128, height=64, ssao_impl="xla", taa_impl="xla")
    jb, pb = kit.build_pair("full_nohelmet", jcfg.RenderConfig(**cfg),
                            RenderConfig(**cfg), noise=False)
    plan = dataclasses.replace(
        jb.plan, rec_pack="f32", interpret=True,
        main_grid=dataclasses.replace(jb.plan.main_grid, rec_dtype="f32"))
    assert plan.atlas_num_materials == 6
    g, mm, nm = jb.frame_globals(1)
    vis, records, _, _ = jax.jit(
        lambda b, g_, m, n: jframe.raster_stage(plan, b, g_, m, n))(
        jb.batch, g, mm, nm)
    want, _, _ = jax.jit(lambda v, r, b, g_: jgbuf.resolve_gbuffer(
        v, r, b.atlas_packed, g_.camera_prev.projection_view,
        atlas_size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
        n_levels=plan.atlas_n_levels))(vis, records, jb.batch, g)
    t = convert.to_tensor
    pvis = praster.VisibilityBuffer(depth=t(vis.depth), tri_id=t(vis.tri_id),
                                    overflow=t(vis.overflow))
    got = pgbuf.resolve_gbuffer(
        pvis, t(records), pb.batch.atlas_packed,
        t(g.camera_prev.projection_view), atlas_size=plan.atlas_size,
        layer_stride=plan.atlas_layer_stride, n_levels=plan.atlas_n_levels)
    mids = np.unique(np.asarray(jb.batch.static_rows)[0][
        np.asarray(vis.tri_id)[np.asarray(vis.tri_id) >= 0]])
    assert len(mids) >= 3, mids           # the tap spans several layers
    for name in ("albedo", "emissive", "metallic_roughness", "velocity"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    dn = np.abs(got.normal.numpy() - np.asarray(want.normal)).max(0)
    assert (dn > 1e-5).mean() < 0.01 and dn.max() < 0.05, dn.max()
