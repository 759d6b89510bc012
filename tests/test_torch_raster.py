"""Parity of the port's rasterizer (setup, binning, records and K1's
plain resolve) with the JAX package's ``rasterize(rec_dtype="f32",
interpret=True)`` and with the numpy oracle ``raster_oracle``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raster_oracle import make_clip, naive_raster
from soc_real_time_renderer_tpu.ops import raster2 as jraster
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster

JGRID = jraster.BinGrid(width=64, height=64, bin_size=32, group=2,
                        chunk=128, pair_cap=2048, med_cap=128, med_slots=16,
                        rec_dtype="f32")


def _pgrid(jgrid):
    return convert.grid_from_jax(jgrid)


def _soup(seed, n):
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-1, -1, -4], [1, 1, -2], (n, 3))
    offs = rng.uniform(-0.5, 0.5, (n, 3, 3))
    return (centers[:, None, :] + offs).reshape(-1, 3).astype(np.float32)


def _quads():
    def quad(z, s):
        return [[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]]
    verts = np.asarray(quad(-2.0, 1.0) + quad(-1.0, 0.3), np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 6, 5], [4, 7, 6]])
    return verts[idx.reshape(-1)]


SCENES = {
    "soup40": lambda: _soup(0, 40),
    "soup64": lambda: _soup(1, 64),
    "slivers": lambda: _soup(2, 60) * np.array([1.0, 0.02, 1.0],
                                               np.float32),
    "quads": _quads,
    "medium": lambda: np.asarray([[0.0, 3.0, -1.0], [-3.0, -3.0, -1.0],
                                  [3.0, -3.0, -1.0]], np.float32),
    "near_plane": lambda: np.asarray([[0.0, 0.05, -5.0], [-0.3, 0.05, 1.0],
                                      [0.3, 0.05, 1.0]], np.float32),
}


def _both(verts, cull, jgrid=JGRID):
    clip = make_clip(verts)
    n = len(verts) // 3
    planar = clip.reshape(n, 3, 4).transpose(1, 2, 0)
    jvis, _ = jraster.rasterize_jit(jnp.asarray(planar), jgrid, cull, True)
    pvis, _ = praster.rasterize(torch.from_numpy(np.ascontiguousarray(
        planar)), _pgrid(jgrid), cull)
    return clip, n, jvis, pvis


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("cull", ["none", "front"])
def test_raster_matches_jax(name, cull):
    """tri_id agreement >= 0.999 (exact off depth ties), depth < 1e-4
    where ids agree, identical overflow bits."""
    _, _, jvis, pvis = _both(SCENES[name](), cull)
    jt, pt = np.asarray(jvis.tri_id), pvis.tri_id.numpy()
    agree = jt == pt
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(pvis.depth.numpy()[agree],
                               np.asarray(jvis.depth)[agree], atol=1e-4)
    assert int(pvis.overflow) == int(jvis.overflow)


@pytest.mark.parametrize("name", ["soup40", "quads"])
def test_raster_matches_naive_oracle(name):
    clip, n, _, pvis = _both(SCENES[name](), "none")
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    nd, nt = naive_raster(clip, idx, 64, 64, cull="none")
    got = pvis.tri_id.numpy()
    assert ((got >= 0) != (nt >= 0)).mean() < 0.01
    both = (got >= 0) & (nt >= 0) & (got == nt)
    assert both.sum() >= 0.95 * ((got >= 0) & (nt >= 0)).sum()
    np.testing.assert_allclose(pvis.depth.numpy()[both], nd[both],
                               atol=1e-3)


def _planar(verts):
    clip = make_clip(verts)
    n = len(verts) // 3
    return np.ascontiguousarray(clip.reshape(n, 3, 4).transpose(1, 2, 0))


def _bin_pairs(starts, tids):
    """The stream's (bin, triangle) pairs as sorted bin * 2^20 + id
    keys (a multiset: a pair that repeats stays twice)."""
    starts, tids = np.asarray(starts), np.asarray(tids)
    bins = np.repeat(np.arange(len(starts) - 1), np.diff(starts))
    return np.sort(bins.astype(np.int64) * 2 ** 20
                   + tids[:starts[-1]].astype(np.int64))


def _cut_bins(setup, grid, large_cap):
    """Independent of build_pairs: the (bin, triangle) keys the JAX
    package drops (a kept medium triangle's bins past med_slots, in its
    bbox's row-major slot order), for the first `large_cap` such
    triangles."""
    x0, y0, x1, y1 = (np.asarray(a) for a in setup.bbox)
    valid = np.asarray(setup.valid)

    def bin_of(v, size, n):
        return np.clip(np.floor(v / size).astype(np.int64), 0, n - 1)

    bx0, by0 = bin_of(x0, grid.bw, grid.bx), bin_of(y0, grid.bh, grid.by)
    w = bin_of(x1 - 1, grid.bw, grid.bx) - bx0 + 1
    h = bin_of(y1 - 1, grid.bh, grid.by) - by0 + 1
    med = np.flatnonzero(valid & (w * h > grid.n_small))[:grid.med_cap]
    large = [t for t in med if w[t] * h[t] > grid.med_slots][:large_cap]
    keys = [((by0[t] + s // w[t]) * grid.bx + bx0[t] + s % w[t]) * 2 ** 20
            + t for t in large for s in range(grid.med_slots, w[t] * h[t])]
    return np.asarray(keys, np.int64), len(large)


@pytest.mark.parametrize("grid,jax_cuts", [
    (dict(chunk=8, pair_cap=16), False),             # OVERFLOW_PAIRS
    (dict(bin_size=16, med_cap=1, med_slots=4), True),  # MED_SLOTS
])
def test_binning_caps_match(grid, jax_cuts):
    """Where the JAX package's build_pairs keeps every bin (bit 4
    clear): starts, the sorted pair stream and every overflow bit equal
    its, truncation included.  Where it cuts medium triangles at
    med_slots bins (bit 4 set), the port's third tier keeps them: bits
    1 and 2 equal JAX's, bit 4 is clear, and per bin the port's pairs
    are the JAX pairs plus exactly the bins JAX dropped."""
    jgrid = dataclasses.replace(JGRID, **grid)
    planar = _planar(np.concatenate([_soup(1, 64), SCENES["medium"]()]))
    jsetup = jraster.triangle_setup_planar(jnp.asarray(planar), 64, 64,
                                           "none")
    js, jt, jo = jax.jit(lambda s: jraster.build_pairs(s, jgrid))(jsetup)
    psetup = praster.triangle_setup_planar(torch.from_numpy(planar), 64, 64,
                                           "none")
    pgrid = _pgrid(jgrid)
    ps, pt, po = praster.build_pairs(psetup, pgrid)
    assert int(jo) != 0
    assert bool(int(jo) & praster.OVERFLOW_MED_SLOTS) == jax_cuts
    if not jax_cuts:
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
        assert int(po) == int(jo)
        return
    low = praster.OVERFLOW_PAIRS | praster.OVERFLOW_MED_CAP
    assert int(po) & low == int(jo) & low
    assert not int(po) & praster.OVERFLOW_MED_SLOTS
    cut, n_large = _cut_bins(psetup, pgrid, pgrid.large_cap)
    assert n_large >= 1 and len(cut)
    np.testing.assert_array_equal(
        _bin_pairs(ps, pt), np.sort(np.concatenate([_bin_pairs(js, jt),
                                                    cut])))


def test_more_cut_triangles_than_large_cap_set_bit_4():
    """With large_cap 1 and several triangles past med_slots bins, bit
    4 is set, and only the first of them gets its remaining bins: the
    pairs are the JAX pairs plus that triangle's cut bins alone."""
    jgrid = dataclasses.replace(JGRID, bin_size=16, med_slots=4)
    big = [SCENES["medium"]() * np.float32(k) + np.float32([0, 0, -k])
           for k in (0.5, 0.8, 1.1)]
    planar = _planar(np.concatenate([_soup(1, 64)] + big))
    jsetup = jraster.triangle_setup_planar(jnp.asarray(planar), 64, 64,
                                           "none")
    js, jt, jo = jax.jit(lambda s: jraster.build_pairs(s, jgrid))(jsetup)
    psetup = praster.triangle_setup_planar(torch.from_numpy(planar), 64, 64,
                                           "none")
    pgrid = dataclasses.replace(_pgrid(jgrid), large_cap=1)
    ps, pt, po = praster.build_pairs(psetup, pgrid)
    _, n_large = _cut_bins(psetup, pgrid, pgrid.med_cap)
    assert n_large >= 2
    assert int(po) & praster.OVERFLOW_MED_SLOTS
    assert int(po) & ~praster.OVERFLOW_MED_SLOTS == int(jo) & \
        ~praster.OVERFLOW_MED_SLOTS
    cut, _ = _cut_bins(psetup, pgrid, 1)
    np.testing.assert_array_equal(
        _bin_pairs(ps, pt), np.sort(np.concatenate([_bin_pairs(js, jt),
                                                    cut])))


def _terrain_clip(width, height, camera_pos, reduced):
    """Planar clip positions of frame 0 of the terrain (reduced: the 64^2
    heightmap at tess level 1, else the default preset) seen from
    camera_pos, and the port's main grid for it."""
    from soc_real_time_renderer_tpu_torch import scenes as pscenes
    from soc_real_time_renderer_tpu_torch.config import RenderConfig
    from soc_real_time_renderer_tpu_torch.graph import frame as pframe
    from soc_real_time_renderer_tpu_torch.models import terrain as pterrain
    kw = dict(device="cpu")
    if reduced:
        hm = pterrain.procedural_heightmap(64)
        model = pterrain.build_terrain_model(
            hm, pterrain.default_albedo(hm), tess_level=1)
        kw["atlas_size"] = 64
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pscenes, "_terrain_model", lambda **_: model)
            built = pscenes.build("terrain", RenderConfig(width=width,
                                                          height=height),
                                  **kw)
    else:
        built = pscenes.build("terrain", RenderConfig(width=width,
                                                      height=height), **kw)
    built.camera_position = np.asarray(camera_pos, np.float32)
    g, mm, nm = built.frame_globals(0)
    world, _ = pframe.transform_triangles(built.batch, mm, nm)
    return pframe._clip_of(world, g.camera.projection_view), built.plan


def test_reduced_terrain_past_med_slots_matches_jax_uncut():
    """The reduced terrain at 128x64 from [20, 18, 20] on 16-px bins
    with med_slots 8: triangles near the camera span up to 20 of the 32
    bins.  The port's raster on that grid against the JAX rasterize on
    the same grid with med_slots 32 (covering every bbox): the file's
    bounds, bit 4 clear on both; the JAX one on the cut grid sets bit 4
    and loses coverage."""
    clip, _ = _terrain_clip(128, 64, [20.0, 18.0, 20.0], reduced=True)
    planar = jnp.asarray(clip.numpy())
    jcut = jraster.BinGrid(width=128, height=64, bin_size=16, group=2,
                           chunk=128, pair_cap=65536, med_cap=4096,
                           med_slots=8, rec_dtype="f32")
    juncut = dataclasses.replace(jcut, med_slots=jcut.num_bins)
    jvis, _ = jraster.rasterize_jit(planar, juncut, "front", True)
    jvis_cut, _ = jraster.rasterize_jit(planar, jcut, "front", True)
    pvis, _ = praster.rasterize(clip, _pgrid(jcut), "front")
    assert int(jvis_cut.overflow) & praster.OVERFLOW_MED_SLOTS
    assert (np.asarray(jvis_cut.tri_id) < 0).sum() > (
        np.asarray(jvis.tri_id) < 0).sum()
    assert int(pvis.overflow) == int(jvis.overflow) == 0
    jt, pt = np.asarray(jvis.tri_id), pvis.tri_id.numpy()
    agree = jt == pt
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(pvis.depth.numpy()[agree],
                               np.asarray(jvis.depth)[agree], atol=1e-4)


def test_default_terrain_past_med_slots_keeps_every_bin():
    """ROADMAP fault C22: the default terrain at 1920x1088 from
    [20, 18, 20], where triangles near the camera span 72-176 of the
    main grid's 1,020 bins (med_slots 64).  The port's pairs, per bin,
    equal those of the same grid with med_slots 1024 (no cut at all),
    with no overflow bit on either."""
    clip, plan = _terrain_clip(1920, 1088, [20.0, 18.0, 20.0],
                               reduced=False)
    grid = plan.main_grid
    assert grid.med_slots == 64 and grid.num_bins <= 1024
    setup = praster.triangle_setup_planar(clip, 1920, 1088, "front")
    ps, pt, po = praster.build_pairs(setup, grid)
    us, ut, uo = praster.build_pairs(
        setup, dataclasses.replace(grid, med_slots=1024))
    _, n_large = _cut_bins(setup, grid, grid.med_cap)
    assert 0 < n_large <= grid.large_cap
    assert int(po) == int(uo) == 0
    np.testing.assert_array_equal(_bin_pairs(ps, pt), _bin_pairs(us, ut))


def test_resolve_dispatch_refuses_cuda_on_cpu():
    verts = SCENES["quads"]()
    clip = make_clip(verts)
    planar = torch.from_numpy(np.ascontiguousarray(
        clip.reshape(4, 3, 4).transpose(1, 2, 0)))
    with pytest.raises(ValueError):
        praster.rasterize(planar, _pgrid(JGRID), "none", impl="cuda")


def test_binning_viewport_narrower_than_its_bin_row():
    """A 96-px viewport with 32-px bins in groups of two has a bin row
    128 px wide; a triangle right of the viewport gets the empty bbox
    [96, 96) and a bin span of width 0.  The CPU's integer division by
    that 0 raised (ROADMAP fault C20); the pairs now equal the JAX
    package's build_pairs, and the raster its rasterize."""
    jgrid = dataclasses.replace(JGRID, width=96)
    verts = _soup(3, 48) + np.array([3.0, 0.0, 0.0], np.float32)
    clip = make_clip(verts)
    n = len(verts) // 3
    planar = clip.reshape(n, 3, 4).transpose(1, 2, 0)
    jsetup = jraster.triangle_setup_planar(jnp.asarray(planar), 96, 64,
                                           "none")
    psetup = praster.triangle_setup_planar(
        torch.from_numpy(np.ascontiguousarray(planar)), 96, 64, "none")
    x0, _, x1, _ = psetup.bbox
    assert ((x0 == 96) & (x1 == 96)).any()       # off the right edge
    js, jt, jo = jax.jit(lambda s: jraster.build_pairs(s, jgrid))(jsetup)
    ps, pt, po = praster.build_pairs(psetup, _pgrid(jgrid))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert int(po) == int(jo)
    _, _, jvis, pvis = _both(verts, "none", jgrid)
    assert pvis.tri_id.shape == (64, 96)
    assert (np.asarray(jvis.tri_id) == pvis.tri_id.numpy()).mean() >= 0.999
