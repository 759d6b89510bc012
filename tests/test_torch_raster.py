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
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster

JGRID = jraster.BinGrid(width=64, height=64, bin_size=32, group=2,
                        chunk=128, pair_cap=2048, med_cap=128, med_slots=16,
                        rec_dtype="f32")


def _pgrid(jgrid):
    return praster.BinGrid(**{f.name: getattr(jgrid, f.name)
                              for f in dataclasses.fields(praster.BinGrid)})


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


@pytest.mark.parametrize("grid", [
    dict(chunk=8, pair_cap=16),                      # OVERFLOW_PAIRS
    dict(bin_size=16, med_cap=1, med_slots=4),       # MED_CAP | MED_SLOTS
])
def test_binning_caps_match(grid):
    """starts, the sorted pair stream and every overflow bit equal the
    JAX package's build_pairs, truncation included."""
    jgrid = dataclasses.replace(JGRID, **grid)
    verts = np.concatenate([_soup(1, 64), SCENES["medium"]()])
    clip = make_clip(verts)
    n = len(verts) // 3
    planar = clip.reshape(n, 3, 4).transpose(1, 2, 0)
    jsetup = jraster.triangle_setup_planar(jnp.asarray(planar), 64, 64,
                                           "none")
    js, jt, jo = jax.jit(lambda s: jraster.build_pairs(s, jgrid))(jsetup)
    psetup = praster.triangle_setup_planar(
        torch.from_numpy(np.ascontiguousarray(planar)), 64, 64, "none")
    ps, pt, po = praster.build_pairs(psetup, _pgrid(jgrid))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert int(po) == int(jo) and int(po) != 0


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
