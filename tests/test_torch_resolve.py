"""The exact rejects of K1 (``kernels/csrc/resolve.cu``) on the CPU.

K1 skips a record before any per-pixel work in two ways, and both must
be exact, or the kernel would differ from ``raster2.resolve_plain``:

* a record with no w > 0 covers no pixel under ``_eval_records``;
* ``tile_may_cover``, the plain mirror below of ``edge_may_cover`` in
  ``resolve.cu`` (with its rounding margin), never rejects a rectangle
  of pixels that holds a pixel inside all three edges: a warp's 8x4
  tile, K1's 32x8 block region and K4's 32x32 one.

K4 (the shadow view's depth-only resolve) runs the same body, so the
same rule is held on the reduced ``atrium_lifted`` shadow view's own
records (orthographic: every w is 1), and ``resolve_depth_plain`` is
held on a bin size that does not divide 256.

The binning keeps the reference's rule for triangles wholly behind the
camera (valid, bbox (0, 0, 1, 1), so they land in bin 0): its starts and
sorted ids equal the JAX package's on soups that hold such triangles.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from raster_oracle import make_clip
from soc_real_time_renderer_tpu.ops import raster2 as jraster
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.models import terrain as pterrain
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster
from soc_real_time_renderer_tpu_torch.scene import components as pcomp
from soc_real_time_renderer_tpu_torch.scene.scene import Scene as PScene

TILE_W, TILE_H = 8, 4


def tile_may_cover(rec, xl, xh, yl, yh):
    """resolve.cu's tile test in plain PyTorch: rec (20, N); tile corner
    pixel centres (M,) each -> (N, M) bool, False only where no pixel
    centre of the tile can pass all three edge tests."""
    xl, xh, yl, yh = (t[None, :] for t in (xl, xh, yl, yh))
    may = torch.ones((rec.shape[1], xl.shape[1]), dtype=torch.bool)
    for k in (0, 3, 6):
        a0, a1, a2 = (rec[k + i][:, None] for i in range(3))
        ec = (a0 * torch.where(a0 >= 0, xh, xl)
              + a1 * torch.where(a1 >= 0, yh, yl) + a2)
        s = a0.abs() * xh + a1.abs() * yh + a2.abs()
        may &= ~(ec < -(s * 2.0 ** -21 + 2.0 ** -126))
    return may


def _planar(verts):
    clip = make_clip(verts)
    n = len(verts) // 3
    return torch.from_numpy(np.ascontiguousarray(
        clip.reshape(n, 3, 4).transpose(1, 2, 0)))


def _soup(seed, n, z=(-4.0, -2.0), spread=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-1, -1, z[0]], [1, 1, z[1]], (n, 3))
    offs = rng.uniform(-spread, spread, (n, 3, 3))
    return (centers[:, None, :] + offs).reshape(-1, 3).astype(np.float32)


def _random_clip(seed, n):
    """Clip-space triangles straight from a seed: w in [-1, 2], so some
    lie wholly behind the camera and some cross the near plane."""
    rng = np.random.default_rng(seed)
    ww = rng.uniform(-1.0, 2.0, (n, 3, 1))
    xy = rng.uniform(-1.5, 1.5, (n, 3, 2)) * np.abs(ww)
    z = rng.uniform(0.0, 1.0, (n, 3, 1)) * ww
    clip = np.concatenate([xy, z, ww], axis=2).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(clip.transpose(1, 2, 0)))


def _pixel_aligned(seed, n, w, h):
    """Triangles whose vertices sit on pixel centres (w = 1): edges run
    exactly through pixel centres, where e is 0 or a few ulps off."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, w, (n, 3)) + 0.5
    py = rng.integers(0, h, (n, 3)) + 0.5
    X = px / w * 2.0 - 1.0
    Y = py / h * 2.0 - 1.0
    clip = np.stack([X, Y, np.full_like(X, 0.5), np.ones_like(X)], axis=2)
    return torch.from_numpy(np.ascontiguousarray(
        clip.astype(np.float32).transpose(1, 2, 0)))


def _pixels(w, h):
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    return (xs.reshape(-1).to(torch.float32) + 0.5,
            ys.reshape(-1).to(torch.float32) + 0.5)


def _edges_inside(rec, px, py):
    """(N, P): all three edge functions >= 0, in _eval_records' order."""
    r = rec[:, :, None]
    inside = torch.ones((rec.shape[1], px.shape[0]), dtype=torch.bool)
    for k in (0, 3, 6):
        inside &= r[k] * px + r[k + 1] * py + r[k + 2] >= 0
    return inside


def _no_w_positive(rec):
    return ~((rec[12] > 0) | (rec[13] > 0) | (rec[14] > 0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_records_without_positive_w_cover_nothing(seed):
    """Random records with every w <= 0 (±0.0 and 1e-30 magnitudes
    among them) cover no pixel; the same records with w > 0 do.  Their
    boxes hold the whole target, so the w rule alone decides."""
    rng = np.random.default_rng(seed)
    n = 4000
    rows = praster.REC_ROWS
    scale = rng.choice([1e-30, 1e-3, 1.0, 1e3], (rows, n))
    rec = rng.normal(size=(rows, n)) * scale
    rec[rng.random((rows, n)) < 0.05] = 0.0
    rec[rng.random((rows, n)) < 0.05] = -0.0
    rec[12:15] = -np.abs(rec[12:15])
    rec[12:15][rng.random((3, n)) < 0.1] = 0.0
    rec[12:15][rng.random((3, n)) < 0.1] = -0.0
    rec[15:19] = np.array([0.0, 0.0, 64.0, 32.0])[:, None]
    rec[19] = np.arange(n)
    rec = torch.from_numpy(rec.astype(np.float32))
    assert bool(_no_w_positive(rec).all())
    assert bool((rec[12:15] == 0).any()) and bool(
        torch.signbit(rec[12:15][rec[12:15] == 0]).any())
    px, py = _pixels(64, 32)
    cov, _ = praster._eval_records(rec[:, :, None], px, py)
    assert not bool(cov.any())
    flipped = rec.clone()
    flipped[12:15] = flipped[12:15].abs() + 1.0
    cov, _ = praster._eval_records(flipped[:, :, None], px, py)
    assert bool(cov.any())


def test_terrain_records_behind_the_camera_cover_nothing():
    """The reduced terrain frame's own triangles with no w > 0: the
    binning keeps them valid with bbox (0, 0, 1, 1) (so they reach bin
    0), and none covers a pixel of the 128x64 target."""
    hm = pterrain.procedural_heightmap(64)
    model = pterrain.build_terrain_model(hm, pterrain.default_albedo(hm),
                                         tess_level=1)
    scene = PScene("terrain")
    e = scene.create_entity("terrain")
    e.add_component(pcomp.TransformComponent())
    e.add_component(pcomp.MeshComponent()).model = model
    w, h = 128, 64
    built = pscenes._finish(scene, [model], RenderConfig(width=w, height=h),
                            [20.0, 12.0, 20.0], [50, 0, 50], device="cpu",
                            atlas_size=64)
    g, mm, nm = built.frame_globals(1)
    world, _ = pframe.transform_triangles(built.batch, mm, nm)
    clip = pframe._clip_of(world, g.camera.projection_view)
    setup = praster.triangle_setup_planar(clip, w, h, "front")
    rec = praster.build_records(setup)[:, :-1]
    dead = _no_w_positive(rec) & setup.valid
    assert int(dead.sum()) > 100
    assert torch.equal(setup.bbox[:, dead],
                       torch.tensor([[0.0], [0.0], [1.0], [1.0]]).expand(
                           4, int(dead.sum())))
    px, py = _pixels(w, h)
    dead_rec = rec[:, dead].clone()
    dead_rec[15:19] = torch.tensor([0.0, 0.0, w, h])[:, None]  # the w rule
    cov, _ = praster._eval_records(dead_rec[:, :, None], px, py)
    assert not bool(cov.any())


def _near_axis(seed, n, h):
    """Records whose first edge runs within a few ulps of a pixel row with
    a slope below an ulp per pixel (the other two edges always pass): the
    per-pixel values there are pure rounding."""
    rng = np.random.default_rng(seed)
    a1 = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-4, 12, n)
          * rng.choice([-1, 1], n)).astype(np.float32)
    prod = a1 * (rng.integers(0, h, n) + 0.5).astype(np.float32)
    ulp = np.spacing(np.abs(prod)).astype(np.float32)
    rec = np.zeros((16, n), np.float32)
    rec[0] = rng.choice([-1, 1], n) * ulp * rng.uniform(0.01, 0.2, n)
    rec[1] = a1
    rec[2] = -prod + rng.integers(-3, 4, n) * ulp
    rec[5] = rec[8] = 1.0
    return torch.from_numpy(rec)


def _tile_soups():
    """name -> (records (16, N), target width, height); the slivers of
    test_torch_raster.py cover pixels only on a finer target."""
    def recs(clip, w, h):
        setup = praster.triangle_setup_planar(clip, w, h, "none")
        return praster.build_records(setup)[:, :-1], w, h
    return {
        "slivers": lambda: recs(_planar(
            _soup(2, 60) * np.array([1.0, 0.02, 1.0], np.float32)), 256, 256),
        "soup": lambda: recs(_planar(
            _soup(3, 400, z=(-6.0, 1.0), spread=2.0)), 64, 64),
        "random_clip": lambda: recs(_random_clip(4, 1500), 64, 64),
        "pixel_aligned": lambda: recs(_pixel_aligned(5, 1500, 64, 64), 64,
                                      64),
        "near_axis": lambda: (_near_axis(7, 4000, 64), 64, 64),
    }


def _rule_on_rectangles(rec, w, h, rw, rh, chunk=256):
    """The rule on every (record, rw x rh rectangle) of the w x h target
    (w, h multiples of rw, rh): (covered, may), both (N, rectangles):
    some pixel centre of the rectangle is inside all three edges; the
    rectangle test keeps the record."""
    px, py = _pixels(w, h)
    tile = (torch.arange(w * h) // w) // rh * (w // rw) \
        + (torch.arange(w * h) % w) // rw
    n_tiles = (w // rw) * (h // rh)
    t = torch.arange(n_tiles)
    x0 = (t % (w // rw)) * rw
    y0 = (t // (w // rw)) * rh
    f = torch.float32
    covered, may = [], []
    for c0 in range(0, rec.shape[1], chunk):   # (chunk, w*h) at a time
        r = rec[:, c0:c0 + chunk]
        inside = _edges_inside(r, px, py)
        cov = torch.zeros((r.shape[1], n_tiles), dtype=torch.int32)
        cov.index_add_(1, tile, inside.to(torch.int32))
        covered.append(cov > 0)
        may.append(tile_may_cover(r, x0.to(f) + 0.5, (x0 + rw - 1).to(f) + 0.5,
                                  y0.to(f) + 0.5, (y0 + rh - 1).to(f) + 0.5))
    return torch.cat(covered), torch.cat(may)


@pytest.mark.parametrize("name", sorted(_tile_soups()))
def test_tile_rule_never_rejects_a_covered_tile(name):
    """Every (record, 8x4 tile) of the target: where any pixel centre
    of the tile is inside all three edges, the tile test keeps the
    record; and it rejects most of the others (it is not vacuous)."""
    rec, w, h = _tile_soups()[name]()
    covered, may = _rule_on_rectangles(rec, w, h, TILE_W, TILE_H)
    assert bool(covered.any())
    assert not bool((covered & ~may).any())
    assert (~may & ~covered).sum() > 0.5 * (~covered).sum()


# a block's region: K1's is one 8x4 tile a warp (32x8), K4's four (32x32)
REGIONS = {"k1_32x8": (32, 8), "k4_32x32": (32, 32)}


@pytest.mark.parametrize("region", sorted(REGIONS))
@pytest.mark.parametrize("name", sorted(_tile_soups()))
def test_region_rule_never_rejects_a_covered_region(name, region):
    """The same rule at the block's first level, on K1's and K4's region
    sizes: no record that covers a pixel centre of a region is rejected
    there, and some uncovered regions are (fewer than at the tile level:
    the first reject is the coarser one)."""
    rec, w, h = _tile_soups()[name]()
    covered, may = _rule_on_rectangles(rec, w, h, *REGIONS[region])
    assert bool(covered.any())
    assert not bool((covered & ~may).any())
    assert bool((~may & ~covered).any())


def _box_rule_on_regions(rec, w, h, rw, rh):
    """(covered, kept, edges) of every (record, rw x rh region) of the
    w x h target: some pixel centre of the region is inside all three
    edges and inside the record's box (_eval_records' coverage);
    resolve.cu's first level keeps the record (its box holds a pixel
    centre of the region, and the edge rule); the edge rule alone keeps
    it."""
    px, py = _pixels(w, h)
    nx = w // rw
    region = (torch.arange(w * h) // w) // rh * nx \
        + (torch.arange(w * h) % w) // rw
    t = torch.arange(nx * (h // rh))
    xl = (t % nx * rw).float() + 0.5
    yl = (t // nx * rh).float() + 0.5
    xh, yh = xl + (rw - 1), yl + (rh - 1)
    cov, _ = praster._eval_records(rec[:, :, None], px, py)
    covered = torch.zeros((rec.shape[1], len(t)), dtype=torch.int32)
    covered.index_add_(1, region, (_edges_inside(rec, px, py) & cov)
                       .to(torch.int32))
    box = ((rec[15][:, None] < xh) & (rec[17][:, None] > xl)
           & (rec[16][:, None] < yh) & (rec[18][:, None] > yl))
    edges = tile_may_cover(rec, xl, xh, yl, yh)
    return covered > 0, box & edges, edges


@pytest.mark.parametrize("region", sorted(REGIONS))
@pytest.mark.parametrize("name", sorted(set(_tile_soups()) - {"near_axis"}))
def test_region_box_rule_never_rejects_a_covered_region(name, region):
    """The first level's box test (a record is kept only where its box
    holds a pixel centre of the block's region) with the edge rule: no
    record that covers a pixel centre of a region, box included, is
    rejected, and the box rejects records that the edge rule keeps."""
    rec, w, h = _tile_soups()[name]()
    covered, kept, edges = _box_rule_on_regions(rec, w, h,
                                                *REGIONS[region])
    assert bool(covered.any())
    assert not bool((covered & ~kept).any())
    assert bool((edges & ~kept).any())


def test_a_sliver_covers_nothing_past_its_box():
    """A sliver 0.2 texels wide whose float32 edge functions all pass at
    texels (1971, 2190) and (1971, 2191), below its box's last row 2189
    (the atrium of ``sponza_lifted`` in the sun's 4096^2 view: K4 and
    its plain version once wrote it there, nearer than the floor under
    it).  The records' box rows keep _eval_records, and so the resolve,
    inside the box, as the benchmark's reference tests each pixel of
    the box alone."""
    S = 4096
    setup = praster.triangle_setup_planar(kit.sliver_clip(), S, S, "back")
    assert bool(setup.valid[0])
    assert setup.bbox[:, 0].tolist() == [1971.0, 2182.0, 1973.0, 2190.0]
    rec = praster.build_records(setup)[:, :-1]
    px = torch.full((4,), 1971.5)
    py = torch.tensor([2188.5, 2189.5, 2190.5, 2191.5])
    assert bool(_edges_inside(rec, px, py).all())
    cov, _ = praster._eval_records(rec, px, py)
    assert cov.tolist() == [True, True, False, False]
    grid = praster.default_grid(S, S, kind="shadow")
    starts, recs, ovf, rgrid = praster.gather_records(setup, grid)
    depth = praster.resolve_depth_plain(starts, recs, rgrid)
    assert int(ovf) == 0
    assert depth[2188:2192, 1971].lt(1.0).tolist() == [True, True, False,
                                                        False]
    ys, xs = torch.nonzero(depth < 1.0, as_tuple=True)
    assert len(ys) and bool(((ys >= 2182) & (ys < 2190)).all())
    assert bool(((xs >= 1971) & (xs < 1973)).all())


@pytest.fixture(scope="module")
def shadow_view():
    """(starts, recs, grid, S) of the reduced atrium_lifted scene's sun
    view at frame 1: the small atrium at y = 32 under the orthographic
    sun, a 512^2 shadow map in 128x128 bins."""
    S = 512
    built = kit.build_port("atrium_lifted", RenderConfig(
        width=128, height=64, shadow_resolution=S), "cpu", noise=False)
    assert not built.plan.shadow_statically_empty
    g, mm, nm = built.frame_globals(1)
    world, _ = pframe.transform_triangles(built.batch, mm, nm)
    clip = pframe._clip_of(world, g.sun.projection_view)
    setup = praster.triangle_setup_planar(clip, S, S, "back")
    starts, recs, ovf, grid = praster.gather_records(setup,
                                                     built.plan.shadow_grid)
    assert int(ovf) == 0 and (grid.bw, grid.bh) == (128, 128)
    return starts, recs, grid, S


@pytest.mark.parametrize("rect", [(TILE_W, TILE_H), REGIONS["k4_32x32"]],
                         ids=["tile_8x4", "region_32x32"])
def test_rule_on_the_shadow_views_own_records(shadow_view, rect):
    """K4's two reject levels on the records it is given: every pair of
    the reduced atrium_lifted shadow view (w = 1 at every vertex, so the
    w > 0 test keeps them all) against every rectangle of the map."""
    starts, recs, _, S = shadow_view
    n = int(starts[-1])
    assert n > 500
    rec = recs[:, :n]
    assert bool((rec[12:15] == 1.0).all())
    covered, may = _rule_on_rectangles(rec, S, S, *rect, chunk=64)
    assert covered.any(dim=1).float().mean() > 0.5
    assert not bool((covered & ~may).any())
    assert (~may & ~covered).sum() > 0.5 * (~covered).sum()


def test_shadow_view_depth_is_the_min_over_covering_records(shadow_view):
    """resolve_depth_plain on the shadow view's records equals the
    minimum z, over each bin's records, of _eval_records at the pixel
    (taken here bin by bin with amin), 1.0 where none covers; and the
    atrium shadows a good part of the map."""
    starts, recs, grid, S = shadow_view
    depth = praster.resolve_depth_plain(starts, recs, grid)
    assert depth.shape == (S, S)
    want = torch.ones((S, S))
    lx, ly = _pixels(grid.bw, grid.bh)
    for b in range(grid.num_bins):
        s0, s1 = int(starts[b]), int(starts[b + 1])
        if s1 == s0:
            continue
        gx0, gy0 = b % grid.bx * grid.bw, b // grid.bx * grid.bh
        cov, z = praster._eval_records(recs[:, s0:s1, None], lx + gx0,
                                       ly + gy0)
        zmin = torch.where(cov, z, math.inf).amin(dim=0)
        want[gy0:gy0 + grid.bh, gx0:gx0 + grid.bw] = torch.where(
            torch.isfinite(zmin), zmin, 1.0).reshape(grid.bh, grid.bw)
    assert torch.equal(depth, want)
    assert 0.05 < (depth < 1.0).float().mean().item() < 1.0


@pytest.mark.parametrize("bins", [96, 80])
def test_resolve_depth_plain_on_bins_that_do_not_divide_256(bins):
    """A 192x192 target in 96x96 or 80x80 bins (neither divides 256, the
    first depth kernel's restriction; 80 is no multiple of the 32-pixel
    region either): the depth inside the viewport equals the 32x32-bin
    resolve's and resolve_plain's depth bit for bit (a pixel's minimum
    over its covering records does not depend on the binning), and the
    dispatch takes the grid on CPU tensors."""
    S = 192
    planar = _planar(_soup(12, 300, spread=0.6))
    setup = praster.triangle_setup_planar(planar, S, S, "back")

    def grid(b):
        return praster.BinGrid(width=S, height=S, bin_size=b, group=1,
                               pair_cap=16384, med_cap=512, med_slots=64)

    out = {}
    for b in (bins, 32):
        starts, recs, ovf, rgrid = praster.gather_records(setup, grid(b))
        assert int(ovf) == 0
        out[b] = praster.resolve_depth(starts, recs, rgrid)
        assert out[b].shape == (rgrid.by * b, rgrid.bx * b)
    ids_depth, ids = praster.resolve_plain(starts, recs, rgrid)
    assert torch.equal(out[bins][:S, :S], out[32][:S, :S])
    assert torch.equal(out[32], ids_depth)
    assert torch.equal(out[32] < 1.0, ids >= 0)
    assert 0.05 < (out[bins][:S, :S] < 1.0).float().mean().item() < 1.0


JGRID = jraster.BinGrid(width=64, height=64, bin_size=32, group=2,
                        chunk=128, pair_cap=4096, med_cap=128, med_slots=16,
                        rec_dtype="f32")


@pytest.mark.parametrize("cull", ["none", "front"])
def test_binning_keeps_behind_camera_triangles_as_the_reference(cull):
    """A soup in front of, across and wholly behind the camera: starts,
    the sorted pair stream and the overflow bits equal the JAX package's
    build_pairs, and bin 0 holds the triangles with no w > 0."""
    verts = _soup(6, 300, z=(-4.0, 3.0), spread=1.0)
    planar = _planar(verts)
    jsetup = jraster.triangle_setup_planar(jnp.asarray(planar.numpy()), 64,
                                           64, cull)
    js, jt, jo = jax.jit(lambda s: jraster.build_pairs(s, JGRID))(jsetup)
    pgrid = convert.grid_from_jax(JGRID)
    psetup = praster.triangle_setup_planar(planar, 64, 64, cull)
    ps, pt, po = praster.build_pairs(psetup, pgrid)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert int(po) == int(jo)
    dead = (_no_w_positive(praster.build_records(psetup)[:, :-1])
            & psetup.valid)
    assert int(dead.sum()) > 0
    bin0 = set(pt[int(ps[0]):int(ps[1])].tolist())
    assert set(torch.nonzero(dead)[:, 0].tolist()) <= bin0


@pytest.mark.parametrize("b", [0, 1, 3])
def test_one_bin_starts_resolve_that_bin_alone(b):
    """kernel_ab.only_bin, the starts with which K1's heaviest bin is
    timed alone: bin b keeps its records [starts[b], starts[b + 1]) and
    every other bin is empty, so resolving them gives the full resolve's
    result in bin b and the clear (depth 1, id -1) everywhere else.  (K1
    reads each bin's range as it stands; the plain version numbers pairs
    from 0, so it is handed the same ranges shifted by starts[b].)"""
    import kernel_ab
    planar = _planar(_soup(8, 300, z=(-4.0, 3.0), spread=1.0))
    pgrid = convert.grid_from_jax(JGRID)
    setup = praster.triangle_setup_planar(planar, 64, 64, "front")
    starts, recs, ovf, grid = praster.gather_records(setup, pgrid)
    assert int(ovf) == 0 and int(starts[b + 1] - starts[b]) > 0
    depth, ids = praster.resolve_plain(starts, recs, grid)
    one = kernel_ab.only_bin(starts, b)
    assert torch.equal(one[1:] - one[:-1] != 0,
                       torch.arange(grid.num_bins) == b)
    s0 = int(starts[b])
    d1, i1 = praster.resolve_plain(one - s0, recs[:, s0:], grid)
    rows = slice(b // grid.bx * grid.bh, (b // grid.bx + 1) * grid.bh)
    cols = slice(b % grid.bx * grid.bw, (b % grid.bx + 1) * grid.bw)
    inside = torch.zeros_like(ids, dtype=torch.bool)
    inside[rows, cols] = True
    assert bool((ids[inside] >= 0).any())
    assert torch.equal(d1[inside], depth[inside])
    assert torch.equal(i1[inside], ids[inside])
    assert bool((d1[~inside] == 1.0).all() and (i1[~inside] == -1).all())
