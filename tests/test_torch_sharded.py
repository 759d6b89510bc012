"""The row split of one frame over a device mesh: ``parallel/halo.py``,
``parallel/mesh.py``'s ``make_mesh`` / ``shard_inputs`` /
``make_sharded_shade_fn`` / the ``mesh`` argument of
``make_batched_render_fn``, ``raster2.resolve_row_sharded`` and the band
modes of K1, K4, K2 and K3, on meshes of the CPU device named several
times (``["cpu"] * 4``), against

* the port's own unsplit frame (the split must not change a value:
  max abs 0 is what the CPU gives; the bound stated is 1e-6);
* the JAX package's ``make_sharded_shade_fn`` on meshes of the virtual
  CPU devices, with the exact oracle plan (``ssao_impl="xla"``,
  ``taa_impl="xla"``, the XLA texture gather, f32 records), at the frame
  bounds of test_torch_parallel.py; and the JAX ``resolve_row_sharded``
  (Pallas in interpret mode) on the same starts and records, bit for
  bit.

The ``mesh`` argument of ``make_batched_render_fn`` (the meshed batched
step) is in tests/test_torch_sharded_step.py.

As in test_torch_parallel.py, the sky LUT and the smooth SSAO hash are
shared between the packages and between the split and the unsplit
frame: the reference hash multiplies a last-bit difference by 4e4, and on
the CPU a band moves which pixels fall in the tail of a vectorised loop.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel as tp
import torch_scene_kit as kit
from raster_oracle import make_clip
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.ops import raster2 as jraster
from soc_real_time_renderer_tpu.parallel import mesh as jmesh
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster
from soc_real_time_renderer_tpu_torch.ops import ssao as pssao
from soc_real_time_renderer_tpu_torch.ops import taa as ptaa
from soc_real_time_renderer_tpu_torch.parallel import halo
from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh

BOUNDS = {"terrain": (2e-3, 3e-2), "atrium_lifted": (2e-4, 1e-2)}


def cpu_mesh(n, dp=1):
    return pmesh.make_mesh(n, dp=dp, devices=["cpu"] * n)


# --- halos and bands -------------------------------------------------------

def _image(h, w=5, lead=(2,), seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(*lead, h, w))
                            .astype(np.float32))


def _clamped(x, a, b):
    """Rows [a, b) of x with the rows past its edges clamped, by hand."""
    rows = [min(max(r, 0), x.shape[-2] - 1) for r in range(a, b)]
    return x[..., rows, :]


@pytest.mark.parametrize("heights", [(4, 4, 4, 4), (6, 2, 4), (3, 5)])
@pytest.mark.parametrize("halos", [(1, 1), (2, 1), (3, 0), (7, 9)])
def test_exchange_row_halos_builds_the_padded_band(heights, halos):
    """Each padded band is the whole image's rows [s - top, e + bot) with
    the screen's edges repeated, for equal and unequal bands and halos
    reaching past a neighbour (7 and 9 rows)."""
    x = _image(sum(heights))
    starts = np.cumsum((0,) + heights).tolist()
    bands = halo.split_rows(x, ["cpu"] * len(heights), starts)
    assert halo.starts_of(bands) == starts
    top, bot = halos
    padded = halo.exchange_row_halos(bands, top, bot)
    for p, a, b in zip(padded, starts, starts[1:]):
        assert torch.equal(p, _clamped(x, a - top, b + bot))
    assert torch.equal(halo.assemble(bands, "cpu"), x)


def test_row_band_call_gives_row0_and_crops():
    """fn sees its padded band and the screen row of its first padded
    row (negative on band 0); the halos are cropped off its outputs."""
    x = _image(16, lead=())
    mesh = cpu_mesh(4)
    seen = []

    def fn(imgs, row0, k):
        seen.append((row0, imgs[0].clone()))
        return imgs[0] * k, imgs[0] + row0

    a, b = halo.row_band_call(mesh, "sp", fn, (x,), (torch.tensor(2.0),),
                              halo_top=2, halo_bot=3)
    assert [r for r, _ in seen] == [-2, 2, 6, 10]
    for (row0, img), s in zip(seen, (0, 4, 8, 12)):
        assert torch.equal(img, _clamped(x, s - 2, s + 4 + 3))
    assert torch.equal(halo.assemble(a, "cpu"), x * 2)
    assert [t.shape[-2] for t in b] == [4, 4, 4, 4]
    assert torch.equal(b[0], x[:4] - 2)


def test_band_starts_even_or_raise():
    assert halo.band_starts(1088, 4) == [0, 272, 544, 816, 1088]
    assert halo.band_starts(100, 3) == [0, 34, 68, 100]
    for h, n in ((99, 3), (6, 4)):
        with pytest.raises(ValueError):
            halo.band_starts(h, n)


def test_replicas_once_per_distinct_device():
    g = tp.terrain_port(RenderConfig(**tp.ORACLE)).frame_globals(0)[0]
    reps = halo.replicate(g, [torch.device("cpu")] * 4)
    assert list(reps) == [torch.device("cpu")]
    assert reps[torch.device("cpu")].camera.view is g.camera.view


# --- the mesh ---------------------------------------------------------------

def test_make_mesh_shapes_and_refusals():
    m = cpu_mesh(8, dp=2)
    assert m.shape == {"dp": 2, "sp": 4} and m.axis_names == ("dp", "sp")
    assert m.group(1).band_devices("sp") == [torch.device("cpu")] * 4
    assert pmesh.make_mesh(devices=["cpu"] * 6).shape == {"dp": 2, "sp": 3}
    with pytest.raises(ValueError):
        m.band_devices("sp")                 # dp = 2: take a group
    with pytest.raises(ValueError):
        pmesh.make_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        pmesh.make_mesh(6, dp=4, devices=["cpu"] * 6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):    # no card: no CPU fallback
            pmesh.make_mesh(2)
    else:
        with pytest.raises(ValueError):      # more than the cards
            pmesh.make_mesh(torch.cuda.device_count() + 1)


# --- K1 and K4 in band mode -------------------------------------------------

JGRID = jraster.BinGrid(width=128, height=96, bin_w=64, bin_h=32, group=2,
                        chunk=128, pair_cap=4096, med_cap=128, med_slots=16,
                        rec_dtype="f32")


def _soup(seed, n):
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-1, -1, -4], [1, 1, -2], (n, 3))
    offs = rng.uniform(-0.5, 0.5, (n, 3, 3))
    return (centers[:, None, :] + offs).reshape(-1, 3).astype(np.float32)


def _jax_inputs(jgrid, verts, cull="none", vh=None):
    """The JAX package's starts and bin-ordered f32 records for `jgrid`
    (rasterize's own steps: the setup on the viewport of height `vh`,
    the binning on the grid, padded or not), the grid with its record
    width, and the same records in the port's layout (the setup's pixel
    box inserted before the id row, praster.build_records)."""
    clip = make_clip(verts)
    n = len(verts) // 3
    planar = jnp.asarray(clip.reshape(n, 3, 4).transpose(1, 2, 0))
    setup = jraster.triangle_setup_planar(planar, jgrid.width,
                                          vh or jgrid.height, cull)
    starts, st, _ = jraster.build_pairs(setup, jgrid)
    recs = jraster.build_records(setup, dtype="f32")
    box = jnp.pad(setup.bbox, ((0, 0), (0, 1)))      # the sentinel's 0
    S = st.shape[0]
    cap = min(jgrid.pair_cap, -(-S // jgrid.chunk) * jgrid.chunk)
    cols = jnp.minimum(st[:min(S, cap)], n)
    rs, bs = recs[:, cols], box[:, cols]
    if rs.shape[1] < cap:
        rs = jnp.pad(rs, ((0, 0), (0, cap - rs.shape[1])))
        bs = jnp.pad(bs, ((0, 0), (0, cap - bs.shape[1])))
    port = np.concatenate([np.asarray(rs)[:15], np.asarray(bs),
                           np.asarray(rs)[15:]])
    assert port.shape[0] == praster.REC_ROWS
    return (starts, rs, dataclasses.replace(jgrid, pair_cap=cap),
            torch.from_numpy(port))


@pytest.mark.parametrize("sp", [2, 3])
@pytest.mark.parametrize("depth_only", [False, True])
def test_resolve_row_sharded_equals_unsplit_and_jax(sp, depth_only):
    """H = 96 (3 bin rows of 32) padded to a multiple of sp bin rows: the
    port's resolve_row_sharded on a ["cpu"] * sp mesh, band by band, is
    bit-identical to its unsplit resolve, and the padded bin rows
    resolve to the clear.  Against the JAX resolve_row_sharded
    (interpret mode, sp virtual devices) on the same starts and records:
    XLA's CPU jit contracts a*b + c into FMA and the port does not, so
    the bounds are test_torch_raster.py's kind: every id equal off depth
    ties (>= 0.999 of the pixels), depth within 1e-6 where they agree
    (measured: all ids equal, depth 2.4e-7)."""
    BYp = -(-3 // sp) * sp
    jgrid = dataclasses.replace(JGRID, height=BYp * 32)
    verts = np.concatenate([_soup(4, 60), _soup(5, 20) * 0.3])
    js, jr, jg, recs = _jax_inputs(jgrid, verts, vh=96)
    starts = torch.from_numpy(np.array(js))
    grid = convert.grid_from_jax(jg)
    pd, pt = praster.resolve_row_sharded(starts, recs, grid, cpu_mesh(sp),
                                         "sp", depth_only=depth_only)
    assert [b.shape[-2] for b in pd] == [BYp // sp * 32] * sp
    whole = (praster.resolve_depth(starts, recs, grid) if depth_only
             else praster.resolve(starts, recs, grid))
    whole = whole if isinstance(whole, tuple) else (whole, None)
    assert torch.equal(halo.assemble(pd, "cpu"), whole[0])
    if not depth_only:
        assert torch.equal(halo.assemble(pt, "cpu"), whole[1])
        assert (whole[1][96:] == -1).all() and (whole[1] >= 0).any()
    assert (whole[0][96:] == 1.0).all()
    mesh = jmesh.make_mesh(sp, dp=1)
    with mesh:
        jd, jt = jax.jit(lambda s, r: jraster.resolve_row_sharded(
            s, r, jg, mesh, "sp", interpret=True,
            depth_only=depth_only))(js, jr)
    agree = np.ones(whole[0].shape, bool)
    if not depth_only:
        agree = whole[1].numpy() == np.asarray(jt)
        assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(whole[0].numpy()[agree],
                               np.asarray(jd)[agree], rtol=0, atol=1e-6)


def test_band_resolve_is_the_band_of_the_whole():
    """resolve / resolve_depth of bin rows [row0, row0 + band_by) are
    those rows of the whole grid's, the edge bands included; a band past
    the grid raises."""
    js, jr, jg, recs = _jax_inputs(dataclasses.replace(JGRID, height=128),
                                   _soup(6, 80))
    starts = torch.from_numpy(np.array(js))
    grid = convert.grid_from_jax(jg)
    d, t = praster.resolve(starts, recs, grid)
    dd = praster.resolve_depth(starts, recs, grid)
    for row0, n in ((0, 1), (1, 2), (3, 1), (0, 4)):
        rows = slice(row0 * 32, (row0 + n) * 32)
        bd, bt = praster.resolve(starts, recs, grid, row0=row0, band_by=n)
        assert torch.equal(bd, d[rows]) and torch.equal(bt, t[rows])
        assert torch.equal(praster.resolve_depth(
            starts, recs, grid, row0=row0, band_by=n), dd[rows])
    with pytest.raises(ValueError):
        praster.resolve(starts, recs, grid, row0=3, band_by=2)


# --- K3 and the SSAO path in band mode -------------------------------------

@pytest.mark.parametrize("starts", [(0, 16, 32, 48, 64), (0, 2, 40, 64)])
def test_band_reproject_equals_unsplit(starts):
    """reproject_plain of a band (row0, the whole history) is the band's
    rows of the unsplit fetch, bit for bit, with velocities that reach
    past the band and off the screen."""
    rng = np.random.default_rng(7)
    hist = torch.from_numpy(rng.uniform(size=(5, 64, 48))
                            .astype(np.float32)).to(torch.bfloat16)
    vel = torch.from_numpy(rng.normal(0, 0.2, (2, 64, 48))
                           .astype(np.float32))
    whole = ptaa.reproject_history(hist, vel)
    for a, b in zip(starts, starts[1:]):
        got = ptaa.reproject_history(hist, vel[:, a:b], row0=a)
        assert torch.equal(got, whole[:, a:b])
    with pytest.raises(ValueError):
        ptaa.reproject_history(hist, vel[:, :8], row0=60)


@pytest.fixture(scope="module")
def terrain_port():
    return tp.terrain_port(RenderConfig(**tp.ORACLE))


def test_ssao_bands_equal_unsplit(terrain_port, monkeypatch):
    """ssao_row_bands on a ["cpu"] * 4 mesh (preamble and taps per band
    against the whole depth, blur and upsample with their halos) equals
    the unsplit SSAO, upsampled, bit for bit; so do the band's half-res
    taps (ssao_generate with row0)."""
    monkeypatch.setattr(pssao, "_rand", tp.smooth_rand_torch)
    built = terrain_port
    g, mm, nm = built.frame_globals(0)
    vis, records, _, _ = pframe.raster_stage(built.plan, built.batch, g, mm,
                                             nm)
    from soc_real_time_renderer_tpu_torch.ops import gbuffer, sampling
    gb = gbuffer.resolve_gbuffer(
        vis, records, built.batch.atlas_packed, g.camera_prev.projection_view,
        atlas_size=built.plan.atlas_size,
        layer_stride=built.plan.atlas_layer_stride,
        n_levels=built.plan.atlas_n_levels)
    half = pssao.ssao_generate(vis.depth, gb.normal, g)
    want = sampling.upsample_bilinear(pssao.ssao_blur(half), 64, 128)
    mesh = cpu_mesh(4)
    d = halo.split_rows(vis.depth, ["cpu"] * 4)
    n = halo.split_rows(gb.normal, ["cpu"] * 4)
    got = pssao.ssao_row_bands(mesh, "sp", d, n, vis.depth, g)
    assert torch.equal(halo.assemble(got, "cpu"), want)
    assert want.std() > 1e-3
    band = pssao.ssao_generate(vis.depth[16:32], gb.normal[:, 16:32], g,
                               row0=16, depth_full=vis.depth)
    assert torch.equal(band, half[8:16])
    with pytest.raises(ValueError):
        pssao.ssao_generate(vis.depth[15:31], gb.normal[:, 15:31], g,
                            row0=15, depth_full=vis.depth)


# --- the sharded shade against the JAX one and the unsplit frame ----------

def _pair(name):
    if name == "terrain":
        return tp.terrain_jax(), tp.terrain_port(RenderConfig(**tp.ORACLE))
    return kit.build_pair(name, jcfg.RenderConfig(**tp.ATRIUM),
                          RenderConfig(**tp.ATRIUM))


def _sharded_frames(jb, pb, frames=2):
    """`frames` frames of the JAX make_sharded_shade_fn (oracle plan, a
    (1, 4) mesh of the virtual devices) and of the port's (a ["cpu"] * 4
    mesh, raster_stage split alike), each carrying its history, and of
    the port's unsplit render_frame -> [(jax colour, jax history, port
    colour bands, port history, unsplit outputs, unsplit history)]."""
    jplan = tp.oracle_plan(jb.plan)
    jm = jmesh.make_mesh(4, dp=1)
    jshade = jmesh.make_sharded_shade_fn(jplan, jm)
    pm = cpu_mesh(4)
    splan = dataclasses.replace(pb.plan, shard_mesh=pm, shard_axis="sp")
    pshade = pmesh.make_sharded_shade_fn(pb.plan, pm)
    jh = jframe.RenderHistory.create(jb.plan.config)
    ph = uh = pframe.RenderHistory.create(pb.plan.config, device="cpu")
    out = []
    for f in range(frames):
        jg, jmm, jnm = jb.frame_globals(f)
        pg, pmm, pnm = pb.frame_globals(f)
        jin = jframe.raster_stage(jplan, jb.batch, jg, jmm, jnm)
        with jm:
            jc, jh = jshade(jb.batch, jg, jh, *jin)
            jc = np.asarray(jc)
        pin = pframe.raster_stage(splan, pb.batch, pg, pmm, pnm)
        assert isinstance(pin[0].depth, list) and isinstance(pin[1], dict)
        pc, ph = pshade(pb.batch, pg, ph, *pin)
        uo, uh = pframe.render_frame(pb.plan, pb.batch, pg, uh, pmm, pnm)
        out.append((jc, jh, pc, ph, uo, uh))
    return out


@pytest.fixture(scope="module", params=["terrain", "atrium_lifted"])
def sharded(request):
    jb, pb = _pair(request.param)
    with pytest.MonkeyPatch.context() as mp:
        tp.shared_inputs(mp, tp.luts_seeded())
        frames = _sharded_frames(jb, pb)
    return request.param, pb, frames


@pytest.mark.parametrize("frame", [0, 1])
def test_sharded_shade_matches_jax(sharded, frame):
    """Colour and history colour of the port's 4-band shade at the
    scene's frame bounds (mean abs, 99.9th percentile) of the JAX
    sharded shade; exposure within 1e-4 stops."""
    name, _, frames = sharded
    jc, jh, pc, ph, _, _ = frames[frame]
    assert [b.shape for b in pc] == [(3, 16, 128)] * 4
    got = halo.assemble(pc, "cpu").numpy()
    assert got.std() > 1e-3
    tp._image_bounds(jc, got, *BOUNDS[name])
    tp._image_bounds(np.asarray(jh.previous_color, np.float32),
                     halo.assemble(ph.previous_color, "cpu").float().numpy(),
                     *BOUNDS[name])
    assert abs(float(jh.exposure) - float(ph.exposure)) < 1e-4


@pytest.mark.parametrize("frame", [0, 1])
def test_sharded_shade_equals_unsplit(sharded, frame):
    """The port's split frame (K1 / K4 per band of bin rows, the shade
    per band) against its unsplit render_frame carrying its own history:
    colour, history colour and velocity, exposure max abs <= 1e-6
    (measured on the CPU: 0)."""
    name, pb, frames = sharded
    _, _, pc, ph, uo, uh = frames[frame]
    worst = max((a.float() - b.float()).abs().max().item() for a, b in (
        (uo.color, halo.assemble(pc, "cpu")),
        (uh.previous_color, halo.assemble(ph.previous_color, "cpu")),
        (uh.previous_velocity, halo.assemble(ph.previous_velocity, "cpu")),
        (uh.exposure, ph.exposure)))
    assert worst <= 1e-6, (name, worst)
    if name == "atrium_lifted":
        assert not pb.plan.shadow_statically_empty


def test_unsplit_inputs_into_the_sharded_shade(sharded):
    """make_sharded_shade_fn takes the unsplit raster_stage's whole
    tensors too (as the JAX one does) and gives the same bands."""
    name, pb, _ = sharded
    with pytest.MonkeyPatch.context() as mp:
        tp.shared_inputs(mp, tp.luts_seeded())
        g, mm, nm = pb.frame_globals(0)
        h = pframe.RenderHistory.create(pb.plan.config, device="cpu")
        ins = pframe.raster_stage(pb.plan, pb.batch, g, mm, nm)
        pc, _ = pmesh.make_sharded_shade_fn(pb.plan, cpu_mesh(4))(
            pb.batch, g, h, *ins)
        want, _ = pframe.shade_stage(pb.plan, pb.batch, g, h, *ins)
    assert torch.equal(halo.assemble(pc, "cpu"), want.color)


@pytest.mark.parametrize("rows,n", [(96, 4), (100, 3)])
def test_uneven_and_padded_bands_equal_unsplit(rows, n):
    """A height whose bin rows need padding (96 rows, 3 bin rows, 4
    bands) and one that cuts into unequal bands (100 rows: 34, 34, 32)
    on atrium_lifted (shadow split too): the split frame equals the
    unsplit one."""
    cfg = RenderConfig(**dict(tp.ATRIUM, height=rows, shadow_resolution=512))
    pb = kit.build_port("atrium_lifted", cfg, "cpu")
    splan = dataclasses.replace(pb.plan, shard_mesh=cpu_mesh(n),
                                shard_axis="sp")
    with pytest.MonkeyPatch.context() as mp:
        tp.shared_inputs(mp, tp.luts_seeded())
        g, mm, nm = pb.frame_globals(0)
        h = pframe.RenderHistory.create(cfg, device="cpu")
        want, _ = pframe.render_frame(pb.plan, pb.batch, g, h, mm, nm)
        got, gh = pframe.render_frame(splan, pb.batch, g, h, mm, nm)
    assert halo.starts_of(got.color) == halo.band_starts(rows, n)
    assert torch.equal(halo.assemble(got.color, "cpu"), want.color)
    odd = dataclasses.replace(cfg, height=rows - 1)
    with pytest.raises(ValueError):
        halo.band_starts(odd.height, n)


# --- rebuilds keep the split; the package stays free of jax ---------------

def test_rebuild_keeps_the_split():
    """BuiltScene.rebuild keeps shard_mesh / shard_axis in both tiers, as
    the JAX rebuild keeps them (_PLAN_OVERRIDES)."""
    built = kit.build_port("atrium_lifted", RenderConfig(**tp.ORACLE), "cpu")
    mesh = cpu_mesh(2)
    built.plan = dataclasses.replace(built.plan, shard_mesh=mesh,
                                     shard_axis="sp")
    batch0 = built.batch
    built.rebuild()                          # the same models: cheap tier
    assert built.batch is batch0
    assert built.plan.shard_mesh is mesh and built.plan.shard_axis == "sp"
    ent = built.scene.mesh_entities()[0]
    from soc_real_time_renderer_tpu_torch.scene.components import \
        MeshComponent
    comp = ent.get_component(MeshComponent)
    comp.model = dataclasses.replace(comp.model)   # a new model object
    built.rebuild()                          # another model: full tier
    assert built.batch is not batch0
    assert built.plan.shard_mesh is mesh and built.plan.shard_axis == "sp"
    assert "shard_mesh" in pscenes.BuiltScene._PLAN_OVERRIDES


def test_parallel_imports_no_jax():
    code = ("import sys\n"
            "import soc_real_time_renderer_tpu_torch.parallel.halo\n"
            "import soc_real_time_renderer_tpu_torch.parallel.mesh\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'soc_real_time_renderer_tpu' "
            "or m.startswith('soc_real_time_renderer_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root)
