"""The passes that are off by default with a leading view axis: SSR,
depth of field, the per-pixel cloud march and the volumetric light each
take one call for a batch of views (``ops/ssr.py``, ``ops/dof.py``,
``ops/clouds.render_clouds``, ``ops/composition._volumetric``), as every
pass is one batched operation under the JAX package's ``vmap``.

* Each function at B = 3 (so that a (C, h, w) array cannot line up with
  the view axis by accident) on random 32x64 fields from numpy seeds,
  views of distinct cameras, suns, clip planes, focus and time, against
  its single-view calls: max abs <= 1e-6 (SSR, DoF, the volumetric
  term; every operation is elementwise or a gather from the view's own
  image, so 0 is what the CPU gives), and <= 1e-7 for the cloud march
  (the bound of test_torch_passes.py::test_render_clouds_chunking: on
  the CPU, PyTorch's vectorised exp and sqrt round the tail of a loop
  unlike its body, and a chunk of rows now straddles views).
* The port's ``make_batched_render_fn`` with the ``atrium_passes``
  switches (2 views at 128x64) and on ``terrain_perpixel`` (64x32)
  against the JAX ``make_batched_render_fn`` (``vmap`` on a dp = 2 mesh
  of the virtual CPU devices), sky LUT and SSAO hash shared as in
  test_torch_parallel.py, at test_torch_passes_frames.py's bounds.
* The 4-band split frame on a ["cpu"] * 4 mesh with the passes on,
  one view and a batch of two, against its unsplit frame (max abs <=
  1e-6; 0 is what the CPU gives).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel as tp
import torch_scene_kit as kit
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.parallel import mesh as jmesh
from soc_real_time_renderer_tpu_torch.camera import Camera3D, \
    camera_matrices
from soc_real_time_renderer_tpu_torch.config import RenderConfig, \
    ShaderGlobals, SunInfo
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import composition as pcomp
from soc_real_time_renderer_tpu_torch.ops import dof as pdof
from soc_real_time_renderer_tpu_torch.ops import ssr as pssr
from soc_real_time_renderer_tpu_torch.parallel import halo
from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
from soc_real_time_renderer_tpu_torch.utils import mathutil as mu

B, H, W = 3, 32, 64


def _views():
    """([ShaderGlobals of each view], batched globals): B cameras of
    distinct field of view, clip planes, position and direction, each
    under its own sun (near the scene, so that the volumetric march
    samples fall inside its map), time and lens."""
    gs = []
    for i in range(B):
        cam = Camera3D(fov=70.0 + 15.0 * i, near_clip=0.1 + 0.05 * i,
                       far_clip=1000.0 - 200.0 * i)
        cam.resize(W, H)
        eye = np.float32([0.3 * i, 0.2 * i, 1.0 + 0.2 * i])
        cam.view_mat = mu.look_at(eye, eye + np.float32([0.1 * i, 0.05 * i,
                                                         -1.0]),
                                  np.float32([0.0, 1.0, 0.0]))
        cm = camera_matrices(cam, eye, i + 1, W, H)
        gs.append(ShaderGlobals.create(
            camera=cm, camera_prev=cm, near_clip=cam.near_clip,
            far_clip=cam.far_clip,
            sun=SunInfo.create(angle_direction_deg=(4.0 + 12.0 * i,
                                                    30.0 * i, 5.0 * i),
                               position=(0.0, 4.0, 0.0)),
            frame_counter=np.int32(i + 1),
            elapsed_time=np.float32(1.0 + 2.0 * i),
            focal_length=np.float32(5.0 - i),
            plane_in_focus=np.float32(1.0 + 0.5 * i),
            aperture=np.float32(8.0 - 2.0 * i)))
    return gs, pmesh.batched_globals(gs)


def _fields(seed=3):
    """depth (B, H, W) in [0.3, 0.8], albedo and unit normals (B, 3, H,
    W), metallic-roughness (B, 2, H, W) with 10%, 50% and 30% of the
    pixels metallic in views 0, 1 and 2."""
    rng = np.random.default_rng(seed)
    depth = (0.3 + 0.5 * rng.random((B, H, W))).astype(np.float32)
    albedo = rng.random((B, 3, H, W), dtype=np.float32)
    n = rng.normal(size=(B, 3, H, W)).astype(np.float32)
    normal = n / np.linalg.norm(n, axis=1, keepdims=True)
    metal = (rng.random((B, H, W))
             < np.array([0.1, 0.5, 0.3])[:, None, None]).astype(np.float32)
    mr = np.stack([np.full((B, H, W), 0.5, np.float32), metal], 1)
    return [torch.from_numpy(a) for a in (depth, albedo, normal, mr)]


def _worst(batched, singles):
    return max((a - b).abs().max().item() for a, b in zip(batched, singles))


@pytest.fixture(scope="module")
def views():
    return _views()


# --- each function at B = 3 against its single-view calls ------------------

@pytest.mark.parametrize("cap", ["dense", "one_view_over", "all_under"])
def test_ssr_batched_equals_single_views(views, cap):
    """The dense march and the per-view compaction: a cap that view 1
    (50% metallic) overflows and views 0 and 2 do not gives bit 16 and
    the reflective-pixel count per view; every output equals the
    single-view call's."""
    gs, gb = views
    f = _fields()
    n_act = [int((f[3][i, 1] >= pssr.METALLIC_MIN).sum()) for i in range(B)]
    assert n_act[0] < n_act[2] < n_act[1]
    compact = {"dense": 0, "one_view_over": n_act[2] + 10,
               "all_under": 10 ** 9}[cap]
    out, ovf, n = pssr.ssr(*f, gb, compact_cap=compact)
    assert out.shape == (B, 3, H, W) and ovf.shape == n.shape == (B,)
    singles = [pssr.ssr(*(a[i] for a in f), gs[i], compact_cap=compact)
               for i in range(B)]
    assert _worst(out, [s[0] for s in singles]) <= 1e-6
    assert [int(x) for x in ovf] == [int(s[1]) for s in singles]
    assert [int(x) for x in n] == [int(s[2]) for s in singles]
    if cap == "dense":
        assert (n == -1).all() and (ovf == 0).all()
    else:
        assert n.tolist() == n_act
        assert ovf.tolist() == ([0, pssr.OVERFLOW_SSR_CAP, 0]
                                if cap == "one_view_over" else [0] * 3)
    metal = f[3][:, 1] >= pssr.METALLIC_MIN
    assert (out.permute(1, 0, 2, 3)[:, metal] != 0).any(0).float().mean() \
        > 0.2, "rays found hits"


def test_dof_batched_equals_single_views(views):
    """Each view's CoC from its own clip planes, focus and aperture, its
    taps from its own mip chain; sky pixels (depth 1) pass through."""
    gs, gb = views
    rng = np.random.default_rng(7)
    color = torch.from_numpy(rng.random((B, 3, H, W), dtype=np.float32)
                             * 4.0)
    depth = _fields()[0]
    depth[torch.from_numpy(rng.random((B, H, W)) < 0.2)] = 1.0
    levels = pdof.build_mips_device(color)
    assert [tuple(lv.shape) for lv in levels][-1] == (B, 3, 1, 2)
    out = pdof.depth_of_field(color, depth, gb)
    singles = [pdof.depth_of_field(color[i], depth[i], gs[i])
               for i in range(B)]
    assert _worst(out, singles) <= 1e-6
    sky = (depth == 1.0)[:, None].expand_as(color)
    assert torch.equal(out[sky], color[sky])
    blur = [(out[i] - color[i]).abs().mean().item() for i in range(B)]
    assert min(blur) > 0.05 and len({round(b, 4) for b in blur}) == B


@pytest.mark.parametrize("quadrant", [False, True])
@pytest.mark.parametrize("rows_per_chunk", [64, 7])
def test_render_clouds_batched_equals_single_views(views, quadrant,
                                                   rows_per_chunk):
    """The march at (16, 32) half-res pixels a view, the upper 20 rows
    of depth sky, with and without the QUADRANT quirk; one chunk over
    all 48 (view, row) rows, and chunks of 7 rows straddling views."""
    gs, gb = views
    depth = _fields()[0]
    depth[:, :20] = 1.0
    noise = torch.from_numpy(kit.cloud_noise())
    kw = dict(full_width=W, full_height=H) if quadrant else {}
    out = pclouds.render_clouds(gb, depth, noise, W // 2, H // 2,
                                rows_per_chunk=rows_per_chunk, **kw)
    assert out.shape == (B, 3, H // 2, W // 2)
    singles = [pclouds.render_clouds(gs[i], depth[i], noise, W // 2, H // 2,
                                     rows_per_chunk=rows_per_chunk, **kw)
               for i in range(B)]
    assert _worst(out, singles) <= 1e-7
    clear = torch.tensor([0.2, 0.4, 1.0])[:, None, None]
    sky = (out != clear).any(1)
    assert torch.isfinite(out).all() and sky.float().mean() > 0.3
    assert (out[0] - out[1]).abs()[:, sky[0] & sky[1]].mean() > 1e-3


@pytest.mark.parametrize("empty", [False, True])
def test_volumetric_batched_equals_single_views(views, empty):
    """compose with the volumetric term over each view's own (64, 64)
    shadow map, and over the proved-empty map: one _volumetric call for
    the batch, equal to the single-view compose; the term is there."""
    gs, gb = views
    depth, albedo, normal, _ = _fields()
    rng = np.random.default_rng(11)
    smap = None if empty else torch.from_numpy(
        rng.random((B, 64, 64), dtype=np.float32))
    ssao = torch.from_numpy(rng.random((B, H, W), dtype=np.float32))
    clouds = torch.from_numpy(rng.random((B, 3, H, W), dtype=np.float32))
    kw = dict(enable_volumetric=True, max_point_lights=0, max_spot_lights=0,
              empty_shadow_map=empty)
    args = (depth, albedo, albedo, normal, ssao, smap, clouds)
    out = pcomp.compose(gb, *args, **kw)
    singles = [pcomp.compose(gs[i], *(None if a is None else a[i]
                                      for a in args), **kw)
               for i in range(B)]
    assert _worst(out, singles) <= 1e-6
    off = pcomp.compose(gb, *args, **{**kw, "enable_volumetric": False})
    assert all((out[i] - off[i]).abs().mean() > 1e-3 for i in range(B))


# --- the batched step against the JAX vmap step ----------------------------

SWITCHES = {
    "atrium_passes": dict(enable_ssr=True, composite_ssr=True,
                          enable_depth_of_field=True,
                          enable_volumetric_light=True),
    "terrain_perpixel": dict(cloud_impl="perpixel", width=64, height=32),
}
SSR_CAP = 4096           # above the reduced atrium's reflective pixels
# two views each (the terrain's second position of test_torch_parallel.py
# sees 1% sky at 64x32, its third 40%)
POSITIONS = {"atrium_passes": tp.POSITIONS["atrium_lifted"][:2],
             "terrain_perpixel": tp.POSITIONS["terrain"][::2]}


def _configs(name):
    cfg = {**tp.ORACLE, "shadow_resolution": 512, **SWITCHES[name]}
    return jcfg.RenderConfig(**cfg), RenderConfig(**cfg)


def _jax_step(plan, mesh, H_, W_):
    """The JAX make_batched_render_fn, with the render_frame it vmaps
    wrapped so that each view's colour carries its SSR target, its
    ssr_active and its clouds target (zero-padded to H_ x W_) as more
    channels: one compile of the step gives them too."""
    real = jframe.render_frame

    def render_frame(*a, **k):
        out, h = real(*a, **k)
        extra = [out.ssr if out.ssr is not None
                 else jnp.zeros((3, H_, W_), jnp.float32),
                 jnp.broadcast_to(out.ssr_active.astype(jnp.float32),
                                  (1, H_, W_))]
        c = out.clouds
        extra.append(jnp.pad(c, ((0, 0), (0, H_ - c.shape[1]),
                                 (0, W_ - c.shape[2]))))
        return dataclasses.replace(
            out, color=jnp.concatenate([out.color] + extra)), h

    return jmesh.make_batched_render_fn(plan, mesh), render_frame


@pytest.fixture(scope="module")
def port_step():
    """name -> (port BuiltScene, its plan at SSR_CAP, (colour, history)
    of the port's unmeshed batched step on frame 0 of the scene's two
    views, sky LUT and SSAO hash shared): rendered once in the module,
    read by batched_pair and by the split test's two-view case."""
    done = {}

    def get(name):
        if name not in done:
            pb = kit.build_port(name, _configs(name)[1], "cpu")
            plan = dataclasses.replace(pb.plan, ssr_cap=SSR_CAP)
            gs, mm, nm = pmesh.view_globals(pb, POSITIONS[name], 0)
            hb = pmesh.batched_history([pframe.RenderHistory.create(
                plan.config, device="cpu") for _ in range(2)])
            with pytest.MonkeyPatch.context() as mp:
                tp.shared_inputs(mp, tp.luts_seeded())
                step = pmesh.make_batched_render_fn(plan)(
                    pb.batch, pmesh.batched_globals(gs), hb, mm, nm)
            done[name] = pb, plan, step
        return done[name]
    return get


@pytest.fixture(scope="module", params=["atrium_passes", "terrain_perpixel"])
def batched_pair(request, port_step):
    """One batched frame of 2 views of both packages -> (name, JAX
    colour, JAX extra targets (ssr, ssr_active, clouds), port colour,
    port outputs of render_frame on the batch, port step's history, JAX
    history)."""
    name = request.param
    jc_, pc_ = _configs(name)
    jb = kit.build_jax(name, jc_)
    pb, pplan, (pc, ph2) = port_step(name)
    jplan = dataclasses.replace(tp.oracle_plan(jb.plan), ssr_cap=SSR_CAP)
    positions = POSITIONS[name]
    Hc, Wc = pc_.height, pc_.width
    mesh = jmesh.make_mesh(2, dp=2)
    jstep, wrapped = _jax_step(jplan, mesh, Hc, Wc)
    jh = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[jframe.RenderHistory.create(jplan.config) for _ in range(2)])
    ph = pmesh.batched_history([pframe.RenderHistory.create(
        pplan.config, device="cpu") for _ in range(2)])
    with pytest.MonkeyPatch.context() as mp:
        tp.shared_inputs(mp, tp.luts_seeded())
        jgs, jmm, jnm = pmesh.view_globals(jb, positions, 0)
        pgs, pmm, pnm = pmesh.view_globals(pb, positions, 0)
        mp.setattr(jframe, "render_frame", wrapped)
        with mesh:
            jc, jh = jstep(jb.batch, jmesh.batched_globals(jgs), jh, jmm,
                           jnm)
            jc = np.asarray(jc)
        pgb = pmesh.batched_globals(pgs)
        po, _ = pframe.render_frame(pplan, pb.batch, pgb, ph, pmm, pnm)
    return name, jc[:, :3], jc[:, 3:], pc, po, ph2, jh


def test_batched_passes_match_jax(batched_pair):
    """Per view: colour and history colour at the frame bounds of
    test_torch_passes_frames.py (mean abs < 2e-4, 99.9th percentile <
    1e-2; read: mean <= 1.4e-5, p99.9 <= 8.1e-4), exposure within 1e-4
    stops; the port step's colour is render_frame's on the same batch."""
    name, jc, _, pc, po, ph, jh = batched_pair
    assert pc.shape == jc.shape and pc.shape[0] == 2
    assert torch.equal(pc, po.color)
    for i in range(2):
        tp._image_bounds(jc[i], pc[i].numpy(), 2e-4, 1e-2)
        tp._image_bounds(np.asarray(jh.previous_color[i], np.float32),
                         ph.previous_color[i].float().numpy(), 2e-4, 1e-2)
        assert abs(float(jh.exposure[i]) - float(ph.exposure[i])) < 1e-4
    assert (pc[0] - pc[1]).abs().mean() > 1e-3


def test_batched_pass_targets_match_jax(batched_pair):
    """atrium_passes: each view's SSR target within mean abs 1e-6 of the
    JAX view's (read 2.4e-7: the flat materials' albedo differs by an
    ulp between the packages' texture taps) and its ssr_active equal
    (under the cap, > 1% of the pixels); terrain_perpixel: each view's
    clouds target at the cloud bounds of test_torch_passes_frames.py
    (median < 1e-5, mean < 5e-5; read: median 0, mean <= 1.1e-5)."""
    name, _, jx, _, po, _, _ = batched_pair
    for i in range(2):
        if name == "atrium_passes":
            d = np.abs(po.ssr[i].numpy() - jx[i, :3])
            assert d.mean() < 1e-6, d.mean()
            n = int(po.ssr_active[i])
            assert n == int(jx[i, 3, 0, 0])
            assert 0.01 * 128 * 64 < n <= SSR_CAP
            assert int(po.overflow[i]) == 0
        else:
            h, w = po.clouds.shape[-2:]
            got = po.clouds[i].numpy()
            d = np.abs(got - jx[i, 4:, :h, :w])
            assert np.isfinite(got).all()
            assert np.median(d) < 1e-5 and d.mean() < 5e-5, d.mean()
            sky = (got != np.float32([0.2, 0.4, 1.0])[:, None, None]).any(0)
            assert sky.mean() > 0.1


# --- the split frame against the unsplit one -------------------------------

@pytest.mark.parametrize("views_", [1, 2])
@pytest.mark.parametrize("name", ["atrium_passes", "terrain_perpixel"])
def test_split_passes_equal_unsplit(port_step, name, views_):
    """The frame in 4 row bands over a ["cpu"] * 4 mesh, its SSR, DoF
    and cloud march on the gathered screen and its volumetric term per
    band, against the unsplit frame: colour, hdr, the SSR target, the
    reflective-pixel count and the history; one view (render_frame of
    the split plan), and two (the meshed batched step on a (1, 4)
    mesh against the unmeshed one, port_step's)."""
    _, cfg = _configs(name)
    if views_ == 1:
        pb = kit.build_port(name, cfg, "cpu")
        plan = dataclasses.replace(pb.plan, ssr_cap=SSR_CAP)
    else:
        pb, plan, (want, wh) = port_step(name)
    mesh = pmesh.make_mesh(4, dp=1, devices=["cpu"] * 4)
    with pytest.MonkeyPatch.context() as mp:
        tp.shared_inputs(mp, tp.luts_seeded())
        if views_ == 1:
            g, mm, nm = pb.frame_globals(0)
            h = pframe.RenderHistory.create(cfg, device="cpu")
            splan = dataclasses.replace(plan, shard_mesh=mesh,
                                        shard_axis="sp")
            want, wh = pframe.render_frame(plan, pb.batch, g, h, mm, nm)
            got, gh = pframe.render_frame(splan, pb.batch, g, h, mm, nm)
            pairs = [(want.color, halo.assemble(got.color, "cpu")),
                     (want.hdr, halo.assemble(got.hdr, "cpu")),
                     (wh.previous_color,
                      halo.assemble(gh.previous_color, "cpu")),
                     (wh.exposure, gh.exposure)]
            if name == "atrium_passes":
                pairs.append((want.ssr, got.ssr))
                assert int(got.ssr_active) == int(want.ssr_active) > 0
        else:
            positions = POSITIONS[name]
            gs, mm, nm = pmesh.view_globals(pb, positions, 0)
            gb = pmesh.batched_globals(gs)
            hb = pmesh.batched_history([pframe.RenderHistory.create(
                cfg, device="cpu") for _ in range(2)])
            batch, gm, hm = pmesh.shard_inputs(mesh, pb.batch, gb, hb)
            got, gh = pmesh.make_batched_render_fn(plan, mesh=mesh)(
                batch, gm, hm, mm, nm)
            gh = pmesh.assemble_history(gh, "cpu")
            pairs = [(want, pmesh.assemble_views(got, "cpu")),
                     (wh.previous_color, gh.previous_color),
                     (wh.exposure, gh.exposure)]
    worst = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    assert worst <= 1e-6, worst
