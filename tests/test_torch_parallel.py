"""Batched multi-camera rendering: ``parallel/mesh.py`` of the port (a
leading view axis through the frame, each kernel launched once for the
B views) against the JAX package's ``make_batched_render_fn``
(``jax.vmap`` of ``render_frame`` on a (dp=2, sp=1) mesh of the virtual
CPU devices), and against the port's own single-view ``render_frame``.

* Reduced terrain (128x64, the exact oracle plan of test_torch_frame.py)
  and reduced ``atrium_lifted`` (shadow paid, a 1024^2 map read through
  its proved crop: at 512^2 this coarse atrium's crop would cover over
  70% of the map, and the plan keeps none), B = 2 views from two camera positions, two consecutive batched
  frames carrying history: colour, history colour and exposure per view.
* View i of a batch (B = 3) against ``render_frame`` of view i, the
  passes that are off by default included (SSR, depth of field, the
  volumetric light, the per-pixel cloud march), and B = 1.
* The plain kernel versions with a view axis against themselves view by
  view; the globals stacking against the JAX package's; the checks the
  step makes before it renders; per-view exposure.

As in test_torch_frame.py, two inputs that the reference computes
ill-conditioned in float32 are shared between the packages: the sky LUT
(both packages pick it from one stacked array by ``frame_counter``,
which ``vmap`` batches) and the SSAO noise hash (a smooth one in both).
The port-only comparisons share them too: on the CPU, PyTorch's
vectorised transcendental functions round the tail of a loop unlike its
body, so the same pixel can differ in its last bit between a batched and
a single-view call, and the reference hash multiplies that by 4e4.
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

import torch_scene_kit as kit
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu import scenes as jscenes
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.models import terrain as jterrain
from soc_real_time_renderer_tpu.ops import clouds as jclouds
from soc_real_time_renderer_tpu.ops import ssao as jssao
from soc_real_time_renderer_tpu.parallel import mesh as jmesh
from soc_real_time_renderer_tpu.scene.components import MeshComponent, \
    TransformComponent
from soc_real_time_renderer_tpu.scene.scene import Scene
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig, SunInfo, \
    select_view, view_count
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.models import terrain as pterrain
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import exposure as pexposure
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster
from soc_real_time_renderer_tpu_torch.ops import ssao as pssao
from soc_real_time_renderer_tpu_torch.ops import taa as ptaa
from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
from soc_real_time_renderer_tpu_torch.scene import components as pcomp
from soc_real_time_renderer_tpu_torch.scene.scene import Scene as PScene

ORACLE = dict(width=128, height=64, ssao_impl="xla", taa_impl="xla")
ATRIUM = dict(ORACLE, shadow_resolution=1024)
# the views' camera positions (each scene's own first, then moved)
POSITIONS = {
    "terrain": ([20.0, 12.0, 20.0], [26.0, 15.0, 14.0], [16.0, 10.0, 25.0]),
    "atrium_lifted": ([-7.0, 33.8, 0.0], [-4.0, 35.0, 2.0],
                      [-8.0, 34.5, -2.5]),
}


def smooth_rand_jax(cu, cv):
    return 0.5 + 0.5 * jnp.sin(cu * 0.7 + cv * 1.3)


def smooth_rand_torch(cu, cv):
    return 0.5 + 0.5 * torch.sin(cu * 0.7 + cv * 1.3)


def luts_seeded(n=2, seed=3):
    """(n, 3, 128, 256) sky LUTs from a seed: smooth sky-like values (the
    frames read them through the bilinear lookup only)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.05, 0.6, (n, 3, 8, 16)).astype(np.float32)
    return np.kron(base, np.ones((1, 1, 16, 16), np.float32))


def shared_inputs(mp, luts):
    """With monkeypatch `mp`: both packages' sky LUT picked from `luts`
    by frame_counter, both SSAO hashes the smooth one."""
    jl, pl = jnp.asarray(luts), torch.from_numpy(luts)
    mp.setattr(jssao, "_rand", smooth_rand_jax)
    mp.setattr(pssao, "_rand", smooth_rand_torch)
    mp.setattr(jclouds, "render_sky_lut",
               lambda g_, *a, **k: jl[g_.frame_counter])
    mp.setattr(pclouds, "render_sky_lut",
               lambda g_, *a, **k: pl[g_.frame_counter.long()])


def terrain_port(cfg):
    hm = pterrain.procedural_heightmap(64)
    model = pterrain.build_terrain_model(hm, pterrain.default_albedo(hm),
                                         tess_level=1)
    scene = PScene("terrain")
    e = scene.create_entity("terrain")
    e.add_component(pcomp.TransformComponent())
    e.add_component(pcomp.MeshComponent()).model = model
    return pscenes._finish(scene, [model], cfg, device="cpu", atlas_size=64,
                           camera_pos=POSITIONS["terrain"][0],
                           camera_target=[50, 0, 50])


def terrain_jax():
    hm = jterrain.procedural_heightmap(64)
    model = jterrain.build_terrain_model(hm, jterrain.default_albedo(hm),
                                         tess_level=1)
    scene = Scene("terrain")
    e = scene.create_entity("terrain")
    e.add_component(TransformComponent())
    e.add_component(MeshComponent()).model = model
    return jscenes._finish(scene, [model], jcfg.RenderConfig(**ORACLE),
                           atlas_size=64, camera_pos=POSITIONS["terrain"][0],
                           camera_target=[50, 0, 50])


def oracle_plan(plan):
    """The JAX plan on its exact path: f32 records, Pallas in interpret
    mode, the XLA texture gather."""
    return dataclasses.replace(
        plan, rec_pack="f32", interpret=True, texture_impl="xla",
        main_grid=dataclasses.replace(plan.main_grid, rec_dtype="f32"),
        shadow_grid=dataclasses.replace(plan.shadow_grid, rec_dtype="f32"))


def batched_frames(jb, pb, name, B=2, frames=2):
    """Two batched frames of both packages -> [(jax colours, jax history,
    port colours, port history, port views' globals, jax batched
    globals, port batched globals, model_mats, normal_mats)] per
    frame."""
    positions = POSITIONS[name][:B]
    mesh = jmesh.make_mesh(2, dp=2)
    jstep = jmesh.make_batched_render_fn(oracle_plan(jb.plan), mesh)
    pstep = pmesh.make_batched_render_fn(pb.plan)
    jh = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[jframe.RenderHistory.create(jb.plan.config) for _ in range(B)])
    ph = pmesh.batched_history([pframe.RenderHistory.create(
        pb.plan.config, device="cpu") for _ in range(B)])
    jprev = pprev = None
    out = []
    for f in range(frames):
        jgs, jmm, jnm = pmesh.view_globals(jb, positions, f, jprev)
        pgs, pmm, pnm = pmesh.view_globals(pb, positions, f, pprev)
        jprev = [g.camera for g in jgs]
        pprev = [g.camera for g in pgs]
        jgb, pgb = jmesh.batched_globals(jgs), pmesh.batched_globals(pgs)
        with mesh:
            jc, jh = jstep(jb.batch, jgb, jh, jmm, jnm)
            jc = np.asarray(jc)
        pc, ph = pstep(pb.batch, pgb, ph, pmm, pnm)
        out.append((jc, jh, pc, ph, pgs, jgb, pgb, pmm, pnm))
    return out


@pytest.fixture(scope="module")
def terrain_pair():
    jb = terrain_jax()
    pb = terrain_port(RenderConfig(**ORACLE))
    with pytest.MonkeyPatch.context() as mp:
        shared_inputs(mp, luts_seeded())
        frames = batched_frames(jb, pb, "terrain")
    return jb, pb, frames


@pytest.fixture(scope="module")
def atrium_pair():
    jb, pb = kit.build_pair("atrium_lifted", jcfg.RenderConfig(**ATRIUM),
                            RenderConfig(**ATRIUM))
    with pytest.MonkeyPatch.context() as mp:
        shared_inputs(mp, luts_seeded())
        frames = batched_frames(jb, pb, "atrium_lifted")
    return jb, pb, frames


def _image_bounds(a, b, mean, p999):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert np.isfinite(b).all()
    assert d.mean() < mean, d.mean()
    assert np.quantile(d, 0.999) < p999, np.quantile(d, 0.999)


@pytest.mark.parametrize("scene,bounds", [
    ("terrain", (2e-3, 3e-2)), ("atrium_lifted", (2e-4, 1e-2))])
@pytest.mark.parametrize("frame", [0, 1])
def test_batched_step_matches_jax(request, scene, bounds, frame):
    """Per view: colour and history colour at the scene's frame bounds
    (mean abs, 99.9th percentile: the terrain's as in test_torch_frame,
    the atrium's as in test_torch_scenes), exposure within 1e-4 stops."""
    fixture = "terrain_pair" if scene == "terrain" else "atrium_pair"
    _, _, frames = request.getfixturevalue(fixture)
    jc, jh, pc, ph, *_ = frames[frame]
    assert pc.shape == jc.shape == (2, 3, 64, 128)
    for i in range(2):
        got = pc[i].numpy()
        assert got.std() > 1e-3
        _image_bounds(jc[i], got, *bounds)
        _image_bounds(np.asarray(jh.previous_color[i], np.float32),
                      ph.previous_color[i].float().numpy(), *bounds)
        a, b = float(jh.exposure[i]), float(ph.exposure[i])
        assert abs(a - b) < 1e-4, (i, a, b)
    # the two views are two cameras, not one image twice
    assert np.abs(pc[0].numpy() - pc[1].numpy()).mean() > 1e-3


def test_atrium_batch_pays_the_shadow_per_view(atrium_pair):
    """The batched atrium rasters each view's sun view (the proof does
    not elide it) and reads it through the proved crop."""
    _, pb, frames = atrium_pair
    assert not pb.plan.shadow_statically_empty
    assert pb.plan.shadow_crop is not None
    pgb = frames[0][6]
    vis, _, smap, ovf = pframe.raster_stage(pb.plan, pb.batch, pgb,
                                            *pb.frame_globals(0, peek=True)
                                            [1:])
    assert smap.shape == (2, 1024, 1024) and ovf.shape == (2,)
    assert ((smap < 1.0).float().mean(dim=(1, 2)) > 0.05).all()
    assert (ovf == 0).all() and vis.tri_id.shape == (2, 64, 128)


def test_batched_globals_match_jax(terrain_pair):
    """The port's batched_globals of its views' globals is byte-identical
    to the JAX batched_globals of the JAX views' globals, converted."""
    _, _, frames = terrain_pair
    for *_, jgb, pgb, _, _ in frames:
        cg = convert.batched_globals_from_numpy(jgb)
        assert view_count(cg) == view_count(pgb) == 2

        def leaves(x):
            if dataclasses.is_dataclass(x):
                for f in dataclasses.fields(x):
                    yield from ((f"{f.name}.{n}", v) for n, v in
                                leaves(getattr(x, f.name)))
            else:
                yield "", x

        for (n, a), (_, b) in zip(leaves(cg), leaves(pgb)):
            assert a.dtype == b.dtype and a.shape == b.shape, n
            assert a.numpy().tobytes() == b.numpy().tobytes(), n


def test_batched_history_converts(terrain_pair):
    _, _, frames = terrain_pair
    _, jh, _, ph, *_ = frames[1]
    ch = convert.batched_history_from_numpy(jh)
    assert ch.previous_color.dtype == torch.bfloat16
    assert ch.previous_color.shape == ph.previous_color.shape \
        == (2, 3, 64, 128)
    assert ch.exposure.shape == ph.exposure.shape == (2,)


# --- batched against single, the port alone -------------------------------

@pytest.fixture(scope="module")
def port_scenes():
    return {"terrain": terrain_port(RenderConfig(**ORACLE)),
            "atrium_lifted": kit.build_port(
                "atrium_lifted", RenderConfig(**ATRIUM), "cpu")}


def _batched_frames(built, name, B, frames=2):
    """`frames` batched frames of B views of the port alone -> [(colours,
    history, views' globals, model_mats, normal_mats)] per frame."""
    positions = POSITIONS["terrain" if name.startswith("terrain")
                          else "atrium_lifted"][:B]
    step = pmesh.make_batched_render_fn(built.plan)
    hb = pmesh.batched_history([pframe.RenderHistory.create(
        built.plan.config, device="cpu") for _ in range(B)])
    prev = None
    out = []
    for f in range(frames):
        gs, mm, nm = pmesh.view_globals(built, positions, f, prev)
        prev = [g.camera for g in gs]
        colors, hb = step(built.batch, pmesh.batched_globals(gs), hb, mm, nm)
        out.append((colors, hb, gs, mm, nm))
    return out


def _single_vs_batched(built, batched):
    """Max abs differences (colour, history colour, exposure) between view
    i of consecutive batched frames and render_frame of view i carrying
    its own history."""
    plan = built.plan
    B = batched[0][0].shape[0]
    hs = [pframe.RenderHistory.create(plan.config, device="cpu")
          for _ in range(B)]
    worst = [0.0, 0.0, 0.0]
    for colors, hb, gs, mm, nm in batched:
        for i in range(B):
            out, hs[i] = pframe.render_frame(plan, built.batch, gs[i], hs[i],
                                             mm, nm)
            for k, (a, b) in enumerate((
                    (out.color, colors[i]),
                    (hs[i].previous_color, hb.previous_color[i]),
                    (hs[i].exposure, hb.exposure[i]))):
                worst[k] = max(worst[k],
                               (a.float() - b.float()).abs().max().item())
    return worst


def test_batched_equals_single_views_terrain(terrain_pair):
    """View i of the two consecutive batched terrain frames that were
    held against the JAX package (B = 2) against render_frame of view i
    carrying its own history: max abs <= 1e-6 on colour, history colour
    and exposure.  Measured on the CPU: colour <= 1.8e-7, history and
    exposure 0."""
    _, pb, frames = terrain_pair
    batched = [(pc, ph, pgs, mm, nm)
               for _, _, pc, ph, pgs, _, _, mm, nm in frames]
    with pytest.MonkeyPatch.context() as mp:
        shared_inputs(mp, luts_seeded())
        worst = _single_vs_batched(pb, batched)
    assert max(worst) <= 1e-6, worst


@pytest.mark.parametrize("B", [3, 1])
def test_batched_equals_single_views_atrium(port_scenes, B):
    """The same on atrium_lifted (each view's 1024^2 shadow map through
    the crop) with B = 3 views of different content, and a batch of one
    view (one frame each: the terrain and the JAX comparisons carry the
    history)."""
    built = port_scenes["atrium_lifted"]
    with pytest.MonkeyPatch.context() as mp:
        shared_inputs(mp, luts_seeded())
        worst = _single_vs_batched(
            built, _batched_frames(built, "atrium_lifted", B, 1))
    assert max(worst) <= 1e-6, worst


@pytest.mark.parametrize("name", ["atrium_passes", "terrain_perpixel"])
def test_off_by_default_passes_batched_equal_single(name):
    """SSR (compacted, composited), depth of field and the volumetric
    light (atrium_passes), and the per-pixel cloud march
    (terrain_perpixel): B = 2 batched against single, max abs <= 1e-6."""
    cfg = RenderConfig(**ATRIUM)
    if name == "atrium_passes":
        cfg = cfg.replace(enable_ssr=True, composite_ssr=True,
                          enable_depth_of_field=True,
                          enable_volumetric_light=True)
    else:
        cfg = cfg.replace(cloud_impl="perpixel", width=64, height=32)
    built = kit.build_port(name, cfg, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        shared_inputs(mp, luts_seeded())
        worst = _single_vs_batched(built, _batched_frames(built, name, 2, 1))
    assert max(worst) <= 1e-6, worst


# --- the checks the step makes before it renders --------------------------

def _refuses(mp, step, *args):
    """`step(*args)` raises ValueError before anything is rendered."""
    def no_render(*a, **k):
        raise AssertionError("rendered before the check")
    mp.setattr(pframe, "raster_stage", no_render)
    with pytest.raises(ValueError):
        step(*args)


def test_step_refuses_a_sun_the_proof_was_not_run_for(port_scenes):
    """Terrain elides the shadow by its proof: a batch with one view
    under another sun raises."""
    built = port_scenes["terrain"]
    assert built.plan.shadow_statically_empty
    gs, mm, nm = pmesh.view_globals(built, POSITIONS["terrain"][:2], 0)
    gs[1] = dataclasses.replace(gs[1], sun=SunInfo.create(
        angle_direction_deg=(12.0, 0.0, 0.0)))
    hb = pmesh.batched_history([pframe.RenderHistory.create(
        built.plan.config, device="cpu") for _ in range(2)])
    with pytest.MonkeyPatch.context() as mp:
        _refuses(mp, pmesh.make_batched_render_fn(built.plan), built.batch,
                 pmesh.batched_globals(gs), hb, mm, nm)


def test_step_refuses_moved_model_matrices(port_scenes):
    """atrium_lifted samples its shadow through a crop proved for its
    model matrices: moved matrices raise (the JAX step does not check,
    see parallel/mesh.py)."""
    built = port_scenes["atrium_lifted"]
    assert built.plan.shadow_crop is not None
    gs, mm, nm = pmesh.view_globals(built, POSITIONS["atrium_lifted"][:2], 0)
    moved = mm.clone()
    moved[..., 1, 3] += 0.5
    hb = pmesh.batched_history([pframe.RenderHistory.create(
        built.plan.config, device="cpu") for _ in range(2)])
    with pytest.MonkeyPatch.context() as mp:
        _refuses(mp, pmesh.make_batched_render_fn(built.plan), built.batch,
                 pmesh.batched_globals(gs), hb, moved, nm)


def test_step_refuses_unbatched_inputs(port_scenes):
    built = port_scenes["terrain"]
    gs, mm, nm = pmesh.view_globals(built, POSITIONS["terrain"][:2], 0)
    one = pframe.RenderHistory.create(built.plan.config, device="cpu")
    step = pmesh.make_batched_render_fn(built.plan)
    with pytest.MonkeyPatch.context() as mp:
        _refuses(mp, step, built.batch, gs[0], one, mm, nm)
        _refuses(mp, step, built.batch, pmesh.batched_globals(gs),
                 pmesh.batched_history([one]), mm, nm)


# --- per-view reductions and the plain kernel versions --------------------

def test_exposure_adapts_per_view(port_scenes):
    """Two views of very different brightness: each view's histogram and
    adaptation are its own (equal to the single-view call), and the two
    exposures move apart, not to a shared value."""
    gs, _, _ = pmesh.view_globals(port_scenes["terrain"],
                            POSITIONS["terrain"][:2], 0)
    gb = pmesh.batched_globals(gs)
    rng = np.random.default_rng(4)
    base = torch.from_numpy(rng.uniform(0.5, 1.5, (2, 3, 32, 48))
                            .astype(np.float32))
    hdr = base * torch.tensor([0.005, 100.0]).reshape(2, 1, 1, 1)
    prev = torch.zeros(2)
    got = pexposure.auto_exposure(hdr, prev, gb)
    singles = [pexposure.auto_exposure(hdr[i], prev[i], gs[i])
               for i in range(2)]
    assert got.shape == (2,)
    for i in range(2):
        assert torch.equal(got[i], singles[i])
    hist = pexposure.luminance_histogram(hdr, gb.log_min_luminance,
                                         gb.log_max_luminance)
    assert hist.shape == (2, 256) and (hist.sum(dim=1) == 32 * 48).all()
    assert (got[0] - got[1]).abs() > 0.1, got


def test_plain_kernels_batched_equal_view_by_view(port_scenes):
    """The plain versions of K1 (the main view), K4 (the sun view), K2
    and K3 with a view axis (B = 3, views of different content) equal the
    same calls view by view, bit for bit."""
    built = port_scenes["atrium_lifted"]
    plan = built.plan
    gs, mm, nm = pmesh.view_globals(built, POSITIONS["atrium_lifted"], 0)
    gb = pmesh.batched_globals(gs)
    world, _ = pframe.transform_triangles(built.batch, mm, nm)
    # the shadow view on a 256^2 grid: the plain resolves are the cost
    sgrid = dataclasses.replace(plan.shadow_grid, width=256, height=256)
    for grid, pv, cull, resolve in (
            (plan.main_grid, gb.camera.projection_view, "front",
             praster.resolve),
            (sgrid, gb.sun.projection_view, "back", praster.resolve_depth)):
        clip = pframe._clip_of(world, pv)
        assert clip.shape[0] == 3
        setup = praster.triangle_setup_planar(clip, grid.width, grid.height,
                                              cull)
        starts, recs, ovf, rgrid = praster.gather_records(setup, grid)
        out = resolve(starts, recs, rgrid)
        out = out if isinstance(out, tuple) else (out,)
        for i in range(3):
            s1 = praster.triangle_setup_planar(pframe._clip_of(world, pv[i]),
                                               grid.width, grid.height, cull)
            st1, rc1, ov1, _ = praster.gather_records(s1, grid)
            assert torch.equal(st1, starts[i]) and torch.equal(rc1, recs[i])
            assert torch.equal(ov1, ovf[i])
            one = resolve(st1, rc1, rgrid)
            one = one if isinstance(one, tuple) else (one,)
            assert all(torch.equal(a, b[i]) for a, b in zip(one, out))
    # K2 and K3 on (B, ...) inputs of different content
    rng = np.random.default_rng(9)
    dep = torch.from_numpy(rng.uniform(0.2, 0.99, (3, 32, 64))
                           .astype(np.float32))
    nrm = torch.from_numpy(rng.normal(size=(3, 3, 32, 64))
                           .astype(np.float32))
    kern = pssao.kernel_vectors(26, "cpu")
    planes = torch.stack([torch.cat(pssao._preamble(dep[i], nrm[i], gs[i]))
                          for i in range(3)])
    bp = torch.cat(pssao._preamble(dep, nrm, gb), dim=0).movedim(0, 1)
    assert torch.equal(bp, planes)
    k2 = pssao.ssao_taps(planes, dep, gb.camera.projection,
                         gb.camera.inv_projection, gb.ssao_radius,
                         gb.ssao_bias, kern)
    for i in range(3):
        assert torch.equal(k2[i], pssao.ssao_taps(
            planes[i], dep[i], gs[i].camera.projection,
            gs[i].camera.inv_projection, gs[i].ssao_radius,
            gs[i].ssao_bias, kern))
    hist = torch.from_numpy(rng.uniform(size=(3, 5, 32, 64))
                            .astype(np.float32)).to(torch.bfloat16)
    vel = torch.from_numpy(rng.normal(0, 0.05, (3, 2, 32, 64))
                           .astype(np.float32))
    k3 = ptaa.reproject_history(hist, vel)
    for i in range(3):
        assert torch.equal(k3[i], ptaa.reproject_history(hist[i], vel[i]))


def test_sky_lut_batched_equals_view_by_view(port_scenes):
    """K6's plain version (the noise-texture LUT) and the procedural LUT
    with batched globals: a LUT per view, each equal to the single-view
    call (a 32x16 LUT; its march is ill-conditioned, so the reading is
    stated: measured max abs / peak 0 on the CPU)."""
    gs, _, _ = pmesh.view_globals(port_scenes["terrain"], POSITIONS["terrain"], 0)
    gs = [dataclasses.replace(g, elapsed_time=torch.tensor(0.7 * i))
          for i, g in enumerate(gs)]
    gb = pmesh.batched_globals(gs)
    noise = torch.from_numpy(kit.cloud_noise())
    for tex in (noise, None):
        lut = pclouds.render_sky_lut(gb, 32, 16, noise_tex=tex)
        assert lut.shape == (3, 3, 16, 32)
        peak = lut.abs().max().item()
        for i in range(3):
            one = pclouds.render_sky_lut(gs[i], 32, 16, noise_tex=tex)
            assert (one - lut[i]).abs().max().item() <= 1e-6 * peak
        assert (lut[0] - lut[1]).abs().max() > 1e-3 * peak


def test_single_view_select_round_trips(port_scenes):
    gs, _, _ = pmesh.view_globals(port_scenes["terrain"], POSITIONS["terrain"], 1)
    gb = pmesh.batched_globals(gs)
    assert view_count(gs[0]) is None and view_count(gb) == 3
    back = select_view(gb, 2)
    assert torch.equal(back.camera.view, gs[2].camera.view)
    assert torch.equal(back.lights.point_position,
                       gs[2].lights.point_position)


def test_parallel_imports_no_jax():
    code = ("import sys\n"
            "import soc_real_time_renderer_tpu_torch.parallel.mesh\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'soc_real_time_renderer_tpu' "
            "or m.startswith('soc_real_time_renderer_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root)
