"""Batched multi-camera rendering: ``parallel/mesh.py`` of the port (a
leading view axis through the frame, each kernel launched once for the
B views) against the JAX package's ``make_batched_render_fn``
(``jax.vmap`` of ``render_frame`` on a (dp=2, sp=1) mesh of the virtual
CPU devices), and against the port's own single-view ``render_frame``.

* Reduced terrain (128x64, the exact oracle plan of test_torch_frame.py)
  and reduced ``atrium_lifted`` (shadow paid, a 1024^2 map read through
  its proved crop: at 512^2 this coarse atrium's crop would cover over
  70% of the map, and the plan keeps none), B = 2 views from two camera
  positions, two consecutive batched frames carrying history: colour,
  history colour and exposure per view; the globals stacking against
  the JAX package's.
* View i of the terrain's batched frames against ``render_frame`` of
  view i.  The port's other batched checks (B = 3 and 1, the passes that
  are off by default, the checks the step makes before it renders,
  per-view exposure, the plain kernel versions with a view axis) are in
  tests/test_torch_parallel_port.py, which reads this file's helpers.

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
from soc_real_time_renderer_tpu_torch.config import RenderConfig, view_count
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.models import terrain as pterrain
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import ssao as pssao
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


# --- batched against single ---------------------------------------------

def _single_vs_batched(built, batched, singles=None):
    """Max abs differences (colour, history colour, exposure) between view
    i of consecutive batched frames and render_frame of view i carrying
    its own history.  singles: a dict that keeps each (view, frame)
    render for the next call on the same scene and positions."""
    plan = built.plan
    B = batched[0][0].shape[0]
    hs = [pframe.RenderHistory.create(plan.config, device="cpu")
          for _ in range(B)]
    singles = {} if singles is None else singles
    worst = [0.0, 0.0, 0.0]
    for f, (colors, hb, gs, mm, nm) in enumerate(batched):
        for i in range(B):
            if (i, f) not in singles:
                singles[i, f] = pframe.render_frame(
                    plan, built.batch, gs[i], hs[i], mm, nm)
            out, hs[i] = singles[i, f]
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
