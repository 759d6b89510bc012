"""The host side of the multi-entity scenes, port against the JAX package:
the ECS (lights, TRS matrices), the procedural atrium, and ``_finish``
(batch, pair caps, the sun-shadow emptiness proof, its crop and the
matrices the crop is proved for).  All of it is numpy on the host in
both packages, so every comparison is exact.  The ``full_lit`` preset's
lights against the benchmark configuration's, gathered by the
reference.

Also: the entry points run on the card by default and refuse to fall
back to the CPU, no module of the port (nor ``chip_smoke.py``) imports
JAX, and the new kernels' wrappers refuse ``impl="cuda"`` on CPU
tensors.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu import scenes as jscenes
from soc_real_time_renderer_tpu.models import proc as jproc
from soc_real_time_renderer_tpu.scene import components as jcomp
from soc_real_time_renderer_tpu.scene.scene import Scene as JScene
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.models import proc as pproc
from soc_real_time_renderer_tpu_torch.ops import composition as pcomp_ops
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster
from soc_real_time_renderer_tpu_torch.ops import sky as psky
from soc_real_time_renderer_tpu_torch.ops import texsample as ptex
from soc_real_time_renderer_tpu_torch.scene import components as pcomp
from soc_real_time_renderer_tpu_torch.scene.scene import Scene as PScene


def _lit_scene(Scene, comps, proc):
    """Two meshes (one rotated and scaled), three point lights, two spot
    lights (rotated), a light without a transform (not gathered)."""
    s = Scene("lit")
    for i, (pos, rot, scale) in enumerate((
            ([0.0, 32.0, 0.0], [0.0, 0.0, 0.0], [0.01] * 3),
            ([1.5, -2.0, 3.0], [10.0, 35.0, -20.0], [2.0, 0.5, 1.0]))):
        e = s.create_entity(f"mesh {i}")
        tc = e.add_component(comps.TransformComponent())
        tc.set_position(pos)
        tc.set_rotation(rot)
        tc.set_scale(scale)
        e.add_component(comps.MeshComponent()).model = proc.unit_quad()
    for i in range(3):
        e = s.create_entity(f"point {i}")
        e.add_component(comps.TransformComponent()).set_position(
            [i * 1.5, 2.0, -i])
        lc = e.add_component(comps.PointLightComponent())
        lc.color = np.array([1.0, 0.5 + 0.1 * i, 0.2], np.float32)
        lc.intensity = 10.0 + i
    for i in range(2):
        e = s.create_entity(f"spot {i}")
        tc = e.add_component(comps.TransformComponent())
        tc.set_position([0.0, 4.0 + i, 1.0])
        tc.set_rotation([30.0 * (i + 1), 45.0, -15.0 * i])
        lc = e.add_component(comps.SpotLightComponent())
        lc.cut_off = 15.0 + i
        lc.outer_cut_off = 25.0 + i
    s.create_entity("loose light").add_component(comps.PointLightComponent())
    return s


def _lights_equal(a, b):
    for f in dataclasses.fields(b):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        assert x.tobytes() == y.tobytes(), f.name


def test_scene_update_and_transforms_match():
    js = _lit_scene(JScene, jcomp, jproc)
    ps = _lit_scene(PScene, pcomp, pproc)
    for dt in (0.0, 1.0 / 60.0):
        jl, pl = js.update(dt), ps.update(dt)
        _lights_equal(jl, pl)
        assert int(pl.point_count) == 3 and int(pl.spot_count) == 2
        for a, b in zip(js.transform_matrices(), ps.transform_matrices()):
            assert a.dtype == b.dtype == np.float32 and a.shape == (2, 4, 4)
            assert a.tobytes() == b.tobytes()
    # an edit re-dirties one transform
    for s, comps in ((js, jcomp), (ps, pcomp)):
        s.mesh_entities()[1].get_component(
            comps.TransformComponent).set_rotation([5.0, -70.0, 12.0])
    _lights_equal(js.update(0.0), ps.update(0.0))
    for a, b in zip(js.transform_matrices(), ps.transform_matrices()):
        assert a.tobytes() == b.tobytes()


def test_build_atrium_is_byte_identical(tmp_path):
    jm = jproc.build_atrium(texture_dir=None)
    pm = pproc.build_atrium(texture_dir=None)
    for name in ("positions", "normals", "uvs", "indices"):
        a, b = getattr(jm, name), getattr(pm, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert len(jm.indices) // 3 == 152_896
    assert [dataclasses.astuple(p) for p in jm.primitives] \
        == [dataclasses.astuple(p) for p in pm.primitives]
    # the port's MaterialData carries the image slots the atlas packs
    assert [{k: vars(j)[k] for k in vars(p)}
            for j, p in zip(jm.materials, pm.materials)] \
        == [vars(p) for p in pm.materials]
    assert len(pm.materials) == 5 and pm.images == []
    # a texture directory without Sponza.gltf or JPEGs: the same five
    # flat materials in both (tests/test_torch_presets.py has the
    # textured one)
    jt = jproc.build_atrium(texture_dir=str(tmp_path))
    pt = pproc.build_atrium(texture_dir=str(tmp_path))
    assert pt.positions.tobytes() == pm.positions.tobytes()
    assert [vars(m) for m in jt.materials] == [vars(m) for m in pt.materials]
    assert pt.images == jt.images == []


def _quad_and_atrium(pkg):
    """The lifted unit quad of test_shadow_elision.py and the atrium
    lifted into the sun's volume, two mesh entities."""
    if pkg == "jax":
        Scene, comps, proc = JScene, jcomp, jproc
    else:
        Scene, comps, proc = PScene, pcomp, pproc
    atrium = proc.build_atrium(texture_dir=None)
    quad = proc.unit_quad(z=-1.0, size=0.5)
    ents = [("sponza model", atrium, [0.0, 32.0, 0.0], [0.01] * 3),
            ("quad", quad, [0.0, 32.0, 0.0], None)]
    return kit.make_scene(pkg, ents), [m for _, m, _, _ in ents]


CAMERA = dict(camera_pos=[-7.0, 33.8, 0.0], camera_target=[0, 33.5, 0])


@pytest.fixture(scope="module", params=["quad_and_atrium", "full_nohelmet"])
def finished(request):
    """(JAX BuiltScene, port BuiltScene) of the same two-entity scene:
    the lifted quad and the lifted full atrium (the shadow proof fails,
    a crop is proved), or the small full_nohelmet (proved empty)."""
    cfg = dict(width=128, height=64)
    if request.param == "full_nohelmet":
        return kit.build_pair("full_nohelmet", jcfg.RenderConfig(**cfg),
                              RenderConfig(**cfg), noise=False)
    js, jmodels = _quad_and_atrium("jax")
    ps, pmodels = _quad_and_atrium("port")
    jb = jscenes._finish(js, jmodels, jcfg.RenderConfig(**cfg),
                         atlas_size=64, **CAMERA)
    pb = pscenes._finish(ps, pmodels, RenderConfig(**cfg), atlas_size=64,
                         device="cpu", **CAMERA)
    return jb, pb


def test_finish_batch_is_byte_identical(finished):
    jb, pb = finished
    cb = convert.scene_batch_from_numpy(jb.batch)
    for f in dataclasses.fields(pb.batch):
        a, b = getattr(cb, f.name), getattr(pb.batch, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.numpy().tobytes() == b.numpy().tobytes(), f.name
    assert int(pb.batch.tri_entity.max()) == 1


def test_finish_plan_and_proof_match(finished):
    """Same config (light bounds), pair caps of both grids, emptiness
    proof, proved sun, crop and the matrices the crop is proved for."""
    jb, pb = finished
    assert convert.plan_from_jax_plan(jb.plan) == pb.plan
    plan = pb.plan
    assert plan.atlas_num_materials >= 2
    if plan.shadow_statically_empty:
        assert plan.proved_sun_pv is not None and plan.shadow_crop is None
    else:
        x0, y0, w, h = plan.shadow_crop
        S = plan.config.shadow_resolution
        assert x0 % 128 == y0 % 128 == 0 and w * h < 0.7 * S * S
        mm, _ = pb.scene.transform_matrices()
        assert plan.proved_crop_mats == tuple(float(v) for v in mm.ravel())


def test_finish_frame_inputs_match(finished):
    """frame_globals of both packages: globals (lights, camera, the
    animated orbit), model and normal matrices, exactly."""
    jb, pb = finished
    for f in (0, 5):
        jg, jmm, jnm = jb.frame_globals(f)
        pg, pmm, pnm = pb.frame_globals(f)
        cg, cmm, cnm = convert.frame_inputs_from_numpy(jg, jmm, jnm)
        assert torch.equal(cmm, pmm) and torch.equal(cnm, pnm)
        for fld in dataclasses.fields(cg):
            a, b = getattr(cg, fld.name), getattr(pg, fld.name)
            if dataclasses.is_dataclass(a):
                for ff in dataclasses.fields(a):
                    assert torch.equal(getattr(a, ff.name),
                                       getattr(b, ff.name)), ff.name
            else:
                assert torch.equal(a, b), fld.name


def test_finish_sizes_ssr_cap_and_keeps_models():
    """_finish sizes FramePlan.ssr_cap as the JAX package does (5% of the
    screen, rounded up to 1,024, when enable_ssr; fault C17) and keeps
    the packed models on the BuiltScene (fault C18)."""
    for cfg in (dict(width=128, height=64, enable_ssr=True),
                dict(width=320, height=192, enable_ssr=True),
                dict(width=128, height=64)):
        js, jmodels = _quad_and_atrium("jax")
        ps, pmodels = _quad_and_atrium("port")
        jb = jscenes._finish(js, jmodels, jcfg.RenderConfig(**cfg),
                             atlas_size=64, **CAMERA)
        pb = pscenes._finish(ps, pmodels, RenderConfig(**cfg), atlas_size=64,
                             device="cpu", **CAMERA)
        assert pb.plan.ssr_cap == jb.plan.ssr_cap, cfg
        assert pb.plan.ssr_cap == (
            -(-int(0.05 * cfg["width"] * cfg["height"]) // 1024) * 1024
            if cfg.get("enable_ssr") else 0)
        assert convert.plan_from_jax_plan(jb.plan) == pb.plan
        assert len(pb._models) == len(pmodels) == 2
        assert all(a is b for a, b in zip(pb._models, pmodels))


def test_full_lit_gathers_the_configurations_lights(tmp_path, monkeypatch):
    """The full_lit preset (its atrium and terrain the kit's reduced ones,
    the small asset tree): Scene.update gives the benchmark reference's
    lights_of of the full_lit_1080p configuration's ``lights``, leaf for
    leaf at max abs 0, and _finish binds 128 point and 128 spot
    lights."""
    from benchmark import registry
    from benchmark.reference import globals as rg
    monkeypatch.setattr(pscenes, "ASSETS", kit.small_tree(tmp_path))
    monkeypatch.setattr(pproc, "build_atrium",
                        lambda **kw: kit.small_atrium_port())
    monkeypatch.setattr(pscenes, "_terrain_model",
                        lambda **kw: kit.small_terrain("port", **kw))
    built = pscenes.build("full_lit", RenderConfig(
        width=64, height=32, shadow_resolution=256), device="cpu",
        atlas_size=64)
    cfg = built.plan.config
    assert (cfg.max_point_lights, cfg.max_spot_lights) == (128, 128)
    got = built.scene.update(1 / 60)
    want = rg.lights_of(registry.config("full_lit_1080p")["lights"])
    for f in dataclasses.fields(want):
        x = np.asarray(getattr(got, f.name))
        y = np.asarray(getattr(want, f.name))
        assert x.shape == y.shape and x.dtype == y.dtype, f.name
        assert np.array_equal(x, y), f.name
    assert (int(got.point_count), int(got.spot_count)) == (128, 128)


def test_entry_points_refuse_without_a_card(monkeypatch):
    """scenes.build, build_terrain, _finish and RenderHistory.create run
    on the card by default; with no card they raise instead of running
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(width=128, height=64)
    scene = PScene("empty")
    for call in (lambda: pscenes.build("terrain", cfg),
                 lambda: pscenes.build_terrain(cfg),
                 lambda: pscenes._finish(scene, [], cfg, [0, 0, 1],
                                         [0, 0, 0]),
                 lambda: pframe.RenderHistory.create(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    h = pframe.RenderHistory.create(cfg, device="cpu")
    assert h.previous_color.device.type == "cpu"


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port (the asset path's png, image_io, exr, the
    glTF loader, the render CLI and synth_assets, the viewer's ui/,
    utils/metrics and tools/viewer among them),
    chip_smoke.py and kernel_ab.py import neither jax nor the JAX
    package."""
    code = (
        "import pkgutil, sys\n"
        "import soc_real_time_renderer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: __import__(n)\n"
        "import chip_smoke, kernel_ab\n"
        "assert len(names) > 20, names\n"
        "new = ['utils.png', 'utils.image_io', 'utils.exr', 'models.gltf', "
        "'tools.render', 'tools.synth_assets', 'tools.viewer', "
        "'utils.metrics', 'ui.server', 'ui.scene_panel', 'ui.widgets']\n"
        "assert all(p.__name__ + '.' + n in names for n in new), names\n"
        "import soc_real_time_renderer_tpu_torch.tools.render as r\n"
        "r.parse_args(['--scene', 'full'])\n"
        "bad = [m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'soc_real_time_renderer_tpu' "
        "or m.startswith('soc_real_time_renderer_tpu.')]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root)


def test_new_kernel_entries_refuse_cuda_on_cpu():
    """impl="cuda" on CPU tensors raises instead of running the plain
    version, for each of K4, K5, K6 and K7."""
    z = torch.zeros
    grid = praster.BinGrid(width=128, height=128, bin_size=128, group=1,
                           pair_cap=128)
    with pytest.raises(ValueError):
        praster.resolve_depth(z(2, dtype=torch.int32), z(16, 128), grid,
                              impl="cuda")
    with pytest.raises(ValueError):
        ptex.sample_atlas(z(8, 12, dtype=torch.int32),
                          z(4, dtype=torch.int32), z(2, 4), z(4), size=2,
                          layer_stride=5, n_levels=2, impl="cuda")
    b = kit.build_port("atrium_lifted", RenderConfig(width=128, height=64),
                       "cpu")
    g, _, _ = b.frame_globals(0)
    with pytest.raises(ValueError):
        psky.render_sky_lut_noise(g, b.batch.cloud_noise, impl="cuda")
    with pytest.raises(ValueError):
        pcomp_ops._local_lights(g, z(3, 8), z(3, 8), z(3, 8), 1, 1,
                                impl="cuda")
