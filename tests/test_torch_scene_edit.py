"""Live scene edits in both packages: the viewer-facing calls of
``BuiltScene`` (``apply_input``, ``set_sun``, ``mesh_signature``,
``rebuild`` with both tiers, ``resize``, the fly branch of
``frame_globals``) and the scene panel, driven the same way on the JAX
package's scene and the port's.

The scenes come from a small synthetic asset tree
(``tools/synth_assets.py``: a 500-triangle helmet with five 64^2 maps,
a 64^2 ``Clouds/noise.png``), both packages' ``scenes.ASSETS`` pointed
at it, and the reduced terrain of tests/torch_scene_kit.py.  The
sequences are those of tests/test_scene_edit.py.  After every step the
port's plan equals the JAX plan (``convert.plan_from_jax_plan``), its
batch is byte-identical and its ``frame_globals`` leaves are equal
(orbit and fly camera; ``peek`` leaves the prev-camera roll alone).
Then two frames after the edits "helmet at y = 32, a second helmet,
160x96, fly camera moved" in both packages, within the presets' bounds
(mean < 2e-4, 99.9th percentile < 1e-2), the JAX package on its oracle
plan with the sky LUT and the SSAO noise hash shared, as in
tests/test_torch_presets.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu import camera as jcam
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu import scenes as jscenes
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.ops import clouds as jclouds
from soc_real_time_renderer_tpu.ops import ssao as jssao
from soc_real_time_renderer_tpu.ui import scene_panel as jpanel
from soc_real_time_renderer_tpu.ui import server as jserver
from soc_real_time_renderer_tpu_torch import camera as pcam
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.ops import sky as psky
from soc_real_time_renderer_tpu_torch.ops import ssao as pssao
from soc_real_time_renderer_tpu_torch.ui import scene_panel as ppanel
from soc_real_time_renderer_tpu_torch.ui import server as pserver

SMALL = dict(width=128, height=64, shadow_resolution=512)
ORACLE = dict(SMALL, ssao_impl="xla", taa_impl="xla")
TRIS = 500                 # the small tree's helmet (its batch splits the
#                            larger triangles: more rows than this)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return kit.small_tree(tmp_path_factory.mktemp("tree"))


@pytest.fixture
def assets(tree, monkeypatch):
    kit.point_both_at(monkeypatch, tree)
    return tree


@dataclasses.dataclass
class Pair:
    jb: object
    pb: object
    jp: object
    pp: object

    def panel(self, op, *args):
        """The same panel call on both; equal results (None-ness for a
        component) are asserted and the port's returned."""
        a, b = getattr(self.jp, op)(*args), getattr(self.pp, op)(*args)
        if op == "add_component":
            assert (a is None) == (b is None)
        else:
            assert a == b
        return b

    def both(self, op, *args, **kw):
        getattr(self.jb, op)(*args, **kw)
        getattr(self.pb, op)(*args, **kw)


def _pair(name, cfg=SMALL):
    jb = jscenes.build(name, jcfg.RenderConfig(**cfg), atlas_size=64)
    pb = pscenes.build(name, RenderConfig(**cfg), atlas_size=64,
                       device="cpu")
    return Pair(jb, pb,
                jpanel.SceneHiearchyPanel(jb.scene,
                                          model_loader=jscenes.default_model),
                ppanel.SceneHiearchyPanel(pb.scene,
                                          model_loader=pscenes.default_model))


def _globals_equal(jb, pb, frame):
    """frame_globals(frame, peek=True) leaf for leaf in both packages;
    the peek leaves each package's prev-camera roll where it was."""
    rolls = (getattr(jb, "_prev_cam", None), getattr(pb, "_prev_cam", None))
    jg, jmm, jnm = jb.frame_globals(frame, peek=True)
    pg, pmm, pnm = pb.frame_globals(frame, peek=True)
    assert getattr(jb, "_prev_cam", None) is rolls[0]
    assert getattr(pb, "_prev_cam", None) is rolls[1]
    cg = convert.globals_from_numpy(jg)
    for f in dataclasses.fields(cg):
        a, b = getattr(cg, f.name), getattr(pg, f.name)
        if dataclasses.is_dataclass(a):
            for ff in dataclasses.fields(a):
                assert torch.equal(getattr(a, ff.name),
                                   getattr(b, ff.name)), (f.name, ff.name)
        else:
            assert torch.equal(a, b), f.name
    assert np.asarray(jmm).tobytes() == pmm.numpy().tobytes()
    assert np.asarray(jnm).tobytes() == pnm.numpy().tobytes()


def _same_state(p: Pair, frame=3):
    """Plans equal, batches byte-identical, globals equal."""
    assert convert.plan_from_jax_plan(p.jb.plan) == p.pb.plan
    cb = convert.scene_batch_from_numpy(p.jb.batch)
    for f in dataclasses.fields(p.pb.batch):
        a, b = getattr(cb, f.name), getattr(p.pb.batch, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.numpy().tobytes() == b.numpy().tobytes(), f.name
    assert p.jb.mesh_signature() != () or p.pb.mesh_signature() == ()
    assert len(p.jb.mesh_signature()) == len(p.pb.mesh_signature())
    _globals_equal(p.jb, p.pb, frame)


def _fly(p: Pair, n=4):
    """n fly-camera inputs on both scenes (the first starts the fly
    camera from the preset's camera)."""
    for i in range(n):
        kw = dict(forward=True, right=i % 2 == 1, cursor_dx=30.0 * i,
                  cursor_dy=-20.0)
        p.jb.apply_input(jcam.InputState(**kw), 1.0 / 60.0)
        p.pb.apply_input(pcam.InputState(**kw), 1.0 / 60.0)
    assert p.jb._fly.position.tobytes() == p.pb._fly.position.tobytes()
    assert p.pb.animate is False


def _add_helmet(p: Pair, position):
    eid = p.panel("create_entity", "second helmet")
    p.panel("select", eid)
    sig = p.pb.mesh_signature()
    p.panel("add_component", eid, "TransformComponent")
    p.panel("set_property", eid, "TransformComponent", "position", position)
    assert p.pb.mesh_signature() == sig     # no mesh yet: no new signature
    comp = p.panel("add_component", eid, "MeshComponent")
    assert comp.model is not None and len(comp.model.triangles) == TRIS
    assert p.pb.mesh_signature() != sig
    return eid


def _seq_add_mesh(p):
    batch0 = p.pb.batch
    t0 = batch0.num_triangles
    eid = _add_helmet(p, [1.2, 0.0, 0.0])
    p.both("rebuild")                        # full tier: the model set grew
    assert p.pb.batch is not batch0
    assert p.pb.batch.num_triangles == 2 * t0
    assert p.pb.scene.transform_matrices()[0].shape[0] == 2
    _same_state(p)
    p.panel("destroy_entity", eid)
    p.both("rebuild")
    assert p.pb.batch.num_triangles == t0
    _same_state(p)


def _seq_sun_volume(p):
    assert p.pb.plan.shadow_statically_empty
    eid = p.pb.scene.mesh_entities()[0].eid
    batch0 = p.pb.batch
    p.panel("set_property", eid, "TransformComponent", "position",
            [0.0, 32.0, 0.0])
    p.both("rebuild")                        # cheap tier
    assert not p.pb.plan.shadow_statically_empty
    assert p.pb.plan.shadow_crop is not None
    assert p.pb.batch is batch0 and p.pb._proof_pos is not None
    _same_state(p)
    p.panel("set_property", eid, "TransformComponent", "position",
            [0.0, 0.0, 0.0])
    p.both("rebuild")
    assert p.pb.plan.shadow_statically_empty and p.pb.batch is batch0
    _same_state(p)


def _seq_light(p):
    assert p.pb.plan.config.max_point_lights == 0
    eid = p.panel("create_entity", "lamp")
    p.panel("add_component", eid, "TransformComponent")
    p.panel("set_property", eid, "TransformComponent", "position",
            [0.0, 0.0, 1.5])
    p.panel("add_component", eid, "PointLightComponent")
    p.panel("set_property", eid, "PointLightComponent", "intensity", 40.0)
    p.both("rebuild")
    assert p.pb.plan.config.max_point_lights == 1
    g, _, _ = p.pb.frame_globals(0, peek=True)
    assert int(g.lights.point_count) == 1
    assert float(g.lights.point_intensity[0]) == 40.0
    _same_state(p)


def _seq_trilinear(p):
    p.jb.plan = dataclasses.replace(p.jb.plan, texture_filter="trilinear")
    p.pb.plan = dataclasses.replace(p.pb.plan, texture_filter="trilinear")
    t0 = p.pb.batch.num_triangles
    _add_helmet(p, [0.0, 0.0, 0.0])
    p.both("rebuild")                        # full tier keeps the override
    assert p.pb.plan.texture_filter == "trilinear"
    assert p.pb.batch.num_triangles == 2 * t0
    _same_state(p)


def _seq_empty(p):
    batch0, plan0 = p.pb.batch, p.pb.plan
    for e in list(p.pb.scene.mesh_entities()):
        p.panel("destroy_entity", e.eid)
    assert p.jb.mesh_signature() == p.pb.mesh_signature() == ()
    p.both("rebuild")                        # nothing to render: no-op
    assert p.pb.batch is batch0 and p.pb.plan is plan0
    assert convert.plan_from_jax_plan(p.jb.plan) == p.pb.plan


def _seq_sun(p):
    assert p.pb.plan.shadow_statically_empty
    p.both("set_sun", position=(0.0, 8.0, 0.0))
    assert p.pb.sun.position.device.type == "cpu"
    p.both("rebuild")
    assert not p.pb.plan.shadow_statically_empty
    _same_state(p)
    p.both("set_sun", position=(-3.2, 40.0, -4.0))
    p.both("rebuild")
    assert p.pb.plan.shadow_statically_empty
    _same_state(p)


def _relief(b, mesh_cls):
    """The terrain model's y extent."""
    e = b.scene.mesh_entities()[0]
    return float(np.ptp(e.get_component(mesh_cls).model.positions[:, 1]))


def _seq_terrain(p):
    sig = p.pb.mesh_signature()
    y0 = _relief(p.pb, pscenes.MeshComponent)
    assert jserver._rebake_terrain(p.jb, {"height_scale": 140.0})
    assert pserver._rebake_terrain(p.pb, {"height_scale": 140.0})
    assert p.pb.mesh_signature() != sig
    assert _relief(p.jb, jscenes.MeshComponent) \
        == _relief(p.pb, pscenes.MeshComponent)
    # 70 -> 140 doubles the relief
    assert abs(_relief(p.pb, pscenes.MeshComponent) / y0 - 2.0) < 1e-3
    p.both("rebuild")                        # a new model: the full tier
    _same_state(p)


def _seq_resize(p):
    main0 = p.pb.plan.main_grid
    p.pb.frame_globals(0)                    # a prev-camera roll to drop
    p.jb.frame_globals(0)
    p.both("resize", 160, 96)
    assert not hasattr(p.pb, "_prev_cam") and not hasattr(p.jb, "_prev_cam")
    assert p.pb.plan.config.width == 160 and p.pb.plan.config.height == 96
    assert p.pb.plan.main_grid != main0
    assert abs(p.pb.camera.aspect - 160 / 96) < 1e-7
    _same_state(p)
    for b in (p.jb, p.pb):
        with pytest.raises(ValueError, match="multiples of 32"):
            b.resize(100, 64)
    assert p.pb.plan.config.width == 160
    _same_state(p)


SEQUENCES = {"add_mesh": ("helmet", _seq_add_mesh),
             "sun_volume": ("helmet", _seq_sun_volume),
             "light": ("helmet", _seq_light),
             "trilinear": ("helmet", _seq_trilinear),
             "empty": ("helmet", _seq_empty),
             "sun": ("helmet", _seq_sun),
             "terrain": ("terrain", _seq_terrain),
             "resize": ("helmet", _seq_resize)}


@pytest.mark.parametrize("camera", ["orbit", "fly"])
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_edit_sequence_matches(assets, seq, camera):
    name, run = SEQUENCES[seq]
    p = _pair(name)
    _same_state(p)
    if camera == "fly":
        _fly(p)
        _same_state(p)
    run(p)
    if camera == "fly":
        _fly(p, 2)
        _same_state(p)


def test_peek_leaves_the_roll(assets):
    """A non-peek frame rolls prev-camera in both packages; peeks in
    between (the viewer's /schema) do not, on the orbit and fly
    branches."""
    p = _pair("helmet")
    for fly in (False, True):
        if fly:
            _fly(p)
        p.jb.frame_globals(1)
        pg1, _, _ = p.pb.frame_globals(1)
        _globals_equal(p.jb, p.pb, 2)
        _globals_equal(p.jb, p.pb, 5)
        pg2, _, _ = p.pb.frame_globals(2)
        assert torch.equal(pg2.camera_prev.projection_view,
                           pg1.camera.projection_view)


def test_stale_plans_raise_in_both(assets):
    """check_sun_proof on a moved sun and check_shadow_crop on moved
    geometry raise before rebuild() in both packages, and pass after."""
    p = _pair("helmet")
    p.both("set_sun", position=(0.0, 8.0, 0.0))
    jg, _, _ = p.jb.frame_globals(0, peek=True)
    pg, _, _ = p.pb.frame_globals(0, peek=True)
    with pytest.raises(ValueError, match="different sun"):
        jframe.check_sun_proof(p.jb.plan, jg)
    with pytest.raises(ValueError, match="different sun"):
        pframe.check_sun_proof(p.pb.plan, pg)
    p.both("set_sun", position=(-3.2, 40.0, -4.0))

    eid = p.pb.scene.mesh_entities()[0].eid
    p.panel("set_property", eid, "TransformComponent", "position",
            [0.0, 32.0, 0.0])
    p.both("rebuild")
    assert p.pb.plan.shadow_crop is not None
    assert p.pb.plan.shadow_crop == p.jb.plan.shadow_crop
    p.panel("set_property", eid, "TransformComponent", "position",
            [0.5, 33.0, 0.0])
    jmm, _ = p.jb.scene.transform_matrices()
    _, pmm, _ = p.pb.frame_globals(0, peek=True)
    with pytest.raises(ValueError, match="shadow_crop"):
        jframe.check_shadow_crop(p.jb.plan, jmm)
    with pytest.raises(ValueError, match="shadow_crop"):
        pframe.check_shadow_crop(p.pb.plan, pmm)
    p.both("rebuild")
    _same_state(p)
    pframe.check_shadow_crop(p.pb.plan, pmm)
    jframe.check_shadow_crop(p.jb.plan, jmm)


def _oracle(plan):
    return dataclasses.replace(
        plan, rec_pack="f32", interpret=True, texture_impl="xla",
        main_grid=dataclasses.replace(plan.main_grid, rec_dtype="f32"),
        shadow_grid=dataclasses.replace(plan.shadow_grid, rec_dtype="f32"))


@pytest.fixture(scope="module")
def edited_frames(tree):
    """[(jax outputs, port outputs)] of frames 0 and 1 after the edits
    "helmet to y = 32 (cheap tier), a second helmet at (1.2, 32, 0)
    (full tier), 160x96, fly camera moved"."""
    with pytest.MonkeyPatch.context() as mp:
        kit.point_both_at(mp, tree)
        p = _pair("helmet", ORACLE)
        t0 = p.pb.batch.num_triangles
        eid = p.pb.scene.mesh_entities()[0].eid
        p.panel("set_property", eid, "TransformComponent", "position",
                [0.0, 32.0, 0.0])
        p.both("rebuild")
        _add_helmet(p, [1.2, 32.0, 0.0])
        p.both("rebuild")
        p.both("resize", 160, 96)
        # the fly camera from (0, 32, 2.5) looking at the helmets
        p.jb.camera_position = np.array([0.0, 32.0, 2.5], np.float32)
        p.pb.camera_position = np.array([0.0, 32.0, 2.5], np.float32)
        p.jb.camera_target = np.array([0.6, 32.0, 0.0], np.float32)
        p.pb.camera_target = np.array([0.6, 32.0, 0.0], np.float32)
        _fly(p, 3)
        _same_state(p)
        assert not p.pb.plan.shadow_statically_empty
        assert p.pb.batch.num_triangles == 2 * t0
        plan = _oracle(p.jb.plan)
        mp.setattr(jssao, "_rand",
                   lambda cu, cv: 0.5 + 0.5 * jnp.sin(cu * 0.7 + cv * 1.3))
        mp.setattr(pssao, "_rand",
                   lambda cu, cv: 0.5 + 0.5 * torch.sin(cu * 0.7 + cv * 1.3))
        real_lut = jax.jit(lambda g_, n_: jclouds.render_sky_lut(
            g_, noise_tex=n_))
        luts = [np.asarray(real_lut(p.jb.frame_globals(f, peek=True)[0],
                                    p.jb.batch.cloud_noise))
                for f in (0, 1)]
        mp.setattr(jclouds, "render_sky_lut",
                   lambda g_, *a, **k: jnp.where(g_.frame_counter == 0,
                                                 luts[0], luts[1]))
        mp.setattr(psky, "render_sky_lut_noise",
                   lambda g_, *a, **k: torch.from_numpy(
                       luts[int(g_.frame_counter)].copy()))
        render = jax.jit(lambda b, g, h, m, n: jframe.render_frame(
            plan, b, g, h, m, n))
        prender = pframe.make_render_fn(p.pb.plan)
        jh = jframe.RenderHistory.create(plan.config)
        ph = pframe.RenderHistory.create(p.pb.plan.config, device="cpu")
        out = []
        for f in range(2):
            jg, jmm, jnm = p.jb.frame_globals(f)
            jo, jh = render(p.jb.batch, jg, jh, jmm, jnm)
            pg, pmm, pnm = p.pb.frame_globals(f)
            po, ph = prender(p.pb.batch, pg, ph, pmm, pnm)
            out.append((jo, po))
    return out


def test_edited_frames_take_their_path(edited_frames):
    for jo, po in edited_frames:
        assert po.color.shape == (3, 96, 160)
        assert int(jo.overflow) == int(po.overflow) == 0
        assert po.shadow_map is not None and jo.shadow_map is not None
        covered = (po.gbuffer.depth < 1.0).float().mean().item()
        assert 0.05 < covered < 0.95


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("target", ["hdr", "color"])
def test_edited_frames_match(edited_frames, frame, target):
    """mean abs < 2e-4 and 99.9th percentile < 1e-2, the presets'
    bounds (tests/test_torch_presets.py)."""
    jo, po = edited_frames[frame]
    got = getattr(po, target).numpy()
    d = np.abs(np.asarray(getattr(jo, target)) - got)
    assert np.isfinite(got).all() and got.std() > 1e-3
    assert d.mean() < 2e-4, d.mean()
    assert np.quantile(d, 0.999) < 1e-2, np.quantile(d, 0.999)
