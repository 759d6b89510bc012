"""The glTF presets (``helmet``, ``helmet_lifted``, ``sponza``, ``full``)
built by both packages from an asset tree this test writes
(``tools/synth_assets.py``: a 500-triangle helmet with five 64^2 maps,
Sponza's five materials as 64^2 PNGs, a 64^2 ``Clouds/noise.png``), both
packages' ``scenes.ASSETS`` pointed at it:

* each preset's batch (triangle streams, static rows, packed atlas,
  cloud noise) byte-identical and its plan equal, at a 64^2 atlas; the
  atrium presets also without ``Sponza/`` (five flat materials);
* ``helmet_lifted`` defeats the shadow proof in both, ``helmet`` does not;
* without the tree every preset raises ``FileNotFoundError``;
* ``_terrain_model`` with ``SOC_TERRAIN_HEIGHTMAP`` (PNG or EXR) and
  ``SOC_TERRAIN_ALBEDO`` equal in both packages (ROADMAP fault C19);
* two frames of ``helmet_lifted`` and of ``full`` (its atrium the kit's
  coarse one with ``_sponza_materials``' textures, its terrain the kit's
  reduced one, in both packages) within the atrium scenes' bounds of
  tests/test_torch_scenes.py.  The JAX package runs its oracle plan;
  the sky LUT of each frame (over the noise texture) and the SSAO noise
  hash are shared, as in tests/test_torch_frame.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu import scenes as jscenes
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.models import proc as jproc
from soc_real_time_renderer_tpu.models import texture as jtexture
from soc_real_time_renderer_tpu.ops import clouds as jclouds
from soc_real_time_renderer_tpu.ops import ssao as jssao
from soc_real_time_renderer_tpu.utils import exr as jexr
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.models import proc as pproc
from soc_real_time_renderer_tpu_torch.ops import ssao as pssao
from soc_real_time_renderer_tpu_torch.ops import sky as psky
from soc_real_time_renderer_tpu_torch.scene.components import MeshComponent
from soc_real_time_renderer_tpu_torch.tools import synth_assets
from soc_real_time_renderer_tpu_torch.utils import png

PRESETS = ["helmet", "helmet_lifted", "sponza", "full"]
SMALL = dict(width=128, height=64, shadow_resolution=512)
ORACLE = dict(SMALL, ssao_impl="xla", taa_impl="xla")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{"full": tree, "no_sponza": the tree without Sponza/, "empty": an
    empty directory}."""
    out = {}
    for name, sponza in (("full", True), ("no_sponza", False)):
        root = tmp_path_factory.mktemp(name)
        synth_assets.write_asset_tree(str(root), rings=10, segments=25,
                                      helmet_map=64, sponza_map=64,
                                      sponza=sponza)
        out[name] = str(root)
    out["empty"] = str(tmp_path_factory.mktemp("empty"))
    return out


def _point_assets(mp, root):
    mp.setattr(jscenes, "ASSETS", root)
    mp.setattr(pscenes, "ASSETS", root)


@pytest.mark.parametrize("name,tree", [(p, "full") for p in PRESETS]
                         + [("sponza", "no_sponza"), ("full", "no_sponza")])
def test_preset_batch_and_plan_match(trees, monkeypatch, name, tree):
    _point_assets(monkeypatch, trees[tree])
    jb = jscenes.build(name, jcfg.RenderConfig(**SMALL), atlas_size=64)
    pb = pscenes.build(name, RenderConfig(**SMALL), atlas_size=64,
                       device="cpu")
    cb = convert.scene_batch_from_numpy(jb.batch)
    for f in dataclasses.fields(pb.batch):
        a, b = getattr(cb, f.name), getattr(pb.batch, f.name)
        assert a is not None and b is not None, f.name
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.numpy().tobytes() == b.numpy().tobytes(), f.name
    assert convert.plan_from_jax_plan(jb.plan) == pb.plan
    noise = png.decode_png(open(f"{trees[tree]}/{synth_assets.NOISE}",
                                "rb").read())[..., 0] / np.float32(255)
    assert pb.batch.cloud_noise.numpy().tobytes() == noise.tobytes()
    models = [e.get_component(MeshComponent).model
              for e in pb.scene.mesh_entities()]
    assert len(pb._models) == len(models) == {"helmet": 1,
                                              "helmet_lifted": 1,
                                              "sponza": 2, "full": 3}[name]
    assert all(a is b for a, b in zip(pb._models, models))
    n_mat = {"helmet": 1, "helmet_lifted": 1, "sponza": 6, "full": 7}[name]
    assert pb.plan.atlas_num_materials == n_mat
    if name in ("sponza", "full"):
        atrium = models[0]
        assert len(atrium.images) == (15 if tree == "full" else 0)
    assert pb.plan.shadow_statically_empty == (name != "helmet_lifted")
    assert jb.plan.shadow_statically_empty == (name != "helmet_lifted")


def test_presets_raise_without_the_tree(trees, monkeypatch):
    _point_assets(monkeypatch, trees["empty"])
    cfg = RenderConfig(**SMALL)
    for name in PRESETS:
        with pytest.raises(FileNotFoundError, match="DamagedHelmet.gltf"):
            pscenes.build(name, cfg, atlas_size=64, device="cpu")
    with pytest.raises(FileNotFoundError, match="DamagedHelmet.gltf"):
        jscenes.build("helmet", jcfg.RenderConfig(**SMALL), atlas_size=64)
    with pytest.raises(ValueError):
        pscenes.build("nope", cfg, device="cpu")


def _write_terrain_inputs(tmp_path):
    """(heightmap PNG, heightmap EXR, albedo PNG, albedo EXR) paths."""
    rng = np.random.default_rng(9)
    hm = rng.random((48, 48)).astype(np.float32)
    paths = {"hm.png": png.encode_png((hm * 255).astype(np.uint8),
                                      filter_type=4)}
    alb = rng.integers(0, 256, (40, 40, 3)).astype(np.uint8)
    paths["alb.png"] = png.encode_png(alb, filter_type=1)
    out = {}
    for name, data in paths.items():
        (tmp_path / name).write_bytes(data)
        out[name] = str(tmp_path / name)
    jexr.write_exr(str(tmp_path / "hm.exr"), hm[None])
    jexr.write_exr(str(tmp_path / "alb.exr"),
                   rng.random((4, 40, 40)).astype(np.float32))
    out["hm.exr"] = str(tmp_path / "hm.exr")
    out["alb.exr"] = str(tmp_path / "alb.exr")
    return out


@pytest.mark.parametrize("hm,alb", [("hm.png", "alb.png"),
                                    ("hm.exr", "alb.exr"),
                                    ("hm.png", None)])
def test_terrain_model_reads_the_environment(tmp_path, monkeypatch, hm,
                                             alb):
    """SOC_TERRAIN_HEIGHTMAP / SOC_TERRAIN_ALBEDO build the same terrain
    in both packages (the port ignored them before: fault C19)."""
    paths = _write_terrain_inputs(tmp_path)
    monkeypatch.setenv("SOC_TERRAIN_HEIGHTMAP", paths[hm])
    if alb:
        monkeypatch.setenv("SOC_TERRAIN_ALBEDO", paths[alb])
    else:
        monkeypatch.delenv("SOC_TERRAIN_ALBEDO", raising=False)
    jm = jscenes._terrain_model(tess_level=1, height_scale=30.0)
    pm = pscenes._terrain_model(tess_level=1, height_scale=30.0)
    for name in ("positions", "normals", "uvs", "indices"):
        assert getattr(jm, name).tobytes() == getattr(pm, name).tobytes()
    assert len(jm.images) == len(pm.images) == 2
    for ref, img in zip(jm.images, pm.images):
        assert jtexture.decode_image(ref.data).tobytes() == img.tobytes()
    monkeypatch.delenv("SOC_TERRAIN_HEIGHTMAP")
    monkeypatch.delenv("SOC_TERRAIN_ALBEDO", raising=False)
    default = pscenes._terrain_model(tess_level=1)
    assert default.positions.tobytes() != pm.positions.tobytes()


def _coarse_atrium(pkg, texture_dir):
    """The kit's coarse atrium with _sponza_materials' textures."""
    if pkg == "jax":
        model = kit.small_atrium_jax()
        model.images, model.materials = jproc._sponza_materials(texture_dir)
    else:
        model = kit.small_atrium_port()
        model.images, model.materials = pproc._sponza_materials(texture_dir)
    return model


def _oracle(plan):
    return dataclasses.replace(
        plan, rec_pack="f32", interpret=True, texture_impl="xla",
        main_grid=dataclasses.replace(plan.main_grid, rec_dtype="f32"),
        shadow_grid=dataclasses.replace(plan.shadow_grid, rec_dtype="f32"))


@pytest.fixture(scope="module", params=["helmet_lifted", "full"])
def frames(request, trees):
    """(name, [(jax outputs, port outputs)] of frames 0 and 1)."""
    name = request.param
    root = trees["full"]
    with pytest.MonkeyPatch.context() as mp:
        _point_assets(mp, root)
        sponza_dir = f"{root}/{synth_assets.SPONZA}"
        mp.setattr(jproc, "build_atrium",
                   lambda **kw: _coarse_atrium("jax", sponza_dir))
        mp.setattr(pproc, "build_atrium",
                   lambda **kw: _coarse_atrium("port", sponza_dir))
        mp.setattr(jscenes, "_terrain_model",
                   lambda **kw: kit.small_terrain("jax"))
        mp.setattr(pscenes, "_terrain_model",
                   lambda **kw: kit.small_terrain("port"))
        jb = jscenes.build(name, jcfg.RenderConfig(**ORACLE), atlas_size=64)
        pb = pscenes.build(name, RenderConfig(**ORACLE), atlas_size=64,
                           device="cpu")
        plan = _oracle(jb.plan)
        mp.setattr(jssao, "_rand",
                   lambda cu, cv: 0.5 + 0.5 * jnp.sin(cu * 0.7 + cv * 1.3))
        mp.setattr(pssao, "_rand",
                   lambda cu, cv: 0.5 + 0.5 * torch.sin(cu * 0.7 + cv * 1.3))
        # the JAX package's exact noise-texture LUT of each frame, picked
        # by frame_counter in both packages (one trace of the frame)
        real_lut = jax.jit(lambda g_, n_: jclouds.render_sky_lut(
            g_, noise_tex=n_))
        luts = [np.asarray(real_lut(jb.frame_globals(f, peek=True)[0],
                                    jb.batch.cloud_noise)) for f in (0, 1)]
        mp.setattr(jclouds, "render_sky_lut",
                   lambda g_, *a, **k: jnp.where(g_.frame_counter == 0,
                                                 luts[0], luts[1]))
        mp.setattr(psky, "render_sky_lut_noise",
                   lambda g_, *a, **k: torch.from_numpy(
                       luts[int(g_.frame_counter)].copy()))
        render = jax.jit(lambda b, g, h, m, n: jframe.render_frame(
            plan, b, g, h, m, n))
        jh = jframe.RenderHistory.create(plan.config)
        ph = pframe.RenderHistory.create(pb.plan.config, device="cpu")
        out = []
        for f in range(2):
            jg, jmm, jnm = jb.frame_globals(f)
            jo, jh = render(jb.batch, jg, jh, jmm, jnm)
            pg, pmm, pnm = pb.frame_globals(f)
            po, ph = pframe.render_frame(pb.plan, pb.batch, pg, ph, pmm, pnm)
            out.append((jo, po))
    return name, out


def test_preset_frames_take_their_path(frames):
    name, out = frames
    for jo, po in out:
        assert int(jo.overflow) == int(po.overflow) == 0
        covered = (po.gbuffer.depth < 1.0).float().mean().item()
        assert 0.05 < covered
        if name == "helmet_lifted":
            assert po.shadow_map is not None and jo.shadow_map is not None
            assert covered < 0.9              # the sky shows around it
        else:
            assert po.shadow_map is None


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("target", ["hdr", "color"])
def test_preset_image_matches(frames, frame, target):
    """mean abs < 2e-4 and 99.9th percentile < 1e-2, the bounds of the
    atrium scenes (tests/test_torch_scenes.py)."""
    _, out = frames
    jo, po = out[frame]
    got = getattr(po, target).numpy()
    d = np.abs(np.asarray(getattr(jo, target)) - got)
    assert np.isfinite(got).all() and got.std() > 1e-3
    assert d.mean() < 2e-4, d.mean()
    assert np.quantile(d, 0.999) < 1e-2, np.quantile(d, 0.999)
