"""The slice as a whole: the reduced terrain scene built by both packages
and two frames rendered by both (frame_counter 0 and 1, so TAA reads
history), the JAX package on its exact oracle plan (ssao_impl="xla",
taa_impl="xla", rec_pack="f32", rec_dtype="f32", clouds on), the port
with its plain PyTorch kernel versions on the CPU.

Two inputs are shared between the packages rather than recomputed by
each, because the reference computes them ill-conditioned in float32
(tests/test_torch_ops.py::test_render_sky_lut and
tests/test_torch_ssao.py hold them on their own): the sky LUT of each
frame (the JAX package's) and the SSAO noise hash (a smooth one in both).
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

from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu import scenes as jscenes
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.models import terrain as jterrain
from soc_real_time_renderer_tpu.ops import clouds as jclouds
from soc_real_time_renderer_tpu.ops import ssao as jssao
from soc_real_time_renderer_tpu.scene.components import MeshComponent, \
    TransformComponent
from soc_real_time_renderer_tpu.scene.scene import Scene
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.models import terrain as pterrain
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster
from soc_real_time_renderer_tpu_torch.ops import ssao as pssao
from soc_real_time_renderer_tpu_torch.ops import taa as ptaa
from soc_real_time_renderer_tpu_torch.scene import components as pcomp
from soc_real_time_renderer_tpu_torch.scene.scene import Scene as PScene

W, H = 128, 64
CAMERA = dict(camera_pos=[20.0, 12.0, 20.0], camera_target=[50, 0, 50])
ORACLE = dict(width=W, height=H, ssao_impl="xla", taa_impl="xla")


@pytest.fixture(scope="module")
def built():
    """(JAX BuiltScene with the oracle plan, port BuiltScene): the
    reduced terrain, 64^2 heightmap, tess level 1, 64^2 atlas."""
    hm = jterrain.procedural_heightmap(64)
    jmodel = jterrain.build_terrain_model(hm, jterrain.default_albedo(hm),
                                          tess_level=1)
    scene = Scene("terrain")
    e = scene.create_entity("terrain")
    e.add_component(TransformComponent())
    e.add_component(MeshComponent()).model = jmodel
    jb = jscenes._finish(scene, [jmodel], jcfg.RenderConfig(**ORACLE),
                         atlas_size=64, **CAMERA)
    jb.plan = dataclasses.replace(
        jb.plan, rec_pack="f32", interpret=True,
        main_grid=dataclasses.replace(jb.plan.main_grid, rec_dtype="f32"))
    hm2 = pterrain.procedural_heightmap(64)
    pmodel = pterrain.build_terrain_model(
        hm2, pterrain.default_albedo(hm2), tess_level=1)
    pscene = PScene("terrain")
    pe = pscene.create_entity("terrain")
    pe.add_component(pcomp.TransformComponent())
    pe.add_component(pcomp.MeshComponent()).model = pmodel
    pb = pscenes._finish(pscene, [pmodel], RenderConfig(**ORACLE),
                         device="cpu", atlas_size=64, **CAMERA)
    return jb, pb


def smooth_rand_jax(cu, cv):
    return 0.5 + 0.5 * jnp.sin(cu * 0.7 + cv * 1.3)


def smooth_rand_torch(cu, cv):
    return 0.5 + 0.5 * torch.sin(cu * 0.7 + cv * 1.3)


@pytest.fixture(scope="module")
def frames(built):
    """Two frames from each package -> list of (jax outputs, jax
    history, port outputs, port history)."""
    jb, pb = built
    plan = jb.plan
    out = []
    jh = jframe.RenderHistory.create(plan.config)
    ph = pframe.RenderHistory.create(pb.plan.config, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssao, "_rand", smooth_rand_jax)
        mp.setattr(pssao, "_rand", smooth_rand_torch)
        render = jax.jit(lambda b, g, h, m, n: jframe.render_frame(
            plan, b, g, h, m, n))
        real_lut = jclouds.render_sky_lut
        for f in range(2):
            jg, jmm, jnm = jb.frame_globals(f)
            lut = np.asarray(jax.jit(lambda g_: real_lut(g_))(jg))
            mp.setattr(jclouds, "render_sky_lut",
                       lambda g_, *a, _l=lut, **k: jnp.asarray(_l))
            mp.setattr(pclouds, "render_sky_lut",
                       lambda g_, *a, _l=lut, **k: torch.from_numpy(_l))
            jo, jh = render(jb.batch, jg, jh, jmm, jnm)
            pg, pmm, pnm = pb.frame_globals(f)
            po, ph = pframe.render_frame(pb.plan, pb.batch, pg, ph, pmm, pnm)
            out.append((jo, jh, po, ph))
            render = jax.jit(lambda b, g, h, m, n: jframe.render_frame(
                plan, b, g, h, m, n))      # re-trace with the next LUT
    return out


def test_scene_batch_is_byte_identical(built):
    jb, pb = built
    for name in ("tri_pos", "tri_nrm", "tri_uv", "tri_entity",
                 "static_rows", "atlas_packed"):
        a = np.asarray(getattr(jb.batch, name))
        b = getattr(pb.batch, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert jb.batch.cloud_noise is None and pb.batch.cloud_noise is None


def test_plan_and_globals_match(built):
    jb, pb = built
    assert convert.plan_from_jax_plan(jb.plan) == pb.plan
    assert pb.plan.shadow_statically_empty
    jg, _, _ = jb.frame_globals(3, peek=True)
    pg, _, _ = pb.frame_globals(3, peek=True)
    cg = convert.globals_from_numpy(jg)
    for f in dataclasses.fields(cg):
        a, b = getattr(cg, f.name), getattr(pg, f.name)
        if dataclasses.is_dataclass(a):
            for ff in dataclasses.fields(a):
                assert torch.equal(getattr(a, ff.name), getattr(b, ff.name))
        else:
            assert torch.equal(a, b), f.name


@pytest.mark.parametrize("frame", [0, 1])
def test_visibility_matches(frames, frame):
    jo, _, po, _ = frames[frame]
    jt = np.asarray(jo.gbuffer.depth)
    assert (np.abs(jt - po.gbuffer.depth.numpy()) < 1e-4).mean() >= 0.999
    assert int(jo.overflow) == int(po.overflow) == 0


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("target", ["hdr", "color"])
def test_image_matches(frames, frame, target):
    """mean abs < 2e-3 and 99.9th percentile < 3e-2."""
    jo, _, po, _ = frames[frame]
    d = np.abs(np.asarray(getattr(jo, target))
               - getattr(po, target).numpy())
    assert np.isfinite(getattr(po, target).numpy()).all()
    assert d.mean() < 2e-3, d.mean()
    assert np.quantile(d, 0.999) < 3e-2, np.quantile(d, 0.999)


@pytest.mark.parametrize("frame", [0, 1])
def test_exposure_matches(frames, frame):
    """|difference| < 1e-4 stops (a 7e-5 brightness change).  Exposure
    is a log2 value that starts at 0 and moves 1.6% of the way to its
    target per frame, so a relative bound on it is ill-posed: a pixel
    whose luminance differs by an ulp across one of the histogram's
    bin edges moves the value by ~2e-7 stops, and tens of the 8192
    pixels do."""
    _, jh, _, ph = frames[frame]
    a, b = float(jh.exposure), float(ph.exposure)
    assert a > 0.01 and abs(a - b) < 1e-4, (a, b)


def test_history_carries_bf16(frames):
    _, jh, _, ph = frames[1]
    assert ph.previous_color.dtype == torch.bfloat16
    d = np.abs(np.asarray(jh.previous_color, np.float32)
               - ph.previous_color.float().numpy())
    assert d.mean() < 2e-3


def test_tri_ids_agree(built):
    """The main-view raster of frame 0 alone: tri_id agreement >= 0.999
    against the JAX rasterize on the f32 record stream."""
    jb, pb = built
    jg, jmm, jnm = jb.frame_globals(0, peek=True)
    pg, pmm, pnm = pb.frame_globals(0, peek=True)
    jvis = jax.jit(lambda b, g, m, n: jframe.raster_stage(
        jb.plan, b, g, m, n)[0])(jb.batch, jg, jmm, jnm)
    pvis = pframe.raster_stage(pb.plan, pb.batch, pg, pmm, pnm)[0]
    agree = np.asarray(jvis.tri_id) == pvis.tri_id.numpy()
    assert agree.mean() >= 0.999, agree.mean()
    assert (pvis.tri_id.numpy() >= 0).mean() > 0.05


def test_import_leaves_jax_out():
    code = ("import sys, soc_real_time_renderer_tpu_torch as p\n"
            "import soc_real_time_renderer_tpu_torch.graph.frame\n"
            "import soc_real_time_renderer_tpu_torch.scenes\n"
            "import soc_real_time_renderer_tpu_torch.convert\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith("
            "'soc_real_time_renderer_tpu.') "
            "or m == 'soc_real_time_renderer_tpu']\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root)


def test_kernel_entries_refuse_cuda_on_cpu():
    """impl="cuda" on CPU tensors raises instead of running the plain
    version, for each of K1, K2 and K3."""
    z = torch.zeros
    grid = praster.BinGrid(width=64, height=32, bin_w=64, bin_h=32,
                           group=1, pair_cap=128)
    with pytest.raises(ValueError):
        praster.resolve(z(2, dtype=torch.int32), z(16, 128), grid,
                        impl="cuda")
    with pytest.raises(ValueError):
        pssao.ssao_taps(z(12, 4, 4), z(8, 8), z(4, 4), z(4, 4), z(()),
                        z(()), z(26, 3), impl="cuda")
    with pytest.raises(ValueError):
        ptaa.reproject_history(z(5, 4, 4, dtype=torch.bfloat16),
                               z(2, 4, 4), impl="cuda")
