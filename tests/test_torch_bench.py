"""The port's measuring entry points (tools/bench.py, bench_baselines.py,
bench_toggle.py) on the CPU, at a tiny size: the reduced terrain (64^2
heightmap, tess level 1) at 128x64, one to three frames, ``--device
cpu``.

The mains run on the terrain preset with its model swapped for the
reduced one, a synthetic asset tree written at small map sizes (the
terrain reads only its noise PNG), and the sky LUT picked from seeded
LUTs by frame_counter (the procedural one and K6's plain version each
take seconds a frame here; test_torch_ops.py and test_torch_sky.py hold
them).  The frame loop is held against a JAX ``lax.scan`` of
``render_frame`` over the same staged globals (the JAX bench.py's
``run``), with the sky LUT and the SSAO hash shared as in
test_torch_frame.py, at that file's terrain bounds.  The mains of
bench_toggle.py and bench_baselines.py print their tables in
tests/test_torch_bench_tools.py, with this file's ``small_terrain``.
"""
import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import test_torch_parallel as tp
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.ops import gbuffer as jgbuf
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.models import terrain as pterrain
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import gbuffer as pgbuf
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster
from soc_real_time_renderer_tpu_torch.ops import sky as psky
from soc_real_time_renderer_tpu_torch.ops import texsample as ptex
from soc_real_time_renderer_tpu_torch.tools import bench
from soc_real_time_renderer_tpu_torch.tools import bench_baselines
from soc_real_time_renderer_tpu_torch.tools import bench_toggle
from soc_real_time_renderer_tpu_torch.tools import synth_assets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"BENCH_SCENE": "terrain", "BENCH_WIDTH": "128",
         "BENCH_HEIGHT": "64", "BENCH_FRAMES": "2"}


@pytest.fixture
def small_terrain(monkeypatch, tmp_path):
    """The terrain preset builds the reduced terrain; an empty asset
    directory (the bench writes a small synthetic tree); the sky LUT
    from seeded LUTs by frame_counter, whichever path asks for it."""
    hm = pterrain.procedural_heightmap(64)
    model = pterrain.build_terrain_model(hm, pterrain.default_albedo(hm),
                                         tess_level=1)
    monkeypatch.setattr(pscenes, "_terrain_model", lambda **_: model)
    monkeypatch.setattr(pscenes, "ASSETS", str(tmp_path / "absent"))
    monkeypatch.setattr(synth_assets, "write_asset_tree", functools.partial(
        synth_assets.write_asset_tree, rings=6, segments=9, helmet_map=32,
        sponza_map=32))
    luts = torch.from_numpy(tp.luts_seeded(n=4))

    def lut(g, *a, **k):
        return luts[g.frame_counter.long()]

    monkeypatch.setattr(pclouds, "render_sky_lut", lut)
    monkeypatch.setattr(psky, "render_sky_lut_noise", lut)


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_bench_prints_one_json_line(small_terrain, capsys):
    """The JAX bench's keys and the card's, with their types; value is
    the loop over N (ms), vs_baseline 16 over it; the metric string says
    the assets are synthetic and the device the CPU."""
    ret = bench.main(["--device", "cpu"], SMALL)
    line = _last_json(capsys.readouterr().out)
    assert line == json.loads(json.dumps(ret))
    types = {"metric": str, "value": float, "unit": str,
             "vs_baseline": float, "median_ms": float, "min_ms": float,
             "max_ms": float, "frames": int, "peak_mib": type(None),
             "device": str, "assets": str}
    assert set(line) == set(types)
    for k, t in types.items():
        assert isinstance(line[k], t), (k, line[k])
    assert line["unit"] == "ms" and line["frames"] == 2
    assert line["device"] == "cpu" and line["assets"] == "synthetic"
    assert "terrain 128x64" in line["metric"]
    assert "synthetic assets" in line["metric"] and "cpu" in line["metric"]
    assert 0 < line["min_ms"] <= line["median_ms"] <= line["max_ms"]
    assert abs(line["vs_baseline"] - 16.0 / line["value"]) <= 1e-4


def test_bench_needs_a_card_unless_told_cpu(small_terrain, monkeypatch):
    """Without a card and without --device cpu it raises before it
    builds anything; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_build(*a, **k):
        raise AssertionError("built a scene")

    monkeypatch.setattr(pscenes, "build", no_build)
    for main in (bench.main, bench_baselines.main, bench_toggle.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


def test_bench_tools_import_no_jax():
    """The three tools and what their mains import (the scenes, the
    frame, the kernels' build, the synthetic tree) leave jax and the
    JAX package out."""
    code = ("import sys\n"
            "from soc_real_time_renderer_tpu_torch.tools import bench, "
            "bench_baselines, bench_toggle, synth_assets\n"
            "from soc_real_time_renderer_tpu_torch import scenes, config\n"
            "from soc_real_time_renderer_tpu_torch.graph import frame\n"
            "from soc_real_time_renderer_tpu_torch.kernels import build\n"
            "assert 'torch' in sys.modules\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'soc_real_time_renderer_tpu.')) or m == "
            "'soc_real_time_renderer_tpu']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def _jax_scan(jb, plan, frames):
    """The JAX bench.py's run: a lax.scan of render_frame over the
    stacked globals of frames 1..N -> (history, colours, overflow)."""
    gs = []
    for i in range(frames):
        g, mm, nm = jb.frame_globals(i + 1)
        gs.append(g)
    gb = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *gs)

    def run(batch, gb, hist, mm, nm):
        def step(h, g):
            out, h2 = jframe.render_frame(plan, batch, g, h, mm, nm)
            return h2, (out.color, out.overflow)
        return jax.lax.scan(step, hist, gb)

    hist, (colors, overflow) = jax.jit(run)(
        jb.batch, gb, jframe.RenderHistory.create(plan.config), mm, nm)
    return hist, np.asarray(colors), np.asarray(overflow)


def test_loop_matches_jax_scan(monkeypatch, tmp_path):
    """Three frames of the loop (bench.stage + bench.run on the CPU)
    against the JAX scan over the same staged globals: every frame's
    overflow 0 on both; the last frame's colour at test_torch_frame.py's
    terrain bounds (mean abs < 2e-3, 99.9th percentile < 3e-2), the
    carried history colour (mean < 2e-3) and exposure (< 1e-4)."""
    for mod in (tp.jscenes, pscenes):
        monkeypatch.setattr(mod, "ASSETS", str(tmp_path))
    jb = tp.terrain_jax()
    pb = tp.terrain_port(RenderConfig(**tp.ORACLE))
    tp.shared_inputs(monkeypatch, tp.luts_seeded(n=4))
    frames = 3
    jh, jcolors, jovf = _jax_scan(jb, tp.oracle_plan(jb.plan), frames)
    staged = bench.stage(pb, pb.plan, frames)
    t = bench.run(pb, pb.plan, staged)
    assert len(t.frame_ms) == frames
    assert t.overflow == [0] * frames and jovf.tolist() == [0] * frames
    assert t.launches == {k: 0 for k in t.launches}
    got = t.outputs.color.numpy()
    assert np.isfinite(got).all()
    d = np.abs(jcolors[-1] - got)
    assert d.mean() < 2e-3, d.mean()
    assert np.quantile(d, 0.999) < 3e-2, np.quantile(d, 0.999)
    dh = np.abs(np.asarray(jh.previous_color, np.float32)
                - t.history.previous_color.float().numpy())
    assert dh.mean() < 2e-3, dh.mean()
    assert abs(float(jh.exposure) - float(t.history.exposure)) < 1e-4


def _jax_list(path, name):
    """The value of `name = [...]` / `{...}` in a JAX tool, read with
    ast (the JAX tools import jax inside main)."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return eval(compile(ast.Expression(node.value), path, "eval"),
                        {"__builtins__": {}, "dict": dict})
    raise LookupError(f"{name} not in {path}")


@pytest.mark.parametrize("path,name,port", [
    ("tools/bench_baselines.py", "CONFIGS",
     lambda: {n: (s, kw, d) for n, d, s, kw in bench_baselines.CONFIGS}),
    ("tools/bench_toggle.py", "PRESETS",
     lambda: {n: (s, kw, None) for n, (s, kw) in
              bench_toggle.PRESETS.items()}),
])
def test_configurations_equal_the_jax_tools(path, name, port):
    """The seven BASELINE configurations and the six toggle presets:
    the same numbers, scenes and descriptions, and every RenderConfig
    field equal between the two packages' configs."""
    want = _jax_list(path, name)
    if isinstance(want, list):
        want = {n: (s, kw, d) for n, d, s, kw in want}
    else:
        want = {n: (s, kw, None) for n, (s, kw) in want.items()}
    got = port()
    assert sorted(got) == sorted(want) and len(got) in (6, 7)
    for n, (scene, kw, desc) in want.items():
        assert got[n][0] == scene and got[n][2] == desc, n
        jc, pc = jcfg.RenderConfig(**kw), RenderConfig(**got[n][1])
        for f in dataclasses.fields(pc):
            assert getattr(pc, f.name) == getattr(jc, f.name), (n, f.name)


@pytest.mark.parametrize("noise,switches,sky", [
    (False, {}, "sky_lut_procedural"),
    (True, {}, "sky_lut"),
    (True, {"cloud_noise_mode": "procedural"}, "sky_lut_procedural"),
    (True, {"cloud_impl": "perpixel"}, None),
    (False, {"cloud_impl": "perpixel"}, "sky_lut_procedural"),
    (False, {"enable_clouds": False}, None)],
    ids=["procedural", "texture", "procedural_mode", "perpixel",
         "perpixel_without_noise", "no_clouds"])
def test_kernel_path_names_the_frames_sky_kernel(noise, switches, sky):
    """bench.kernel_path names the sky kernel the frame launches, as
    graph/frame picks it: K6 over the noise texture, K6p without it (or
    in the procedural noise mode), neither under the per-pixel march
    (which falls back to the LUT without the noise) or with the clouds
    off."""
    from types import SimpleNamespace
    # a scene with no light, as _finish binds it
    plan = SimpleNamespace(config=RenderConfig(max_point_lights=0,
                                               max_spot_lights=0, **switches),
                           texture_filter="bilinear",
                           shadow_statically_empty=True)
    batch = SimpleNamespace(cloud_noise=torch.zeros(64, 64) if noise
                            else None)
    want = ["resolve", "gbuffer_resolve", "ssao_taps", "taa_resolve"]
    assert bench.kernel_path(plan, batch) == want + ([sky] if sky else [])


@pytest.mark.parametrize("lights", [(128, 128), (3, 0), (0, 2), (0, 0)])
def test_kernel_path_names_the_local_lights(lights):
    """bench.kernel_path names K7 (local_lights) where the plan binds a
    point or a spot light slot, as composition launches it."""
    from types import SimpleNamespace
    plan = SimpleNamespace(config=RenderConfig(max_point_lights=lights[0],
                                               max_spot_lights=lights[1]),
                           texture_filter="bilinear",
                           shadow_statically_empty=True)
    path = bench.kernel_path(plan, SimpleNamespace(cloud_noise=None))
    assert ("local_lights" in path) == (lights != (0, 0))


def test_tex_none_matches_jax(monkeypatch):
    """The attribution probe filter_mode="none" (tex_none): the port's
    resolve_gbuffer against the JAX one on the reduced terrain's frame
    1, every target within 1e-5, and the material tap (K5's dispatch)
    not called."""
    jb = tp.terrain_jax()
    plan = tp.oracle_plan(jb.plan)
    g, mm, nm = jb.frame_globals(1)
    vis, records, _, _ = jax.jit(
        lambda b, g_, m, n: jframe.raster_stage(plan, b, g_, m, n))(
        jb.batch, g, mm, nm)
    kw = dict(atlas_size=plan.atlas_size,
              layer_stride=plan.atlas_layer_stride,
              n_levels=plan.atlas_n_levels, filter_mode="none")
    want, _, _ = jax.jit(lambda v, r, b, g_: jgbuf.resolve_gbuffer(
        v, r, b.atlas_packed, g_.camera_prev.projection_view, **kw))(
        vis, records, jb.batch, g)

    def no_tap(*a, **k):
        raise AssertionError("the material tap ran")

    monkeypatch.setattr(ptex, "sample_atlas", no_tap)
    t = convert.to_tensor
    got = pgbuf.resolve_gbuffer(
        praster.VisibilityBuffer(depth=t(vis.depth), tri_id=t(vis.tri_id),
                                 overflow=t(vis.overflow)),
        t(records), t(jb.batch.atlas_packed),
        t(g.camera_prev.projection_view), **kw)
    assert (np.asarray(vis.tri_id) >= 0).mean() > 0.05
    for name in ("albedo", "emissive", "normal", "metallic_roughness",
                 "velocity", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
