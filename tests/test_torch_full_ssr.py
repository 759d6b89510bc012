"""The reflective atrium, the ``full_ssr`` preset, on the CPU.

Its frames from the kit's reduced atrium (with the synthetic Sponza
materials) and terrain and the small synthetic asset tree, at 128x64
through the harness's frame loop
(``graph/frame.make_render_fn``), against the benchmark's plain
reference within ``full_ssr_1080p.json``'s limits; its SSR cap (the
screen's pixel count) beside ``full``'s 5% rule; the ``ssr_pixels``
counter, eager and under a stand-in for the CUDA graph API; the floor's
tile map, shared with the kit; and the cell's configuration and its
three metric readers.
"""
import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from benchmark import check, harness, registry, spans as spans_mod
from benchmark.traffic import Traffic
from soc_real_time_renderer_tpu_torch import scenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as fm
from soc_real_time_renderer_tpu_torch.graph import replay
from soc_real_time_renderer_tpu_torch.models import proc
from soc_real_time_renderer_tpu_torch.ops import ssr
from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
from soc_real_time_renderer_tpu_torch.tools import bench, synth_assets
from soc_real_time_renderer_tpu_torch.utils import trace
from test_torch_graphs import _StandInGraph, _StandInStream

CPU = torch.device("cpu")
SEED = 2 ** 31 + 2424
W, H = 128, 64
CONFIG = "full_ssr_1080p"
READERS = ("ssr_ms", "ssr_roofline", "ssr_pixels_per_frame")


def _five_percent(w, h):
    """_finish's default SSR cap: 5% of the screen, rounded up to
    1,024 (the JAX package's sizing)."""
    return -(-int(0.05 * w * h) // 1024) * 1024


@contextlib.contextmanager
def _reduced(tree):
    """scenes.build on the small tree, with the kit's coarse atrium (the
    tree's Sponza materials) and reduced terrain."""
    def atrium(**kw):
        model = kit.small_atrium_port()
        model.images, model.materials = proc._sponza_materials(
            os.path.join(tree, synth_assets.SPONZA))
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scenes, "ASSETS", tree)
        mp.setattr(proc, "build_atrium", atrium)
        mp.setattr(scenes, "_terrain_model",
                   lambda **kw: kit.small_terrain("port", **kw))
        yield


def _build(tree, name, **render_config):
    with _reduced(tree):
        return scenes.build(name, RenderConfig(**{
            "width": W, "height": H, "shadow_resolution": 256,
            **render_config}), device=CPU, atlas_size=64)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The small synthetic tree with Sponza's materials as 64^2 maps."""
    root = str(tmp_path_factory.mktemp("assets"))
    synth_assets.write_asset_tree(root, rings=10, segments=25,
                                  helmet_map=64, sponza_map=64)
    return root


@pytest.fixture(scope="module")
def ssr_frames(tree):
    """(configuration, BuiltScene, traffic, frames) of three frames of
    the reduced full_ssr preset through the harness's loop on the cell's
    orbit traffic."""
    cfg = registry.config(CONFIG)
    cfg.update(width=W, height=H, render_config=dict(
        cfg["render_config"], shadow_resolution=256))
    built = _build(tree, "full_ssr", **cfg["render_config"])
    sp = spans_mod.Spans()
    sp.install(fm)
    try:
        traffic = Traffic(registry.traffic("orbit"), SEED)
        loop = harness.Loop(built, traffic, sp, harness.Clock(CPU))
        frames = [loop.frame(n) for n in range(3)]
    finally:
        sp.uninstall()
    assert loop.raised == 0 and not loop.flags[:3].any()
    return cfg, built, traffic, frames


def test_full_ssr_frames_match_the_reference(ssr_frames):
    """Three frames of the reduced full_ssr preset, each against the
    benchmark's reference (its dense SSR march over the program's depth
    and G-buffer, the mix, the frame) within full_ssr_1080p.json's
    limits, with ``ssr``, ``hdr`` and ``color`` at 0.  Each frame
    reflects more pixels than _finish's default cap would march, so
    that cap would have set bit 16; the preset's cap sets none."""
    cfg, built, traffic, frames = ssr_frames
    samples = [dict(k=k, g=f[0], mats=(f[1], f[2]),
                    targets=harness.targets_of(*f[3:]))
               for k, f in enumerate(frames)]
    per_frame, _ = harness.reference_check(cfg, built, traffic, samples,
                                           CPU)
    assert len(per_frame) == 3
    ok, shown = check.judge(check.worst(per_frame), cfg["check"]["limits"])
    assert ok, shown
    for number in ("ssr", "hdr", "color"):
        assert shown[number]["value"] == 0.0, shown
    for _, _, _, out, *_ in frames:
        n = int(out.ssr_active)
        mr = out.gbuffer.metallic_roughness
        assert n == int((mr[1] >= ssr.METALLIC_MIN).sum())
        assert n > _five_percent(W, H) > 0.05 * W * H
        assert int(out.overflow) == 0


@pytest.mark.parametrize("name", ["full_ssr", "full"])
def test_the_ssr_cap_is_sized_from_the_data(tree, name):
    """full_ssr's FramePlan.ssr_cap is the screen's pixel count (its
    floor can fill any share of it), kept by a full rebuild; full's is
    still _finish's 5% rule."""
    built = _build(tree, name, enable_ssr=True)
    want = W * H if name == "full_ssr" else _five_percent(W, H)
    assert built.plan.ssr_cap == want
    assert built.ssr_cap == (W * H if name == "full_ssr" else None)
    # a new model set re-packs the batch and re-sizes the plan
    built._models = built._models[:1]
    with _reduced(tree):
        built.rebuild()
    assert built.plan.ssr_cap == want


def test_the_floor_is_polished_tiles(tree):
    """full_ssr's atrium is full's with material 0 (the floor) taking the
    tile map as its metallic-roughness image, its albedo and normal
    images and every other material unchanged."""
    with _reduced(tree):
        _, (plain, *_) = scenes._full_scene("full")
        _, (polished, *_) = scenes._full_scene("full_ssr")
    scenes.polish_floor(polished)
    assert len(polished.images) == len(plain.images) + 1
    assert np.array_equal(polished.images[-1], proc.metal_tile_image())
    m0, p0 = plain.materials[0], polished.materials[0]
    assert p0.metallic_roughness_image == len(polished.images) - 1
    assert m0.albedo_image >= 0 and m0.normal_image >= 0
    assert (p0.albedo_image, p0.normal_image) == (m0.albedo_image,
                                                  m0.normal_image)
    assert all(np.array_equal(a, b)
               for a, b in zip(plain.images, polished.images))
    assert polished.materials[1:] == plain.materials[1:]


def test_the_kits_metal_image_is_the_ports_tile_map():
    """The kit's metal_image (the atrium_passes floor of the tests) is
    proc.metal_tile_image, seed for seed: 8x8-texel tiles, roughness in
    [0.1, 0.5], metallic about 0.9 with about a quarter of the tiles
    dielectric."""
    for seed in (5, 11):
        assert np.array_equal(kit.metal_image(seed), proc.metal_tile_image(
            seed))
    img = proc.metal_tile_image()
    assert img.shape == (64, 64, 4) and img.dtype == np.uint8
    tiles = img[::8, ::8]
    assert (img == np.kron(tiles, np.ones((8, 8, 1), np.uint8))).all()
    rough, metal = tiles[..., 1] / 255.0, tiles[..., 2] / 255.0
    assert 0.09 < rough.min() and rough.max() < 0.5
    assert ((metal == 0) | ((metal > 0.84) & (metal <= 1.0))).all()
    assert 0.1 < (metal == 0).mean() < 0.4


@pytest.fixture(scope="module")
def small_passes():
    """The kit's coarse atrium_passes at 32x32, SSR on, no shadow view
    and no clouds: a frame in well under a second on the CPU."""
    return kit.build_port("atrium_passes", RenderConfig(
        width=32, height=32, shadow_resolution=128, enable_shadows=False,
        enable_clouds=False, enable_ssr=True, composite_ssr=True), "cpu")


@pytest.mark.parametrize("ssr_on", [True, False], ids=["on", "off"])
def test_ssr_pixels_counts_each_march(small_passes, monkeypatch, ssr_on):
    """``ssr_pixels`` adds pixels x views a march: H x W a frame, eager
    and under a stand-in for the CUDA graph API (the first frame eager,
    the second captured, the rest replayed, each re-adding it), and
    3 x H x W for a call on three views; nothing where SSR is off."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _StandInStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _StandInStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(replay, "engages", lambda plan, impl, devices:
                        impl is None and fm._shard(plan) is None)
    built = small_passes
    plan = built.plan
    if not ssr_on:
        plan = dataclasses.replace(plan, config=plan.config.replace(
            enable_ssr=False, composite_ssr=False))
    render = fm.make_render_fn(plan)
    h = fm.RenderHistory.create(plan.config, device="cpu")
    per_frame, replays = [], []
    for f in range(4):
        g, mm, nm = built.frame_globals(f)
        c0 = dict(trace.counters)
        out, h = render(built.batch, g, h, mm, nm)
        per_frame.append(trace.counters["ssr_pixels"]
                         - c0.get("ssr_pixels", 0))
        replays.append(trace.counters["graph_replays"]
                       - c0.get("graph_replays", 0))
    assert replays[0] == 0 and replays[2] > 0 and replays[3] > 0
    assert per_frame == [32 * 32 if ssr_on else 0] * 4
    assert (out.ssr is not None) == ssr_on
    if ssr_on:
        gbuf = out.gbuffer
        g3 = pmesh.batched_globals([g] * 3)
        c0 = trace.counters["ssr_pixels"]
        stack = [torch.stack([x] * 3) for x in (
            gbuf.depth, gbuf.albedo, gbuf.normal, gbuf.metallic_roughness)]
        ssr.ssr(*stack, g3, compact_cap=32 * 32)
        assert trace.counters["ssr_pixels"] - c0 == 3 * 32 * 32


@pytest.mark.parametrize("enable_ssr", [True, False])
def test_kernel_path_names_the_ssr_march(enable_ssr):
    """bench.kernel_path names K8 (ssr_march) where the plan enables SSR,
    as the frame launches it on the card."""
    from types import SimpleNamespace
    plan = SimpleNamespace(config=RenderConfig(enable_ssr=enable_ssr),
                           texture_filter="bilinear",
                           shadow_statically_empty=True)
    path = bench.kernel_path(plan, SimpleNamespace(cloud_noise=None))
    assert ("ssr_march" in path) == enable_ssr


def test_the_configuration_is_full_1080p_with_ssr():
    """full_ssr_1080p loads: full_1080p's camera, size, traffic keys and
    limits, with the full_ssr preset, SSR on and composited, and an
    ``ssr`` limit of 1e-3; the cell runs it on the orbit traffic on one
    chip."""
    ssr_cfg, full = registry.config(CONFIG), registry.config("full_1080p")
    assert ssr_cfg["preset"] == "full_ssr"
    assert ssr_cfg["render_config"] == {"enable_ssr": True,
                                        "composite_ssr": True}
    assert ssr_cfg["check"]["limits"] == dict(full["check"]["limits"],
                                              ssr=0.001)
    same = set(full) - {"preset", "render_config", "source", "assumed",
                        "check"}
    assert {k: ssr_cfg[k] for k in same} == {k: full[k] for k in same}
    cell = registry.cell(registry.load_spec(), "full_ssr_1080p.orbit")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "orbit", 1)


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_without_k8_or_its_counter(monkeypatch,
                                                            name):
    """A traced record of a program without K8 (another port kernel ran,
    no ``ssr_march`` job) and whose counters hold no SSR pixel: None,
    and no error; nor from an empty record."""
    from benchmark import passes
    rec = {"frames": 5, "jobs_ms": {"resolve": 0.01}, "kernels": {
        "resolve_body<true, 2>(...)": {"s": 0.002, "n": 5, "port": True}}}
    monkeypatch.setattr(passes, "profiled", lambda: {
        "totals": {"frame.render": {"host_s": 0.1, "calls": 5}},
        "counters": {"h2d_copies": 5}, "launches": {}})
    assert registry.metric_reader(name)(rec) is None
    monkeypatch.setattr(passes, "profiled", lambda: None)
    assert registry.metric_reader(name)({"frames": 0, "kernels": {}}) is None


def test_the_readers_read_k8_and_its_counter(monkeypatch):
    """K8's 0.25 ms a frame over 4 frames and the ssr_march job's 0.0274
    ms: ssr_ms 0.25, ssr_roofline 100 x 0.0274 / 0.25; 2,088,960 pixels a
    frame counted: ssr_pixels_per_frame that."""
    from benchmark import passes
    rec = {"frames": 4, "jobs_ms": {"ssr_march": 0.0274, "resolve": 0.01},
           "kernels": {
               "(anonymous namespace)::ssr_march_kernel(...)":
                   {"s": 0.001, "n": 4, "port": True},
               "void at::native::elementwise_kernel<...>":
                   {"s": 0.5, "n": 40, "port": False}}}
    monkeypatch.setattr(passes, "profiled", lambda: {
        "totals": {}, "counters": {"ssr_pixels": 4 * 2_088_960},
        "launches": {}})
    read = {n: registry.metric_reader(n)(rec) for n in READERS}
    assert read["ssr_ms"] == pytest.approx(0.25)
    assert read["ssr_roofline"] == pytest.approx(100 * 0.0274 / 0.25)
    assert read["ssr_pixels_per_frame"] == 2_088_960
