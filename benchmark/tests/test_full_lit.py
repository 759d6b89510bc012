"""The lit atrium's configuration, ``full_lit_1080p``: its ``lights`` are
the ``full_lit`` preset's, the check holds a frame of the preset to them
(it passes with them, and fails past the ``hdr`` and ``color`` limits
when the configuration leaves out every light, or only the spot
lights), and the cell's three metric readers read nothing from a
record without K7 or its counters.

The frames are the preset's own build (``scenes.build("full_lit")``)
from the small synthetic asset tree of ``tests/torch_scene_kit.py``,
with its coarse atrium and reduced terrain, at 64x32 on the CPU: two
frames of the cell's orbit traffic in the harness's frame loop, the
second sampled."""
import os
import sys

import pytest
import torch

from benchmark import check, harness, registry, spans as spans_mod
from benchmark.traffic import Traffic

sys.path.insert(0, os.path.join(registry.ROOT, "tests"))
import torch_scene_kit as kit  # noqa: E402

SEED = 2 ** 31 + 2121
CPU = torch.device("cpu")
READERS = ("lights_ms", "lights_roofline", "light_pairs_per_frame")


def test_the_configurations_lights_are_the_presets():
    from soc_real_time_renderer_tpu_torch import scenes
    lights = registry.config("full_lit_1080p")["lights"]
    assert lights == scenes.full_lit_lights()
    assert (len(lights["point"]), len(lights["spot"])) == (128, 128)


def test_the_configuration_is_full_1080p_with_lights():
    """The configuration is full_1080p's (camera, size, check limits)
    with the preset and the lights its own."""
    lit, full = registry.config("full_lit_1080p"), registry.config(
        "full_1080p")
    assert lit["preset"] == "full_lit"
    same = set(full) - {"preset", "source", "assumed"}
    assert {k: lit[k] for k in same} == {k: full[k] for k in same}


@pytest.fixture(scope="module")
def lit_frames(tmp_path_factory):
    """(configuration, BuiltScene, traffic, samples) of the reduced
    full_lit preset."""
    from soc_real_time_renderer_tpu_torch import scenes
    from soc_real_time_renderer_tpu_torch.config import RenderConfig
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.models import proc
    from soc_real_time_renderer_tpu_torch.tools import synth_assets
    cfg = registry.config("full_lit_1080p")
    cfg.update(width=64, height=32, render_config={"shadow_resolution": 256})
    cfg["check"] = dict(cfg["check"], samples=1, within_frames=2)
    root = str(tmp_path_factory.mktemp("assets"))
    synth_assets.write_asset_tree(root, rings=10, segments=25,
                                  helmet_map=64, sponza_map=64)

    def atrium(**kw):
        model = kit.small_atrium_port()
        model.images, model.materials = proc._sponza_materials(
            f"{root}/{synth_assets.SPONZA}")
        return model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scenes, "ASSETS", root)
        mp.setattr(proc, "build_atrium", atrium)
        mp.setattr(scenes, "_terrain_model",
                   lambda **kw: kit.small_terrain("port", **kw))
        built = scenes.build("full_lit", RenderConfig(
            width=64, height=32, **cfg["render_config"]), device=CPU,
            atlas_size=64)
    assert (built.plan.config.max_point_lights,
            built.plan.config.max_spot_lights) == (128, 128)
    sp = spans_mod.Spans()
    sp.install(fm)
    try:
        traffic = Traffic(registry.traffic("orbit"), SEED)
        loop = harness.Loop(built, traffic, sp, harness.Clock(CPU))
        frames = [loop.frame(n) for n in range(2)]
    finally:
        sp.uninstall()
    assert loop.raised == 0 and not loop.flags[:2].any()
    g, mm, nm = frames[1][:3]
    samples = [dict(k=1, g=g, mats=(mm, nm),
                    targets=harness.targets_of(*frames[1][3:]))]
    return cfg, built, traffic, samples


def _without(lights, kinds):
    return {k: v for k, v in lights.items() if k not in kinds}


@pytest.mark.parametrize("left_out", [(), ("point", "spot"), ("spot",)],
                         ids=["all_lights", "no_lights", "no_spot_lights"])
def test_the_check_holds_the_frame_to_the_lights(lit_frames, left_out):
    """With the configuration's 256 lights the check passes, with the
    globals exact; without them, or without its 128 spot lights, the
    frame's ``hdr`` and tonemapped ``color`` are past their limits."""
    cfg, built, traffic, samples = lit_frames
    cfg = dict(cfg, lights=_without(cfg["lights"], left_out))
    per_frame, _ = harness.reference_check(cfg, built, traffic, samples, CPU)
    ok, shown = check.judge(check.worst(per_frame), cfg["check"]["limits"])
    if not left_out:
        assert ok, shown
        assert shown["globals"]["value"] == 0.0
    else:
        assert not ok
        for number in ("hdr", "color"):
            assert shown[number]["value"] > shown[number]["limit"], shown


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_without_k7_or_its_counters(monkeypatch,
                                                             name):
    """A traced record of a program without K7 (another port kernel
    ran) and whose counters hold no light: None, and no error."""
    from benchmark import passes
    rec = {"frames": 5, "kernels": {
        "resolve_body<true, 2>(...)": {"s": 0.002, "n": 5, "port": True}}}
    monkeypatch.setattr(passes, "profiled", lambda: {
        "totals": {"frame.render": {"host_s": 0.1, "calls": 5}},
        "counters": {"h2d_copies": 310}, "launches": {}})
    assert registry.metric_reader(name)(rec) is None
    monkeypatch.setattr(passes, "profiled", lambda: None)
    assert registry.metric_reader(name)({"frames": 0, "kernels": {}}) is None


def test_the_readers_read_k7_and_its_counters(monkeypatch):
    """K7's 3 ms a frame over 5 frames, 534,773,760 pairs (half of them
    spot) and 2,088,960 pixels a frame: lights_ms 3,
    light_pairs_per_frame the pairs, and lights_roofline the compute
    bound (56 f32 operations a point pair, 66 a spot pair, at 67
    TFLOP/s) over 3 ms; without the spot counter, nothing."""
    from benchmark import passes
    pairs, pixels = 256 * 2_088_960, 2_088_960
    rec = {"frames": 5, "kernels": {
        "(anonymous namespace)::local_lights_kernel(...)":
            {"s": 0.015, "n": 5, "port": True},
        "void at::native::elementwise_kernel<...>":
            {"s": 0.5, "n": 50, "port": False}}}
    monkeypatch.setattr(passes, "profiled", lambda: {
        "totals": {}, "counters": {"light_pairs": 5 * pairs,
                                   "spot_light_pairs": 5 * pairs // 2,
                                   "light_pixels": 5 * pixels},
        "launches": {}})
    read = {n: registry.metric_reader(n)(rec) for n in READERS}
    assert read["lights_ms"] == pytest.approx(3.0)
    assert read["light_pairs_per_frame"] == pairs == 534_773_760
    assert read["lights_roofline"] == pytest.approx(
        100 * pairs // 2 * (56 + 66) / 67e12 / 3e-3)
    monkeypatch.setattr(passes, "profiled", lambda: {
        "totals": {}, "counters": {"light_pairs": 5 * pairs,
                                   "light_pixels": 5 * pixels},
        "launches": {}})
    assert registry.metric_reader("lights_roofline")(rec) is None
