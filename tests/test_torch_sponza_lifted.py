"""The ``sponza_lifted`` preset (the sunlit atrium of the benchmark's
``sponza_lifted_1080p`` configuration) on the CPU, against the
benchmark's plain reference (``benchmark/reference/``).

The preset is built once, from the small synthetic asset tree of
tests/test_torch_presets.py (a 500-triangle helmet, Sponza's materials
as 64^2 PNGs, a 64^2 cloud noise) with the kit's coarse atrium in place
of the 153k-triangle one, at 64x32 and a 1024^2 shadow map: the
smallest map whose 128-texel crop granularity still proves a crop (at
512^2 the 128-aligned box is 75% of the map).  Two frames of the
benchmark's orbit traffic run through ``make_render_fn`` in the
harness's frame loop, and:

* the build defeats the emptiness proof and proves a crop;
* both frames agree with ``benchmark.reference.frame.render`` under
  ``benchmark.check``'s numbers within the configuration's limits;
* the reference's own shadow map (the whole map, no crop) is exactly
  1.0 outside the proved crop and holds covered texels inside it, and
  the program's map (K4's plain version) equals it bit for bit;
* ``shadow_texels`` counts the crop's area a frame, and the shadow
  view's sub-spans are entered once a frame; an elided frame
  (``terrain``, the kit's reduced terrain) counts nothing and enters
  neither.
"""
import json
import os

import pytest
import torch

import torch_scene_kit as kit
from benchmark import check, harness
from benchmark import spans as spans_mod
from benchmark.reference import globals as rg
from benchmark.reference import raster as rraster
from benchmark.traffic import Traffic
from soc_real_time_renderer_tpu_torch import scenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as fm
from soc_real_time_renderer_tpu_torch.models import proc
from soc_real_time_renderer_tpu_torch.tools import synth_assets
from soc_real_time_renderer_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(width=64, height=32, shadow_resolution=1024)
SEED = 2 ** 31 + 1601
SPANS = ("raster.shadow", "shadow.setup", "shadow.resolve")


def _json(*path):
    with open(os.path.join(ROOT, "benchmark", *path)) as f:
        return json.load(f)


def _coarse_atrium(texture_dir):
    model = kit.small_atrium_port()
    model.images, model.materials = proc._sponza_materials(texture_dir)
    return model


def _frames(built, traffic, n):
    """`n` frames of `traffic` through the harness's frame loop; returns
    (the check's samples, the frames' outputs, the program's trace
    totals and counters over them)."""
    sp = spans_mod.Spans()
    sp.install(fm)
    try:
        loop = harness.Loop(built, traffic, sp,
                            harness.Clock(torch.device("cpu")), max_frames=n)
        before = trace.snapshot()
        samples, outs = [], []
        for k in range(n):
            res = loop.frame(k)
            assert res is not None, "the frame raised"
            g, mm, nm, out, hist, prev, capture = res
            samples.append(dict(k=k, g=g, mats=(mm, nm), targets={
                name: v.clone() for name, v in harness.targets_of(
                    out, hist, prev, capture).items()}))
            outs.append(out)
        after = trace.snapshot()
    finally:
        sp.uninstall()
    calls = {s: after["totals"].get(s, {"calls": 0})["calls"]
             - before["totals"].get(s, {"calls": 0})["calls"]
             for s in SPANS + ("frame.raster",)}
    texels = after["counters"].get("shadow_texels", 0) \
        - before["counters"].get("shadow_texels", 0)
    return samples, outs, calls, texels


@pytest.fixture(scope="module")
def lifted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("assets"))
    synth_assets.write_asset_tree(root, rings=10, segments=25,
                                  helmet_map=64, sponza_map=64)
    cfg = _json("configs", "sponza_lifted_1080p.json")
    cfg.update(width=SIZE["width"], height=SIZE["height"],
               render_config={"shadow_resolution": SIZE["shadow_resolution"]})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scenes, "ASSETS", root)
        mp.setattr(proc, "build_atrium", lambda **kw: _coarse_atrium(
            f"{root}/{synth_assets.SPONZA}"))
        built = scenes.build(cfg["preset"], RenderConfig(**SIZE),
                             atlas_size=64, device="cpu")
        mp.setattr(scenes, "_terrain_model",
                   lambda **kw: kit.small_terrain("port"))
        terrain = scenes.build("terrain", RenderConfig(**SIZE),
                               atlas_size=64, device="cpu")
    traffic = Traffic(_json("traffic", "orbit.json"), SEED)
    samples, outs, calls, texels = _frames(built, traffic, 2)
    return dict(cfg=cfg, built=built, traffic=traffic, samples=samples,
                outs=outs, calls=calls, texels=texels, terrain=terrain)


def test_the_preset_defeats_the_proof_and_proves_a_crop(lifted):
    plan = lifted["built"].plan
    assert not plan.shadow_statically_empty
    x0, y0, w, h = plan.shadow_crop
    S = SIZE["shadow_resolution"]
    assert 0 < w * h < 0.7 * S * S
    assert lifted["built"].animate
    for out in lifted["outs"]:
        assert out.shadow_map is not None
        assert int(out.overflow) == 0


def test_frames_match_the_reference(lifted):
    per_frame, _ = harness.reference_check(
        lifted["cfg"], lifted["built"], lifted["traffic"],
        lifted["samples"], torch.device("cpu"))
    limits = lifted["cfg"]["check"]["limits"]
    assert len(per_frame) == 2
    ok, shown = check.judge(check.worst(per_frame), limits)
    assert ok, shown


@pytest.fixture(scope="module")
def reference_maps(lifted):
    """The reference's own shadow map of each frame: the whole map, no
    crop, from the reference's default sun."""
    built, S = lifted["built"], SIZE["shadow_resolution"]
    scene = harness.scene_data(built, lifted["cfg"])
    sun_pv = torch.from_numpy(rg.default_sun().projection_view)
    maps = []
    for s in lifted["samples"]:
        world, _ = rraster.transform_triangles(scene, *s["mats"])
        setup = rraster.triangle_setup_planar(
            rraster.clip_of(world, sun_pv), S, S, "back")
        ref_map, _, covered = rraster.resolve(setup, S, S)
        assert covered > 0
        maps.append(ref_map)
    return maps


def test_the_references_map_is_the_clear_outside_the_crop(lifted,
                                                          reference_maps):
    x0, y0, w, h = lifted["built"].plan.shadow_crop
    for ref_map in reference_maps:
        assert bool((ref_map[y0:y0 + h, x0:x0 + w] < 1.0).any())
        outside = ref_map.clone()
        outside[y0:y0 + h, x0:x0 + w] = 1.0
        assert bool((outside == 1.0).all())


def test_the_programs_map_is_the_references(lifted, reference_maps):
    """The shadow view's plain resolve (K4's plain version) gives the
    reference's map bit for bit: the whole 1024^2 map, crop or not."""
    for out, ref_map in zip(lifted["outs"], reference_maps):
        assert torch.equal(out.shadow_map, ref_map)


def test_shadow_texels_count_the_crop_and_the_spans_run(lifted):
    x0, y0, w, h = lifted["built"].plan.shadow_crop
    assert lifted["texels"] == 2 * w * h
    assert lifted["calls"] == {s: 2 for s in SPANS + ("frame.raster",)}


def test_an_elided_frame_counts_nothing(lifted):
    terrain = lifted["terrain"]
    assert terrain.plan.shadow_statically_empty
    _, outs, calls, texels = _frames(
        terrain, Traffic(_json("traffic", "orbit.json"), SEED), 1)
    assert outs[0].shadow_map is None
    assert texels == 0
    assert calls == {"raster.shadow": 0, "shadow.setup": 0,
                     "shadow.resolve": 0, "frame.raster": 1}
