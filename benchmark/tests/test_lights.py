"""A configuration's ``lights`` in the reference's globals: without the
key the globals are those of no light, leaf for leaf; ``lights_of``
gathers as the port's ``Scene.update`` does; and a frame whose scene
holds the lights (added live and bound through ``BuiltScene.rebuild``,
the viewer's edit path) passes the check when the configuration names
them and fails it when it leaves them out."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import check, harness, registry, spans as spans_mod
from benchmark.reference import globals as rg
from benchmark.traffic import Traffic

SEED = 2 ** 31 + 555
CPU = torch.device("cpu")
# 2-4 units above terrain that the second frame of the fly mix sees
LIGHTS = {
    "point": [
        {"position": [46.6, 25.2, 13.3], "color": [1.0, 0.6, 0.3],
         "intensity": 40.0},
        {"position": [49.1, 2.3, 26.0], "color": [0.3, 0.7, 1.0],
         "intensity": 60.0},
        {"position": [65.3, 23.8, 13.9], "color": [1.0, 1.0, 1.0],
         "intensity": 25.0}],
    "spot": [
        {"position": [44.6, 24.0, 14.3], "rotation_deg": [10.0, 0.0, 5.0],
         "color": [1.0, 0.9, 0.8], "intensity": 80.0, "cut_off_deg": 30.0,
         "outer_cut_off_deg": 45.0},
        {"position": [16.5, 22.0, 41.1], "rotation_deg": [-10.0, 30.0, 0.0],
         "color": [0.5, 1.0, 0.5], "intensity": 50.0, "cut_off_deg": 25.0,
         "outer_cut_off_deg": 40.0}],
}


def _camera_set(i):
    return rg.camera_matrices(*rg.Orbit([-7.0, 1.8, 0.0], [0.0, 1.5, 0.0])
                              .pose(i, 1 / 60), i, 64, 32)


def _leaves(tree, prefix=""):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), prefix + f.name + ".")
    else:
        yield prefix[:-1], tree


def test_frame_globals_without_lights_is_no_lights():
    """No `lights`: every leaf equals the globals made with no_lights()
    (the only lights the reference had before the key), the light slots
    128 zeros and both counts 0."""
    a, b = _camera_set(12), _camera_set(11)
    plain = dict(_leaves(rg.frame_globals(a, b, 12, 1 / 60, CPU)))
    given = dict(_leaves(rg.frame_globals(a, b, 12, 1 / 60, CPU,
                                          rg.no_lights())))
    assert plain.keys() == given.keys()
    for name, x in plain.items():
        assert x.dtype == given[name].dtype and torch.equal(x, given[name]), \
            name
    assert plain["lights.point_position"].shape == (128, 3)
    assert plain["lights.spot_cut_off"].shape == (128,)
    assert all(not x.any() for n, x in plain.items()
               if n.startswith("lights."))


def _port_scene(spec):
    """The port's Scene holding `spec`'s lights as entities."""
    from soc_real_time_renderer_tpu_torch.scene import components as pc
    from soc_real_time_renderer_tpu_torch.scene.scene import Scene
    scene = Scene("lights")
    add_lights(scene, spec, pc)
    return scene


def add_lights(scene, spec, pc):
    for i, p in enumerate(spec.get("point", [])):
        e = scene.create_entity(f"point {i}")
        e.add_component(pc.TransformComponent()).set_position(p["position"])
        e.add_component(pc.PointLightComponent(
            color=np.asarray(p["color"], np.float32),
            intensity=p["intensity"]))
    for i, s in enumerate(spec.get("spot", [])):
        e = scene.create_entity(f"spot {i}")
        tc = e.add_component(pc.TransformComponent())
        tc.set_position(s["position"])
        tc.set_rotation(s["rotation_deg"])
        e.add_component(pc.SpotLightComponent(
            color=np.asarray(s["color"], np.float32),
            intensity=s["intensity"], cut_off=s["cut_off_deg"],
            outer_cut_off=s["outer_cut_off_deg"]))


def _many(n):
    rng = np.random.default_rng(3)
    return {"point": [{"position": rng.uniform(-9, 9, 3).tolist(),
                       "color": rng.uniform(0, 1, 3).tolist(),
                       "intensity": float(rng.uniform(1, 50))}
                      for _ in range(n)],
            "spot": [{"position": rng.uniform(-9, 9, 3).tolist(),
                      "rotation_deg": rng.uniform(-180, 180, 3).tolist(),
                      "color": rng.uniform(0, 1, 3).tolist(),
                      "intensity": float(rng.uniform(1, 50)),
                      "cut_off_deg": float(rng.uniform(5, 30)),
                      "outer_cut_off_deg": float(rng.uniform(30, 60))}
                     for _ in range(n)]}


@pytest.mark.parametrize("spec", [LIGHTS, {}, _many(130)],
                         ids=["3_point_2_spot", "none", "130_each"])
def test_lights_of_gathers_as_the_port(spec):
    """Leaf for leaf against the port's Scene.update of the same
    components: directions and cosines within 1e-7, the rest exact; past
    128 of a kind the rest are dropped."""
    port = _port_scene(spec).update(1 / 60)
    ref = rg.lights_of(spec)
    for f in dataclasses.fields(ref):
        x = np.asarray(getattr(ref, f.name))
        y = np.asarray(getattr(port, f.name))
        assert x.shape == y.shape and x.dtype == y.dtype, f.name
        if f.name in ("spot_direction", "spot_cut_off",
                      "spot_outer_cut_off"):
            assert np.abs(x.astype(np.float64) - y).max() <= 1e-7, f.name
        else:
            assert np.array_equal(x, y), f.name
    n = min(len(spec.get("point", [])), 128)
    assert int(ref.point_count) == n and int(ref.spot_count) == \
        min(len(spec.get("spot", [])), 128)


@pytest.fixture(scope="module")
def lit_frames(tiny):
    """(configuration with `lights`, BuiltScene, traffic, samples): the
    tiny terrain with LIGHTS added to its scene and bound through
    BuiltScene.rebuild, two frames of its fly traffic, the second
    sampled."""
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.scene import components as pc
    spec, base = tiny
    with open(f"{base}/configs/tiny_terrain.json") as f:
        cfg = json.load(f)
    wl = dict(registry.cell(spec, "tiny.fly"), chips=1)
    dev = harness.prepare(wl, cfg, "cpu")
    built = harness.build_scene(cfg, dev)
    add_lights(built.scene, LIGHTS, pc)
    built.rebuild()
    assert (built.plan.config.max_point_lights,
            built.plan.config.max_spot_lights) == (3, 2)
    sp = spans_mod.Spans()
    sp.install(fm)
    try:
        traffic = Traffic(registry.traffic("fly", base), SEED)
        loop = harness.Loop(built, traffic, sp, harness.Clock(dev))
        frames = [loop.frame(n) for n in range(2)]
    finally:
        sp.uninstall()
    assert loop.raised == 0 and not loop.flags[:2].any()
    g, mm, nm = frames[1][:3]
    samples = [dict(k=1, g=g, mats=(mm, nm),
                    targets=harness.targets_of(*frames[1][3:]))]
    return dict(cfg, lights=LIGHTS), built, traffic, samples


@pytest.mark.parametrize("named", [True, False],
                         ids=["lights_named", "lights_left_out"])
def test_a_lit_frame_is_checked_against_the_configurations_lights(
        lit_frames, named):
    cfg, built, traffic, samples = lit_frames
    if not named:
        cfg = {k: v for k, v in cfg.items() if k != "lights"}
    per_frame, _ = harness.reference_check(cfg, built, traffic, samples,
                                           CPU)
    ok, shown = check.judge(check.worst(per_frame), cfg["check"]["limits"])
    if named:
        assert ok, shown
        assert shown["globals"]["value"] == 0.0
    else:
        assert not ok
        for number in ("globals", "hdr"):
            assert shown[number]["value"] > shown[number]["limit"], shown
