"""The port's interactive viewer on the CPU: ``ui/server.py`` (HTTP
surface and render loop), ``ui/widgets.py``, ``ui/scene_panel.py``,
``utils/metrics.py`` and ``tools/viewer.py``.

* tests/test_viewer_http.py's two tests against the port's server (stub
  render function; the resize test stubs ``frame.make_render_fn``);
* parity: one list of requests sent to the JAX package's server and to
  the port's, both serving the small synthetic tree's ``helmet``; after
  each request ``/schema`` matches (settings within 1e-6, the scene tree
  and components with the uuids set aside, the selection, the fly
  camera's position), and so do the answers and, once the render loops
  have applied the edit, the plans;
* the real ``make_render_fn`` on the reduced terrain at 64x64: frames
  arrive, ``/metrics`` flows, the frame index advances after each
  rebuild tier;
* ``settings_schema``, ``category_totals`` and ``table`` equal to the
  JAX package's; ``GPUMetric.measure``; ``tools/viewer.main``;
* no fallback hides the card: without one, ``start_server`` on a scene
  that lives on CUDA, the viewer CLI and ``GPUMetric.measure`` raise
  unless the caller asked for the CPU; without Pillow ``start_server``
  raises ``ImportError``.

The render thread is a daemon, as in the JAX package; every server here
is stopped and its render thread joined before the test ends.
"""
import contextlib
import dataclasses
import io
import json
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu import scenes as jscenes
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.ui import server as jserver
from soc_real_time_renderer_tpu.ui import widgets as jwidgets
from soc_real_time_renderer_tpu.utils import metrics as jmetrics
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig, \
    ShaderGlobals
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.tools import viewer as pviewer
from soc_real_time_renderer_tpu_torch.ui import server as pserver
from soc_real_time_renderer_tpu_torch.ui import widgets as pwidgets
from soc_real_time_renderer_tpu_torch.utils import metrics as pmetrics

# tests/test_viewer_http.py's configuration
CFG = dict(width=16, height=16, shadow_resolution=16, enable_ssao=False,
           enable_bloom=False, enable_clouds=False, enable_taa=False,
           enable_auto_exposure=False, enable_hiz=False)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return kit.small_tree(tmp_path_factory.mktemp("tree"))


@pytest.fixture
def assets(tree, monkeypatch):
    kit.point_both_at(monkeypatch, tree)
    return tree


def _stub_make_render_fn(plan):
    """A render function that returns a grey frame of the plan's size."""
    h, w = plan.config.height, plan.config.width

    def fn(batch, g, history, mm, nm):
        time.sleep(0.002)            # keep the render thread polite
        return (types.SimpleNamespace(
            color=np.full((3, h, w), 0.5, np.float32)), history)
    return fn


@contextlib.contextmanager
def serving(server_mod, built, render_fn, history):
    """start_server + serve_forever on threads; on exit the render loop
    is stopped and its thread joined, the server shut down."""
    before = set(threading.enumerate())
    server, state, panel = server_mod.start_server(
        built, render_fn, history, port=0, host="127.0.0.1")
    loop = [t for t in threading.enumerate() if t not in before]
    assert len(loop) == 1 and loop[0].daemon       # the render thread
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield base, state, panel
    finally:
        state.stop = True
        server.shutdown()
        server.server_close()
        loop[0].join(timeout=120)
        assert not loop[0].is_alive()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.read()


def _post(base, path, body):
    req = urllib.request.Request(base + path,
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def _wait(cond, seconds, what):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out after {seconds} s: {what}")


def _advanced(state, n=2, seconds=60.0):
    """Wait until the render loop has dispatched n more frames (an edit
    posted before the call is then applied)."""
    f0 = state.frame_index
    _wait(lambda: state.frame_index >= f0 + n, seconds,
          f"frame_index to pass {f0 + n}")


@pytest.fixture()
def viewer(assets):
    built = pscenes.build("helmet", RenderConfig(**CFG), device="cpu",
                          atlas_size=64)
    with serving(pserver, built, _stub_make_render_fn(built.plan),
                 None) as v:
        yield v


def test_viewer_http_roundtrip(viewer):
    base, state, panel = viewer

    # page + schema
    assert b"canvas id=c" in _get(base, "/")
    schema = json.loads(_get(base, "/schema"))
    assert "sun settings" in schema["settings"]
    assert schema["scene"]["roots"]            # the helmet entity

    # fly camera: a forward input moves the camera
    _post(base, "/input", {"dx": 0.0, "dy": 0.0})    # starts the fly camera
    p0 = np.array(state.built._fly.position, np.float32)
    for _ in range(3):
        _post(base, "/input", {"forward": True, "dx": 0.0, "dy": 0.0})
    p1 = np.array(state.built._fly.position, np.float32)
    assert np.linalg.norm(p1 - p0) > 1e-4

    # settings write-through: the override shows in the next schema
    _post(base, "/set", {"section": "ssao settings", "name": "bias",
                         "value": 0.125})
    schema = json.loads(_get(base, "/schema"))
    bias = [p for p in schema["settings"]["ssao settings"]
            if p["name"] == "bias"][0]
    assert abs(bias["value"] - 0.125) < 1e-6

    # scene ops: create -> in the tree; select -> components schema
    n0 = len(schema["scene"]["nodes"])
    _post(base, "/scene", {"op": "create", "name": "http entity"})
    schema = json.loads(_get(base, "/schema"))
    assert len(schema["scene"]["nodes"]) == n0 + 1
    eid = next(int(i) for i, n in schema["scene"]["nodes"].items()
               if n["tag"] == "http entity")
    _post(base, "/scene", {"op": "select", "id": eid})
    schema = json.loads(_get(base, "/schema"))
    assert schema["selected"] == eid
    assert "TagComponent" in schema["components"]

    # stale ids / unknown ops answer 200 with a JSON body
    assert json.loads(_post(base, "/scene", {"op": "destroy",
                                             "id": 999999})) == {}
    _post(base, "/scene", {"op": "add_component", "id": 999999,
                           "type": "MeshComponent"})
    _post(base, "/scene", {"op": "set_property", "id": 999999,
                           "component": "TagComponent", "prop": "tag",
                           "value": "x"})
    _post(base, "/scene", {"op": "no_such_op"})
    assert b"error" in _post(base, "/scene", {"op": "destroy"})
    # ... and the destroy removes the created entity
    _post(base, "/scene", {"op": "destroy", "id": eid})
    schema = json.loads(_get(base, "/schema"))
    assert len(schema["scene"]["nodes"]) == n0
    assert schema["selected"] is None          # selection cleared

    # frames + metrics from the render thread (stub render function)
    _wait(lambda: _get(base, "/frame.jpg").startswith(b"\xff\xd8"), 10.0,
          "a JPEG")
    metrics = json.loads(_get(base, "/metrics"))
    assert metrics["frame"] > 1 and metrics["fps"] > 0
    assert metrics["tex_dirty"] == -1 and metrics["overflow"] == 0


def test_viewer_resize(viewer, monkeypatch):
    """POST /resize: the render loop swaps in a new render function and
    history, and frames arrive at the new size."""
    from PIL import Image
    base, state, panel = viewer
    monkeypatch.setattr(pframe, "make_render_fn", _stub_make_render_fn)

    # invalid sizes answer an error without touching the loop
    assert b"error" in _post(base, "/resize", {"width": 100, "height": 64})
    assert b"error" in _post(base, "/resize", {"width": 64})
    assert state.pending_resize is None

    _post(base, "/resize", {"width": 64, "height": 96})

    def size():
        jpg = _get(base, "/frame.jpg")
        return (Image.open(io.BytesIO(jpg)).size
                if jpg.startswith(b"\xff\xd8") else None)

    _wait(lambda: size() == (64, 96), 15.0, "a 64x96 frame")
    assert state.built.plan.config.width == 64
    assert abs(state.built.camera.aspect - 64.0 / 96.0) < 1e-6
    assert state.history.previous_color.shape == (3, 96, 64)
    assert state.history.previous_color.device.type == "cpu"


# -- the JAX server and the port's, request for request ----------------------

REQUESTS = [
    ("GET", "/schema", None),
    ("POST", "/input", {"dx": 0.0, "dy": 0.0}),
    ("POST", "/input", {"forward": True, "dx": 12.0, "dy": -5.0}),
    ("POST", "/input", {"right": True, "sprint": True, "dx": -40.0,
                        "dy": 900.0}),
    ("POST", "/input", {"left": True, "up": True, "dx": 3.5, "dy": -2000.0}),
    ("POST", "/set", {"section": "ssao settings", "name": "bias",
                      "value": 0.125}),
    ("POST", "/set", {"section": "composition settings", "name": "ambient",
                      "value": [0.2, 0.1, 0.05]}),
    ("POST", "/set", {"section": "sun settings", "name": "intensity",
                      "value": 2.5}),
    ("POST", "/set", {"section": "sun settings", "name": "position",
                      "value": [-3.2, 44.0, -4.0]}),
    ("POST", "/set", {"section": "terrain settings", "name": "height scale",
                      "value": 90.0}),
    ("POST", "/set", {"section": "tone mapping settings", "name": "peak",
                      "value": 1.3}),
    ("POST", "/scene", {"op": "create", "name": "http entity"}),
    ("POST", "/scene", {"op": "select", "id": 2}),
    ("POST", "/scene", {"op": "add_component", "id": 2,
                        "type": "TransformComponent"}),
    ("POST", "/scene", {"op": "set_property", "id": 2,
                        "component": "TransformComponent", "prop": "position",
                        "value": [1.2, 0.0, 0.0]}),
    ("POST", "/scene", {"op": "add_component", "id": 2,
                        "type": "MeshComponent"}),
    ("POST", "/scene", {"op": "add_component", "id": 2,
                        "type": "MeshComponent"}),
    ("POST", "/scene", {"op": "add_component", "id": 2,
                        "type": "PointLightComponent"}),
    ("POST", "/scene", {"op": "set_property", "id": 2,
                        "component": "PointLightComponent",
                        "prop": "intensity", "value": 40.0}),
    ("POST", "/scene", {"op": "set_property", "id": 2,
                        "component": "PointLightComponent", "prop": "color",
                        "value": [1.0, 0.5, 0.25]}),
    ("POST", "/scene", {"op": "set_property", "id": 1,
                        "component": "TransformComponent", "prop": "position",
                        "value": [0.0, 32.0, 0.0]}),
    ("POST", "/scene", {"op": "destroy", "id": 999999}),
    ("POST", "/scene", {"op": "destroy"}),
    ("POST", "/scene", {"op": "no_such_op"}),
    ("POST", "/scene", {"op": "set_property", "id": 999999,
                        "component": "TagComponent", "prop": "tag",
                        "value": "x"}),
    ("POST", "/scene", {"op": "create", "name": "second"}),
    ("POST", "/scene", {"op": "add_component", "id": 3,
                        "type": "SpotLightComponent"}),
    ("POST", "/scene", {"op": "select", "id": 3}),
    ("POST", "/scene", {"op": "destroy", "id": 3}),
    ("POST", "/resize", {"width": 100, "height": 64}),
    ("POST", "/resize", {"width": 64}),
    ("POST", "/resize", {"width": 64, "height": 96}),
    ("POST", "/scene", {"op": "select", "id": 1}),
    ("POST", "/scene", {"op": "destroy", "id": 2}),
]


def _strip_uuids(schema):
    for node in schema["scene"]["nodes"].values():
        node.pop("uuid")
    schema["components"].pop("UUIDComponent", None)
    return schema


def _settings_close(a, b):
    assert a.keys() == b.keys()
    for sec in a:
        assert [p["name"] for p in a[sec]] == [p["name"] for p in b[sec]]
        for pa, pb_ in zip(a[sec], b[sec]):
            assert {k: v for k, v in pa.items() if k != "value"} == \
                {k: v for k, v in pb_.items() if k != "value"}
            np.testing.assert_allclose(pa["value"], pb_["value"], rtol=0,
                                       atol=1e-6, err_msg=pa["name"])


def _settled(state):
    return not (state.needs_rebuild or state.pending_resize
                or state.terrain_dirty)


def test_http_parity_with_the_jax_server(assets, monkeypatch):
    monkeypatch.setattr(jframe, "make_render_fn", _stub_make_render_fn)
    monkeypatch.setattr(pframe, "make_render_fn", _stub_make_render_fn)
    jb = jscenes.build("helmet", jcfg.RenderConfig(**CFG), atlas_size=64)
    pb = pscenes.build("helmet", RenderConfig(**CFG), atlas_size=64,
                       device="cpu")
    with serving(jserver, jb, _stub_make_render_fn(jb.plan), None) as (
            jbase, jstate, _), \
            serving(pserver, pb, _stub_make_render_fn(pb.plan), None) as (
            pbase, pstate, _):
        for method, path, body in REQUESTS:
            if method == "POST":
                ja, pa = _post(jbase, path, body), _post(pbase, path, body)
                assert json.loads(ja) == json.loads(pa), (path, body)
            js = _strip_uuids(json.loads(_get(jbase, "/schema")))
            ps = _strip_uuids(json.loads(_get(pbase, "/schema")))
            _settings_close(js.pop("settings"), ps.pop("settings"))
            assert js == ps, (path, body)
            if hasattr(pstate.built, "_fly"):
                assert (jstate.built._fly.position.tobytes()
                        == pstate.built._fly.position.tobytes())
            for st in (jstate, pstate):
                _wait(lambda: _settled(st), 60.0, "the edit applied")
                _advanced(st)
            assert convert.plan_from_jax_plan(jstate.built.plan) \
                == pstate.built.plan, (path, body)
            assert jstate.built.batch.num_triangles \
                == pstate.built.batch.num_triangles
        # what the sequence did: a second helmet came and went (full
        # tier twice), the first moved into the sun volume under a moved
        # sun, a light came and went, and the window is 64x96
        assert pstate.built.plan.config.width == 64
        assert not pstate.built.plan.shadow_statically_empty
        assert pstate.built.plan.config.max_point_lights == 0
        assert len(pstate.built.scene.mesh_entities()) == 1


def test_real_render_fn_on_the_cpu(assets):
    """The reduced terrain at 64x64 (clouds off, so that a CPU frame is
    a fraction of a second) through the real make_render_fn: JPEGs of
    the right size arrive, /metrics carries every key, and the frame
    index advances after a cheap-tier edit and after a terrain re-bake
    (the full tier)."""
    from PIL import Image
    cfg = RenderConfig(width=64, height=64, shadow_resolution=64,
                       enable_clouds=False)
    built = pscenes.build("terrain", cfg, device="cpu", atlas_size=64)
    eid = built.scene.mesh_entities()[0].eid
    with serving(pserver, built, pframe.make_render_fn(built.plan),
                 pframe.RenderHistory.create(cfg, device="cpu")) as (
            base, state, panel):
        _wait(lambda: _get(base, "/frame.jpg").startswith(b"\xff\xd8"),
              120.0, "the first JPEG")
        jpg = _get(base, "/frame.jpg")
        assert Image.open(io.BytesIO(jpg)).size == (64, 64)
        m = json.loads(_get(base, "/metrics"))
        assert set(m) == {"frame_ms", "latency_ms", "fps", "frame",
                          "overflow", "tex_dirty", "pass_ms",
                          "category_ms", "device_idle_ms"}
        assert m["overflow"] == 0 and m["tex_dirty"] == -1
        # the device clock reads no frame on the CPU: no pass times
        assert m["pass_ms"] == m["category_ms"] == {}
        assert m["device_idle_ms"] is None
        assert m["frame_ms"] > 0 and m["latency_ms"] > 0

        batch0 = state.built.batch
        _post(base, "/scene", {"op": "set_property", "id": eid,
                               "component": "TransformComponent",
                               "prop": "position", "value": [0.0, -2.0, 0.0]})
        _wait(lambda: _settled(state), 60.0, "the cheap tier")
        _advanced(state)
        assert state.built.batch is batch0
        _post(base, "/set", {"section": "terrain settings",
                             "name": "height scale", "value": 90.0})
        _wait(lambda: state.built.batch is not batch0, 60.0,
              "the re-baked terrain's batch")
        _advanced(state)
        _post(base, "/input", {"forward": True, "dx": 5.0})
        _advanced(state)
        assert json.loads(_get(base, "/metrics"))["frame"] > m["frame"]


# -- widgets, metrics, the CLI -----------------------------------------------

def test_settings_schema_matches(assets):
    """settings_schema of the same globals, with the same overrides
    applied by each package's _apply_overrides, is equal."""
    jb = jscenes.build("helmet", jcfg.RenderConfig(**CFG), atlas_size=64)
    pb = pscenes.build("helmet", RenderConfig(**CFG), atlas_size=64,
                       device="cpu")
    over = {("ssao settings", "radius"): 0.7,
            ("composition settings", "ambient"): [0.3, 0.2, 0.1],
            ("terrain settings", "scale"): [80.0, 60.0],
            ("sun settings", "bias"): 0.002,
            ("sun settings", "position"): [1.0, 2.0, 3.0]}
    jg = jserver._apply_overrides(jb.frame_globals(2, peek=True)[0], over)
    pg = pserver._apply_overrides(pb.frame_globals(2, peek=True)[0], over)
    assert pwidgets.settings_schema(pg) == jwidgets.settings_schema(jg)
    assert pg.ssao_radius.dtype == torch.float32
    assert pg.ambient.shape == (3,)
    again = pserver._apply_overrides(pb.frame_globals(2, peek=True)[0], over)
    assert again.ambient is pg.ambient      # one upload per value
    d = pwidgets.settings_schema(ShaderGlobals.create())
    assert d == jwidgets.settings_schema(jcfg.ShaderGlobals.create())


def test_metrics_pool_matches():
    names = {"depth prepass": 1.25, "shadow map": 3.5, "g-buffer": 0.75,
             "bloom": 2.0, "ssao blur": 0.5, "ssr": 4.0, "clouds": 1.0,
             "composition": 0.25, "luminance": 0.125, "taa": 0.5,
             "tonemap": 0.0625, "something else": 7.0}
    jp, pp = jmetrics.GPUMetricPool(), pmetrics.GPUMetricPool()
    for name, ms in names.items():
        jp.get(name).time_elapsed = ms
        pp.get(name).time_elapsed = ms
    assert pp.category_totals() == jp.category_totals()
    assert pp.table() == jp.table()
    assert pp.CATEGORIES == jp.CATEGORIES
    assert pp.get("ssr") is pp.get("ssr")


def test_metrics_pass_times_group_the_device_clocks_frame(monkeypatch):
    """/metrics' HUD keys: the newest frame's pass ms as the device clock
    read them, summed into the reference's categories, and its idle ms;
    empty where the clock read no frame."""
    from soc_real_time_renderer_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "last_frame", lambda: None)
    assert pserver.pass_times() == {"pass_ms": {}, "category_ms": {},
                                    "device_idle_ms": None}
    passes = {"raster.main": 1.5, "raster.records": 0.25,
              "raster.shadow": 1.25, "shade.gbuffer": 0.125,
              "shade.bloom": 2.5, "shade.sky_lut": 0.125,
              "shade.clouds": 1.0, "shade.compose": 0.875,
              "shade.exposure": 1.0, "shade.taa": 0.125,
              "replay.copy": 0.25}
    monkeypatch.setattr(trace, "last_frame", lambda: {
        "ms": 12.0, "idle_ms": 0.5, "passes": passes})
    got = pserver.pass_times()
    assert got["pass_ms"] == passes and got["device_idle_ms"] == 0.5
    assert got["category_ms"] == {
        "Geometry": 1.875, "Shadows": 1.25, "Bloom": 2.5, "Sky": 1.125,
        "Lighting": 0.875, "Exposure": 1.0, "AntiAliasing": 0.125,
        "Other": 0.25}


def test_gpu_metric_measure_on_the_cpu():
    calls = []
    m = pmetrics.GPUMetric("taa")
    ms = m.measure(lambda x: calls.append(x), 3, iters=4, device="cpu")
    assert calls == [3] * 5                  # one warm call + 4
    assert ms >= 0.0 and m.time_elapsed == ms
    t, v = m.history.as_arrays()
    assert len(t) == len(v) == 1 and v[0] == ms
    b = pmetrics.ScrollingBuffer(capacity=2)
    for i in range(3):
        b.add_point(i, i * 2.0)
    assert b.as_arrays()[1].tolist() == [2.0, 4.0]
    b.erase()
    assert b.as_arrays()[0].size == 0


def test_viewer_cli_hands_over_plan_config_device(assets, monkeypatch):
    got = {}

    def serve(built, render_fn, history, port=8000):
        got.update(built=built, render_fn=render_fn, history=history,
                   port=port)

    monkeypatch.setattr(pserver, "serve", serve)
    pviewer.main(["--scene", "helmet", "--width", "64", "--height", "32",
                  "--port", "8123", "--device", "cpu"])
    b = got["built"]
    assert got["port"] == 8123 and b.device == torch.device("cpu")
    cfg = b.plan.config
    assert (cfg.width, cfg.height, cfg.shadow_resolution) == (64, 32, 1024)
    assert got["history"].previous_color.shape == (3, 32, 64)
    assert got["history"].previous_color.device.type == "cpu"
    assert b.plan == pscenes.build("helmet", RenderConfig(
        width=64, height=32, shadow_resolution=1024), device="cpu").plan
    assert callable(got["render_fn"])
    with pytest.raises(SystemExit):
        pviewer.parse_args(["--scene", "nope"])
    assert pviewer.parse_args([]).scene == "helmet"


def test_no_fallback_hides_the_card(assets, monkeypatch):
    """Without a card: the viewer CLI and GPUMetric.measure raise unless
    the CPU was asked for; start_server raises on a scene that lives on
    CUDA; without Pillow start_server raises ImportError naming it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pserver, "serve", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pviewer.main(["--scene", "helmet", "--width", "64",
                      "--height", "32"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmetrics.GPUMetric("x").measure(lambda: None)
    built = pscenes.build("helmet", RenderConfig(**CFG), device="cpu",
                          atlas_size=64)
    on_card = dataclasses.replace(built, device=torch.device("cuda", 0))
    n = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA"):
        pserver.start_server(on_card, _stub_make_render_fn(built.plan), None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="Pillow"):
        pserver.start_server(built, _stub_make_render_fn(built.plan), None)
    assert threading.active_count() == n     # no render thread was started
