"""``utils/trace``: the port's spans per pass and its copy counters.

A span keeps host totals always and makes a profiler event only while a
profiler records; a CPU frame of a small preset runs every span of the
passes it runs; ``config.tree_to`` counts only the host leaves that
cross to a device, and a frame's globals cross in one span; a lit
frame counts its local lights' pairs and pixels.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from soc_real_time_renderer_tpu_torch import config as pconfig
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.camera import InputState
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as fm
from soc_real_time_renderer_tpu_torch.kernels import build as kb
from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
from soc_real_time_renderer_tpu_torch.utils import trace

import torch_scene_kit as kit

HOST = {"scene.apply_input", "scene.frame_globals", "globals.camera",
        "globals.lights", "globals.upload"}
FRAME = {"frame.render", "frame.proofs", "frame.raster", "raster.transform",
         "raster.main", "raster.records", "frame.shade", "shade.hiz",
         "shade.gbuffer", "shade.bloom", "shade.ssao", "shade.ssr",
         "shade.sky_lut", "shade.clouds", "shade.compose", "shade.exposure",
         "shade.taa", "shade.tonemap", "shade.history"}
BUILD = {"scenes.build", "scenes.models", "scenes.pack", "scenes.noise",
         "scenes.prove"}


def _cfg(**kw):
    return RenderConfig(width=64, height=32, shadow_resolution=256, **kw)


@pytest.fixture(scope="module")
def terrain(tmp_path_factory):
    """The terrain preset from the small asset tree (its cloud noise)
    and the reduced terrain, built on the CPU with totals from zero."""
    tree = kit.small_tree(tmp_path_factory.mktemp("assets"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pscenes, "ASSETS", tree)
        mp.setattr(pscenes, "_terrain_model",
                   lambda **kw: kit.small_terrain("port", **kw))
        trace.reset()
        built = pscenes.build("terrain", _cfg(), device="cpu")
        return built, trace.snapshot()


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


def _frame(built, k=1):
    """One frame under a CPU profiler: (the soc: events' names, the
    outputs)."""
    history = fm.RenderHistory.create(built.plan.config, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        built.apply_input(InputState(cursor_dx=2.0), 1 / 60)
        g, mm, nm = built.frame_globals(k)
        out, _ = fm.render_frame(built.plan, built.batch, g, history, mm,
                                 nm)
    names = [e.name for e in prof.events()
             if e.name.startswith(trace.PREFIX)]
    return [n[len(trace.PREFIX):] for n in names], out


def test_span_enters_no_profiler_event_while_none_records(monkeypatch):
    made = []
    monkeypatch.setattr(trace, "_Event", lambda *a: made.append(a))
    assert not torch._C._autograd._profiler_enabled()
    for _ in range(3):
        with trace.span("outer"):
            with trace.span("inner"):
                pass
    assert made == []
    tot = trace.snapshot()["totals"]
    assert tot["outer"]["calls"] == tot["inner"]["calls"] == 3
    assert tot["outer"]["host_s"] >= tot["inner"]["host_s"] > 0
    assert trace.profiled() is None


def test_span_under_a_profiler_makes_nested_function_scope_events():
    with trace.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).add_(1)
    ev = {e.name: e for e in prof.events()}
    outer, inner = ev["soc:outer"], ev["soc:inner"]
    assert inner.cpu_parent is outer
    assert any(c.name == "aten::add_" for c in inner.cpu_children)
    # FUNCTION scope, not a user annotation: the profiler mirrors a user
    # annotation on the device line, where it would read as device work
    for e in (outer, inner):
        assert not e.is_user_annotation and e.scope == 0
    assert "soc:before" not in ev
    tot = trace.snapshot()["totals"]
    assert {n: tot[n]["calls"] for n in ("before", "outer", "inner")} \
        == {"before": 1, "outer": 1, "inner": 1}


def test_profiled_holds_the_latest_recorded_stretch():
    with trace.span("untraced"):
        trace.counters["h2d_copies"] += 5
    for copies in (3, 2):
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(copies):
                with trace.span("traced"):
                    trace.counters["h2d_copies"] += 1
                    kb.launches["taa_reproject"] += 1
        p = trace.profiled()               # open until a span sees the stop
        assert p["totals"]["traced"]["calls"] == copies
        assert p["counters"] == {"h2d_copies": copies}
        assert p["launches"] == {"taa_reproject": copies}
        with trace.span("untraced"):
            trace.counters["h2d_copies"] += 7
        p = trace.profiled()
        assert set(p["totals"]) == {"traced"}
        assert p["counters"] == {"h2d_copies": copies}
    kb.reset_launches()
    snap = trace.snapshot()
    assert snap["counters"]["h2d_copies"] == 5 + 5 + 14
    assert snap["totals"]["untraced"]["calls"] == 3
    assert set(snap) == {"totals", "counters", "launches"}
    trace.reset()
    assert trace.snapshot()["totals"] == {} and trace.profiled() is None


@pytest.mark.parametrize("case", ["terrain", "lifted_dof", "sharded"])
def test_a_cpu_frame_runs_every_span_of_its_passes(terrain, case):
    built, build_totals = terrain
    want = HOST | FRAME
    if case == "lifted_dof":
        built = kit.build_port("atrium_lifted",
                               _cfg(enable_depth_of_field=True), "cpu")
        assert not built.plan.shadow_statically_empty
        want = want | {"raster.shadow", "shadow.setup", "shadow.resolve",
                       "shade.dof"}
    elif case == "sharded":
        built = dataclasses.replace(built)
        built.plan = dataclasses.replace(
            built.plan, shard_mesh=pmesh.make_mesh(2, dp=1,
                                                   devices=["cpu"] * 2),
            shard_axis="sp")
        want = want | {"shade.bands"}
    else:
        assert set(build_totals["totals"]) == BUILD
        assert all(v["calls"] == 1 for v in build_totals["totals"].values())
    names, out = _frame(built)
    assert set(names) == want
    assert len(names) == len(want)                 # each once a frame
    assert torch.isfinite(torch.as_tensor(
        out.color if case != "sharded" else out.color[0])).all()
    p = trace.profiled()["totals"]
    assert set(p) == want
    # the stages hold their passes
    for stage, prefix in (("frame.raster", "raster."),
                          ("frame.shade", "shade.")):
        inner = sum(v["host_s"] for n, v in p.items()
                    if n.startswith(prefix))
        assert inner <= p[stage]["host_s"] <= p["frame.render"]["host_s"]


@pytest.mark.parametrize("lit", [True, False], ids=["lit", "lightless"])
def test_a_cpu_frame_counts_its_light_pairs(lit):
    """One CPU frame of the kit's reduced atrium and terrain, with the
    full_lit preset's 256 lights added and bound (BuiltScene.rebuild):
    ``light_pairs`` = 256 x H x W, ``spot_light_pairs`` = 128 x H x W and
    ``light_pixels`` = H x W, inside the span ``compose.lights`` entered
    once.  Without lights it counts none of them and enters no such
    span."""
    built = kit.build_port("full_nohelmet", _cfg(), "cpu")
    if lit:
        pscenes.add_lights(built.scene, pscenes.full_lit_lights())
        built.rebuild()
    cfg = built.plan.config
    assert (cfg.max_point_lights, cfg.max_spot_lights) == (
        (128, 128) if lit else (0, 0))
    names, out = _frame(built)
    counters = trace.profiled()["counters"]
    assert torch.isfinite(out.color).all()
    if lit:
        assert counters["light_pairs"] == 256 * 32 * 64
        assert counters["spot_light_pairs"] == 128 * 32 * 64
        assert counters["light_pixels"] == 32 * 64
        assert names.count("compose.lights") == 1
    else:
        assert "light_pairs" not in counters
        assert "spot_light_pairs" not in counters
        assert "light_pixels" not in counters
        assert "compose.lights" not in names


def test_a_cpu_frame_copies_nothing_across(terrain):
    built, _ = terrain
    _frame(built)
    assert trace.profiled()["counters"] == {}
    assert not any(k.startswith(("h2d", "d2h"))
                   for k in trace.snapshot()["counters"])


@pytest.mark.parametrize("target, crossing", [
    ("meta", 3), (torch.device("meta"), 3), ("cpu", 0)])
def test_tree_to_counts_the_host_leaves_that_cross(target, crossing):
    on = torch.device(target)
    tree = pconfig.SunInfo(
        projection=np.eye(4, dtype=np.float32),
        view=torch.eye(4),                               # a CPU tensor
        projection_view=torch.eye(4, device=on),         # already there
        terrain_y_clip_trick=None, position=np.zeros(3, np.float32),
        direction=torch.zeros(3, device=on),
        exponential_factor=None, darkening_factor=None, bias=None,
        intensity=None)
    out = pconfig.tree_to(tree, target)
    assert {getattr(out, f).device.type for f in (
        "projection", "view", "projection_view", "position",
        "direction")} == {on.type}
    c = trace.snapshot()["counters"]
    assert c.get("h2d_copies", 0) == crossing
    assert c.get("h2d_bytes", 0) == (64 + 64 + 12 if crossing else 0)


def test_frame_globals_uploads_every_leaf_inside_globals_upload(
        terrain, monkeypatch):
    """On a device (meta here), a frame's globals and its two matrices
    cross in one packed copy, inside the span globals.upload."""
    built, _ = terrain
    built = dataclasses.replace(built, device=torch.device("meta"))
    open_spans, at = [], []
    enter, exit_ = trace.span.__enter__, trace.span.__exit__

    def entering(self):
        open_spans.append(self.name)
        return enter(self)

    def exiting(self, *exc):
        open_spans.pop()
        return exit_(self, *exc)

    count = trace.count_h2d
    monkeypatch.setattr(trace.span, "__enter__", entering)
    monkeypatch.setattr(trace.span, "__exit__", exiting)
    monkeypatch.setattr(trace, "count_h2d",
                        lambda t: (at.append(open_spans[-1]), count(t)))
    for k in (1, 2):
        g, mm, nm = built.frame_globals(k)
    assert g.camera.view.device.type == "meta" and mm.device.type == "meta"
    assert trace.snapshot()["counters"]["h2d_copies"] == 2 * 1
    assert set(at) == {"globals.upload"}


def test_unprofiled_holds_the_latest_stretch_without_a_profiler():
    with trace.span("setup"):
        trace.counters["h2d_copies"] += 5
    u = trace.unprofiled()                 # open until a span sees a start
    assert u["totals"]["setup"]["calls"] == 1
    assert u["counters"] == {"h2d_copies": 5}
    for frames in (3, 2):
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("traced"):
                trace.counters["h2d_copies"] += 1
        u = trace.unprofiled()             # the stretch before: closed
        assert "traced" not in u["totals"]
        for _ in range(frames):
            with trace.span("untraced"):
                trace.counters["h2d_copies"] += 7
                kb.launches["taa_reproject"] += 1
        u = trace.unprofiled()
        assert set(u["totals"]) == {"untraced"}
        assert u["totals"]["untraced"]["calls"] == frames
        assert u["counters"] == {"h2d_copies": 7 * frames}
        assert u["launches"] == {"taa_reproject": frames}
        assert trace.profiled()["totals"]["traced"]["calls"] == 1
    kb.reset_launches()
    trace.reset()
    assert trace.unprofiled() is None and trace.profiled() is None


class _Card:
    """A stand-in for one card's stream and timing events: an event takes
    the card time `t` when it is recorded, and has completed once `done`
    reaches it.  `made` counts the events created."""

    def __init__(self):
        self.t, self.done, self.made = 0.0, float("inf"), 0
        self.device_index = 0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                card.made += 1

            def record(self, stream):
                assert stream is card
                self.at = card.t

            def query(self):
                return self.at <= card.done

            def elapsed_time(self, end):
                # the clock reads completed events only
                assert self.query() and end.query()
                return end.at - self.at
        self.Event = Event


@pytest.fixture
def card(monkeypatch):
    c = _Card()
    monkeypatch.setattr(torch.cuda, "Event", c.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: c)
    return c


CUDA = torch.device("cuda")


def _clocked_frame(card, host_gap=2.0, pass_ms=3.0):
    """One frame on the stand-in card, in card ms: the caller's `host_gap`
    with an upload (no bracket), then frame.render: 0.2 idle, a read from
    the card (no work), a pass of `pass_ms` with a nested span inside,
    0.5 idle, a seam's copy of 0.25, a pass of 4.0, 0.1 idle."""
    card.t += host_gap
    with trace.span("scene.frame_globals"):
        with trace.span("globals.upload"):
            card.t += 0.1
    with trace.span("frame.render", CUDA):
        card.t += 0.2
        with trace.bracket("read_back"):
            pass
        with trace.span("raster.main", trace.NESTED):
            with trace.span("shadow.setup", trace.NESTED):
                card.t += pass_ms
        card.t += 0.5
        with trace.bracket("replay.copy"):
            card.t += 0.25
        with trace.span("shade.taa", trace.NESTED):
            card.t += 4.0
        card.t += 0.1


def test_the_device_clock_reads_each_frames_passes(card):
    for _ in range(60):
        _clocked_frame(card)
    made = card.made
    for k in range(60):
        _clocked_frame(card, pass_ms=3.0 + k)
    assert card.made == made <= 24         # events come from a pool
    f = trace.last_frame()
    assert f["passes"] == pytest.approx({"read_back": 0.0, "replay.copy": 0.25,
                                         "raster.main": 62.0,
                                         "shade.taa": 4.0})
    assert f["ms"] == pytest.approx(67.05)
    assert f["idle_ms"] == pytest.approx(0.8)
    # host totals as ever; a bracket keeps none
    u = trace.unprofiled()["totals"]
    assert u["shadow.setup"]["calls"] == u["frame.render"]["calls"] == 120
    assert "replay.copy" not in u and "read_back" not in u
    assert trace.profiled() is None


def test_the_device_clock_never_reads_an_unfinished_event(card):
    for k in range(3):
        _clocked_frame(card, pass_ms=1.0 + k)
    card.done = card.t - 4.2               # inside the last frame
    assert trace.last_frame()["passes"]["raster.main"] == pytest.approx(2.0)
    card.done = float("inf")
    assert trace.last_frame()["passes"]["raster.main"] == pytest.approx(3.0)
    # a frame read once a later one has completed, without a call between
    for k in range(2):
        _clocked_frame(card, pass_ms=7.0 + k)
    assert trace.last_frame()["passes"]["raster.main"] == pytest.approx(8.0)


def test_the_device_clock_rests_while_a_profiler_records(card):
    """The profiler times the device itself: under it no span records an
    event, and the newest frame read stays the one before it."""
    _clocked_frame(card, pass_ms=5.0)
    made = card.made
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            _clocked_frame(card, pass_ms=9.0)
    assert card.made == made
    assert trace.last_frame()["passes"]["raster.main"] == pytest.approx(5.0)
    assert trace.profiled()["totals"]["raster.main"]["calls"] == 3
    _clocked_frame(card, pass_ms=6.0)
    assert trace.last_frame()["passes"]["raster.main"] == pytest.approx(6.0)


def test_the_device_clock_records_nothing_off_a_card(card):
    """No bracket on the CPU or a meta device, for a nested span or a
    bracket with no frame open around it, or on another thread while a
    frame is open."""
    import threading
    for dev in (torch.device("cpu"), torch.device("meta"), None):
        with trace.span("frame.render", dev):
            with trace.span("shade.taa", trace.NESTED):
                pass
    with trace.span("shade.taa", trace.NESTED), trace.bracket("replay.copy"):
        pass
    assert card.made == 0 and trace.last_frame() is None
    seen = []

    def other():
        with trace.span("frame.render", CUDA):
            with trace.span("raster.main", trace.NESTED):
                seen.append(trace._frame)
    with trace.span("frame.render", CUDA):
        t = threading.Thread(target=other)
        t.start()
        t.join(10)
        assert not t.is_alive() and len(seen) == 1
    assert card.made == 2
    assert trace.last_frame()["passes"] == {}


def test_the_device_clock_reads_from_another_thread(card):
    """The viewer's render thread runs the frames while HTTP threads run
    spans and read the clock, more threads than cores, switching often:
    each frame read is whole (a lost update or an event shared by two
    brackets would change its numbers), and no thread raises."""
    import os
    import sys
    import threading
    import time
    stop, errors, read = threading.Event(), [], []

    def reader(opens):
        try:
            while not stop.is_set():
                with trace.span("frame.render", CUDA if opens else None):
                    with trace.span("shade.taa", trace.NESTED):
                        with trace.bracket("read_back"):
                            pass
                f = trace.last_frame()
                if f is not None:
                    read.append(f)
                time.sleep(1e-3 if opens else 0)
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=reader, args=(k == 0,))
               for k in range((os.cpu_count() or 1) + 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for k in range(200):
            _clocked_frame(card, pass_ms=1.0 + k % 7)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and read
    mine = 0
    for f in read + [trace.last_frame()]:
        passes = f["passes"]
        if set(passes) == {"shade.taa"}:    # a reader's own frame
            continue
        mine += 1
        assert f["idle_ms"] == pytest.approx(0.8)
        assert f["ms"] == pytest.approx(sum(passes.values()) + 0.8)
        assert min(abs(passes["raster.main"] - 1.0 - k)
                   for k in range(7)) < 1e-6
    assert mine


def test_a_cpu_frame_records_no_event(terrain, card):
    built, _ = terrain
    history = fm.RenderHistory.create(built.plan.config, device="cpu")
    g, mm, nm = built.frame_globals(1)
    render = fm.make_render_fn(built.plan)
    for _ in range(2):
        out, history = render(built.batch, g, history, mm, nm)
    assert torch.isfinite(out.color).all()
    assert trace.unprofiled()["totals"]["frame.render"]["calls"] == 2
    assert card.made == 0 and trace.last_frame() is None
