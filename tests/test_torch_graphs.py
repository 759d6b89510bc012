"""The frame replayed as CUDA graphs (``graph/replay.py``) through
``graph/frame.make_render_fn``.

On the CPU (tier-1): the render function stays eager there, with
``impl="plain"`` and with a row split, and equals ``render_frame`` bit
for bit; ``engages`` and ``capture_key`` decide from what they observe;
and with a stand-in for the CUDA graph API (a capture that runs its
pass, a replay that does nothing) the seams capture their passes once,
in frame order, hand back copies and count what they replay.

On the card (marker ``cuda``, skipped without one; this file imports no
jax): ``full``, ``terrain``, ``sponza_lifted``, ``full_lit`` and
``full_ssr`` (K8 replayed) from a small synthetic
tree, each on the benchmark's traffic for it, through the render
function against ``render_frame`` at max abs 0, with the counters; a
frame's returned tensors and the seams' returns (``tri_id``, the sky
LUT), and a side-stream copy of them, unchanged by later replays; and a
new scene batch or size capturing again:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py -q
"""
import contextlib
import dataclasses
import gc
import inspect

import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu_torch import scenes
from soc_real_time_renderer_tpu_torch.camera import InputState
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as fm
from soc_real_time_renderer_tpu_torch.graph import replay
from soc_real_time_renderer_tpu_torch.kernels import build as kb
from soc_real_time_renderer_tpu_torch.ops import sky as sky_ops
from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
from soc_real_time_renderer_tpu_torch.utils import trace

SEAMS = ("raster_stage", "shade_stage", "_sky_lut")
RASTER = ["raster.transform", "raster.main", "raster.records"]
SHADE = ["shade.hiz", "shade.gbuffer", "shade.bloom", "shade.ssao",
         "shade.ssr", "shade.clouds", "shade.compose", "shade.exposure",
         "shade.taa", "shade.tonemap", "shade.history"]
COUNTERS = ("graph_captures", "graph_replays")


def _equal(a, b):
    """Every tensor of two output trees equal, bit for bit."""
    ta, tb = replay._leaves(a), replay._leaves(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def _graph_counts():
    return {k: trace.counters.get(k, 0) for k in COUNTERS}


def _warm_capture_replay(per_frame, n):
    """per_frame: (captures, replays) of each frame: eager frames (at
    least one, the warm-up), one frame that captures and replays the `n`
    segments, then frames that replay them (at least one)."""
    at = next(i for i, c in enumerate(per_frame) if c != (0, 0))
    assert at >= 1 and per_frame[:at] == [(0, 0)] * at, per_frame
    rest = len(per_frame) - at - 1
    assert rest >= 1 and per_frame[at:] == [(n, n)] + [(0, n)] * rest, \
        per_frame


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


# --- the CPU ----------------------------------------------------------------

@pytest.fixture(scope="module")
def atrium():
    """The kit's coarse atrium (1,424 triangles) at 32x32, no shadow view
    and no clouds: a frame in ~0.1 s on the CPU, after a first one here
    (PyTorch's own first-call costs)."""
    built = kit.build_port("atrium_lifted", RenderConfig(
        width=32, height=32, shadow_resolution=128, enable_shadows=False,
        enable_clouds=False), "cpu")
    g, mm, nm = built.frame_globals(0)
    fm.render_frame(built.plan, built.batch, g, fm.RenderHistory.create(
        built.plan.config, device="cpu"), mm, nm)
    return built


@pytest.mark.parametrize("case", ["cpu", "plain", "split"])
def test_render_fn_stays_eager(atrium, case):
    """On the CPU, with impl="plain" and with a split plan the render
    function captures nothing and equals render_frame bit for bit."""
    plan, impl = atrium.plan, ("plain" if case == "plain" else None)
    if case == "split":
        plan = dataclasses.replace(plan, shard_axis="sp", shard_mesh=(
            pmesh.make_mesh(2, dp=1, devices=["cpu"] * 2)))
    render = fm.make_render_fn(plan, impl)
    hr = he = fm.RenderHistory.create(plan.config, device="cpu")
    for f in range(2):
        g, mm, nm = atrium.frame_globals(f)
        out_r, hr = render(atrium.batch, g, hr, mm, nm)
        out_e, he = fm.render_frame(plan, atrium.batch, g, he, mm, nm,
                                    impl=impl)
        _equal((out_r, hr), (out_e, he))
    assert _graph_counts() == dict.fromkeys(COUNTERS, 0)


def test_engages_decides_from_what_it_observes(atrium):
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    split = dataclasses.replace(atrium.plan, shard_axis="sp", shard_mesh=(
        pmesh.make_mesh(2, dp=1, devices=["cpu"] * 2)))
    assert replay.engages(atrium.plan, None, {cuda})
    assert replay.engages(atrium.plan, "cuda", {cuda})
    assert not replay.engages(atrium.plan, "plain", {cuda})
    assert not replay.engages(atrium.plan, None, {cpu})
    assert not replay.engages(atrium.plan, None, {cuda, cpu})
    assert not replay.engages(atrium.plan, None,
                              {cuda, torch.device("cuda", 1)})
    assert not replay.engages(atrium.plan, None, set())
    assert not replay.engages(split, None, {cuda})


def test_capture_key(atrium, monkeypatch):
    """The key keeps the plan, impl, the device, each input's shape and
    dtype and which inputs are one object, and the scene batch's
    addresses; not the inputs' values.  None where the frame stays
    eager."""
    plan, batch = atrium.plan, atrium.batch
    h = fm.RenderHistory.create(plan.config, device="cpu")
    g, mm, nm = atrium.frame_globals(1)
    assert replay.capture_key(plan, None, batch, (g, h, mm, nm)) is None
    monkeypatch.setattr(replay, "engages", lambda *a: True)
    key = replay.capture_key(plan, None, batch, (g, h, mm, nm))
    g2, mm2, nm2 = atrium.frame_globals(2)
    h2 = dataclasses.replace(h, exposure=h.exposure + 1)
    assert replay.capture_key(plan, None, batch, (g2, h2, mm2, nm2)) == key
    other_plan = dataclasses.replace(plan)
    bigger = fm.RenderHistory.create(dataclasses.replace(
        plan.config, width=64), device="cpu")
    moved = dataclasses.replace(batch, tri_uv=batch.tri_uv.clone())
    aliased = dataclasses.replace(g, camera_prev=g.camera)
    as_f64 = dataclasses.replace(h, exposure=h.exposure.double())
    for changed in [
            (other_plan, None, batch, (g, h, mm, nm)),
            (plan, "cuda", batch, (g, h, mm, nm)),
            (plan, None, batch, (g, bigger, mm, nm)),
            (plan, None, batch, (g, as_f64, mm, nm)),
            (plan, None, moved, (g, h, mm, nm)),
            (plan, None, batch, (aliased, h, mm, nm))]:
        assert replay.capture_key(*changed) != key


class _StandInGraph:
    """torch.cuda.CUDAGraph's part that replay.py uses: the capture runs
    the pass as it is written, the replay does nothing."""
    captured = 0
    replayed = 0

    def capture_begin(self, pool=None, capture_error_mode="global"):
        pass

    def capture_end(self):
        _StandInGraph.captured += 1

    def replay(self):
        _StandInGraph.replayed += 1


class _StandInStream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


def test_seams_under_stand_in_graphs(atrium, monkeypatch):
    """With the CUDA graph API stood in for on the CPU: the first frame
    runs eagerly (and a scene's very first, whose globals share one
    camera as camera and camera_prev, has a key of its own), the next
    captures each pass once in frame order, and every frame runs the
    seams' wrappers once and each pass's span once, reads each seam's
    inputs in place and hands back tensors that are none of the graphs'
    static ones, and makes no reference cycle."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _StandInStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _StandInStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(replay, "engages", lambda plan, impl, devices:
                        impl is None and fm._shard(plan) is None)
    # the clouds on, with a LUT that costs nothing to make
    monkeypatch.setattr(sky_ops, "render_sky_lut_noise",
                        lambda g, noise, impl=None:
                        torch.ones(3, 128, 256) * g.elapsed_time)
    plan = dataclasses.replace(atrium.plan, config=dataclasses.replace(
        atrium.plan.config, enable_clouds=True))
    calls = []
    for attr in SEAMS:
        real = getattr(fm, attr)

        def wrapped(*a, _real=real, _attr=attr, **kw):
            calls.append(_attr)
            return _real(*a, **kw)
        monkeypatch.setattr(fm, attr, wrapped)
    render = fm.make_render_fn(plan)
    graphs = inspect.getclosurevars(render).nonlocals["graphs"]
    _StandInGraph.captured = _StandInGraph.replayed = 0
    segments = RASTER + SHADE[:5] + ["shade.sky_lut"] + SHADE[5:]
    h = fm.RenderHistory.create(plan.config, device="cpu")
    per_frame = []
    for f in range(4):
        g, mm, nm = atrium.frame_globals(f)
        calls.clear()
        before = {n: t["calls"] for n, t in trace.snapshot()["totals"].items()}
        counts = _graph_counts()
        out, h = render(atrium.batch, g, h, mm, nm)
        after = trace.snapshot()["totals"]
        assert calls == ["raster_stage", "shade_stage", "_sky_lut"]
        assert all(after[n]["calls"] - before.get(n, 0) == 1
                   for n in segments)
        per_frame.append(tuple(trace.counters[k] - counts[k]
                               for k in COUNTERS))
        if not graphs.stages:
            continue
        statics = {id(t) for st in graphs.stages.values()
                   for t in replay._leaves(st.out) + st.slots}
        statics |= {id(t) for t in graphs.inputs}
        assert not {id(t) for t in replay._leaves((out, h))} & statics
    _warm_capture_replay(per_frame, len(segments))
    # each seam reads its inputs where the frame's inputs or another
    # seam's outputs lie: nothing is a copy of a static tensor
    outputs = {id(t) for st in graphs.stages.values()
               for t in replay._leaves(st.out)}
    assert {id(s) for st in graphs.stages.values() for s in st.slots} \
        <= outputs | {id(t) for t in graphs.inputs}
    order = [i.name if isinstance(i, replay._Segment) else i.seam
             for seam in SEAMS for i in graphs.stages[seam].items]
    assert order == (RASTER + SHADE[:5] + ["_sky_lut"] + SHADE[5:]
                     + ["shade.sky_lut"])
    assert _StandInGraph.captured == len(segments)
    assert _StandInGraph.replayed == sum(r for _, r in per_frame)
    # a replayed frame makes no reference cycle: what it hands back is
    # freed when the caller drops it, not when the collector runs
    gc.collect()
    gc.disable()
    try:
        g, mm, nm = atrium.frame_globals(4)
        out, h = render(atrium.batch, g, h, mm, nm)
        del out
        assert gc.collect() == 0
    finally:
        gc.enable()


# --- the card ---------------------------------------------------------------

PRESETS = {"full": ("orbit", {}), "terrain": ("fly", {}),
           "sponza_lifted": ("orbit", {"shadow_resolution": 1024}),
           "full_lit": ("orbit", {}),
           "full_ssr": ("orbit", {"enable_ssr": True,
                                  "composite_ssr": True})}
SEED = 2 ** 31 + 1717
DT = 1.0 / 60.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from soc_real_time_renderer_tpu_torch.tools import synth_assets
    root = str(tmp_path_factory.mktemp("assets"))
    synth_assets.write_asset_tree(root, rings=10, segments=25,
                                  helmet_map=64, sponza_map=64)
    return root


def _build(name, tree, dev, width=256, height=128):
    """Preset `name` from the small tree, with the kit's coarse atrium and
    reduced terrain, and the benchmark's traffic for it."""
    from benchmark import registry
    from benchmark.traffic import Traffic
    from soc_real_time_renderer_tpu_torch.models import proc
    from soc_real_time_renderer_tpu_torch.tools import synth_assets
    mix, cfg = PRESETS[name]

    def atrium(**kw):
        model = kit.small_atrium_port()
        model.images, model.materials = proc._sponza_materials(
            f"{tree}/{synth_assets.SPONZA}")
        return model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scenes, "ASSETS", tree)
        mp.setattr(proc, "build_atrium", atrium)
        mp.setattr(scenes, "_terrain_model",
                   lambda **kw: kit.small_terrain("port", **kw))
        built = scenes.build(name, RenderConfig(width=width, height=height,
                                                **cfg),
                             atlas_size=64, device=dev)
    return built, Traffic(registry.traffic(mix), SEED)


def _globals(built, traffic, k):
    inp = traffic.inputs(k)
    if inp is not None:
        built.apply_input(InputState(**inp), DT)
    return built.frame_globals(traffic.start_frame + k, DT)


def _segments(built):
    raster = list(RASTER)
    if not built.plan.shadow_statically_empty:
        raster.insert(2, "raster.shadow")
    return raster + SHADE[:5] + ["shade.sky_lut"] + SHADE[5:]


def _counted(fn, *args):
    """fn(*args) and what it added to the counters, the kernels' launches
    and the spans' calls."""
    def state():
        snap = trace.snapshot()
        return ({k: v for k, v in snap["counters"].items()},
                dict(kb.launches),
                {n: t["calls"] for n, t in snap["totals"].items()})
    before = state()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, [{k: v - b.get(k, 0) for k, v in a.items()
                  if v != b.get(k, 0)} for a, b in zip(state(), before)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_replay_equals_eager(dev, tree, name):
    """Six frames of the preset's traffic through make_render_fn and
    through render_frame, each with its own history: every output and
    history tensor equal at max abs 0.  Frames 0-1 run eagerly (frame 0's
    globals share one camera as camera and camera_prev: a key of its
    own), frame 2 captures each pass once, and from frame 2 on every
    pass is replayed once a frame inside its own span; the kernels'
    launches, the shadow view's texels and the spans' calls count as the
    eager frame's do."""
    built, traffic = _build(name, tree, dev)
    segments = _segments(built)
    render = fm.make_render_fn(built.plan)
    hr = he = fm.RenderHistory.create(built.plan.config, device=dev)
    per_frame = []
    for k in range(6):
        g, mm, nm = _globals(built, traffic, k)
        (out_r, hr), got = _counted(render, built.batch, g, hr, mm, nm)
        (out_e, he), eager = _counted(fm.render_frame, built.plan,
                                      built.batch, g, he, mm, nm)
        _equal((out_r, hr), (out_e, he))
        per_frame.append(tuple(got[0].pop(c, 0) for c in COUNTERS))
        assert got[0] == eager[0] and got[1] == eager[1], k
        assert eager[0].get("shadow_texels", 0) == (
            built.plan.shadow_crop[2] * built.plan.shadow_crop[3]
            if "raster.shadow" in segments else 0)
        assert all(got[2][n] == 1 for n in segments)
        if per_frame[-1] == (0, len(segments)):
            # a replay enters no span inside a pass
            assert set(got[2]) == set(segments) | {
                "frame.render", "frame.proofs", "frame.raster",
                "frame.shade"}
    _warm_capture_replay(per_frame, len(segments))


@pytest.mark.cuda
def test_returned_tensors_are_the_callers(dev, tree):
    """Frame 3's outputs and history (replayed), the visibility ids and
    the sky LUT that the seams handed to the benchmark's wrappers, and a
    copy of each into pinned host memory on a side stream, are unchanged
    after frames 4 and 5 replay."""
    from benchmark import spans as spans_mod
    built, traffic = _build("sponza_lifted", tree, dev)
    sp = spans_mod.Spans()
    sp.install(fm)
    try:
        render = fm.make_render_fn(built.plan)
        h = fm.RenderHistory.create(built.plan.config, device=dev)
        side = torch.cuda.Stream()
        for k in range(6):
            g, mm, nm = _globals(built, traffic, k)
            sp.capture = capture = {}
            out, h = render(built.batch, g, h, mm, nm)
            sp.capture = None
            if k == 3:
                kept = replay._leaves((out, h, capture))
                want = [t.clone() for t in kept]
                side.wait_stream(torch.cuda.current_stream())
                host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for t in kept]
                with torch.cuda.stream(side):
                    for dst, t in zip(host, kept):
                        dst.copy_(t, non_blocking=True)
                        t.record_stream(side)
        torch.cuda.synchronize()
    finally:
        sp.uninstall()
    assert len(kept) > 20 and {"tri_id", "sky_lut"} <= set(capture)
    for t, w, c in zip(kept, want, host):
        assert torch.equal(t, w)
        assert torch.equal(c, w.cpu())


@pytest.mark.cuda
def test_a_new_batch_or_size_captures_again(dev, tree):
    """A new scene batch (the same tensors at new addresses) under the
    same render function warms up and captures again, as does a resize's
    new plan and render function; both then equal render_frame."""
    built, traffic = _build("terrain", tree, dev)
    segments = _segments(built)
    render = fm.make_render_fn(built.plan)
    h = fm.RenderHistory.create(built.plan.config, device=dev)
    for k in range(3):
        g, mm, nm = _globals(built, traffic, k)
        _, h = render(built.batch, g, h, mm, nm)
    for stage in ("batch", "resize"):
        if stage == "batch":
            built.batch = dataclasses.replace(built.batch, **{
                f.name: getattr(built.batch, f.name).clone()
                for f in dataclasses.fields(built.batch)
                if getattr(built.batch, f.name) is not None})
        else:
            built.resize(320, 192)
            render = fm.make_render_fn(built.plan)
            h = fm.RenderHistory.create(built.plan.config, device=dev)
        he, captures = h, []
        for k in range(3, 7):
            g, mm, nm = _globals(built, traffic, k)
            before = _graph_counts()
            out, h = render(built.batch, g, h, mm, nm)
            captures.append(trace.counters["graph_captures"]
                            - before["graph_captures"])
            out_e, he = fm.render_frame(built.plan, built.batch, g, he, mm,
                                        nm)
            torch.cuda.synchronize()
            _equal((out, h), (out_e, he))
        assert out.color.shape[-2:] == (built.plan.config.height,
                                        built.plan.config.width)
        # the warm-up (a resize restarts the camera roll, so its first
        # globals share camera and camera_prev: one more), one capture,
        # then replays
        assert captures[0] == 0 and captures[-1] == 0, (stage, captures)
        assert sum(captures) == len(segments), (stage, captures)
