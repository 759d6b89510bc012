"""The program's own spans (``soc:``) in a trace: they leave the harness's
records as they were, :func:`benchmark.passes.program_records` puts
device time, launches and idle time under them, and the readers of the
program's totals give the hand-computed values."""
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import passes, registry, spans
from soc_real_time_renderer_tpu_torch.utils import trace

P = spans.PREFIX


def _ev(name, t0, t1, device=False, kernels=()):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=t0, end=t1),
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU),
        kernels=[types.SimpleNamespace(name=n, duration=d)
                 for n, d in kernels])


# the harness's own events: spans, ops with their kernels, the device line
HARNESS = [
    _ev(P + "traced", 0, 1000),
    _ev(P + "render_frame", 100, 600),
    _ev(P + "raster_stage", 100, 200),
    _ev("aten::add", 110, 120, kernels=[("add_kernel", 30)]),
    _ev(P + "shade_stage", 200, 600),
    _ev("aten::mul", 300, 310, kernels=[("mul_kernel", 100)]),
    _ev("aten::copy_", 320, 330, kernels=[("Memcpy HtoD", 10)]),
    _ev(P + "wait", 600, 900),
    _ev("void resolve_body<true, 1>(int const*)", 150, 180, device=True),
    _ev("add_kernel", 180, 210, device=True),
    _ev("mul_kernel", 650, 750, device=True),
    _ev("Memcpy HtoD", 750, 760, device=True),
    _ev(P + "render_frame", 150, 760, device=True),   # its mirror
]
# the program's spans inside render_frame: host events only (FUNCTION
# scope, so the profiler draws no mirror of them on the device line); the
# ctypes launch of resolve_body links to the innermost, raster.main
PROGRAM = [
    _ev("soc:frame.render", 101, 599),
    _ev("soc:frame.raster", 101, 199),
    _ev("soc:raster.main", 105, 190, kernels=[("resolve_body", 30)]),
    _ev("soc:frame.shade", 201, 599),
    _ev("soc:shade.sky_lut", 205, 400),
    _ev("soc:shade.taa", 400, 590),
]


def _records(events):
    return spans.records(events, 1, (0, 1000), {"resolve_body"}, {})


def test_program_spans_leave_the_device_line_and_the_gaps_as_they_were():
    without, with_ = _records(HARNESS), _records(HARNESS + PROGRAM)
    for key in ("kernels", "busy_s", "gaps", "window_s", "frames"):
        assert with_[key] == without[key], key
    assert not any(k.startswith("soc:") for k in with_["kernels"])
    # the ctypes launch now links to a span event: it counts towards the
    # harness spans that hold that event's start, as an aten op's kernels
    s0, s1 = without["spans"], with_["spans"]
    assert s1["raster_stage"]["device_s"] \
        == pytest.approx(s0["raster_stage"]["device_s"] + 30e-6)
    assert {n: v["host_s"] for n, v in s1.items()} \
        == {n: v["host_s"] for n, v in s0.items()}
    assert set(s1) == set(s0)


def test_program_records_put_device_and_idle_time_under_each_span():
    out = passes.program_records(HARNESS + PROGRAM, (0, 1000))
    prog = out["program"]
    assert set(prog) == {"frame.render", "frame.raster", "raster.main",
                         "frame.shade", "shade.sky_lut", "shade.taa"}
    # raster.main: aten::add's kernel and its own ctypes launch
    assert prog["raster.main"]["device_s"] == pytest.approx(60e-6)
    assert prog["frame.raster"]["device_s"] == pytest.approx(60e-6)
    assert prog["shade.sky_lut"]["device_s"] == pytest.approx(110e-6)
    assert prog["shade.sky_lut"]["launches"] == 1       # the copy left out
    assert prog["frame.render"]["launches"] == 3
    assert prog["frame.shade"]["host_s"] == pytest.approx(398e-6)
    # the device idles [0, 150), [210, 650), [760, 1000)
    assert prog["frame.raster"]["idle_s"] == pytest.approx(49e-6)
    assert prog["shade.sky_lut"]["idle_s"] == pytest.approx(190e-6)
    assert prog["shade.taa"]["idle_s"] == pytest.approx(190e-6)
    assert prog["frame.render"]["idle_s"] == pytest.approx(49e-6 + 389e-6)
    # under a pass: raster.main's 45 of frame.raster's 49 (101-150 less
    # 101-105), sky_lut's 190 and taa's 190 of frame.shade's 389
    assert out["pass_idle_share"] == pytest.approx(
        (45 + 190 + 190) / (49 + 389))
    # the gaps of records, in its order and durations, by innermost span
    gaps = _records(HARNESS + PROGRAM)["gaps"]
    assert [g[1] for g in out["gaps_by_span"]] == [g[1] for g in gaps]
    assert [g[0] for g in out["gaps_by_span"]] == [
        "render_frame/shade.taa", "wait", "harness"]


def test_the_innermost_span_at_the_middle_names_the_gap():
    events = HARNESS[:8] + [_ev("add_kernel", 180, 210, device=True),
                            _ev("mul_kernel", 640, 650, device=True),
                            _ev("soc:frame.render", 101, 599),
                            _ev("soc:shade.sky_lut", 205, 590)]
    out = passes.program_records(events, (0, 1000))
    assert out["gaps_by_span"][0][0] == "render_frame/shade.sky_lut"
    assert out["gaps_by_span"][-1][0] == "harness"


def _traced_frames(frames=4):
    """`frames` fake frames under a CPU profiler, each with the program's
    spans and copies, between untraced ones."""
    trace.reset()

    def frame(k):
        with trace.span("scene.frame_globals"):
            with trace.span("globals.upload"):
                trace.counters["h2d_copies"] += 62
        with trace.span("frame.render"):
            torch.ones(8).add_(k)

    frame(0)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(frames):
            frame(k)
    frame(0)
    return trace.profiled()["totals"]


@pytest.mark.parametrize("name, span, scale, counter", [
    ("dispatch_host_ms", "frame.render", 1e3, None),
    ("upload_host_ms", "globals.upload", 1e3, None),
    ("h2d_copies_per_frame", None, 1, 62)])
def test_program_readers(name, span, scale, counter):
    totals = _traced_frames()
    read = registry.metric_reader(name)
    want = counter if span is None else totals[span]["host_s"] * scale / 4
    assert read({"frames": 4}) == pytest.approx(want)
    assert read({"frames": 0}) is None
    trace.reset()
    assert read({"frames": 4}) is None           # no stretch recorded


@pytest.mark.parametrize("name", ["dispatch_host_ms", "upload_host_ms",
                                  "h2d_copies_per_frame"])
def test_program_readers_find_nothing_in_a_program_without_spans(
        name, monkeypatch):
    import soc_real_time_renderer_tpu_torch.utils as utils
    _traced_frames()
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules,
                        "soc_real_time_renderer_tpu_torch.utils.trace", None)
    assert registry.metric_reader(name)({"frames": 4}) is None
    trace.reset()


@pytest.mark.parametrize("traced", [False, True])
def test_passes_run_reduces_a_whole_run_of_the_tiny_cell(tiny, traced):
    spec, base = tiny
    out = passes.run("tiny.fly", 2 ** 31 + 91, 0.5, traced, device="cpu",
                     spec=spec, base=base)
    assert out["line"]["correct"]
    assert {"frame.render", "frame.raster", "frame.shade",
            "shade.sky_lut", "globals.upload"} <= set(out["program"])
    assert set(out["setup_spans"]) >= {"scenes.build", "scenes.pack"}
    assert out["counters"] == {}                 # the CPU copies nothing
    render = out["program"]["frame.render"]
    assert render["calls"] == out["frames"] >= 1
    # a header, then a row a span
    assert passes.table(out).count("\n| ") == 1 + len(out["program"])
    if traced:
        assert out["frames"] <= out["line"]["attempted"]
        assert render["device_s"] == 0.0 and render["idle_s"] > 0
        assert [g[1] for g in out["gaps_by_span"]] == \
            [g[1] for g in out["gaps"]]
