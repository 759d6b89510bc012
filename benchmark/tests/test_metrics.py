"""Each metric reader gives the hand-computed value on a small recorded
trace, and the trace reduction links kernels to spans."""
import types

import pytest
import torch

from benchmark import registry, spans

WINDOW = {"window_s": 2.0, "frames": 50,
          "frame_intervals_ms": [float(i) for i in range(1, 51)],
          "peak_bytes": 3 * 2 ** 30, "setup_s": 12.5}
REC = {
    "frames": 4, "window_s": 0.2, "busy_s": 0.15,
    "spans": {"apply_input": {"host_s": 0.001, "calls": 4, "device_s": 0.0},
              "frame_globals": {"host_s": 0.007, "calls": 4,
                                "device_s": 0.0001},
              "raster_stage": {"host_s": 0.02, "calls": 4, "device_s": 0.008},
              "shade_stage": {"host_s": 0.1, "calls": 4, "device_s": 0.06},
              "sky_lut": {"host_s": 0.004, "calls": 4, "device_s": 0.0002}},
    "kernels": {"tap_kernel": {"s": 0.0002, "n": 4, "port": True,
                               "copy": False},
                "resolve_body": {"s": 0.0004, "n": 4, "port": True,
                                 "copy": False},
                "elementwise": {"s": 0.05, "n": 400, "port": False,
                                "copy": False},
                "Memcpy HtoD": {"s": 0.001, "n": 240, "port": False,
                                "copy": True}},
    "syncs": {"config.py:58": 192, "frame.py:586": 4},
    "scene_build_s": 7.25,
    "jobs_ms": {"resolve": 0.0066, "texsample": 0.038},
}


@pytest.mark.parametrize("name, value", [
    ("frame_ms", 40.0), ("frame_ms_p95", 47.55), ("peak_mib", 3072.0),
    ("setup_s", 12.5)])
def test_end_to_end_readers(name, value):
    assert registry.metric_reader(name)(WINDOW) == pytest.approx(value)


@pytest.mark.parametrize("name, value", [
    ("scene_build_s", 7.25), ("host_ms", 2.0), ("syncs_per_frame", 49.0),
    ("raster_ms", 2.0), ("shade_ms", 15.0), ("sky_ms", 0.05),
    ("launches_per_frame", 102.0),
    ("kernels_roofline", 100 * 0.0446 / 0.15),
    ("device_idle_pct", 25.0)])
def test_per_layer_readers(name, value):
    assert registry.metric_reader(name)(REC) == pytest.approx(value)


@pytest.mark.parametrize("name", [
    "raster_ms", "shade_ms", "sky_ms", "kernels_roofline", "host_ms",
    "launches_per_frame", "device_idle_pct", "scene_build_s"])
def test_readers_find_nothing_in_an_empty_trace(name):
    assert registry.metric_reader(name)({"frames": 0}) is None


def test_every_metric_of_the_benchmark_has_a_reader():
    spec = registry.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))


def _ev(name, t0, t1, device=False, kernels=()):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=t0, end=t1),
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU),
        kernels=[types.SimpleNamespace(duration=d) for d in kernels])


def test_records_link_kernels_to_spans_and_find_the_gaps():
    p = spans.PREFIX
    events = [
        _ev(p + "traced", 0, 1000),
        _ev(p + "render_frame", 100, 600),
        _ev(p + "raster_stage", 100, 200),
        _ev("aten::add", 110, 120, kernels=[30]),
        _ev(p + "shade_stage", 200, 600, kernels=[50]),   # a ctypes launch
        _ev("aten::mul", 300, 310, kernels=[100]),
        _ev(p + "wait", 600, 900),
        _ev("void resolve_body<true, 1>(int const*)", 150, 180,
            device=True),
        _ev("add_kernel", 180, 210, device=True),
        _ev("mul_kernel", 650, 750, device=True),
        _ev("Memcpy HtoD", 750, 760, device=True),
        _ev(p + "render_frame", 150, 760, device=True),   # the mirror
    ]
    rec = spans.records(events, 1, (0, 1000), {"resolve_body"}, {"a:1": 2})
    s = rec["spans"]
    assert s["raster_stage"]["device_s"] == pytest.approx(30e-6)
    assert s["shade_stage"]["device_s"] == pytest.approx(150e-6)
    assert s["render_frame"]["device_s"] == pytest.approx(180e-6)
    assert rec["busy_s"] == pytest.approx((60 + 110) * 1e-6)
    assert rec["window_s"] == pytest.approx(1000e-6)
    assert rec["kernels"]["void resolve_body<true, 1>(int const*)"]["port"]
    assert not rec["kernels"]["add_kernel"]["port"]
    assert rec["kernels"]["Memcpy HtoD"]["copy"]
    assert p + "render_frame" not in rec["kernels"]
    # gaps, labelled at their middle: [0, 150) outside every frame span,
    # [210, 650) in render_frame, [760, 1000) in the wait
    assert rec["gaps"] == [["render_frame", pytest.approx(440e-6)],
                           ["wait", pytest.approx(240e-6)],
                           ["harness", pytest.approx(150e-6)]]
    assert rec["syncs"] == {"a:1": 2}
