"""The readers of the sun shadow view (the ``sponza_lifted_1080p.orbit``
cell): each gives its value on a hand-made record, and nothing on a
record without its span, kernel, job or counter (the elided map, or a
program that has none)."""
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import registry
from soc_real_time_renderer_tpu_torch.utils import trace

K4 = "void resolve_body<false, 2>(int const*, float const*, float*)"
K1 = "void resolve_body<true, 1>(int const*, float const*, float*, int*)"
REC = {
    "frames": 4,
    "kernels": {K4: {"s": 0.001, "n": 4, "port": True, "copy": False},
                K1: {"s": 0.0004, "n": 4, "port": True, "copy": False},
                "elementwise": {"s": 0.05, "n": 400, "port": False,
                                "copy": False}},
    "jobs_ms": {"resolve": 0.0066, "resolve_depth": 0.02},
}


def _traced_frames(frames=4, shadow=True):
    """`frames` fake frames under a CPU profiler, each with the shadow
    view's spans and counter (or the elided view's none), between
    untraced ones; the traced stretch's totals."""
    trace.reset()

    def frame():
        with trace.span("frame.raster"):
            if shadow:
                with trace.span("raster.shadow"):
                    with trace.span("shadow.setup"):
                        torch.ones(8).add_(1)
                    with trace.span("shadow.resolve"):
                        torch.ones(8).add_(2)
                    trace.counters["shadow_texels"] += 3200 * 1792

    frame()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(frames):
            frame()
    frame()
    return trace.profiled()["totals"]


def test_device_readers():
    assert registry.metric_reader("shadow_resolve_ms")(REC) \
        == pytest.approx(0.25)
    assert registry.metric_reader("shadow_roofline")(REC) \
        == pytest.approx(100 * 0.02 / 0.25)


@pytest.mark.parametrize("name", ["shadow_resolve_ms", "shadow_roofline"])
@pytest.mark.parametrize("drop", ["kernel", "job", "frames"])
def test_device_readers_find_nothing_without_k4(name, drop):
    rec = dict(REC)
    if drop == "kernel":             # K1 alone: the map elided
        rec["kernels"] = {k: v for k, v in REC["kernels"].items()
                          if k != K4}
    elif drop == "job":
        rec["jobs_ms"] = {"resolve": 0.0066}
    else:
        rec["frames"] = 0
    want_none = drop != "job" or name == "shadow_roofline"
    got = registry.metric_reader(name)(rec)
    assert (got is None) if want_none else got == pytest.approx(0.25)


def test_a_kernel_not_built_from_the_port_is_not_k4():
    rec = dict(REC, kernels={K4: dict(REC["kernels"][K4], port=False)})
    assert registry.metric_reader("shadow_resolve_ms")(rec) is None


def test_program_readers():
    totals = _traced_frames()
    assert registry.metric_reader("shadow_host_ms")({"frames": 4}) \
        == pytest.approx(totals["raster.shadow"]["host_s"] * 1e3 / 4)
    assert registry.metric_reader("shadow_texels_per_frame")(
        {"frames": 4}) == 3200 * 1792
    trace.reset()


@pytest.mark.parametrize("name", ["shadow_host_ms",
                                  "shadow_texels_per_frame"])
def test_program_readers_find_nothing_where_the_map_is_elided(name):
    totals = _traced_frames(shadow=False)
    assert "frame.raster" in totals and "raster.shadow" not in totals
    read = registry.metric_reader(name)
    assert read({"frames": 4}) is None
    assert read({"frames": 0}) is None
    trace.reset()
    assert read({"frames": 4}) is None           # no stretch recorded


@pytest.mark.parametrize("name", ["shadow_host_ms",
                                  "shadow_texels_per_frame"])
def test_program_readers_find_nothing_in_a_program_without_spans(
        name, monkeypatch):
    import soc_real_time_renderer_tpu_torch.utils as utils
    _traced_frames()
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules,
                        "soc_real_time_renderer_tpu_torch.utils.trace", None)
    assert registry.metric_reader(name)({"frames": 4}) is None
    trace.reset()
