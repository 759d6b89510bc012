"""Every RenderConfig switch of the port renders: frame 0 of the reduced
``atrium_passes`` scene (tests/torch_scene_kit.py) on the CPU with each
boolean switch flipped alone, the per-pixel clouds, and all of them on,
one case a variant.  The switches that are off by default, each turned
on alone, are in tests/test_torch_switches_on.py, so that the two
halves (each ~7 frames that render their own sky LUT) run on two
workers; the rest are here.  The frame tests with the passes' switches
on are in tests/test_torch_passes_frames.py.
"""
import dataclasses

import pytest
import torch

import test_torch_passes_frames as tpf
import torch_scene_kit as kit
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe

BASE = RenderConfig(**tpf.ORACLE)
FLAGS = [f.name for f in dataclasses.fields(RenderConfig)
         if f.type in (bool, "bool") and f.name.startswith(
             ("enable_", "composite_", "cloud_fullscreen"))]
VARIANTS = [{f: not getattr(BASE, f)} for f in FLAGS]
VARIANTS += [{"cloud_impl": "perpixel"}, {f: True for f in FLAGS}]
ON = [kw for kw in VARIANTS if list(kw.values()) == [True]]


def variant_id(kw):
    if len(kw) > 1:
        return "all_on"
    (name, value), = kw.items()
    return f"{name}={value}"


@pytest.fixture(scope="module")
def frame0():
    """The port's atrium_passes built on BASE, frame 0's inputs and a
    fresh history."""
    pb = kit.build_port("atrium_passes", BASE, "cpu")
    g, mm, nm = pb.frame_globals(0)
    hist = pframe.RenderHistory.create(BASE, device="cpu")
    return pb, g, mm, nm, hist


def renders(frame0, kw):
    """Frame 0 with `kw` applied to BASE renders, finite."""
    assert {"enable_ssr", "enable_depth_of_field",
            "enable_volumetric_light", "composite_ssr"} <= set(FLAGS)
    pb, g, mm, nm, hist = frame0
    plan = dataclasses.replace(pb.plan, config=BASE.replace(**kw))
    out, _ = pframe.render_frame(plan, pb.batch, g, hist, mm, nm)
    assert torch.isfinite(out.color).all(), kw


@pytest.mark.parametrize("kw", [kw for kw in VARIANTS if kw not in ON],
                         ids=variant_id)
def test_every_switch_renders(frame0, kw):
    """render_frame raises NotImplementedError for no RenderConfig
    switch: every boolean off and on, both cloud implementations."""
    renders(frame0, kw)
