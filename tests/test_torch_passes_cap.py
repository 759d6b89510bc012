"""The SSR cap and the passes' switches inside the port, on the CPU:
frame 0 of the reduced ``atrium_passes`` scene (tests/torch_scene_kit.py)
with SSR, depth of field and the volumetric light on, dense, compacted,
over its cap, and with each of those switches off in turn.
"""
import dataclasses

import torch

import test_torch_passes_frames as tpf
import torch_scene_kit as kit
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe


def test_atrium_passes_cap_and_switches():
    """Inside the port, on frame 0: the compacted frame equals the dense
    one bit for bit; a cap at half of the reflective pixels sets bit 16
    and changes only reflective pixels of the SSR target, to black; DoF,
    the volumetric term and the SSR mix each change the frame."""
    cfg = RenderConfig(**{**tpf.ORACLE, **tpf.SWITCHES["atrium_passes"]})
    pb = kit.build_port("atrium_passes", cfg, "cpu")
    g, mm, nm = pb.frame_globals(0)

    def frame(**kw):
        plan = pb.plan
        if "ssr_cap" in kw:
            plan = dataclasses.replace(plan, ssr_cap=kw.pop("ssr_cap"))
        if kw:
            plan = dataclasses.replace(plan, config=plan.config.replace(**kw))
        hist = pframe.RenderHistory.create(plan.config, device="cpu")
        return pframe.render_frame(plan, pb.batch, g, hist, mm, nm)[0]

    assert pb.plan.ssr_cap == 1024           # _finish: 5% of the screen
    dense = frame(ssr_cap=0)
    assert int(dense.ssr_active) == -1 and int(dense.overflow) == 0
    full = frame(ssr_cap=8192)
    n = int(full.ssr_active)
    assert n > 0 and int(full.overflow) == 0
    assert torch.equal(full.ssr, dense.ssr)
    assert torch.equal(full.color, dense.color)
    half = frame(ssr_cap=n // 2)
    assert int(half.overflow) == 16 and int(half.ssr_active) == n
    differs = (half.ssr != dense.ssr).any(0)
    metal = dense.gbuffer.metallic_roughness[1] >= 0.01
    assert differs.any() and bool(metal[differs].all())
    assert bool((half.ssr[:, differs] == 0).all())
    for off in ("enable_depth_of_field", "enable_volumetric_light",
                "composite_ssr"):
        other = frame(ssr_cap=8192, **{off: False})
        assert not torch.equal(other.hdr, full.hdr), off
        assert torch.isfinite(other.color).all()
    assert frame(ssr_cap=8192, enable_ssr=False).ssr is None
