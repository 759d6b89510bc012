"""The render farm's step in the window: a mix with ``views`` renders
them at once through ``parallel/mesh.make_batched_render_fn``, and the
check holds every view of a step against the reference's own turned
orbit.  On the reduced atrium of ``tests/torch_scene_kit.py``
(``full_nohelmet``: the atrium at scale 0.01 and the small terrain,
full's camera and orbit) at 128x64 with a 256^2 shadow map, on the CPU
through the port's plain versions."""
import os
import sys

import pytest
import torch

from benchmark import check, harness, registry, spans as spans_mod
from benchmark.traffic import Traffic

sys.path.insert(0, os.path.join(registry.ROOT, "tests"))
import torch_scene_kit as kit  # noqa: E402

SEED = 2 ** 31 + 4242
ORBIT = {"camera": "orbit", "start_frame": [1, 10000]}
ORBIT2 = dict(ORBIT, views=2)
STEPS = 3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def atrium():
    """(configuration, BuiltScene, spans installed on graph/frame):
    full_1080p's configuration at the reduced size, its camera the
    kit's."""
    from soc_real_time_renderer_tpu_torch.config import RenderConfig
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    cfg = registry.config("full_1080p")
    cfg.update(width=128, height=64,
               render_config={"shadow_resolution": 256})
    scene = kit.SCENES["full_nohelmet"]
    assert cfg["camera"] == {"position": scene["camera_pos"],
                             "target": scene["camera_target"]}
    torch.set_grad_enabled(False)
    built = kit.build_port("full_nohelmet", RenderConfig(
        width=128, height=64, shadow_resolution=256), "cpu")
    sp = spans_mod.Spans()
    sp.install(fm)
    yield cfg, built, sp
    sp.uninstall()
    torch.set_grad_enabled(True)


def _steps(atrium, mix, positions=None):
    """(traffic, [Loop.frame's tuple] of STEPS steps from SEED);
    positions: the views' starts in place of the traffic's."""
    _, built, sp = atrium
    traffic = Traffic(mix, SEED)
    loop = harness.Loop(built, traffic, sp, harness.Clock(CPU))
    if positions is not None:
        loop.positions = positions
    frames = [loop.frame(n) for n in range(STEPS)]
    assert loop.raised == 0 and not loop.flags[:STEPS].any()
    return traffic, frames, loop


def _samples(frames):
    """The check's samples of steps 1 and 2 (k: the traffic frame)."""
    return [dict(k=k, g=f[0], mats=(f[1], f[2]),
                 targets=harness.targets_of(*f[3:]))
            for k, f in enumerate(frames) if k >= 1]


@pytest.fixture(scope="module")
def two_views(atrium):
    return _steps(atrium, ORBIT2)


def test_view_0_of_the_step_is_the_single_view_frame(atrium, two_views):
    """View 0 of each batched step against the single-view loop's frame
    from the same start frame, history carried on both sides: colour,
    history and exposure within 1e-6, the bound that chip_smoke.py's
    batched phase holds each view of a step to against its single frame
    (here on the CPU: PyTorch's vectorised exp and sin round a loop's
    tail unlike its body, so a batched and a single call can part in a
    last bit, which the SSAO hash and the sky LUT can carry further)."""
    _, batched, loop = two_views
    assert loop.views == 2
    _, single, _ = _steps(atrium, ORBIT)
    worst = 0.0
    for b, s in zip(batched, single):
        out_b, hist_b, out_s, hist_s = b[3], b[4], s[3], s[4]
        assert out_b.color.shape[0] == 2
        for x, y in ((out_b.color[0], out_s.color),
                     (hist_b.previous_color[0], hist_s.previous_color),
                     (hist_b.exposure[0], hist_s.exposure)):
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    assert worst <= 1e-6, worst


def test_a_two_view_step_passes_the_check(atrium, two_views):
    """Every view of each sampled step within full_1080p's limits, the
    reference's poses its own orbit turned by 2 pi b / 2."""
    cfg = atrium[0]
    traffic, frames, _ = two_views
    samples = _samples(frames)
    per_frame, _ = harness.reference_check(cfg, atrium[1], traffic,
                                           samples, CPU)
    assert len(per_frame) == 2 * len(samples)
    ok, shown = check.judge(check.worst(per_frame), cfg["check"]["limits"])
    assert ok, shown
    assert shown["globals"]["value"] == 0.0


def test_view_1_under_view_0s_camera_fails_globals(atrium, two_views):
    """The same step with view 1 rendered from view 0's camera: the
    check refuses it on ``globals``."""
    cfg = atrium[0]
    traffic, _, loop = two_views
    home = loop.positions[0]
    _, frames, _ = _steps(atrium, ORBIT2, positions=[home, home.copy()])
    per_frame, _ = harness.reference_check(cfg, atrium[1], traffic,
                                           _samples(frames), CPU)
    ok, shown = check.judge(check.worst(per_frame), cfg["check"]["limits"])
    assert not ok
    assert shown["globals"]["value"] > shown["globals"]["limit"], shown


def test_the_roofline_jobs_count_every_view(atrium, two_views):
    """With `jobs`, a batched step's jobs are the sum of its views': the
    jobs whose size is the frame's alone (SSAO's taps, TAA's fetch) read
    twice the single view's, and every job of the single view is there."""
    cfg, built, _ = atrium
    traffic, frames, _ = two_views
    _, jobs2 = harness.reference_check(cfg, built, traffic,
                                       _samples(frames)[:1], CPU, jobs=True)
    one, single, _ = _steps(atrium, ORBIT)
    _, jobs1 = harness.reference_check(cfg, built, one,
                                       _samples(single)[:1], CPU, jobs=True)
    assert set(jobs2) == set(jobs1) and {"ssao_taps", "taa_reproject"} \
        <= set(jobs1)
    for name in ("ssao_taps", "taa_reproject"):
        assert jobs2[name] == pytest.approx(2 * jobs1[name], rel=1e-12)
    for name in jobs1:
        assert jobs2[name] > jobs1[name]
