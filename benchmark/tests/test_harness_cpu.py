"""A whole run of the tiny cell on the CPU, the card's look skipped: the
last line's keys, `correct` on a sound run, the control refused, and
`correct` false under each fault that a frame loop on one card can have.
(The exchange between chips does not exist on one card.)"""
import dataclasses
import json
import time

import pytest

from benchmark import calibrate, check, harness

SEED = 2 ** 31 + 77


def _run(tiny, trace=False, seconds=0.5):
    spec, base = tiny
    return harness.run("tiny.fly", SEED, seconds, trace, time.perf_counter(),
                       device="cpu", spec=spec, base=base)


@pytest.fixture(scope="module")
def sound(tiny):
    return _run(tiny)


def test_the_line_has_the_contracts_keys(sound, tiny):
    assert list(sound) == ["correct", "attempted", "failed", "metrics",
                           "device", "checked"]
    assert set(sound["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(sound["device"])
    json.dumps(sound)


def test_a_traced_line_adds_the_breakdown(tiny):
    line = _run(tiny, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checked"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"scene_build_s", "host_ms", "syncs_per_frame"} <= \
        set(line["metrics"])


def test_a_sound_run_is_correct(sound):
    assert sound["correct"], sound["checked"]
    assert sound["failed"] == 0 and sound["attempted"] >= 1
    assert all(v["value"] <= v["limit"] for v in sound["checked"].values())


def test_the_control_is_refused(tiny):
    spec, base = tiny
    cfg = json.load(open(f"{base}/configs/tiny_terrain.json"))
    row = next(calibrate.readings("tiny.fly", [SEED], True, device="cpu",
                                  spec=spec, base=base))
    ok, shown = check.judge(row["control"], cfg["check"]["limits"])
    assert not ok
    ok, _ = check.judge(row["program"], cfg["check"]["limits"])
    assert ok


def _half_batch(batch):
    half = batch.tri_pos.shape[-1] // 2
    return dataclasses.replace(
        batch, tri_pos=batch.tri_pos[..., :half],
        tri_nrm=batch.tri_nrm[..., :half], tri_uv=batch.tri_uv[..., :half],
        tri_entity=batch.tri_entity[:half],
        static_rows=batch.static_rows[:, :half])


FAULTS = {
    # the step returns its state unchanged: the TAA history stays
    "state_unchanged": ("history",
                        lambda render, b, g, h, mm, nm:
                        (render(b, g, h, mm, nm)[0], h)),
    # half of the batch left out: half the triangles rendered
    "half_the_batch": ("tri_id",
                       lambda render, b, g, h, mm, nm:
                       render(_half_batch(b), g, h, mm, nm)),
    # an answer altered where it is produced: one pixel of the colour
    "answer_altered": ("color", None),
}


def _altered(render, b, g, h, mm, nm):
    out, new = render(b, g, h, mm, nm)
    color = out.color.clone()
    color[..., 5, 7] += 0.25
    return dataclasses.replace(out, color=color), new


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    number, broken = FAULTS[fault]
    broken = broken or _altered
    real = fm.make_render_fn

    def make(plan, impl=None):
        render = real(plan, impl)
        return lambda *a: broken(render, *a)

    monkeypatch.setattr(fm, "make_render_fn", make)
    line = _run(tiny)
    assert not line["correct"]
    c = line["checked"][number]
    assert c["value"] > c["limit"], line["checked"]
