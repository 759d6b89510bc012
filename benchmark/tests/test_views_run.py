"""A whole run of a two-view cell on the CPU, the card's look skipped:
`correct` on a sound run, and false under each fault that the batched
step can have (its history returned unchanged, half of the scene's
triangles left out, one view's colour altered where the step hands it
back).  The cell is full_1080p's configuration at 128x64 on the reduced
atrium of ``tests/torch_scene_kit.py`` (``full_nohelmet``), which the
run builds in place of ``scenes.build("full")``."""
import dataclasses
import json
import os
import shutil
import sys
import time

import pytest

from benchmark import harness, registry

sys.path.insert(0, os.path.join(registry.ROOT, "tests"))
import torch_scene_kit as kit  # noqa: E402

SEED = 2 ** 31 + 909


@pytest.fixture(scope="module")
def views_cell(tmp_path_factory):
    """(spec, base) of the cell ``tiny.views2``."""
    base = tmp_path_factory.mktemp("bench_views")
    shutil.copytree(os.path.join(registry.HERE, "metrics"), base / "metrics")
    os.makedirs(base / "configs")
    os.makedirs(base / "traffic")
    cfg = registry.config("full_1080p")
    cfg.update(width=128, height=64, assets="none",
               render_config={"shadow_resolution": 256}, warmup_frames=1,
               trace_seconds=0.5)
    cfg["check"] = dict(cfg["check"], samples=1, within_frames=2)
    with open(base / "configs" / "tiny_full.json", "w") as f:
        json.dump(cfg, f)
    with open(base / "traffic" / "orbit2.json", "w") as f:
        json.dump(dict(registry.traffic("orbit4"), views=2), f)
    spec = registry.load_spec()
    spec["workloads"] = [{"name": "tiny.views2", "config": "tiny_full",
                          "traffic": "orbit2", "chips": 1, "why": "tests"}]
    for m in spec["per_layer"] + spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.views2"]
    return spec, str(base)


def _run(views_cell, monkeypatch, trace=False):
    from soc_real_time_renderer_tpu_torch.config import RenderConfig
    spec, base = views_cell

    def build(cfg, dev):
        return kit.build_port("full_nohelmet", RenderConfig(
            width=cfg["width"], height=cfg["height"],
            **cfg["render_config"]), dev)

    monkeypatch.setattr(harness, "build_scene", build)
    return harness.run("tiny.views2", SEED, 0.5, trace, time.perf_counter(),
                       device="cpu", spec=spec, base=base)


def test_a_sound_two_view_run_is_correct(views_cell, monkeypatch):
    line = _run(views_cell, monkeypatch)
    assert line["correct"], line["checked"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


def test_a_traced_two_view_run_reads_the_host_layer(views_cell,
                                                    monkeypatch):
    """The set-up and per-step host metrics read on the batched step: the
    scene's build, the globals spans, the upload (one frame_globals
    call a view) and its copies."""
    line = _run(views_cell, monkeypatch, trace=True)
    assert line["correct"], line["checked"]
    m = line["metrics"]
    assert {"scene_build_s", "host_ms", "syncs_per_frame", "upload_host_ms",
            "h2d_copies_per_frame", "dispatch_host_ms"} <= set(m), m
    assert m["host_ms"]["value"] >= m["upload_host_ms"]["value"] > 0


def _half_batch(batch):
    """Every other triangle (the stream's first half is the atrium the
    camera sees, its second the terrain under the floor)."""
    return dataclasses.replace(
        batch, tri_pos=batch.tri_pos[..., ::2],
        tri_nrm=batch.tri_nrm[..., ::2], tri_uv=batch.tri_uv[..., ::2],
        tri_entity=batch.tri_entity[::2],
        static_rows=batch.static_rows[:, ::2])


def _altered(step, b, g, h, mm, nm):
    color, new = step(b, g, h, mm, nm)
    color = color.clone()
    color[1, :, 5, 7] += 0.25
    return color, new


FAULTS = {
    # the step returns its state unchanged: the TAA history stays
    "state_unchanged": ("history", lambda step, b, g, h, mm, nm:
                        (step(b, g, h, mm, nm)[0], h)),
    # half of the batch left out: half the triangles rendered
    "half_the_batch": ("tri_id", lambda step, b, g, h, mm, nm:
                       step(_half_batch(b), g, h, mm, nm)),
    # an answer altered where it is produced: a pixel of view 1's colour
    "answer_altered": ("color", _altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_batched_step_is_not_correct(views_cell, monkeypatch,
                                               fault):
    from soc_real_time_renderer_tpu_torch.parallel import mesh
    number, broken = FAULTS[fault]
    real = mesh.make_batched_render_fn

    def make(plan, *a, **kw):
        step = real(plan, *a, **kw)
        return lambda *args: broken(step, *args)

    monkeypatch.setattr(mesh, "make_batched_render_fn", make)
    line = _run(views_cell, monkeypatch)
    assert not line["correct"]
    c = line["checked"][number]
    assert c["value"] > c["limit"], line["checked"]
