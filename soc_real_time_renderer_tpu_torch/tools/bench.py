"""Frame-time bench of the port, and the frame loop that
``bench_baselines`` and ``bench_toggle`` share.

    python -m soc_real_time_renderer_tpu_torch.tools.bench [--device cpu]

The counterpart of the JAX package's ``bench.py``, with its contract:
``BENCH_SCENE`` (default ``sponza``), ``BENCH_WIDTH`` / ``BENCH_HEIGHT``
(1280x736), ``BENCH_FRAMES`` (32) and ``BENCH_FILTER`` (the plan's
``texture_filter``) in the environment; ``helmet`` when the scene does
not build; the last line of standard output one JSON object with
``metric``, ``value`` (ms per frame: the whole loop over N), ``unit``
and ``vs_baseline`` (16 ms over ``value``: the BASELINE target, not a
claim).  The object also carries ``median_ms``, ``min_ms`` and
``max_ms`` of the single frames, ``frames``, ``peak_mib`` (the timed
run's peak allocation; None on the CPU), ``device`` (the card's name
and power limit as nvidia-smi gives them, or ``cpu``) and ``assets``.

The loop (:func:`stage`, :func:`run`, :func:`bench`): the globals of
frames 1..N are made before the timed window (the JAX bench's stacked
scan inputs), the sun-shadow proof and the shadow crop are checked once
on them there, one untimed pass of the N frames builds the kernels and
warms the allocator, then N frames run from a fresh ``RenderHistory``
with CUDA events between them (one pair bounds the loop, one each
frame) and nothing waiting for the card inside (on the card the loop
runs under ``torch.cuda.set_sync_debug_mode("warn")``, and
``Timing.syncs`` counts the calls that did wait, by call site).  The
kernels' launch
counts are reset before the timed run and checked after it: on the card
each kernel of the plan's path (:func:`kernel_path`) launches once a
frame and no other; on the CPU (``--device cpu``: the plain versions,
host clock) none does.  Without a card and without ``--device cpu`` it
raises: it never falls back to the CPU.

Assets: when ``scenes.ASSETS`` (``SOC_ASSETS``) lacks the files the
presets read, the tree of ``tools/synth_assets.py`` is written into a
temporary directory and used, and ``assets`` (and the metric string)
say ``synthetic``, as they do for any tree that module wrote.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from dataclasses import dataclass

TARGET_MS = 16.0


def card_name(device) -> str:
    """The card's name and power limit (nvidia-smi's csv line), or
    "cpu"."""
    import torch
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    if not out:
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
    return out[device.index or 0] if len(out) > (device.index or 0) \
        else out[0]


def prepare(device) -> None:
    """TF32 off (the kernels are held against f32 plain versions)."""
    import torch
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def asset_tree():
    """Yields "real" or "synthetic": the tree under scenes.ASSETS when it
    holds every file the presets read (synthetic when synth_assets wrote
    it), else a synthetic tree written into a temporary directory, which
    scenes.ASSETS points at until the block ends."""
    from .. import scenes
    from . import synth_assets
    root = scenes.ASSETS
    if all(os.path.exists(os.path.join(root, f))
           for f in synth_assets.PRESET_FILES):
        yield "synthetic" if synth_assets.is_synthetic(root) else "real"
        return
    with tempfile.TemporaryDirectory() as tree:
        synth_assets.write_asset_tree(tree)
        scenes.ASSETS = tree
        try:
            yield "synthetic"
        finally:
            scenes.ASSETS = root


def kernel_path(plan, batch) -> list[str]:
    """The kernels one frame of `plan` launches on the card."""
    cfg = plan.config
    path = ["resolve"]
    if plan.texture_filter != "none":
        path.append("texsample")
    if cfg.enable_ssao:
        path.append("ssao_taps")
    if cfg.enable_taa:
        path.append("taa_resolve")
    if cfg.enable_shadows and not plan.shadow_statically_empty:
        path.append("resolve_depth")
    if cfg.max_point_lights or cfg.max_spot_lights:
        path.append("local_lights")
    if cfg.enable_ssr:
        path.append("ssr_march")
    noise = batch.cloud_noise is not None
    if cfg.enable_clouds and not (cfg.cloud_impl == "perpixel" and noise):
        texture = cfg.cloud_noise_mode == "texture" and noise
        path.append("sky_lut" if texture else "sky_lut_procedural")
    return path


@dataclass
class Staged:
    """The globals of frames 1..N on the scene's device, and the model
    and normal matrices of the last (the JAX bench's scan inputs)."""
    globals: list
    model_mats: object
    normal_mats: object


def stage(built, plan, frames: int) -> Staged:
    """frame_globals(i + 1) for i < frames, then the two proof checks of
    render_frame once on them."""
    from ..graph import frame as fm
    gs = []
    for i in range(frames):
        g, mm, nm = built.frame_globals(i + 1)
        gs.append(g)
    for g in gs:
        fm.check_sun_proof(plan, g)
    fm.check_shadow_crop(plan, mm)
    return Staged(gs, mm, nm)


def frame(plan, batch, g, history, model_mats, normal_mats):
    """render_frame without its two proof checks, which :func:`stage`
    ran on these globals: the frame the loop times."""
    from ..graph import frame as fm
    vis, records, shadow_map, overflow = fm.raster_stage(
        plan, batch, g, model_mats, normal_mats)
    return fm.shade_stage(plan, batch, g, history, vis, records, shadow_map,
                          overflow)


@dataclass
class Timing:
    """One run of the staged frames."""
    total_ms: float           # the whole loop (CUDA events; host clock)
    frame_ms: list            # each frame
    launches: dict            # kernel -> launches in the run
    path: list                # the kernels the plan's frame launches
    syncs: dict               # call site -> calls in the loop that waited
    #                           for the card (empty: none did)
    overflow: list            # each frame's OVERFLOW_* bits
    ssr_active: list          # each frame's SSR rays (-1: SSR off)
    peak_mib: float | None    # peak allocation of the run, the scene's
    #                           tensors included (the card)
    outputs: object           # the last frame's FrameOutputs
    history: object           # the history after the last frame

    @property
    def ms(self) -> float:
        """The JAX bench's metric: the loop over its frame count."""
        return self.total_ms / len(self.frame_ms)

    @property
    def median_ms(self) -> float:
        return statistics.median(self.frame_ms)


def run(built, plan, staged: Staged) -> Timing:
    """The staged frames from a fresh RenderHistory, timed, with the
    launch counts reset before and checked after (raises on a kernel of
    the path that did not launch once a frame, or on any other)."""
    import torch

    from ..graph import frame as fm
    from ..kernels import build as kb
    device = built.device
    on_card = device.type == "cuda"
    n = len(staged.globals)
    history = fm.RenderHistory.create(plan.config, device=device)
    path = kernel_path(plan, built.batch)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    else:
        marks = [0.0] * (n + 1)

    def mark(i):
        if on_card:
            marks[i].record()
        else:
            marks[i] = time.perf_counter()

    kb.reset_launches()
    outs = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            # on the card, each call that makes the host wait for it warns
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            mark(0)
            for i, g in enumerate(staged.globals):
                out, history = frame(plan, built.batch, g, history,
                                     staged.model_mats, staged.normal_mats)
                outs.append((out.overflow, out.ssr_active))
                mark(i + 1)
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    syncs = dict(collections.Counter(
        f"{w.filename}:{w.lineno}" for w in caught
        if "called a synchronizing" in str(w.message)))
    if on_card:
        marks[n].synchronize()
        frame_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(n)]
        total = marks[0].elapsed_time(marks[n])
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 20
    else:
        frame_ms = [(marks[i + 1] - marks[i]) * 1e3 for i in range(n)]
        total = (marks[n] - marks[0]) * 1e3
        peak = None
    launches = dict(kb.launches)
    want = {k: (n if on_card and k in path else 0) for k in launches}
    if launches != want:
        raise RuntimeError(f"launches {launches}: each kernel of {path} "
                           f"once per frame of {n} on the card, no other, "
                           f"none on the CPU ({want})")
    return Timing(total_ms=total, frame_ms=frame_ms, launches=launches,
                  path=path, syncs=syncs, overflow=[int(o) for o, _ in outs],
                  ssr_active=[int(s) for _, s in outs], peak_mib=peak,
                  outputs=out, history=history)


def bench(built, plan, frames: int) -> tuple[Timing, float]:
    """Stage, one untimed pass (the kernels' build, the allocator), one
    timed run: (its Timing, the untimed pass's seconds)."""
    staged = stage(built, plan, frames)
    t0 = time.perf_counter()
    run(built, plan, staged)
    return run(built, plan, staged), time.perf_counter() - t0


def main(argv=None, environ=None) -> dict:
    """Run the bench; prints the launch counts and, last, the JSON
    object, which it returns."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    env = os.environ if environ is None else environ
    width = int(env.get("BENCH_WIDTH", "1280"))
    height = int(env.get("BENCH_HEIGHT", "736"))
    scene = env.get("BENCH_SCENE", "sponza")
    frames = int(env.get("BENCH_FRAMES", "32"))
    filt = env.get("BENCH_FILTER")

    from .. import scenes
    from ..config import RenderConfig, resolve_device
    device = resolve_device(args.device)
    prepare(device)
    cfg = RenderConfig(width=width, height=height)
    with asset_tree() as assets:
        try:
            built = scenes.build(scene, cfg, device=device)
        except Exception as e:        # the JAX bench's fallback
            print(f"bench: {scene} did not build ({e!r}); helmet instead",
                  file=sys.stderr)
            scene = "helmet"
            built = scenes.build(scene, cfg, device=device)
        plan = built.plan
        if filt:
            plan = dataclasses.replace(plan, texture_filter=filt)
        timing, warm_s = bench(built, plan, frames)
    name = card_name(device)
    print(f"launches in {frames} timed frames: {timing.launches} "
          f"(path {timing.path}); calls that waited for the card: "
          f"{timing.syncs or 0}; untimed pass {warm_s:.1f} s; overflow "
          f"{sorted(set(timing.overflow))}", flush=True)
    ms = timing.ms
    line = {
        "metric": f"ms/frame {scene} {width}x{height} full deferred "
                  f"pipeline ({frames}-frame loop, {assets} assets, "
                  f"{name})",
        "value": round(ms, 3),
        "unit": "ms",
        "vs_baseline": round(TARGET_MS / ms, 4),
        "median_ms": timing.median_ms,
        "min_ms": min(timing.frame_ms),
        "max_ms": max(timing.frame_ms),
        "frames": frames,
        "peak_mib": timing.peak_mib,
        "device": name,
        "assets": assets,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
