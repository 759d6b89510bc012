"""One run of one cell: set-up, the timed window, the check, the line.

The window is the viewer's real-time loop (``ui/server.render_loop``)
without its present step: each frame the traffic's camera input goes to
``BuiltScene.apply_input`` (or the preset's animation runs),
``BuiltScene.frame_globals(i, dt=1/60)`` makes the globals, and
``make_render_fn(plan)`` renders (``graph/frame.render_frame`` with its
proof checks, as the viewer calls it).  With a mix of several
``views`` a frame is the render farm's step instead: each view's
globals from ``parallel/mesh.view_globals`` (its own previous camera as
``camera_prev``), stacked by ``mesh.batched_globals`` with the history
of ``mesh.batched_history``, rendered at once by
``mesh.make_batched_render_fn(plan)``.  A CUDA event marks each frame's
end, and after frame n is issued the host waits for frame n - 1's: at
most two frames in flight.  The window lasts ``--seconds`` on the host
clock and ends with a synchronise.

Set-up (``setup_s``, process start to the first timed frame): imports,
the asset tree (written once into ``build/benchmark/assets``), the
kernel library (built once into ``build/torch_ext``), ``scenes.build``,
warm-up frames of the cell's own traffic, and a full garbage
collection; what survives it is frozen (``gc.freeze``) until the window
closes.

A frame that raises, sets an ``OVERFLOW_*`` bit or has a non-finite
colour counts in ``failed``.  Frames drawn from the seed, and the last,
are checked against the plain reference (:mod:`benchmark.check`) once
the window has closed and the peak memory has been read.

``--trace 1`` runs the first ``trace_seconds`` of the window under
``torch.profiler`` and ``torch.cuda.set_sync_debug_mode("warn")`` and
reports the cell's per-layer metrics from that part; the profiler's
chrome trace and the records the readers read go to the run's output
directory, ``build/benchmark/runs/<workload>.<seed>.<trace>``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import gzip
import os
import shutil
import subprocess
import sys
import time
import types
import warnings

import numpy as np

from . import check, registry, roofline, spans as spans_mod
from .traffic import Traffic

DT = 1.0 / 60.0
BUILD = os.path.join(registry.ROOT, "build", "benchmark")


class NoCard(RuntimeError):
    """The run needs more CUDA cards than the machine has."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Clock:
    """CUDA events on a card; the host clock on the CPU (tests only)."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Snapshots:
    """Copies of the sampled frames' targets, taken on a side stream into
    pinned host buffers made at set-up, so the window does not wait."""

    def __init__(self, positions, template: dict, clock: Clock):
        import torch
        self.torch = torch
        self.positions = list(positions)
        self.clock = clock
        self.taken: dict = {}
        if clock.cuda:
            self.stream = torch.cuda.Stream()
            self.slots = [{k: torch.empty(v.shape, dtype=v.dtype,
                                          pin_memory=True)
                           for k, v in template.items()}
                          for _ in self.positions]

    def take(self, n: int, targets: dict, meta: dict) -> None:
        torch = self.torch
        if not self.clock.cuda:
            self.taken[n] = ({k: v.clone() for k, v in targets.items()},
                             meta)
            return
        slot = self.slots[self.positions.index(n)]
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            for k, v in targets.items():
                slot[k].copy_(v, non_blocking=True)
                v.record_stream(self.stream)
        self.taken[n] = (slot, meta)

    def done(self) -> None:
        if self.clock.cuda:
            self.stream.synchronize()


def targets_of(out, history, prev, capture) -> dict:
    """The frame's targets that the check compares, and its inputs (of a
    batched step, each with its leading view axis)."""
    t = dict(tri_id=capture.get("tri_id"), sky_lut=capture.get("sky_lut"),
             depth=out.gbuffer.depth, albedo=out.gbuffer.albedo,
             normal=out.gbuffer.normal,
             metallic_roughness=out.gbuffer.metallic_roughness,
             velocity=out.gbuffer.velocity, emissive=out.gbuffer.emissive,
             bloom=out.bloom, ssao=out.ssao, clouds=out.clouds, hdr=out.hdr,
             ssr=out.ssr,
             exposure=history.exposure,
             history_color=history.previous_color,
             history_velocity=history.previous_velocity, color=out.color,
             prev_color=prev.previous_color,
             prev_velocity=prev.previous_velocity,
             prev_exposure=prev.exposure)
    return {k: v for k, v in t.items() if v is not None}


class Loop:
    """The frame loop of the window (and of the warm-up): one view a
    frame, or the traffic's views in one batched step."""

    def __init__(self, built, traffic: Traffic, spans, clock: Clock,
                 max_frames: int = 1 << 17):
        import torch
        from soc_real_time_renderer_tpu_torch.camera import InputState
        from soc_real_time_renderer_tpu_torch.graph import frame as fm
        self.torch, self.InputState = torch, InputState
        self.built, self.traffic, self.spans = built, traffic, spans
        self.views = traffic.views
        cfg = built.plan.config
        if self.views == 1:
            self.render = fm.make_render_fn(built.plan)
            self.history = fm.RenderHistory.create(cfg, device=built.device)
        else:
            from soc_real_time_renderer_tpu_torch.parallel import mesh
            self.mesh = mesh
            self.render = mesh.make_batched_render_fn(built.plan)
            self.history = mesh.batched_history([
                fm.RenderHistory.create(cfg, device=built.device)
                for _ in range(self.views)])
            self.positions = traffic.view_positions(built.camera_position,
                                                    built.camera_target)
            self.cameras = None      # each view's camera of the last step
        self.flags = torch.zeros(max_frames, dtype=torch.bool,
                                 device=built.device)
        self.k = 0          # traffic frames rendered (warm-up included)
        self.raised = 0
        self.clock = clock

    def frame(self, n: int):
        """Render traffic frame self.k, its flag into flags[n]; returns
        (g, model_mats, normal_mats, out, new_history, prev_history,
        capture), or None when it raised."""
        torch, sp = self.torch, self.spans
        k = self.k
        self.k += 1
        capture = {}
        sp.capture = capture
        try:
            inp = self.traffic.inputs(k)
            if inp is not None:
                with sp.span("apply_input"):
                    self.built.apply_input(self.InputState(**inp), DT)
            with sp.span("frame_globals"):
                g, mm, nm = self._globals(self.traffic.start_frame + k)
            prev = self.history
            with sp.span("render_frame"):
                out, self.history = self.render(self.built.batch, g, prev,
                                                mm, nm)
            outputs = capture.pop("outputs", None)
            if self.views > 1:
                # the step hands back its colour and history alone: the
                # other targets are shade_stage's outputs, taken at the seam
                out = dataclasses.replace(outputs, color=out)
            with sp.span("check"):
                self.flags[n] = (out.overflow != 0).any() \
                    | ~torch.isfinite(out.color).all()
        except Exception:                       # a failed frame, counted
            import traceback
            traceback.print_exc()
            self.raised += 1
            return None
        finally:
            sp.capture = None
        return g, mm, nm, out, self.history, prev, capture

    def _globals(self, i: int):
        """(g, model_mats, normal_mats) of traffic frame index i: the
        scene's, or the views' stacked, each view's camera_prev its own
        camera of the last step (at the first, its own camera)."""
        if self.views == 1:
            return self.built.frame_globals(i, DT)
        gs, mm, nm = self.mesh.view_globals(self.built, self.positions, i,
                                            self.cameras)
        if self.cameras is None:
            gs = [dataclasses.replace(g, camera_prev=g.camera) for g in gs]
        self.cameras = [g.camera for g in gs]
        return self.mesh.batched_globals(gs), mm, nm


def _smi() -> dict:
    """The card's name, power limit, SM clock and power draw (nvidia-smi),
    or {} where it does not answer."""
    q = "name,power.limit,clocks.sm,power.draw"
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return {}
    return dict(zip(("smi_name", "power_limit", "sm_clock", "power_draw"),
                    (s.strip() for s in line.split(","))))


def scene_data(built, cfg) -> types.SimpleNamespace:
    """The scene as data for the reference: the triangle stream, atlas
    and noise texture that the build packed, and the atlas's layout."""
    b, p = built.batch, built.plan
    return types.SimpleNamespace(
        tri_entity=b.tri_entity, tri_pos=b.tri_pos, tri_nrm=b.tri_nrm,
        tri_uv=b.tri_uv, static_rows=b.static_rows,
        atlas_packed=b.atlas_packed, cloud_noise=b.cloud_noise,
        atlas_size=p.atlas_size, atlas_layer_stride=p.atlas_layer_stride,
        atlas_n_levels=p.atlas_n_levels,
        texture_filter=cfg.get("texture_filter", "bilinear"))


def reference_poses(cfg: dict, traffic: Traffic, ks, b: int = 0) -> dict:
    """{traffic frame k: (view, position)} for each k in `ks` and k - 1,
    from the reference's own camera (of the step's view b)."""
    from .reference import globals as rg
    cam = cfg["camera"]
    want = sorted({k for k in ks} | {k - 1 for k in ks if k > 0})
    poses = {}
    if traffic.kind == "orbit":
        orbit = rg.Orbit(cam["position"], cam["target"],
                         turn=traffic.view_turn(b))
        for k in want:
            poses[k] = orbit.pose(traffic.start_frame + k, DT)
        return poses
    fly = rg.Fly(cam["position"], cam["target"])
    for k in range(max(want) + 1):
        pose = fly.pose(traffic.start_frame + k, DT, traffic.inputs(k))
        if k in want:
            poses[k] = (pose[0].copy(), pose[1].copy())
    return poses


def reference_check(cfg: dict, built, traffic: Traffic, samples, device,
                    control: bool = False, jobs: bool = False):
    """Per sampled frame, and per view of a batched step, the numbers of
    :func:`check.compare` (the program's targets, or with `control` the
    control's, against the reference), and with `jobs` the roofline
    jobs of the first, summed over its views.  The reference's globals
    carry the configuration's ``lights``, and its composition shades as
    many point and spot lights as those name.  Where the configuration's
    ``render_config`` sets ``enable_ssr``, the reference marches the
    program's depth and G-buffer, mixes in the program's ``ssr`` where
    ``composite_ssr``, and ``ssr`` is compared."""
    import torch
    from .reference import clouds as ref_clouds
    from .reference import frame as ref_frame
    from .reference import globals as rg
    rc = dict(cfg.get("render_config", {}))
    lights = None
    if "lights" in cfg:
        lights = rg.lights_of(cfg["lights"])
        rc.update(max_point_lights=int(lights.point_count),
                  max_spot_lights=int(lights.spot_count))
    rcfg = rg.RenderConfig(width=cfg["width"], height=cfg["height"], **rc)
    scene = scene_data(built, cfg)
    ks = [s["k"] for s in samples]
    poses = [reference_poses(cfg, traffic, ks, b)
             for b in range(traffic.views)]
    per_frame, frame_jobs = [], {} if jobs else None
    for s, b in ((s, b) for s in samples for b in range(traffic.views)):
        k = s["k"]
        i = traffic.start_frame + k
        cams = [rg.camera_matrices(*poses[b][j], traffic.start_frame + j,
                                   rcfg.width, rcfg.height)
                for j in (k, k - 1 if k > 0 else k)]
        g = rg.frame_globals(cams[0], cams[1], i, DT, device, lights)
        t, prog_g = s["targets"], s["g"]
        if traffic.views > 1:
            t = {n: v[b] for n, v in t.items()}
            prog_g = _view_of(prog_g, b)
        t = {n: v.to(device) for n, v in t.items()}
        mm, nm = (m.to(device) for m in s["mats"])
        vis = (t["depth"], t["tri_id"])
        # the program's G-buffer and reflections, which the reference's
        # SSR march and mix take (read only where enable_ssr)
        gbuf = {n: t[n] for n in ("albedo", "normal", "metallic_roughness")}
        ref = ref_frame.render(rcfg, scene, g, t["prev_color"],
                               t["prev_velocity"], t["prev_exposure"], mm,
                               nm, visibility=vis, gbuffer=gbuf,
                               ssr=t.get("ssr"))
        if control:
            g_low = rg.frame_globals(*(_bf16_tree(c) for c in cams), i, DT,
                                     device, lights)
            ctl = ref_frame.render(rcfg, scene, g_low, t["prev_color"],
                                   t["prev_velocity"], t["prev_exposure"],
                                   mm, nm, visibility=vis, control=True,
                                   gbuffer=gbuf, ssr=t.get("ssr"))
            prog = dict(ctl, globals=check.globals_gap(g_low, g))
        else:
            prog = dict(t, globals=check.globals_gap(prog_g, g))
        per_frame.append(check.compare(prog, ref))
        if jobs and s is samples[0]:
            # a batched step launches each kernel once for its views: its
            # jobs are the sum of every view's
            for name, ms in roofline.frame_jobs(rcfg, scene, g, ref,
                                                ref_clouds).items():
                frame_jobs[name] = frame_jobs.get(name, 0.0) + ms
        del ref, t
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return per_frame, frame_jobs


def _view_of(tree, b: int):
    """View `b` of a batched dataclass tree (each leaf's index b on its
    leading view axis)."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _view_of(getattr(tree, f.name), b)
            for f in dataclasses.fields(tree)})
    return tree[b]


def _bf16_tree(cam):
    """A host camera set rounded to bfloat16 (the control's globals)."""
    import torch
    return dataclasses.replace(cam, **{
        f.name: torch.from_numpy(np.asarray(getattr(cam, f.name)))
        .to(torch.bfloat16).to(torch.float32).numpy()
        for f in dataclasses.fields(cam)})


def prepare(wl: dict, cfg: dict, device: str = "cuda"):
    """The run's device, after checking that it has the cell's cards
    (NoCard) and making the environment every run shares: SOC_ASSETS
    (the configuration's ``assets``: "synthetic", the tree written once;
    "none", an empty directory, so no preset finds the cloud noise), TF32
    off, no autograd."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < wl["chips"]):
        raise NoCard(f"{wl['name']} needs {wl['chips']} CUDA card(s); "
                     f"torch sees {torch.cuda.device_count()}")
    os.makedirs(BUILD, exist_ok=True)
    from . import assets
    if cfg.get("assets", "synthetic") == "synthetic":
        tree = os.path.join(BUILD, "assets")
        t = time.perf_counter()
        if assets.ensure(tree):
            log(f"wrote the asset tree into {tree} in "
                f"{time.perf_counter() - t:.1f} s (first run of this "
                f"checkout)")
    else:
        tree = os.path.join(BUILD, "no_assets")
        os.makedirs(tree, exist_ok=True)
    os.environ["SOC_ASSETS"] = tree
    from soc_real_time_renderer_tpu_torch import scenes
    scenes.ASSETS = tree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    return dev


def build_scene(cfg: dict, dev):
    from soc_real_time_renderer_tpu_torch import scenes
    from soc_real_time_renderer_tpu_torch.config import RenderConfig
    return scenes.build(cfg["preset"], RenderConfig(
        width=cfg["width"], height=cfg["height"],
        **cfg.get("render_config", {})), device=dev)


def sample_positions(seed: int, chk: dict) -> list:
    """The window frames (counted from 0) whose targets the check takes,
    drawn from the seed."""
    rng = np.random.default_rng([int(seed), 2])
    return sorted(int(p) for p in rng.choice(
        np.arange(1, chk["within_frames"]), size=chk["samples"],
        replace=False))


def run(workload: str, seed: int, seconds: float, trace: bool,
        process_start: float, device: str = "cuda", spec=None,
        base: str = registry.HERE, out_dir: str | None = None) -> dict:
    """One run; returns the result line's object.  Raises NoCard when
    the cell's cards are not there (device "cpu" is for tests only)."""
    spec = spec or registry.load_spec()
    wl = registry.cell(spec, workload)
    cfg = registry.config(wl["config"], base)
    mix = registry.traffic(wl["traffic"], base)
    dev = prepare(wl, cfg, device)
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    sp = spans_mod.Spans()
    sp.install(fm)
    try:
        return _run(wl, cfg, mix, seed, seconds, trace, process_start, dev,
                    spec, sp, out_dir, base)
    finally:
        sp.uninstall()


def _run(wl, cfg, mix, seed, seconds, trace, process_start, dev, spec, sp,
         out_dir, base):
    import torch
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    clock = Clock(dev)
    chk = cfg["check"]
    with sp.span("scene_build"):
        built = build_scene(cfg, dev)
    traffic = Traffic(mix, seed)
    loop = Loop(built, traffic, sp, clock)
    positions = sample_positions(seed, chk)
    warm = None
    for w in range(cfg["warmup_frames"]):
        warm = loop.frame(w)
    if warm is None:
        raise RuntimeError("the warm-up's last frame failed")
    snaps = Snapshots(positions, targets_of(*warm[3:]), clock)
    del warm
    if kb.build_seconds is not None:
        log(f"built the kernel library in {kb.build_seconds:.1f} s (first "
            f"run of this checkout)")
    # set-up's garbage collected now, and what survives set apart from
    # the collector until the window closes: no gen-2 pass over the
    # scene's objects lands in the window (or in its traced part)
    gc.collect()
    gc.freeze()
    clock.sync()
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    loop.flags.zero_()
    loop.raised = 0
    setup_s = time.perf_counter() - process_start

    # ---- the window
    prof = None
    stack = contextlib.ExitStack()
    caught = []
    trace_s = cfg.get("trace_seconds", 3.0) if trace else 0.0
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if clock.cuda else [])
        prof = stack.enter_context(profile(activities=acts))
        caught = stack.enter_context(warnings.catch_warnings(record=True))
        warnings.simplefilter("always")
        if clock.cuda:
            torch.cuda.set_sync_debug_mode("warn")
        stack.enter_context(sp.span("traced"))
    traced = None
    marks = [clock.mark()]
    last = None
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        res = loop.frame(n)
        marks.append(clock.mark())
        if res is not None:
            g, mm, nm, out, hist, prev, capture = res
            meta = dict(k=loop.k - 1, g=g, mats=(mm, nm))
            if n in positions:
                with sp.span("snapshot"):
                    snaps.take(n, targets_of(out, hist, prev, capture), meta)
            last = (n, targets_of(out, hist, prev, capture), meta)
            del g, mm, nm, out, hist, prev, capture, res
        if n >= 1:
            with sp.span("wait"):
                clock.wait(marks[n])
        n += 1
        if prof is not None and time.perf_counter() - t0 >= trace_s:
            clock.sync()
            if clock.cuda:
                torch.cuda.set_sync_debug_mode("default")
            stack.close()
            traced = n
            prof_events = prof.events()
            prof_obj, prof = prof, None
    clock.sync()
    window_s = time.perf_counter() - t0
    if prof is not None:              # the window ended inside the trace
        if clock.cuda:
            torch.cuda.set_sync_debug_mode("default")
        stack.close()
        traced = n
        prof_events = prof.events()
        prof_obj = prof
    gc.unfreeze()
    snaps.done()
    frame_int = [clock.ms(marks[j], marks[j + 1]) for j in range(n)]
    peak = torch.cuda.max_memory_allocated(dev) if clock.cuda else 0
    failed = int(loop.flags[:n].sum()) + loop.raised
    smi = _smi() if clock.cuda else {}

    # ---- the check, after the window, with the program's frames freed
    # but for the sampled ones
    loop.history = None
    samples = [dict(k=meta["k"], g=meta["g"], mats=meta["mats"],
                    targets=tg)
               for _, (tg, meta) in sorted(snaps.taken.items())]
    if last is not None and last[0] not in snaps.taken:
        samples.append(dict(k=last[2]["k"], g=last[2]["g"],
                            mats=last[2]["mats"], targets=last[1]))
    del last
    t_chk = time.perf_counter()
    per_frame, jobs = reference_check(cfg, built, traffic, samples, dev,
                                      jobs=trace)
    numbers = check.worst(per_frame) if per_frame else {}
    ok, shown = check.judge(numbers, chk.get("limits", {}))
    log(f"checked {len(per_frame)} frames against the reference in "
        f"{time.perf_counter() - t_chk:.1f} s")

    window = dict(window_s=window_s, frames=n, frame_intervals_ms=frame_int,
                  peak_bytes=peak, setup_s=setup_s)
    metrics, breakdown, dev_info = {}, None, {}
    if trace:
        rec = spans_mod.records(
            prof_events, traced, _traced_window(prof_events),
            spans_mod.port_kernel_names(_package_dir()),
            collections.Counter(f"{w.filename}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message)))
        rec["scene_build_s"] = sp.host_s.get("scene_build")
        rec["jobs_ms"] = jobs or {}
        _write_run(out_dir, wl["name"], seed, prof_obj, rec)
        kinds = registry.metrics_of(spec, wl["name"], "per_layer")
        breakdown = {"device_ops": sorted(
            ([k, v["s"]] for k, v in rec["kernels"].items()),
            key=lambda x: -x[1])[:10], "idle_gaps": rec["gaps"]}
        dev_info = dict(busy_s=rec["busy_s"], window_s=rec["window_s"])
        source = rec
    else:
        kinds = registry.metrics_of(spec, wl["name"], "end_to_end")
        source = window
    for m in kinds:
        v = registry.metric_reader(m["name"], base)(source)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if clock.cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if clock.cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak),
                   **dev_info, **smi}
    line = {"correct": bool(ok and failed == 0 and n > 0),
            "attempted": n, "failed": failed, "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checked"] = dict(shown, failed_frames={"value": failed,
                                                 "limit": 0})
    return line


def _traced_window(events) -> tuple:
    for e in events:
        if e.name == spans_mod.PREFIX + "traced":
            return e.time_range.start, e.time_range.end
    raise RuntimeError("the trace holds no traced-window span")


def _package_dir() -> str:
    import soc_real_time_renderer_tpu_torch as pkg
    return os.path.dirname(os.path.abspath(pkg.__file__))


def _write_run(out_dir, workload, seed, prof, rec) -> None:
    out_dir = out_dir or os.path.join(BUILD, "runs",
                                      f"{workload}.{seed}.trace")
    os.makedirs(out_dir, exist_ok=True)
    raw = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as src, gzip.open(raw + ".gz", "wb",
                                           compresslevel=1) as dst:
        shutil.copyfileobj(src, dst)
    os.remove(raw)
    with open(os.path.join(out_dir, "records.json"), "w") as f:
        json.dump(rec, f, indent=1)
    log(f"trace and records in {out_dir}")

