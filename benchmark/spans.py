"""Spans from the benchmark's own files, and the trace reduced to records.

:class:`Spans` wraps the calls into each layer: the harness's own calls
(``scenes.build``, ``BuiltScene.apply_input`` / ``frame_globals``, the
render function, the wait for the frame in flight) and the module
attributes ``graph.frame.raster_stage``, ``shade_stage`` and
``_sky_lut``, which ``render_frame`` looks up when it is called.  Each
span is a ``torch.profiler.record_function`` (so the profiler links the
kernels launched inside it) and a host-clock total.  The wrappers also
hand the visibility buffer and the sky LUT of a frame to the check when
asked (:attr:`Spans.capture`).

:func:`records` turns a ``torch.profiler`` run over the traced frames
into the plain dict that the metric readers (``metrics/*.py``) read.
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time

import torch

PREFIX = "bench:"
# the spans a frame's host time is divided into, for the idle gaps
TOP = ("apply_input", "frame_globals", "render_frame", "wait", "check",
       "snapshot")
NESTED = {"raster_stage": "raster_stage", "shade_stage": "shade_stage",
          "_sky_lut": "sky_lut"}


class Spans:
    def __init__(self):
        self.host_s: dict = {}
        self.capture: dict | None = None    # filled while not None
        self._undo = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            try:
                yield
            finally:
                self.host_s[name] = self.host_s.get(name, 0.0) \
                    + time.perf_counter() - t0

    def install(self, frame_module):
        """Wrap the frame module's stage functions (undone by
        :meth:`uninstall`)."""
        for attr, name in NESTED.items():
            real = getattr(frame_module, attr)

            def wrapped(*a, _real=real, _name=name, **kw):
                with self.span(_name):
                    out = _real(*a, **kw)
                if self.capture is not None:
                    if _name == "raster_stage":
                        self.capture["tri_id"] = out[0].tri_id
                    elif _name == "sky_lut":
                        self.capture["sky_lut"] = out
                return out

            setattr(frame_module, attr, wrapped)
            self._undo.append((frame_module, attr, real))

    def uninstall(self):
        for mod, attr, real in reversed(self._undo):
            setattr(mod, attr, real)
        self._undo.clear()


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def records(events, frames: int, window_us: tuple, port_kernels: set,
            syncs: dict) -> dict:
    """The traced frames as records: per span its host and device seconds
    and calls, per device operation its seconds, count and whether it is
    one of the port's own kernels (a name in `port_kernels`), the device's
    busy seconds, the idle gaps labelled by the span the host was in,
    and the calls that waited for the card (`syncs`: call site ->
    count).  `events`: ``prof.events()``; `window_us`: the traced
    window's (start, end) on the profiler's clock."""
    w0, w1 = window_us
    spans, dev, cpu_ops = [], [], []
    for e in events:
        is_dev = getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        t0, t1 = e.time_range.start, e.time_range.end
        if is_dev and e.name.startswith(PREFIX):
            continue                  # a span's mirror on the device line
        if is_dev:
            dev.append((t0, t1, e.name))
        elif e.name.startswith(PREFIX):
            spans.append((t0, t1, e.name[len(PREFIX):], e))
        if not is_dev and getattr(e, "kernels", None):
            cpu_ops.append((t0, e))
    span_rec: dict = {}
    for t0, t1, name, _ in spans:
        r = span_rec.setdefault(name, {"host_s": 0.0, "calls": 0,
                                       "device_s": 0.0})
        r["host_s"] += (t1 - t0) * 1e-6
        r["calls"] += 1
    # each launch's kernels count towards every span that holds its start
    spans.sort(key=lambda s: s[0])
    starts = [s[0] for s in spans]
    for t, e in cpu_ops:
        dur = sum(k.duration for k in e.kernels) * 1e-6
        i = bisect.bisect_right(starts, t)
        for t0, t1, name, _ in spans[max(0, i - 64):i]:
            if t0 <= t < t1:
                span_rec[name]["device_s"] += dur
    kernels: dict = {}
    for t0, t1, name in dev:
        k = kernels.setdefault(name[:200], {"s": 0.0, "n": 0, "port": False,
                                           "copy": _is_copy(name)})
        k["s"] += (t1 - t0) * 1e-6
        k["n"] += 1
        k["port"] = k["port"] or _port_kernel(name, port_kernels)
    busy, gaps = _busy_and_gaps(sorted((max(a, w0), min(b, w1))
                                       for a, b, _ in dev if b > w0
                                       and a < w1), w0, w1)
    top = [(t0, t1, n) for t0, t1, n, _ in spans if n in TOP]
    labelled = sorted(((_label(top, (a + b) / 2), (b - a) * 1e-6)
                       for a, b in gaps), key=lambda g: -g[1])
    return {"frames": frames, "window_s": (w1 - w0) * 1e-6,
            "busy_s": busy * 1e-6, "spans": span_rec, "kernels": kernels,
            "gaps": [list(g) for g in labelled[:10]],
            "syncs": dict(syncs)}


def _port_kernel(name: str, port_kernels: set) -> bool:
    words = set(re.findall(r"[A-Za-z_]\w*", name))
    return bool(words & port_kernels)


def _busy_and_gaps(intervals, w0, w1):
    """(union length, idle gaps) of sorted intervals inside [w0, w1]."""
    busy, gaps, end = 0.0, [], w0
    for a, b in intervals:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    return busy, gaps


def _label(top, t):
    for t0, t1, name in top:
        if t0 <= t <= t1:
            return name
    return "harness"


def port_kernel_names(package_dir: str) -> set:
    """The names of the port's own kernels: each ``__global__`` function
    of its CUDA sources and each ``@triton.jit`` function of its Python
    files."""
    import glob
    import os
    names = set()
    for path in glob.glob(os.path.join(package_dir, "**", "*.cu"),
                          recursive=True):
        with open(path) as f:
            names |= set(re.findall(
                r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(?:void\s+)?([A-Za-z_]\w*)\s*\(", f.read()))
    for path in glob.glob(os.path.join(package_dir, "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            names |= set(re.findall(r"@triton\.jit[^\n]*\n(?:@[^\n]*\n)*"
                                    r"def\s+([A-Za-z_]\w*)", f.read()))
    return names
