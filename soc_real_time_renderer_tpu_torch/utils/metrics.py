"""Per-pass timers out of the frame, and the HUD's categories.

Counterpart of the JAX package's ``utils/metrics.py``.  The reference
brackets every task of the live frame with timestamp queries
(``utils/gpu_metric.{hpp,cpp}``: start/end per task, elapsed ms
readback) and plots them grouped by category (``renderer.cpp:517-588,
769-806``).  The port's live per-pass timings are ``utils/trace``'s
device clock (CUDA events at the edges of each pass of every frame,
read back without waiting; the viewer's ``/metrics`` groups them with
:attr:`GPUMetricPool.CATEGORIES`).  :meth:`GPUMetric.measure` instead
times a pass's function out of the frame: two CUDA events around
`iters` calls after one warm call; only a caller that asks for
``device="cpu"`` gets the host clock instead.  A missing card raises
(``config.resolve_device``).

:func:`cuda_ms`, :func:`device_ms` and :func:`l2_flush` time one call on
the card, per call (the host's launch path included) and on the card
alone; ``chip_smoke.py``, ``kernel_ab.py`` and the texture-tap benches
(``tools/bench_texsample.py``, ``bench_texkernel_parts.py``,
``bench_texmm2.py``) share them.
"""
from __future__ import annotations

import statistics
import time
from collections import deque

import numpy as np
import torch

from ..config import resolve_device


L2_FLUSH_BYTES = 96 << 20   # twice the H100's 50 MB L2


def cuda_ms(fn, reps):
    """Median ms of fn() over `reps` runs, one CUDA-event pair each (the
    host's launch path included where it outlasts the card's work)."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def l2_flush(device):
    """A callable that writes L2_FLUSH_BYTES on `device`: after it, a
    call finds its inputs in device memory, as a frame's pass does."""
    return torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                       device=device).zero_


def device_ms(fn, reps, flush):
    """Median device ms of fn() over `reps` calls, each after `flush`
    (:func:`l2_flush`), all enqueued behind a sleeping kernel (2^26
    cycles, ~34 ms at 1.98 GHz): the events then time the card's work
    alone, not the host's launch path, which costs a kernel wrapper tens
    of microseconds, as long as the kernels it times.  None when fn
    waits for the card (the enqueueing outlasted the sleep): no number
    is then taken."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * reps + 2)]
    torch.cuda.synchronize()
    ev[-1].record()
    torch.cuda._sleep(1 << 26)
    ev[0].record()
    t0 = time.perf_counter()
    for i in range(reps):
        flush()
        ev[2 * i + 1].record()
        fn()
        ev[2 * i + 2].record()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if ev[-1].elapsed_time(ev[0]) <= host:
        return None
    return statistics.median(ev[2 * i + 1].elapsed_time(ev[2 * i + 2])
                             for i in range(reps))


class ScrollingBuffer:
    """Fixed-capacity metric history (utils/scrolling_buffer.hpp:4-23)."""

    def __init__(self, capacity: int = 2000):
        self.capacity = capacity
        self.data = deque(maxlen=capacity)

    def add_point(self, t, value):
        self.data.append((t, value))

    def erase(self):
        self.data.clear()

    def as_arrays(self):
        if not self.data:
            return np.zeros(0), np.zeros(0)
        a = np.asarray(self.data)
        return a[:, 0], a[:, 1]


class GPUMetric:
    """One pass timer (gpu_metric.hpp GPUMetric)."""

    def __init__(self, name: str):
        self.name = name
        self.time_elapsed = 0.0       # ms, like GPUMetric::time_elapsed
        self.history = ScrollingBuffer()

    def measure(self, fn, *args, iters: int = 8, device=None):
        """ms per call of fn(*args): one warm call, then `iters` calls
        between two CUDA events on `device` (default: the CUDA card; the
        host clock only for device="cpu")."""
        device = resolve_device(device)
        if device.type == "cuda":
            with torch.cuda.device(device):
                fn(*args)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(*args)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
        else:
            fn(*args)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            ms = (time.perf_counter() - t0) * 1e3
        self.time_elapsed = ms / iters
        self.history.add_point(time.time(), self.time_elapsed)
        return self.time_elapsed


class GPUMetricPool:
    """Named metric registry (gpu_metric.hpp GPUMetricPool), with the
    reference's category grouping (renderer.cpp:558-588)."""

    CATEGORIES = {
        "depth prepass": "Geometry", "shadow": "Shadows",
        "g-buffer": "Geometry", "terrain": "Geometry",
        "bloom": "Bloom", "ssao": "SSAO", "ssr": "Reflections",
        "clouds": "Sky", "composition": "Lighting",
        "luminance": "Exposure", "taa": "AntiAliasing",
        "tonemap": "PostProcess",
    }

    def __init__(self):
        self.metrics: dict[str, GPUMetric] = {}

    def get(self, name: str) -> GPUMetric:
        if name not in self.metrics:
            self.metrics[name] = GPUMetric(name)
        return self.metrics[name]

    def category_totals(self):
        out: dict[str, float] = {}
        for name, m in self.metrics.items():
            cat = next((c for k, c in self.CATEGORIES.items() if k in name),
                       "Other")
            out[cat] = out.get(cat, 0.0) + m.time_elapsed
        return out

    def table(self):
        return {name: round(m.time_elapsed, 3)
                for name, m in self.metrics.items()}
