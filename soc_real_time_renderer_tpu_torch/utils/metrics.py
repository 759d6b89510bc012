"""Per-pass timing harness: the GPUMetric/ImPlot HUD analog.

Counterpart of the JAX package's ``utils/metrics.py``.  The reference
brackets every task with timestamp queries
(``utils/gpu_metric.{hpp,cpp}``: start/end per task, elapsed ms
readback) and plots them grouped by category (``renderer.cpp:517-588,
769-806``).  Here :meth:`GPUMetric.measure` times a pass's function with
two CUDA events around `iters` calls after one warm call; only a caller
that asks for ``device="cpu"`` gets the host clock instead.  A missing
card raises (``config.resolve_device``).
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from ..config import resolve_device


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
