"""Everything of one cell is found by name, in files of its own.

- ``BENCHMARK.json`` (the root of the checkout): the cells, the metrics,
  ``run_seconds``.
- ``configs/<config>.json``: a configuration (preset, size, the
  ``RenderConfig`` overrides, the frames the check samples and its
  limits).
- ``traffic/<mix>.json``: a traffic mix, the parameters that
  :mod:`benchmark.traffic`'s one generator reads.
- ``metrics/<metric>.py``: one per-layer metric, a module with
  ``read(records) -> float | None``.

A later cell, mix or metric is a new file and a new entry: no existing
file changes.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(folder: str, name: str, base: str) -> dict:
    path = os.path.join(base, folder, f"{name}.json")
    if not os.path.exists(path):
        raise KeyError(f"no {folder[:-1] if folder.endswith('s') else folder}"
                       f" named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def config(name: str, base: str = HERE) -> dict:
    return _json("configs", name, base)


def traffic(name: str, base: str = HERE) -> dict:
    return _json("traffic", name, base)


def metric_reader(name: str, base: str = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(base, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no metric reader named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def metrics_of(spec: dict, workload: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics that `workload`
    reports: those without a ``workloads`` list, and those that name it."""
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]
