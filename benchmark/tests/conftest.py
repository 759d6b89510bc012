"""The benchmark's own CPU tests (outside the repository's tier-1
``tests/``): ``python -m pytest benchmark/tests -q -p no:cacheprovider``
from the root of the checkout.  A tiny terrain cell (64x32, a 256^2
shadow map) runs the harness on the CPU through the port's plain
versions; the card's runs are the benchmark's own."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
BENCH = os.path.join(ROOT, "benchmark")


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(spec, base): a benchmark folder with the real traffic mixes and
    metric readers and one tiny cell, ``tiny.fly``, whose configuration
    is terrain_1080p's at 64x32 with its limits."""
    base = tmp_path_factory.mktemp("bench")
    for sub in ("traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), base / sub)
    os.makedirs(base / "configs")
    with open(os.path.join(BENCH, "configs", "terrain_1080p.json")) as f:
        cfg = json.load(f)
    cfg.update(width=64, height=32,
               render_config={"shadow_resolution": 256}, warmup_frames=1,
               trace_seconds=0.5)
    cfg["check"] = dict(cfg["check"], samples=1, within_frames=2)
    with open(base / "configs" / "tiny_terrain.json", "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"] = [{"name": "tiny.fly", "config": "tiny_terrain",
                          "traffic": "fly", "chips": 1, "why": "tests"}]
    for m in spec["per_layer"] + spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.fly"]
    return spec, str(base)
