"""A new configuration, traffic mix or per-layer metric is a new file
and a new entry: the registry finds each by name with no other edit."""
import json
import os
import shutil

import pytest

from benchmark import registry
from benchmark.traffic import Traffic


@pytest.fixture
def base(tmp_path):
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(registry.HERE, sub), tmp_path / sub)
    return str(tmp_path)


def test_a_dropped_in_traffic_file_is_found(base):
    with open(os.path.join(base, "traffic", "dolly.json"), "w") as f:
        json.dump({"camera": "fly", "cruise": {
            "keys": {"back": True}, "cursor_dx": [0],
            "segment_frames": [10]}}, f)
    t = Traffic(registry.traffic("dolly", base), 5)
    assert t.inputs(3) == {"back": True, "cursor_dx": 0.0}


def test_a_dropped_in_metric_file_is_found(base):
    with open(os.path.join(base, "metrics", "frames_traced.py"), "w") as f:
        f.write("def read(rec):\n    return rec.get('frames')\n")
    assert registry.metric_reader("frames_traced", base)({"frames": 7}) == 7


def test_a_dropped_in_config_file_is_found(base):
    with open(os.path.join(base, "configs", "helmet_720.json"), "w") as f:
        json.dump({"preset": "helmet", "width": 1280, "height": 736}, f)
    assert registry.config("helmet_720", base)["preset"] == "helmet"


def test_unknown_names_raise(base):
    for find in (registry.config, registry.traffic, registry.metric_reader):
        with pytest.raises(KeyError):
            find("no_such_name", base)


def test_the_cells_and_their_files():
    spec = registry.load_spec()
    names = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        registry.config(w["config"])
        registry.traffic(w["traffic"])
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))
    for m in spec["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in spec["workloads"]}
