"""The port's two table tools (tools/bench_toggle.py and
bench_baselines.py) on the CPU, their mains over the reduced terrain at
128x64, one frame a run, with tests/test_torch_bench.py's
``small_terrain`` (the reduced model, a small synthetic asset tree,
seeded sky LUTs).  The frame loop itself is held against the JAX
package in tests/test_torch_bench.py.
"""
import test_torch_bench as tb
from soc_real_time_renderer_tpu_torch.tools import bench_baselines
from soc_real_time_renderer_tpu_torch.tools import bench_toggle

small_terrain = tb.small_terrain


def test_toggle_prints_each_delta(small_terrain, capsys):
    """Two kept toggles and one the port drops, one frame a run: a line
    per toggle with its median delta and spread over three rounds, the
    dropped one "(unknown toggle)", the baseline last; each variant's
    path lacks its kernel."""
    res = bench_toggle.main(["--device", "cpu", "--scene", "terrain",
                             "--width", "128", "--height", "64",
                             "--frames", "1", "--toggles",
                             "taa,tex_none,ssao_xla"])
    out = capsys.readouterr().out.splitlines()
    assert sorted(res) == ["taa", "tex_none"]
    for name, lead, gone in (("taa", "-taa", "taa_resolve"),
                             ("tex_none", "tex_none", "texsample")):
        r = res[name]
        assert len(r["base_ms"]) == len(r["ms"]) == len(r["delta_ms"]) \
            == bench_toggle.ROUNDS
        assert gone not in r["path"] and "resolve" in r["path"]
        line = next(ln for ln in out if ln.startswith(lead + " "))
        assert "delta" in line and "spread" in line
    assert any(ln.startswith("ssao_xla") and "(unknown toggle)" in ln
               for ln in out)
    assert out[-1].startswith("baseline")


def test_baselines_prints_a_row(small_terrain, monkeypatch, capsys):
    """bench_baselines' main over one configuration (the reduced terrain
    at 128x64): its row, with the JAX tool's columns and the port's."""
    monkeypatch.setattr(bench_baselines, "CONFIGS", [
        (4, "terrain, reduced", "terrain", dict(width=128, height=64))])
    rows = bench_baselines.main(["--device", "cpu", "--frames", "1"])
    out = capsys.readouterr().out.splitlines()
    assert "synthetic assets" in out[0]
    assert [r["config"] for r in rows] == [4]
    assert rows[0]["triangles"] == 19602 and rows[0]["overflow"] == [0]
    row = next(ln for ln in out if ln.startswith("config 4:"))
    for part in ("ms/frame", "20k tris", "Mtris/s", "Mpix/s", "median",
                 "kernels", "terrain, reduced"):
        assert part in row, part
