"""The entry point: no card, no result; a checkout of the benchmark
alone, no result."""
import os
import shutil
import subprocess
import sys

from benchmark import registry

ARGS = ["--workload", "full_1080p.orbit", "--seed", str(2 ** 31 + 9),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          capture_output=True, text=True, timeout=600,
                          cwd=cwd, env=dict(os.environ,
                                            CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_it_fails_and_prints_no_result():
    out = _run(registry.ROOT)
    assert out.returncode == 3
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout == ""
