"""The benchmark imports the port and nothing else of the repository: no
jax, no JAX package, no chip_smoke.py, no tools/, no repo-level bench."""
import ast
import glob
import os
import subprocess
import sys

from benchmark import registry

FORBIDDEN = ("jax", "soc_real_time_renderer_tpu", "chip_smoke", "tools",
             "bench", "kernel_ab")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_forbidden_import_in_the_benchmark():
    files = [p for p in glob.glob(os.path.join(registry.HERE, "**", "*.py"),
                                  recursive=True)
             if os.sep + "tests" + os.sep not in p]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(registry.HERE, "reference", "*.py")):
        for mod in _imports(path):
            assert not mod.startswith("soc_real_time_renderer"), (path, mod)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark import harness, calibrate, check, roofline; "
            "from benchmark.reference import frame; "
            "import soc_real_time_renderer_tpu_torch.scenes; "
            "print('jax' in sys.modules)" % registry.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=registry.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
