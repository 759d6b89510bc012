"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

The cells, metrics and ``run_seconds`` are in ``BENCHMARK.json`` at the
root of the checkout; :mod:`benchmark.harness` says what a run does.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checked``: each number the check compared
beside its limit), and the last lines of standard error repeat the
compared numbers.  Without the CUDA cards the cell asks for it exits 3
and prints no result; on any other failure, or where the process holds
JAX or the JAX package once the run is over, it exits 1.
"""
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_START = time.perf_counter() - _process_age()
# top-level module names that no run may hold once its window has closed
JAX_MODULES = {"jax", "jaxlib", "flax", "soc_real_time_renderer_tpu"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one host thread for numpy's and PyTorch's CPU pools: the frame loop's
# host work is one thread, and idle pool threads that spin after each
# small call take the cores its dispatch runs on (run to run, frame_ms
# spread 18% with the default pools and 6% with one thread, H100 host)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# the build and kernel caches of anything the run compiles: fixed
# directories inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(ROOT, "build", "benchmark", sub)


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness
    try:
        line = harness.run(args.workload, args.seed, args.seconds,
                           bool(args.trace), PROCESS_START)
    except harness.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    loaded = sorted({m.split(".")[0] for m in sys.modules} & JAX_MODULES)
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}; the port "
              f"runs without JAX", file=sys.stderr)
        return 1
    for name, c in line["checked"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
