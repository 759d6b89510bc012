"""The readings that the check's limits are set from, for one cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control] [--out FILE]

In one process (the scene built once): for each seed, the cell's traffic
from that seed through the timed path's frame loop (warm-up, then the
window's frames up to the last sampled one, with no clock), the sampled
frames that a run with that seed checks, and per frame (per view of a
batched step) the check's numbers of the program against the reference
(the lower readings) and, with ``--control``, of the control (the
reference one precision step below,
``reference.frame.render(control=True)``) against the reference (the
upper readings).  One JSON line per seed; a benchmark run never calls
this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seeds, control: bool, device: str = "cuda",
             spec=None, base=None):
    """Yields {"seed", "failed", "program": numbers, "control": numbers}
    per seed."""
    from benchmark import check, harness, registry, spans as spans_mod
    from benchmark.traffic import Traffic
    base = base or registry.HERE
    spec = spec or registry.load_spec()
    wl = registry.cell(spec, workload)
    cfg = registry.config(wl["config"], base)
    mix = registry.traffic(wl["traffic"], base)
    dev = harness.prepare(wl, cfg, device)
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    sp = spans_mod.Spans()
    sp.install(fm)
    try:
        built = harness.build_scene(cfg, dev)
        clock = harness.Clock(dev)
        for seed in seeds:
            for attr in ("_fly", "_prev_cam"):   # a fresh camera per seed
                if hasattr(built, attr):
                    delattr(built, attr)
            traffic = Traffic(mix, seed)
            loop = harness.Loop(built, traffic, sp, clock)
            positions = harness.sample_positions(seed, cfg["check"])
            for w in range(cfg["warmup_frames"]):
                loop.frame(w)
            samples = []
            for n in range(max(positions) + 1):
                res = loop.frame(n)
                if res is not None and n in positions:
                    g, mm, nm, out, hist, prev, capture = res
                    samples.append(dict(
                        k=loop.k - 1, g=g, mats=(mm, nm),
                        targets={k: v.clone() for k, v in harness.targets_of(
                            out, hist, prev, capture).items()}))
            clock.sync()
            failed = int(loop.flags[:max(positions) + 1].sum()) + loop.raised
            prog, _ = harness.reference_check(cfg, built, traffic, samples,
                                              dev)
            row = {"seed": seed, "failed": failed,
                   "program": check.worst(prog)}
            if control:
                ctl, _ = harness.reference_check(cfg, built, traffic,
                                                 samples, dev, control=True)
                row["control"] = check.worst(ctl)
            yield row
    finally:
        sp.uninstall()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    t0 = time.perf_counter()
    for row in readings(args.workload, seeds, args.control):
        row["workload"] = args.workload
        row["t"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
