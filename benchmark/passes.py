"""The program's own spans in a traced run, pass by pass.

The port wraps each pass of the frame, the per-frame host work and the
steps of ``scenes.build`` in ``utils/trace.span``: a host total that is
always kept, and while a profiler records, a FUNCTION-scope profiler
event named ``soc:<pass>`` (no mirror on the device line, unlike the
harness's own ``bench:`` spans).

- :func:`host_ms` and :func:`count` read, for the metric readers, the
  program's host totals and counters over the traced frames
  (``utils/trace.profiled``); None where the program has no such
  module.
- :func:`program_records` reduces a profiler run's events to, per
  ``soc:`` span, its host seconds, calls, device seconds (counted as
  :func:`benchmark.spans.records` counts a harness span's), launches,
  and the device-idle time that overlaps its host interval (children
  included); and the ten longest idle gaps of ``records``, in the same
  order with the same durations, each labelled
  ``<harness span>/<innermost soc: span>`` where a program span holds
  its middle.

    python3 benchmark/passes.py --workload <cell> --seed <n> \\
        --seconds <s> [--trace 0|1] [--out FILE]

runs the cell once (:func:`benchmark.harness.run`), prints the per-pass
table and writes it, with the run's line (and with ``--trace 1``, the
default, its records), as JSON to FILE.  Traced: per span its host,
device and idle ms and launches a traced frame (the profiler slows the
host 1.7-2.3x).  ``--trace 0``: per span its host ms a frame over the
window, at the host's own speed.  Both: the set-up's ``scenes.*``
seconds and the copy counters.
"""
import argparse
import bisect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "soc:"


def profiled():
    """The program's totals and counters over the latest stretch that a
    profiler recorded, or None where it keeps none."""
    try:
        from soc_real_time_renderer_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.profiled()


def _traced(rec):
    """(the program's profiled stretch, traced frames), or None."""
    frames = rec.get("frames")
    p = profiled() if frames else None
    return (p, frames) if p and p["totals"] else None


def host_ms(rec, span: str):
    """Host ms a traced frame inside the program's `span`, or None."""
    got = _traced(rec)
    t = got and got[0]["totals"].get(span)
    return t["host_s"] * 1e3 / got[1] if t else None


def count(rec, counter: str):
    """The program's `counter` a traced frame (0 is a reading), or None
    where the program traced nothing."""
    got = _traced(rec)
    return got[0]["counters"].get(counter, 0) / got[1] if got else None


def program_records(events, window_us: tuple) -> dict:
    """{"program": {name: {host_s, max_host_s (the longest call), calls,
    device_s, launches, idle_s}},
    "gaps_by_span": [[label, seconds]] * 10, "pass_idle_share": the
    share of frame.render's idle time under a pass span}."""
    import torch
    from benchmark import spans as spans_mod
    cuda = torch.autograd.DeviceType.CUDA
    w0, w1 = window_us
    soc, top, dev, cpu_ops = [], [], [], []
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if getattr(e, "device_type", None) == cuda:
            if not e.name.startswith((spans_mod.PREFIX, PREFIX)):
                dev.append((t0, t1))
            continue
        if e.name.startswith(PREFIX):
            soc.append((t0, t1, e.name[len(PREFIX):]))
        elif e.name.startswith(spans_mod.PREFIX) \
                and e.name[len(spans_mod.PREFIX):] in spans_mod.TOP:
            top.append((t0, t1, e.name[len(spans_mod.PREFIX):]))
        if getattr(e, "kernels", None):
            cpu_ops.append((t0, e))
    soc.sort(key=lambda s: s[0])
    starts = [s[0] for s in soc]
    prog: dict = {}
    for t0, t1, name in soc:
        r = prog.setdefault(name, {"host_s": 0.0, "max_host_s": 0.0,
                                   "calls": 0, "device_s": 0.0,
                                   "launches": 0, "idle_s": 0.0})
        r["host_s"] += (t1 - t0) * 1e-6
        r["max_host_s"] = max(r["max_host_s"], (t1 - t0) * 1e-6)
        r["calls"] += 1
    for t, e in cpu_ops:
        dur = sum(k.duration for k in e.kernels) * 1e-6
        n = sum(not spans_mod._is_copy(getattr(k, "name", ""))
                for k in e.kernels)
        for name in _holding(soc, starts, t):
            prog[name]["device_s"] += dur
            prog[name]["launches"] += n
    _, gaps = spans_mod._busy_and_gaps(sorted(
        (max(a, w0), min(b, w1)) for a, b in dev if b > w0 and a < w1),
        w0, w1)
    gap_ends = [b for _, b in gaps]
    for t0, t1, name in soc:
        i = bisect.bisect_right(gap_ends, t0)
        while i < len(gaps) and gaps[i][0] < t1:
            a, b = gaps[i]
            prog[name]["idle_s"] += (min(b, t1) - max(a, t0)) * 1e-6
            i += 1
    labelled = sorted(((_label(top, soc, starts, (a + b) / 2),
                        (b - a) * 1e-6) for a, b in gaps),
                      key=lambda g: -g[1])
    render = prog.get("frame.render", {}).get("idle_s", 0.0)
    under = sum(r["idle_s"] for n, r in prog.items()
                if n.startswith(("frame.proofs", "raster.", "shade.")))
    return {"program": prog,
            "gaps_by_span": [list(g) for g in labelled[:10]],
            "pass_idle_share": under / render if render > 0 else None}


def _holding(soc, starts, t):
    """The names of the spans in `soc` (sorted by start) that hold `t`,
    outermost first."""
    i = bisect.bisect_right(starts, t)
    return [name for t0, t1, name in soc[max(0, i - 128):i]
            if t0 <= t < t1]


def _label(top, soc, starts, t):
    from benchmark import spans as spans_mod
    outer = spans_mod._label(top, t)
    inner = _holding(soc, starts, t)
    return f"{outer}/{inner[-1]}" if inner else outer


def run(workload: str, seed: int, seconds: float, traced: bool,
        **kw) -> dict:
    """One run of `workload` through the harness (`kw`: more of
    :func:`benchmark.harness.run`'s arguments).  Traced: its events
    reduced by :func:`program_records`, with the harness's records.
    Untraced: the program's host ms and counters over the window's
    frames (no profiler: the host runs at its own speed)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness, spans as spans_mod
    from soc_real_time_renderer_tpu_torch.utils import trace
    real, snaps, seen = spans_mod.records, harness.Snapshots, {}

    def records(events, frames, window_us, *a, **kw):
        seen.update(events=events, window=window_us)
        seen["rec"] = real(events, frames, window_us, *a, **kw)
        return seen["rec"]

    class Snapshots(snaps):
        def __init__(self, *a, **kw):          # made as the window opens
            seen["opening"] = trace.snapshot()
            super().__init__(*a, **kw)

    spans_mod.records, harness.Snapshots = records, Snapshots
    try:
        line = harness.run(workload, seed, seconds, traced,
                           time.perf_counter(), **kw)
    finally:
        spans_mod.records, harness.Snapshots = real, snaps
    whole = trace.snapshot()
    out = dict(workload=workload, seed=seed, traced=traced, line=line,
               setup_spans={n: t["host_s"] for n, t
                            in seen["opening"]["totals"].items()
                            if n.startswith("scenes.")})
    if not traced:
        # the window's frames; the check after it runs no program span
        was = seen["opening"]
        out.update(frames=line["attempted"], program={
            n: {"host_s": t["host_s"] - was["totals"].get(
                    n, {"host_s": 0.0})["host_s"],
                "calls": t["calls"] - was["totals"].get(
                    n, {"calls": 0})["calls"]}
            for n, t in whole["totals"].items()
            if not n.startswith("scenes.")},
            counters={k: v - was["counters"].get(k, 0)
                      for k, v in whole["counters"].items()
                      if v != was["counters"].get(k, 0)})
        return out
    rec = seen["rec"]
    out.update(program_records(seen["events"], seen["window"]))
    out.update(frames=rec["frames"], harness_spans=rec["spans"],
               gaps=rec["gaps"], busy_s=rec["busy_s"],
               window_s=rec["window_s"], syncs=rec["syncs"],
               counters=trace.profiled()["counters"])
    return out


def table(out: dict) -> str:
    """The per-pass table, a frame (a traced frame where traced)."""
    f = out["frames"]
    if not out["traced"]:
        rows = [f"{out['workload']} seed {out['seed']}: {f} untraced "
                f"frames, frame_ms "
                f"{out['line']['metrics']['frame_ms']['value']:.2f}",
                "| span | calls | host ms |", "|---|---|---|"]
        rows += [f"| {n} | {r['calls'] / f:g} | "
                 f"{r['host_s'] * 1e3 / f:.3f} |"
                 for n, r in out["program"].items()]
        return "\n".join(rows)
    rows = [f"{out['workload']} seed {out['seed']}: {f} traced frames, "
            f"{out['window_s'] * 1e3 / f:.2f} ms a traced frame, idle "
            f"{100 * (1 - out['busy_s'] / out['window_s']):.1f}%; "
            f"idle of frame.render under a pass: "
            f"{out['pass_idle_share']}",
            "| span | calls | host ms | longest call ms | device ms | "
            "idle ms | launches |", "|---|---|---|---|---|---|---|"]
    for name, r in out["program"].items():
        rows.append(f"| {name} | {r['calls'] / f:g} | "
                    f"{r['host_s'] * 1e3 / f:.3f} | "
                    f"{r['max_host_s'] * 1e3:.3f} | "
                    f"{r['device_s'] * 1e3 / f:.3f} | "
                    f"{r['idle_s'] * 1e3 / f:.3f} | {r['launches'] / f:g} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    print(table(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
