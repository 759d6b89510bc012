"""A/B of the hand-written kernels on the card: one scene's frame inputs
through two builds of the kernel sources, the checkout's ("this") and
another tree's ("other", e.g. the parent commit's), each held against
the plain version and timed on the card alone, alternating other, this,
this, other.

    mkdir -p build/other && git archive HEAD~1 \\
        soc_real_time_renderer_tpu_torch/kernels/csrc | tar -x -C build/other
    python3 kernel_ab.py \\
        --other build/other/soc_real_time_renderer_tpu_torch/kernels/csrc

Per scene (``chip_smoke``'s builds at 1920x1088) and kernel (default
K1 and K3): the kernel's case from ``chip_smoke.kernel_cases`` on the
frame's own inputs, each build compared with the plain version there
(``chip_smoke``'s tolerances) and timed by ``chip_smoke.device_ms``
(median of 20 calls, L2 evicted before each), twice each; the library
call where the case has one, between the builds.  For K1 also the
this-build's time on the frame's records with every bin but one made
empty (the heaviest bin; the heaviest bin counting only records with
some w > 0) and with every bin empty: how far one bin sets the kernel's
time.  The last line is one JSON object with every reading.  Needs a
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys
import traceback

import chip_smoke as cs

REPS = 20


def other_library(csrc):
    """The kernel library built from the .cu sources in `csrc`."""
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    sources = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    cs.check(sources, f"CUDA sources in {csrc}")
    lib = os.path.join(kb.BUILD_DIR, "other", "libsoc_kernels.so")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    kb.build(sources, lib)
    return kb.load(lib)


def only_bin(starts, b):
    """`starts` with every bin but b empty (b keeps its record range)."""
    s = starts.clone()
    s[:b + 1] = starts[b]
    s[b + 1:] = starts[b + 1]
    return s


def resolve_tail(name, starts, recs, grid, flush):
    """K1 (this build) on the frame's records, on its heaviest bin
    alone, on its heaviest bin by live records alone, and on no
    records."""
    import torch
    from soc_real_time_renderer_tpu_torch.ops import raster2
    n = int(starts[-1])
    per_bin = (starts[1:] - starts[:-1]).long()
    dead = ~(recs[12:15, :n] > 0).any(dim=0)
    pair_bin = torch.searchsorted(
        starts, torch.arange(n, dtype=starts.dtype, device=starts.device),
        right=True) - 1
    live = torch.zeros_like(per_bin).index_add_(
        0, pair_bin[~dead], torch.ones_like(pair_bin[~dead]))
    top, top_live = int(per_bin.argmax()), int(live.argmax())
    runs = {"all bins": starts,
            f"bin {top} alone ({int(per_bin[top])} pairs)":
                only_bin(starts, top),
            f"bin {top_live} alone ({int(per_bin[top_live])} pairs, "
            f"{int(live[top_live])} with some w > 0)":
                only_bin(starts, top_live),
            "no pairs": torch.zeros_like(starts)}
    out = {}
    for what, s in runs.items():
        raster2.resolve(s, recs, grid, impl="cuda")
        t = cs.device_ms(lambda: raster2.resolve(s, recs, grid, impl="cuda"),
                         REPS, flush)
        cs.check(t is not None, "K1 timed on the card alone")
        cs.log(f"[{name}] resolve tail, {what}: {t:.4f} ms")
        out[what] = t
    return out


def scene_ab(name, dev, libs, kernels, card):
    import torch
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    from soc_real_time_renderer_tpu_torch.ops import raster2
    built = cs.build_scene(name, dev)
    _, cases = cs.kernel_cases(name, built, dev)
    seen = {}
    real_resolve = raster2.resolve

    def spy(*a, **k):         # records K1's inputs as its case calls it
        seen.setdefault("resolve", a)
        return real_resolve(*a, **k)

    raster2.resolve = spy
    try:
        out = {}
        l2 = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
        for k in kernels:
            if k not in cases:
                continue
            call, cmp, _, lib = cases[k]
            times = {lab: [] for lab in libs}
            lib_times = []
            for order in (("other", "this"), ("this", "other")):
                for lab in order:
                    kb._lib = libs[lab]
                    got, want = call("cuda"), call("plain")
                    torch.cuda.synchronize()
                    _, msg, ok = cmp(got, want)
                    cs.log(f"[{name}] {k} {lab}: {msg}")
                    cs.check(ok, f"{name} {k} {lab} parity")
                    t = cs.device_ms(lambda: call("cuda"), REPS, l2.zero_)
                    cs.check(t is not None, f"{k} timed on the card alone")
                    times[lab].append(t)
                    if lib is not None and lab == order[0]:
                        lib()
                        lib_times.append(cs.device_ms(lib, REPS, l2.zero_))
            kb._lib = libs["this"]
            cs.log(f"[{name}] {k} on the card (ms, median of {REPS} each, "
                   f"runs other, this, this, other): other "
                   f"{times['other']}, this {times['this']}, library "
                   f"{lib_times or 'none'} {card}")
            rec = {"other_ms": times["other"], "this_ms": times["this"],
                   "library_ms": lib_times or None,
                   "this_over_other": statistics.median(times["this"])
                   / statistics.median(times["other"])}
            if k == "resolve":
                rec["tail_ms"] = resolve_tail(name, *seen["resolve"],
                                              l2.zero_)
            out[k] = rec
    finally:
        raster2.resolve = real_resolve
        kb._lib = libs["this"]
    del built, cases
    torch.cuda.empty_cache()
    return out


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="directory of the other build's .cu sources")
    ap.add_argument("--scenes", default="terrain,full_nohelmet,"
                    "atrium_lifted")
    ap.add_argument("--kernels", default="resolve,taa_reproject")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this A/B needs a GPU")
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    card = f"[{cs.smi('name,power.limit')}]"
    cs.log(f"device {card}, torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    dev = torch.device("cuda:0")
    libs = {"this": kb.library(), "other": other_library(args.other)}
    kernels = args.kernels.split(",")
    results = {name: scene_ab(name, dev, libs, kernels, card)
               for name in args.scenes.split(",")}
    print(json.dumps({"card": card, "results": results}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
