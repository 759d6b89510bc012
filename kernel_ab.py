"""A/B of the hand-written kernels on the card: one scene's frame inputs
through two builds of the kernel sources, the checkout's ("this") and
another tree's ("other", e.g. the parent commit's), each held against
the plain version and timed on the card alone, alternating other, this,
this, other.

    mkdir -p build/other && git archive HEAD~1 \\
        soc_real_time_renderer_tpu_torch/kernels/csrc | tar -x -C build/other
    python3 kernel_ab.py \\
        --other build/other/soc_real_time_renderer_tpu_torch/kernels/csrc

The other tree's launch functions must take this tree's arguments (the
view count of the batched render and the row band of K1, K4 and K3
included): a tree from before those does not load.  K1 and K4 of the
other tree must also read this tree's records (``raster2.REC_ROWS``
rows, the pixel box among them): a tree whose kernels read 16-row
records misreads them, and its comparison with the plain version
fails.  Without ``--other`` the other build is the checkout's own
sources, which with ``--other-flags`` times a compile-time variant
against the default (K4's region of 32x8 pixels against its default
32x16):

    python3 kernel_ab.py --kernels resolve_depth --scenes atrium_lifted \\
        --other-flags=-DSOC_K4_TILES=1

Per scene (``chip_smoke``'s builds at 1920x1088) and kernel (default
K1, K4, K6 and K2; any of the six by name): the kernel's case from
``chip_smoke.kernel_cases`` on the frame's own inputs, each build
compared with the plain version there (``chip_smoke``'s tolerances) and
timed by ``utils/metrics.device_ms`` (median of 20 calls, L2 evicted before
each) and per wrapper call, twice each; the library call where the case
has one, between the builds.  For K1 and K4 also
the this-build's time on the frame's records with every bin but one made
empty (the heaviest bin; the heaviest bin counting only records with
some w > 0) and with every bin empty: how far one bin sets the kernel's
time.  For K6 also its launch alone, on a parameter block made
beforehand, without the wrapper's small PyTorch kernels around it.  Then
what the kernels sit in, per wrapper call with both builds in the same
turns: the whole frame (``render_frame``), the SSAO stage (preamble, K2,
blur, upsample) and, where the scene pays it, the sun shadow view's stage
(setup, binning, K4): whether a kernel's gain shows one and two layers
up.  The last line is one JSON object
with every reading.  Needs a card; imports nothing of JAX.
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
from soc_real_time_renderer_tpu_torch.utils.metrics import cuda_ms, \
    device_ms, l2_flush

REPS = 20


def other_library(csrc, flags=()):
    """The kernel library built from the .cu sources in `csrc` with the
    extra nvcc `flags`."""
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    sources = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    cs.check(sources, f"CUDA sources in {csrc}")
    lib = os.path.join(kb.BUILD_DIR, "other", "libsoc_kernels.so")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    report = kb.build(sources, lib, flags)
    for ln in report.splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            cs.log(f"  other build, ptxas: {ln.strip()}")
    # an older tree lacks K5's variants, K6p, the fused TAA resolve and
    # the local lights (none is A/B'd here)
    return kb.load(lib, optional={"texsample_variant_launch",
                                  "sky_lut_procedural_launch",
                                  "taa_resolve_launch",
                                  "local_lights_launch"})


def only_bin(starts, b):
    """`starts` with every bin but b empty (b keeps its record range)."""
    s = starts.clone()
    s[:b + 1] = starts[b]
    s[b + 1:] = starts[b + 1]
    return s


def resolve_tail(name, k, fn, starts, recs, grid, flush):
    """Resolve `fn` (K1's or K4's wrapper, this build) on the frame's
    records, on its heaviest bin alone, on its heaviest bin by live
    records alone, and on no records."""
    import torch
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
        fn(s, recs, grid, impl="cuda")
        t = device_ms(lambda: fn(s, recs, grid, impl="cuda"), REPS, flush)
        cs.check(t is not None, f"{k} timed on the card alone")
        cs.log(f"[{name}] {k} tail, {what}: {t:.4f} ms")
        out[what] = t
    return out


def path_ab(name, built, dev, libs, card):
    """The whole frame, the SSAO stage and the shadow view's stage with
    each build, ms per call (CUDA events, median of REPS), runs other,
    this, this, other."""
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    from soc_real_time_renderer_tpu_torch.ops import raster2, sampling, ssao
    plan, batch = built.plan, built.batch
    cfg = plan.config
    g, mm, nm = built.frame_globals(1, peek=True)
    hist = fm.RenderHistory.create(cfg, device=dev)
    gbuf = fm.render_frame(plan, batch, g, hist, mm, nm)[0].gbuffer

    def ssao_stage():
        half = ssao.ssao_generate(gbuf.depth, gbuf.normal, g,
                                  cfg.ssao_kernel_size)
        return sampling.upsample_bilinear(ssao.ssao_blur(half), cfg.height,
                                          cfg.width)

    runs = {"whole frame":
            lambda: fm.render_frame(plan, batch, g, hist, mm, nm),
            "SSAO stage (preamble, K2, blur, upsample)": ssao_stage}
    if "resolve_depth" in cs.path_of(plan, batch):
        world, _ = fm.transform_triangles(batch, mm, nm)
        sclip = fm._clip_of(world, g.sun.projection_view)
        runs["shadow view stage (setup, binning, K4)"] = \
            lambda: raster2.rasterize(sclip, plan.shadow_grid, cull="back",
                                      depth_only=True)
    out = {}
    try:
        for what, fn in runs.items():
            times = {lab: [] for lab in libs}
            for lab in ("other", "this", "this", "other"):
                kb._lib = libs[lab]
                fn()
                times[lab].append(cuda_ms(fn, REPS))
            cs.log(f"[{name}] {what}, ms per call (median of {REPS} each, "
                   f"runs other, this, this, other): other "
                   f"{times['other']}, this {times['this']} {card}")
            out[what] = times
    finally:
        kb._lib = libs["this"]
    return out


def scene_ab(name, dev, libs, kernels, card):
    import torch
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    from soc_real_time_renderer_tpu_torch.ops import raster2
    built = cs.build_scene(name, dev)
    _, cases = cs.kernel_cases(name, built, dev)
    seen = {}
    real = {"resolve": raster2.resolve,
            "resolve_depth": raster2.resolve_depth}

    def spy(k):               # records K1's / K4's inputs as its case calls
        def call(*a, **kw):
            seen.setdefault(k, a)
            return real[k](*a, **kw)
        return call

    for k in real:
        setattr(raster2, k, spy(k))
    try:
        out = {}
        flush = l2_flush(dev)
        for k in kernels:
            if k not in cases:
                continue
            call, cmp, _, lib, bare = cases[k]
            times = {lab: [] for lab in libs}
            per_call = {lab: [] for lab in libs}
            launch = {lab: [] for lab in libs}
            lib_times = []
            for order in (("other", "this"), ("this", "other")):
                for lab in order:
                    kb._lib = libs[lab]
                    got, want = call("cuda"), call("plain")
                    torch.cuda.synchronize()
                    _, msg, ok = cmp(got, want)
                    cs.log(f"[{name}] {k} {lab}: {msg}")
                    cs.check(ok, f"{name} {k} {lab} parity")
                    t = device_ms(lambda: call("cuda"), REPS, flush)
                    cs.check(t is not None, f"{k} timed on the card alone")
                    times[lab].append(t)
                    per_call[lab].append(cuda_ms(lambda: call("cuda"),
                                                    REPS))
                    if bare is not None:
                        launch[lab].append(device_ms(bare, REPS,
                                                        flush))
                    if lib is not None and lab == order[0]:
                        lib()
                        lib_times.append(device_ms(lib, REPS, flush))
            kb._lib = libs["this"]
            cs.log(f"[{name}] {k} on the card (ms, median of {REPS} each, "
                   f"runs other, this, this, other): other "
                   f"{times['other']}, this {times['this']}, library "
                   f"{lib_times or 'none'}; per wrapper call, its host "
                   f"time included: other {per_call['other']}, this "
                   f"{per_call['this']}; the launch alone, without the "
                   f"wrapper's other device work: other "
                   f"{launch['other'] or 'the same'}, this "
                   f"{launch['this'] or 'the same'} {card}")
            rec = {"other_ms": times["other"], "this_ms": times["this"],
                   "other_call_ms": per_call["other"],
                   "this_call_ms": per_call["this"],
                   "other_launch_ms": launch["other"] or None,
                   "this_launch_ms": launch["this"] or None,
                   "library_ms": lib_times or None,
                   "this_over_other": statistics.median(times["this"])
                   / statistics.median(times["other"])}
            if k in real:
                rec["tail_ms"] = resolve_tail(name, k, real[k], *seen[k],
                                              flush)
            out[k] = rec
    finally:
        for k in real:
            setattr(raster2, k, real[k])
        kb._lib = libs["this"]
    out["path_ms"] = path_ab(name, built, dev, libs, card)
    del built, cases
    torch.cuda.empty_cache()
    return out


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None,
                    help="directory of the other build's .cu sources "
                    "(default: the checkout's own)")
    ap.add_argument("--other-flags", default="",
                    help="extra nvcc flags of the other build, space "
                    "separated (e.g. -DSOC_K4_TILES=1)")
    ap.add_argument("--scenes", default="terrain,full_nohelmet,"
                    "atrium_lifted")
    ap.add_argument("--kernels",
                    default="resolve,resolve_depth,sky_lut,ssao_taps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this A/B needs a GPU")
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    card = f"[{cs.smi('name,power.limit')}]"
    cs.log(f"device {card}, torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    dev = torch.device("cuda:0")
    libs = {"this": kb.library(),
            "other": other_library(args.other or kb.CSRC,
                                   args.other_flags.split())}
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
