"""The BASELINE table of the port: the seven configurations of the JAX
package's ``tools/bench_baselines.py`` through the bench's frame loop.

    python -m soc_real_time_renderer_tpu_torch.tools.bench_baselines \\
        [--frames 32] [--only 3,5,7] [--filter trilinear] \\
        [--cloud-impl perpixel] [--device cpu]

Each configuration builds its scene with the JAX tool's RenderConfig
arguments and runs ``bench.bench`` (staged globals, an untimed pass, N
timed frames with the launch counts checked).  One row each: ms per
frame (the loop over N), thousands of triangles, Mtris/s and Mpix/s as
the JAX tool prints them, then the median and spread of single frames,
the untimed pass's seconds, the kernels that launched and, with SSR on,
its active rays (and any call in the loop that waited for the card,
by call site).  The presets read the asset tree as ``tools/bench.py``
does (a synthetic one when the real files are absent; the header line
says which).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc

from . import bench as bench_mod

# BASELINE.json configs 1-7: (number, description, scene, RenderConfig
# arguments), as the JAX tools/bench_baselines.py lists them
CONFIGS = [
    (1, "helmet 640x360 G-buffer + direct light + tonemap only",
     "helmet", dict(width=640, height=384, shadow_resolution=1024,
                    enable_ssao=False, enable_bloom=False,
                    enable_clouds=False, enable_taa=False,
                    enable_auto_exposure=False, enable_hiz=False)),
    (2, "helmet + normal mapping + shadow map + SSAO, 1280x720",
     "helmet", dict(width=1280, height=736, shadow_resolution=4096,
                    enable_bloom=False, enable_clouds=False,
                    enable_taa=False, enable_auto_exposure=False,
                    enable_hiz=False)),
    (3, "sponza full screen-space stack, 1280x720",
     "sponza", dict(width=1280, height=736)),
    (4, "terrain + shadow + atmosphere sky, 1920x1080",
     "terrain", dict(width=1920, height=1088)),
    (5, "full scene (sponza+terrain+clouds+TAA+exposure), 1920x1080",
     "full", dict(width=1920, height=1088)),
    (6, "APPENDIX config-2 variant, helmet INSIDE sun volume "
        "(shadow raster actually pays)",
     "helmet_lifted", dict(width=1280, height=736, shadow_resolution=4096,
                           enable_bloom=False, enable_clouds=False,
                           enable_taa=False, enable_auto_exposure=False,
                           enable_hiz=False)),
    (7, "APPENDIX config-3 + SSR computed (reference parity mode)",
     "sponza", dict(width=1280, height=736, enable_ssr=True)),
]


def main(argv=None) -> list[dict]:
    """Print one row per configuration; returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--only", default="",
                    help="run a subset, comma-separated (e.g. 3,5,7)")
    ap.add_argument("--filter", default="",
                    help="override FramePlan.texture_filter")
    ap.add_argument("--cloud-impl", default="",
                    help="override RenderConfig.cloud_impl (lut/perpixel)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from .. import scenes
    from ..config import RenderConfig, resolve_device
    device = resolve_device(args.device)
    bench_mod.prepare(device)
    only = {int(s) for s in args.only.split(",") if s.strip()}
    rows = []
    with bench_mod.asset_tree() as assets:
        print(f"BASELINE configs, {args.frames} frames each, {assets} "
              f"assets, {bench_mod.card_name(device)}", flush=True)
        for num, desc, scene, kw in CONFIGS:
            if only and num not in only:
                continue
            built = scenes.build(scene, RenderConfig(**kw), device=device)
            plan = built.plan
            if args.filter:
                plan = dataclasses.replace(plan, texture_filter=args.filter)
            if args.cloud_impl:
                plan = dataclasses.replace(plan, config=plan.config.replace(
                    cloud_impl=args.cloud_impl))
            timing, warm_s = bench_mod.bench(built, plan, args.frames)
            cfg = plan.config
            ms = timing.ms
            tris = built.batch.num_triangles
            mpix = cfg.width * cfg.height / 1e6
            extra = ""
            if cfg.enable_ssr:
                extra = (f", ssr active {min(timing.ssr_active)}.."
                         f"{max(timing.ssr_active)} (cap {plan.ssr_cap})")
            if timing.syncs:
                extra += f", waited for the card {timing.syncs}"
            print(f"config {num}: {ms:8.2f} ms/frame  ({tris / 1e3:.0f}k "
                  f"tris, {tris * 1e3 / ms / 1e6:.0f} Mtris/s, "
                  f"{mpix * 1e3 / ms:.0f} Mpix/s, median "
                  f"{timing.median_ms:.2f} [{min(timing.frame_ms):.2f}.."
                  f"{max(timing.frame_ms):.2f}], untimed pass "
                  f"{warm_s:.1f}s, kernels {timing.path}{extra})  — {desc}",
                  flush=True)
            rows.append(dict(config=num, scene=scene, ms=ms,
                             median_ms=timing.median_ms,
                             min_ms=min(timing.frame_ms),
                             max_ms=max(timing.frame_ms),
                             triangles=tris, launches=timing.launches,
                             path=timing.path, syncs=timing.syncs,
                             overflow=timing.overflow,
                             ssr_active=timing.ssr_active))
            del built, timing
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
