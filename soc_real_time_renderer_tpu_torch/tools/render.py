"""Headless renderer CLI of the port — the Application/main-loop analog.

Usage:
  python -m soc_real_time_renderer_tpu_torch.tools.render --scene full \
      --width 1920 --height 1088 --frames 3 --out out/frame.png \
      [--device cpu] [--dump-passes] [--no-shadows] [--pair-cap N]

The counterpart of the JAX package's ``tools/render.py``: builds the
scene preset (``scenes.build``; the glTF presets read ``SOC_ASSETS``),
runs N frames through ``render_frame`` and writes the last frame as a
PNG (and with ``--dump-passes`` every intermediate target beside it).
``--device`` replaces ``--platform``: the default is the CUDA card,
with no CPU fallback; ``--device cpu`` runs the plain PyTorch versions.
Frame times come from CUDA events on the card (the host clock on the
CPU).  A frame whose static caps overflowed prints a warning.
"""
from __future__ import annotations

import argparse
import os
import time

SCENES = ["helmet", "sponza", "terrain", "full", "helmet_lifted"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="helmet", choices=SCENES)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--out", default="out/frame.png")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--dump-passes", action="store_true")
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--pair-cap", type=int, default=None,
                    help="override BinGrid.pair_cap (debug: exercise "
                         "the overflow detector)")
    return ap.parse_args(argv)


def overflow_names(overflow: int) -> list[str]:
    """The names of the OVERFLOW_* bits set in `overflow`."""
    from ..ops import raster2, ssr
    return [name for bit, name in [(raster2.OVERFLOW_PAIRS, "PAIRS"),
                                   (raster2.OVERFLOW_MED_CAP, "MED_CAP"),
                                   (raster2.OVERFLOW_MED_SLOTS, "MED_SLOTS"),
                                   (ssr.OVERFLOW_SSR_CAP, "SSR_CAP")]
            if overflow & bit]


def dump_passes(base: str, outputs) -> None:
    """Every intermediate target of `outputs` as {base}_{name}.png."""
    import torch
    from ..utils import image_io
    gb = outputs.gbuffer
    v = gb.velocity
    for name, img in [
            ("albedo", gb.albedo), ("emissive", gb.emissive),
            ("normal", gb.normal * 0.5 + 0.5),
            ("depth", gb.depth[None].repeat(3, 1, 1)),
            ("velocity", torch.cat([v.abs() * 20.0,
                                    torch.zeros_like(v[:1])], 0)),
            ("hdr", outputs.hdr)]:
        image_io.save_png(f"{base}_{name}.png", img)
    if outputs.shadow_map is not None:
        image_io.save_png(f"{base}_shadow.png",
                          outputs.shadow_map[None].repeat(3, 1, 1))


def main(argv=None):
    """Run the CLI; returns the last frame's FrameOutputs."""
    args = parse_args(argv)
    import dataclasses

    import torch

    from .. import scenes
    from ..config import RenderConfig, resolve_device
    from ..graph import frame as frame_mod
    from ..utils import image_io

    device = resolve_device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height)
    if args.no_shadows:
        cfg = cfg.replace(enable_shadows=False)
    built = scenes.build(args.scene, cfg, device=device)
    if args.pair_cap is not None:
        built.plan = dataclasses.replace(
            built.plan,
            main_grid=dataclasses.replace(built.plan.main_grid,
                                          pair_cap=args.pair_cap),
            shadow_grid=dataclasses.replace(built.plan.shadow_grid,
                                            pair_cap=args.pair_cap))
    history = frame_mod.RenderHistory.create(built.plan.config,
                                             device=device)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    on_card = device.type == "cuda"
    t_first = None
    for i in range(args.frames):
        g, mm, nm = built.frame_globals(i)
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        outputs, history = frame_mod.render_frame(built.plan, built.batch, g,
                                                  history, mm, nm)
        if on_card:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        if i == 0:
            t_first = ms
        print(f"frame {i}: {ms:.2f} ms", flush=True)

    image_io.save_png(args.out, outputs.color)
    print(f"wrote {args.out} (first frame: {t_first:.0f} ms)")
    names = overflow_names(int(outputs.overflow))
    if names:
        print(f"WARNING: static caps overflowed ({'|'.join(names)}) — "
              f"fragments/SSR rays were dropped (MED_SLOTS: more "
              f"triangles span > med_slots bins than BinGrid.large_cap "
              f"holds); raise BinGrid caps or FramePlan.ssr_cap "
              f"(scenes.py)")
    if args.dump_passes:
        base = os.path.splitext(args.out)[0]
        dump_passes(base, outputs)
        print(f"dumped passes to {base}_*.png")
    return outputs


if __name__ == "__main__":
    main()
