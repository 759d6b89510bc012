"""In-frame attribution of the port: the bench's frame loop with one pass
toggled at a time, the counterpart of the JAX package's
``tools/bench_toggle.py``.

    python -m soc_real_time_renderer_tpu_torch.tools.bench_toggle \\
        [--scene full --width 1920 --height 1088 | --config N] \\
        [--toggles shadows,ssao,...] [--frames 16] [--device cpu]

The variants derive from the scene build's tuned ``plan.config`` (its
scene-true light counts; the JAX tool's rule).  Kept toggles: the passes
``shadows``, ``ssao``, ``bloom``, ``clouds``, ``taa``,
``auto_exposure`` and ``hiz`` (each switched off), and the texture
filters ``tex_nearest``, ``tex_trilinear`` and ``tex_none`` (the
attribution probe: a constant texel, no atlas tap; K9 still launches).
The JAX tool's ``ssao_xla`` (TPU-only), ``stub_*`` and ``unlit``
(``FramePlan.stub``) and ``no_visbar`` / ``visbar_nohiz`` (barriers)
have no job in the port and print ``(unknown toggle)``, as any other
unknown name does.

Where the JAX tool times each variant in a scan of its own against one
base, here base and variant alternate in one process, over ROUNDS
rounds (base, v, v, base, base, v), each run from a fresh history after
one untimed run of each plan; every run is ``bench.run`` with its
launch check.  Per toggle it prints the variant's median ms per frame
and the median of the per-round deltas (base minus variant, the JAX
sign: what the pass costs) with their spread.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics

from . import bench as bench_mod

# the BASELINE presets of the JAX tools/bench_toggle.py: (scene,
# RenderConfig arguments)
PRESETS = {
    1: ("helmet", dict(width=640, height=384, shadow_resolution=1024,
                       enable_ssao=False, enable_bloom=False,
                       enable_clouds=False, enable_taa=False,
                       enable_auto_exposure=False, enable_hiz=False)),
    2: ("helmet", dict(width=1280, height=736, shadow_resolution=4096,
                       enable_bloom=False, enable_clouds=False,
                       enable_taa=False, enable_auto_exposure=False,
                       enable_hiz=False)),
    3: ("sponza", dict(width=1280, height=736)),
    4: ("terrain", dict(width=1920, height=1088)),
    5: ("full", dict(width=1920, height=1088)),
    6: ("helmet_lifted", dict(width=1280, height=736,
                              shadow_resolution=4096,
                              enable_bloom=False, enable_clouds=False,
                              enable_taa=False,
                              enable_auto_exposure=False,
                              enable_hiz=False)),
}
# pass toggles: the RenderConfig switch each turns off
PASSES = {"shadows": "enable_shadows", "ssao": "enable_ssao",
          "bloom": "enable_bloom", "clouds": "enable_clouds",
          "taa": "enable_taa", "auto_exposure": "enable_auto_exposure",
          "hiz": "enable_hiz"}
FILTERS = ("nearest", "trilinear", "none")
KEPT = tuple(PASSES) + tuple(f"tex_{f}" for f in FILTERS)
ROUNDS = 3


def variants(plan) -> dict:
    """toggle name -> the plan with that toggle applied to `plan`."""
    cfg0 = plan.config
    out = {name: dataclasses.replace(plan,
                                     config=cfg0.replace(**{flag: False}))
           for name, flag in PASSES.items()}
    out.update({f"tex_{f}": dataclasses.replace(plan, texture_filter=f)
                for f in FILTERS})
    return out


def main(argv=None) -> dict:
    """Print the baseline and each toggle's delta; returns {toggle:
    {"base_ms", "ms", "delta_ms": per round, "path"}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="full")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--config", type=int, default=0,
                    help="use BASELINE config N's scene + flags "
                         "(overrides --scene/--width/--height)")
    ap.add_argument("--toggles", default=",".join(KEPT))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from .. import scenes
    from ..config import RenderConfig, resolve_device
    device = resolve_device(args.device)
    bench_mod.prepare(device)
    if args.config:
        scene, kw = PRESETS[args.config]
    else:
        scene, kw = args.scene, dict(width=args.width, height=args.height)
    results = {}
    with bench_mod.asset_tree() as assets:
        built = scenes.build(scene, RenderConfig(**kw), device=device)
        base = built.plan
        cfg = base.config
        print(f"{scene} {cfg.width}x{cfg.height}, {args.frames} frames a "
              f"run, {ROUNDS} rounds, {assets} assets, "
              f"{bench_mod.card_name(device)}", flush=True)
        staged = bench_mod.stage(built, base, args.frames)
        bench_mod.run(built, base, staged)                # untimed
        plans = variants(base)
        base_runs = []
        for name in args.toggles.split(","):
            if name not in plans:
                print(f"{name:24s} (unknown toggle)", flush=True)
                continue
            plan = plans[name]
            bench_mod.run(built, plan, staged)            # untimed
            b_ms, v_ms = [], []
            for r in range(ROUNDS):
                order = ((base, b_ms), (plan, v_ms))
                for p, into in (order if r % 2 == 0 else order[::-1]):
                    into.append(bench_mod.run(built, p, staged).ms)
            base_runs += b_ms
            path = bench_mod.kernel_path(plan, built.batch)
            delta = [b - v for b, v in zip(b_ms, v_ms)]
            tag = name if name.startswith("tex_") else "-" + name
            print(f"{tag:24s} {statistics.median(v_ms):8.2f} ms/frame  "
                  f"delta {statistics.median(delta):+8.2f}  [spread "
                  f"{min(delta):+.2f}..{max(delta):+.2f} over {ROUNDS} "
                  f"rounds; kernels {path}]", flush=True)
            results[name] = dict(base_ms=b_ms, ms=v_ms, delta_ms=delta,
                                 path=path)
        if base_runs:
            print(f"{'baseline':24s} {statistics.median(base_runs):8.2f} "
                  f"ms/frame  [{min(base_runs):.2f}..{max(base_runs):.2f} "
                  f"over {len(base_runs)} runs; kernels "
                  f"{bench_mod.kernel_path(base, built.batch)}]", flush=True)
    return results


if __name__ == "__main__":
    main()
