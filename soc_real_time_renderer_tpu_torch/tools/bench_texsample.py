"""Time the material tap on a real frame's tap fields: K5 in each filter
mode, the plain gather, and the G-buffer stage around them.

    python -m soc_real_time_renderer_tpu_torch.tools.bench_texsample \\
        [--scene full] [--width 1920] [--height 1088] [--frame 1] \\
        [--fields $TMPDIR/texfields.npz] [--reps 20] [--device cpu]

The counterpart of the JAX package's ``tools/bench_texsample.py``.  It
reads the npz that ``tools/capture_texfields.py`` wrote for the same
scene and size, builds the scene for its atlas table, and prints one
row per part, each the JAX tool's row where there is one:

* ``K5 <mode>`` (the JAX "pallas kernel"): ``ops/texsample.sample_atlas``
  on the fields for nearest, bilinear and trilinear, on the card alone
  (``utils/metrics.device_ms``: median of --reps calls, L2 evicted before
  each) and per wrapper call (``cuda_ms``, its host time included);
* ``plain gather`` (the JAX "XLA gather tap (old path)"):
  ``gbuffer.sample_packed_atlas``, bilinear, per call;
* ``resolve_gbuffer`` (no JAX row): the whole G-buffer stage of frame
  --frame (record fetch, interpolation, the tap, TBN, velocity): on the
  card K9, its tap K5's device code, on the card alone and per call;
  with ``--device cpu`` the plain version per call.

The JAX rows "phase1 planning" and "full sample_atlas_tiled" print as
having no counterpart: the tile planner and the bf16 page are TPU
machinery that the port does not have.  With ``--device cpu`` only the
plain rows run (host clock); the K5 rows say they need the card.
Without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import time

from . import capture_texfields as ct

NO_COUNTERPART = {
    "phase1 planning": "the TPU tile planner: no counterpart on the card",
    "full sample_atlas_tiled": "the planner, the bf16 page and the "
                               "dirty-tile fallback: no counterpart",
}
MODES = ("nearest", "bilinear", "trilinear")


def timed(fn, reps, device, alone=False):
    """(ms on the card alone, ms per call): with `alone` device_ms (a
    call that waits for the card raises), else None; cuda_ms on a card,
    the host clock's median on the CPU."""
    import statistics
    if device.type != "cuda":
        fn()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return None, statistics.median(ms)
    import torch

    from ..utils import metrics
    fn()
    torch.cuda.synchronize(device)
    dev_ms = None
    if alone:
        dev_ms = metrics.device_ms(fn, reps, metrics.l2_flush(device))
        if dev_ms is None:
            raise RuntimeError("a call timed on the card alone waited for "
                               "the card")
    return dev_ms, metrics.cuda_ms(fn, reps)


def row(label, dev_ms, call_ms, rows, note=""):
    """Print and append one row."""
    card = "—" if dev_ms is None else f"{dev_ms:.4f}"
    call = "—" if call_ms is None else f"{call_ms:.4f}"
    print(f"{label:28s} card {card:>8s} ms  per call {call:>8s} ms"
          + (f"  {note}" if note else ""), flush=True)
    rows.append({"label": label, "device_ms": dev_ms, "ms": call_ms,
                 "note": note})


def main(argv=None, built=None) -> list[dict]:
    """Print the rows and return them.  `built`: the BuiltScene of the
    capture's scene and size, to use in place of building one."""
    ap = ct.parser(__doc__.splitlines()[0],
                   "npz of mid/u/v/lod/live written by "
                   "tools/capture_texfields.py at the same scene and size")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from ..config import resolve_device
    from ..graph import frame as fm
    from ..ops import gbuffer, texsample
    from .bench import asset_tree, card_name, prepare
    device = resolve_device(args.device)
    prepare(device)
    if built is None:
        with asset_tree():
            built = ct.build(args, device)
    plan, batch = built.plan, built.batch
    mid, uv, lod, (H, W) = ct.load_fields(args.fields, device)
    if (H, W) != (plan.config.height, plan.config.width):
        raise ValueError(f"fields {H}x{W} for a {plan.config.height}x"
                         f"{plan.config.width} scene")
    kw = dict(size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
              n_levels=plan.atlas_n_levels)
    atlas = batch.atlas_packed
    on_card = device.type == "cuda"
    print(f"{args.scene} {W}x{H}, {mid.numel()} pixels, atlas "
          f"{tuple(atlas.shape)}, {plan.atlas_num_materials} materials, "
          f"{card_name(device)}", flush=True)
    rows = []
    for label, why in NO_COUNTERPART.items():
        row(label, None, None, rows, why)
    for mode in MODES:
        if not on_card:
            row(f"K5 {mode}", None, None, rows, "needs the card")
            continue
        row(f"K5 {mode}", *timed(lambda m=mode: texsample.sample_atlas(
            atlas, mid, uv, lod, filter_mode=m, **kw), args.reps, device,
            alone=True), rows)
    _, ms = timed(lambda: gbuffer.sample_packed_atlas(
        atlas, mid, uv, lod, filter_mode="bilinear", **kw), args.reps,
        device)
    row("plain gather (bilinear)", None, ms, rows,
        "gbuffer.sample_packed_atlas (the JAX XLA gather tap)")
    g, mm, nm = built.frame_globals(args.frame, peek=True)
    vis, records, _, _ = fm.raster_stage(plan, batch, g, mm, nm)
    dev_ms, ms = timed(lambda: gbuffer.resolve_gbuffer(
        vis, records, atlas, g.camera_prev.projection_view,
        atlas_size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
        n_levels=plan.atlas_n_levels, filter_mode=plan.texture_filter),
        args.reps, device, alone=on_card)
    row("resolve_gbuffer", dev_ms, ms, rows,
        f"the G-buffer stage, {plan.texture_filter}"
        + (" (K9)" if on_card else ""))
    return rows


if __name__ == "__main__":
    main()
