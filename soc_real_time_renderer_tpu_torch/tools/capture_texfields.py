"""Capture the per-pixel texture-tap fields of one frame to an npz:
material id, uv, lod and live, the inputs of K5 (the material tap).

    python -m soc_real_time_renderer_tpu_torch.tools.capture_texfields \\
        [--scene full] [--width 1920] [--height 1088] [--frame 1] \\
        [--out $TMPDIR/texfields.npz] [--device cpu]

The counterpart of the JAX package's ``tools/capture_texfields.py``,
with its npz keys and shapes (``mid`` int32, ``u``, ``v``, ``lod``
float32, ``live`` bool, each (H, W)) and its summary line (live share,
materials, lod p50).  The JAX tool recomputes the tap inputs beside the
frame; here they are what ``gbuffer.resolve_gbuffer`` hands
``texsample.sample_atlas`` in frame ``--frame`` (``raster_stage`` then
the plain ``resolve_gbuffer``, whose tap is that call, with a spy on
it; on the card the frame's resolve is K9, which computes the same tap
inputs bit for bit), so the capture is the tap's real input by
construction.  ``live`` is the visibility buffer's tri id >= 0;
``lod`` is unclamped, as K5 receives it.  ``tools/bench_texsample.py``,
``bench_texkernel_parts.py`` and ``bench_texmm2.py`` read the file.

The scene is built on the card unless ``--device cpu`` is asked for.
When ``SOC_ASSETS`` lacks the presets' files, the synthetic tree of
``tools/synth_assets.py`` is written into a temporary directory and
used (``tools/bench.asset_tree``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

FIELDS = ("mid", "u", "v", "lod", "live")


def default_path() -> str:
    """Where the capture goes unless told: texfields.npz in the
    temporary directory (the JAX tool's /tmp/texfields.npz)."""
    return os.path.join(tempfile.gettempdir(), "texfields.npz")


def capture(built, frame: int = 1, impl: str | None = None) -> dict:
    """The tap fields of frame `frame` of `built`: {"mid", "u", "v",
    "lod", "live"}, each (H, W) numpy, plus "args", the (atlas, mid,
    uv, lod) tensors and the keyword arguments resolve_gbuffer passed
    sample_atlas.  `impl` is raster_stage's; the resolve is the plain
    version, the one that calls sample_atlas (K9 taps inside itself)."""
    from ..graph import frame as fm
    from ..ops import gbuffer, texsample
    plan, batch = built.plan, built.batch
    if plan.texture_filter == "none":
        raise ValueError("texture_filter 'none' takes no material tap")
    g, mm, nm = built.frame_globals(frame, peek=True)
    vis, records, _, _ = fm.raster_stage(plan, batch, g, mm, nm, impl=impl)
    taps = []
    real = texsample.sample_atlas

    def spy(*a, **k):
        taps.append((a, {n: v for n, v in k.items() if n != "impl"}))
        return real(*a, **k)

    texsample.sample_atlas = spy
    try:
        gbuffer.resolve_gbuffer(
            vis, records, batch.atlas_packed, g.camera_prev.projection_view,
            atlas_size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
            n_levels=plan.atlas_n_levels, filter_mode=plan.texture_filter,
            impl="plain")
    finally:
        texsample.sample_atlas = real
    if len(taps) != 1:
        raise RuntimeError(f"resolve_gbuffer took {len(taps)} material "
                           f"taps, not one")
    (atlas, mid, uv, lod), kw = taps[0]
    shape = vis.tri_id.shape
    if len(shape) != 2:
        raise ValueError(f"one view only: tri_id {tuple(shape)}")

    def host(t):
        return t.detach().reshape(shape).cpu().numpy()

    return {"mid": host(mid), "u": host(uv[0]), "v": host(uv[1]),
            "lod": host(lod), "live": host(vis.tri_id >= 0),
            "args": ((atlas, mid, uv, lod), kw)}


def summary(fields: dict) -> str:
    """The JAX tool's summary: live share, materials, lod p50."""
    live, mid, lod = fields["live"], fields["mid"], fields["lod"]
    p50 = np.percentile(lod[live], 50) if live.any() else float("nan")
    return (f"live {live.mean():.1%}, materials "
            f"{np.unique(mid[live]).tolist()}, lod p50 {p50:.2f}")


def load_fields(path: str, device) -> tuple:
    """(mid (P,) int32, uv (2, P) f32, lod (P,) f32, (H, W)) on `device`
    from a capture, flattened as K5 takes them."""
    import torch
    d = np.load(path)
    H, W = d["mid"].shape

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x).reshape(-1)).to(
            device=device, dtype=dtype)

    uv = torch.stack([t(d["u"], torch.float32), t(d["v"], torch.float32)])
    return (t(d["mid"], torch.int32), uv, t(d["lod"], torch.float32),
            (H, W))


def build(args, device):
    """scenes.build(args.scene) at args.width x args.height on `device`."""
    from .. import scenes
    from ..config import RenderConfig
    return scenes.build(args.scene, RenderConfig(width=args.width,
                                                 height=args.height),
                        device=device)


def parser(doc: str, fields_help: str | None = None):
    """The scene options the texture-tap tools share."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--scene", default="full")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--frame", type=int, default=1)
    if fields_help:
        ap.add_argument("--fields", default=default_path(), help=fields_help)
    return ap


def main(argv=None, built=None) -> dict:
    """Capture and write the npz; prints the summary line and returns
    the fields.  `built`: a BuiltScene of the same scene and size to use
    in place of building one."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--out", default=default_path())
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from ..config import resolve_device
    from .bench import asset_tree
    device = resolve_device(args.device)
    if built is None:
        with asset_tree():
            built = build(args, device)
    fields = capture(built, args.frame)
    np.savez(args.out, **{k: fields[k] for k in FIELDS})
    print(f"wrote {args.out}: {summary(fields)}", flush=True)
    return fields


if __name__ == "__main__":
    main()
