"""Interactive viewer of the port (the main.cpp analog for live use).

Usage:
  python -m soc_real_time_renderer_tpu_torch.tools.viewer --scene helmet \
      [--width 640] [--height 384] [--port 8000] [--device cpu]

The counterpart of the JAX package's ``tools/viewer.py``: builds the
scene preset (``scenes.build``; the glTF presets read ``SOC_ASSETS``)
with a 1024^2 shadow map and serves it over HTTP (``ui/server.py``):
open ``http://localhost:<port>`` in a browser.  ``--device`` replaces
``--platform``: the default is the CUDA card, with no CPU fallback;
``--device cpu`` runs the plain PyTorch versions (seconds a frame).
"""
from __future__ import annotations

import argparse

SCENES = ["helmet", "sponza", "terrain", "full", "helmet_lifted"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="helmet", choices=SCENES)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .. import scenes
    from ..config import RenderConfig, resolve_device
    from ..graph import frame as frame_mod
    from ..ui import server

    device = resolve_device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       shadow_resolution=1024)
    built = scenes.build(args.scene, cfg, device=device)
    render = frame_mod.make_render_fn(built.plan)
    history = frame_mod.RenderHistory.create(built.plan.config,
                                             device=device)
    server.serve(built, render, history, port=args.port)


if __name__ == "__main__":
    main()
