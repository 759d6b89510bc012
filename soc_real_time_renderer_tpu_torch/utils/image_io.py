"""Image IO: PNG dumps of rendered frames (the swapchain-present analog
for headless operation) and EXR for HDR dumps.

Counterpart of the JAX package's ``utils/image_io.py``; ``save_png``
writes through :func:`.png.encode_png` and needs no PIL.
"""
from __future__ import annotations

import numpy as np


def to_srgb_u8(color) -> np.ndarray:
    """(3, H, W) linear [0,1] -> (H, W, 3) u8 sRGB-encoded.

    The reference's swapchain is an sRGB format, so the hardware applies
    this encode on write; it is done here at dump time.  `color`: numpy
    or a tensor on any device.
    """
    from ..models.texture import linear_to_srgb
    if hasattr(color, "detach"):
        color = color.detach().cpu().numpy()
    c = np.asarray(color, np.float32)
    c = np.clip(c, 0.0, 1.0).transpose(1, 2, 0)
    return (linear_to_srgb(c) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, color, already_u8: bool = False) -> None:
    """(3, H, W) linear colour, or (H, W, C) u8 with `already_u8`."""
    from . import png
    arr = np.asarray(color) if already_u8 else to_srgb_u8(color)
    with open(path, "wb") as f:
        f.write(png.encode_png(arr))


def save_exr(path: str, color) -> None:
    """(C, H, W) float -> scanline float32 EXR (ZIP)."""
    from . import exr
    if hasattr(color, "detach"):
        color = color.detach().cpu().numpy()
    exr.write_exr(path, np.asarray(color, np.float32))
