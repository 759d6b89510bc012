"""Hierarchical-Z pyramids (min and max), counterpart of the JAX
package's ``ops/hiz.py``: half-resolution base, each level a 2x2
reduction of the previous with edge clamping for odd sizes, down to 1x1.
Built every frame like the reference, which never reads them."""
from __future__ import annotations

import torch.nn.functional as F


def _reduce2x2(x, op):
    """(..., H, W) -> (..., ceil(H/2), ceil(W/2)) by 2x2 min/max with
    clamping."""
    lead = x.shape[:-2]
    H, W = x.shape[-2:]
    pad_h = H % 2
    pad_w = W % 2
    if pad_h or pad_w:
        x = F.pad(x.reshape(1, -1, H, W), (0, pad_w, 0, pad_h),
                  mode="replicate")
        H, W = x.shape[-2:]
    x = x.reshape(*lead, H // 2, 2, W // 2, 2)
    return x.amin(dim=(-3, -1)) if op == "min" else x.amax(dim=(-3, -1))


def build_hiz(depth, op: str = "min") -> list:
    """depth: (*V, H, W) full-res -> list of levels starting at half res
    (each view its own pyramid)."""
    assert op in ("min", "max")
    levels = [_reduce2x2(depth, op)]
    while max(levels[-1].shape[-2:]) > 1:
        levels.append(_reduce2x2(levels[-1], op))
    return levels
