"""Bloom: CoD:AW 13-tap downsample + 3x3 tent additive upsample chain.

Counterpart of the JAX package's ``ops/bloom.py`` in its direct form,
``bloom_depthwise``: each level is one edge-padded filter pass (13-tap,
or 13-tap x 2x2 box at stride 2 for a half-size mip), then the tent
upsample adds each level back (ONE+ONE blending), ending in emissive.
The filters run as explicit float32 tap sums on tensor slices, so no
convolution library (and no TF32) is involved.  The JAX package's
production form (SVD-banded matmuls) computes the same filter and is the
reference the tests hold this against.
"""
from __future__ import annotations

import numpy as np
import torch

from .sampling import edge_pad, shift

# 13-tap weights by (ox, oy) offset in source texels
# (bloom_downsample.inl:119-141)
_DOWN_TAPS = (
    [(0, 0, 0.125)]
    + [(ox, oy, 0.03125) for ox in (-2, 2) for oy in (-2, 2)]
    + [(0, 2, 0.0625), (0, -2, 0.0625), (-2, 0, 0.0625), (2, 0, 0.0625)]
    + [(ox, oy, 0.125) for ox in (-1, 1) for oy in (-1, 1)]
)

_TENT = [(-1, -1, 1.0), (0, -1, 2.0), (1, -1, 1.0),
         (-1, 0, 2.0), (0, 0, 4.0), (1, 0, 2.0),
         (-1, 1, 1.0), (0, 1, 2.0), (1, 1, 1.0)]


def _kernel_13tap():
    k = np.zeros((5, 5), np.float32)
    for ox, oy, w in _DOWN_TAPS:
        k[oy + 2, ox + 2] += w
    return k


def _kernel_13tap_down():
    """13-tap (x) 2x2 box: the stride-2 downsample kernel (6x6)."""
    k5 = _kernel_13tap()
    k6 = np.zeros((6, 6), np.float32)
    for a in range(2):
        for b in range(2):
            k6[a:a + 5, b:b + 5] += k5 * 0.25
    return k6


def _kernel_tent():
    k = np.zeros((3, 3), np.float32)
    for ox, oy, w in _TENT:
        k[oy + 1, ox + 1] += w / 16.0
    return k


def _depthwise(p, kernel, stride: int = 1):
    """VALID correlation of pre-padded (C, H', W') with a static (kh, kw)
    kernel, as a sum of weighted strided slices."""
    kh, kw = kernel.shape
    Ho = (p.shape[1] - kh) // stride + 1
    Wo = (p.shape[2] - kw) // stride + 1
    out = None
    for ky in range(kh):
        for kx in range(kw):
            w = float(kernel[ky, kx])
            if w == 0.0:
                continue
            tap = p[:, ky:ky + stride * (Ho - 1) + 1:stride,
                    kx:kx + stride * (Wo - 1) + 1:stride] * w
            out = tap if out is None else out + tap
    return out


def _upsample2(img):
    """Separable bilinear x2: out length 2N, weights 0.75/0.25."""
    def axis_up(x, axis):
        a = shift(x, -1, 0) if axis == 2 else shift(x, 0, -1)
        b = shift(x, 1, 0) if axis == 2 else shift(x, 0, 1)
        even = 0.25 * a + 0.75 * x
        odd = 0.75 * x + 0.25 * b
        stacked = torch.stack([even, odd], dim=axis + 1)
        shp = list(x.shape)
        shp[axis] *= 2
        return stacked.reshape(shp)

    return axis_up(axis_up(img, 2), 1)


def _up2_to(t, dst_h, dst_w):
    """x2 upsample fitted to (dst_h, dst_w); an odd destination's last
    row/col replicates the edge."""
    up = _upsample2(t)
    ph = dst_h - up.shape[1]
    pw = dst_w - up.shape[2]
    assert -1 <= ph <= 1 and -1 <= pw <= 1, (t.shape, dst_h, dst_w)
    if ph > 0 or pw > 0:
        up = edge_pad(up, 0, max(ph, 0), 0, max(pw, 0))
    return up[:, :dst_h, :dst_w]


def downsample_13tap_conv(src, dst_h, dst_w):
    H, W = src.shape[1:]
    if (dst_h, dst_w) == (H, W):
        return _depthwise(edge_pad(src, 2, 2, 2, 2), _kernel_13tap())
    out = _depthwise(edge_pad(src, 2, 3, 2, 3), _kernel_13tap_down(),
                     stride=2)
    return out[:, :dst_h, :dst_w]


def upsample_tent_conv(src, dst_h, dst_w):
    t = _depthwise(edge_pad(src, 1, 1, 1, 1), _kernel_tent())
    if (dst_h, dst_w) == tuple(src.shape[1:]):
        return t
    return _up2_to(t, dst_h, dst_w)


def bloom(emissive, mip_count: int = 4):
    """Full chain on the emissive target (*V, 3, H, W): mips
    0..mip_count-1 (mip i is (H >> i, W >> i)), additive tent upsample
    back into each level and finally into emissive.  Every filter works
    plane by plane, so the views fold into the channel axis."""
    if emissive.dim() > 3:
        return bloom(emissive.reshape(-1, *emissive.shape[-2:]),
                     mip_count).reshape(emissive.shape)
    H, W = emissive.shape[1:]
    mips = []
    cur = emissive
    for i in range(mip_count):
        h, w = max(H >> i, 1), max(W >> i, 1)
        cur = downsample_13tap_conv(cur, h, w)
        mips.append(cur)
    cur = mips[-1]
    for i in range(mip_count - 2, -1, -1):
        h, w = mips[i].shape[1:]
        cur = mips[i] + upsample_tent_conv(cur, h, w)
    return emissive + upsample_tent_conv(cur, H, W)
