"""AgX_DS tone mapping, counterpart of the JAX package's
``ops/tonemap.py`` (``tone_mapping.inl:74-179``): exposure ``2^e``,
gamut-compressed working space, dual-section curve, saturation mix,
inverse transform.  The reference's matrix-order quirk is kept
(``sRGB_to_XYZ * XYZ_to_adjusted``, ``:160``)."""
from __future__ import annotations

import torch

from . import sampling

_XY_RED = (0.64, 0.33)
_XY_GREEN = (0.3, 0.6)
_XY_BLUE = (0.15, 0.06)
_XY_WHITE = (0.3127, 0.3290)


def _inv(m):
    """3x3 inverse without the host sync of torch.linalg.inv's check."""
    return torch.linalg.inv_ex(m).inverse


def _unproject(xy, device):
    x, y = xy
    return sampling.constant([x / y, 1.0, (1.0 - x - y) / y], device)


def _unproject_dyn(xy):
    return torch.stack([xy[..., 0] / xy[..., 1], torch.ones_like(xy[..., 0]),
                        (1.0 - xy[..., 0] - xy[..., 1]) / xy[..., 1]], dim=-1)


def _primaries_to_matrix(r, g, b, w):
    """tone_mapping.inl:103-116 (columns are primaries); r, g, b (..., 3)
    give (..., 3, 3)."""
    temp = torch.stack([
        torch.stack([r[..., 0], g[..., 0], b[..., 0]], dim=-1),
        torch.ones_like(r),
        torch.stack([r[..., 2], g[..., 2], b[..., 2]], dim=-1)], dim=-2)
    scale = _inv(temp) @ w
    return torch.stack([r * scale[..., 0:1], g * scale[..., 1:2],
                        b * scale[..., 2:3]], dim=-1)


def _compression_matrix(compression):
    """tone_mapping.inl:118-127; compression (*V,) -> (*V, 3, 3)."""
    dev = compression.device
    s = (1.0 / (1.0 - compression))[..., None]
    w = sampling.constant(_XY_WHITE, dev)

    def mixw(p):
        return w + (sampling.constant(p, dev) - w) * s

    r, g, b = mixw(_XY_RED), mixw(_XY_GREEN), mixw(_XY_BLUE)
    return _primaries_to_matrix(_unproject_dyn(r), _unproject_dyn(g),
                                _unproject_dyn(b),
                                _unproject(_XY_WHITE, dev))


def _dual_section(x, linear, peak):
    """tone_mapping.inl:129-137."""
    S = peak * linear
    C = peak / torch.clamp(peak - S, min=1e-6)
    shoulder = peak - (peak - S) * torch.exp((-C * (x - S)) / peak)
    return torch.where(x < S, x, shoulder)


def agx_ds(color, exposure, saturation, linear_section, peak, compression):
    """color: (3, H, W) linear HDR -> (3, H, W) display-referred [0,1].
    With a leading view axis: color (B, 3, H, W), the rest (B,)."""
    dev = color.device
    V = color.shape[:-3]

    def per_view(x):
        return x.reshape(*V, 1, 1)

    work = torch.clamp(color, min=0.0) * per_view(
        torch.exp2(exposure))[..., None]

    srgb_to_xyz = _primaries_to_matrix(
        _unproject(_XY_RED, dev), _unproject(_XY_GREEN, dev),
        _unproject(_XY_BLUE, dev), _unproject(_XY_WHITE, dev))
    adjusted_to_xyz = _compression_matrix(compression)
    xyz_to_adjusted = _inv(adjusted_to_xyz)
    srgb_to_adjusted = srgb_to_xyz @ xyz_to_adjusted   # reference order

    flat = work.reshape(*V, 3, -1)
    flat = srgb_to_adjusted @ flat
    flat = torch.clamp(_dual_section(flat, per_view(linear_section),
                                     per_view(peak)), 0.0, 1.0)
    lum = (0.2126729 * flat[..., 0, :] + 0.7151522 * flat[..., 1, :]
           + 0.0721750 * flat[..., 2, :])[..., None, :]
    flat = lum + (flat - lum) * per_view(saturation)
    flat = torch.clamp(flat, 0.0, 1.0)
    flat = _inv(srgb_to_adjusted) @ flat
    return flat.reshape(color.shape)


def tone_map(color, exposure, g):
    """AgX_DS with the ShaderGlobals tonemap params."""
    return agx_ds(color, exposure, g.saturation, g.agx_ds_linear_section,
                  g.peak, g.compression)
