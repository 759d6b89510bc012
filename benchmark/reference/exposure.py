"""Histogram-based auto exposure, counterpart of the JAX package's
``ops/exposure.py``: 256-bin log-luminance histogram (pixels with
luminance < 1e-3 in bin 0), weighted mean over the non-black bins,
``target = log2(target_luminance / 2^mean)``, exponential smoothing
``alpha = 1 - exp(-dt * speed)``.  The histogram is an integer count
(``index_add_`` of ones), so it is deterministic on any device; it is
not ``bincount``, whose CUDA version reads the indices' min and max back
to the host, two waits for the card a frame.  With a leading view
axis (hdr (B, 3, H, W), exposure and globals (B,)) each view has its
own histogram and adapts on its own."""
from __future__ import annotations

import torch

from .globals import AUTO_EXPOSURE_BIN_COUNT

LUMA = (0.2126, 0.7152, 0.0722)


def luminance_histogram(hdr, log_min, log_max):
    """hdr: (*V, 3, H, W) -> (*V, 256) int64 histogram, log_min and
    log_max (*V,)."""
    V = hdr.shape[:-3]
    lum = (LUMA[0] * hdr[..., 0, :, :] + LUMA[1] * hdr[..., 1, :, :]
           + LUMA[2] * hdr[..., 2, :, :]).reshape(*V, -1)
    log_l = torch.log2(torch.clamp(lum, min=1e-30))
    n = AUTO_EXPOSURE_BIN_COUNT
    log_min = log_min.reshape(*V, 1)
    log_max = log_max.reshape(*V, 1)
    mapped = (log_l - log_min) / (log_max - log_min) * (n - 2) + 1.0
    idx = torch.clamp(torch.nan_to_num(mapped, nan=0.0).clamp(-1.0, n)
                      .to(torch.int64), 0, n - 1)
    idx = torch.where(lum < 1e-3, 0, idx)
    if V:       # view b counts into bins [256 b, 256 (b + 1))
        idx = idx + torch.arange(V[0], device=idx.device)[:, None] * n
    idx = idx.reshape(-1)
    hist = torch.zeros(n * lum.shape[:-1].numel(), dtype=torch.int64,
                       device=idx.device)
    return hist.index_add_(0, idx, torch.ones_like(idx)).reshape(*V, n)


def resolve_exposure(hist, prev_exposure, g, num_pixels: int):
    """hist: (*V, 256) -> new smoothed exposure (*V,) f32 (0-d for one
    view)."""
    n = AUTO_EXPOSURE_BIN_COUNT
    bins = torch.arange(n, dtype=torch.float32, device=hist.device)
    weighted = torch.sum(hist.to(torch.float32) * bins, dim=-1)
    black = hist[..., 0].to(torch.float32)
    mean_bin = weighted / torch.clamp(float(num_pixels) - black, min=1.0)
    log2_mean = ((mean_bin - 1.0) / (n - 1.0)
                 * (g.log_max_luminance - g.log_min_luminance)
                 + g.log_min_luminance)
    target = torch.log2(g.target_luminance / torch.exp2(log2_mean))
    alpha = torch.clamp(1.0 - torch.exp(-g.delta_time * g.adjustment_speed),
                        0.0, 1.0)
    return prev_exposure + (target - prev_exposure) * alpha


def auto_exposure(hdr, prev_exposure, g):
    """Histogram + resolve: returns the new exposure scalar."""
    hist = luminance_histogram(hdr, g.log_min_luminance, g.log_max_luminance)
    H, W = hdr.shape[-2:]
    return resolve_exposure(hist, prev_exposure, g, H * W)
