"""The material texture tap (K5).

Counterpart of the JAX package's ``ops/texsample.py``, whose Pallas
``_tile_kernel`` samples a bf16 atlas page through per-16x16-tile
windows that a planner picks, with a dirty-tile fallback to the exact
gather.  None of that has a job on the card: a gather is native there,
so the CUDA kernel (``kernels/csrc/texsample.cu``) computes the exact
tap of ``gbuffer.sample_packed_atlas`` per pixel from the (N, 12) int32
atlas table, with no planner, page, caps or fallback.  The plain
version is ``sample_packed_atlas`` itself.
"""
from __future__ import annotations

import torch

from ..kernels import build as kb
from .gbuffer import sample_packed_atlas

FILTER_MODES = {"nearest": 0, "bilinear": 1, "trilinear": 2}


def sample_atlas(atlas, mid, uv, lod, *, size: int, layer_stride: int,
                 n_levels: int, filter_mode: str = "bilinear",
                 impl: str | None = None):
    """K5 dispatch: all 11 sampled material channels at (mid, uv, lod).

    atlas: (N, 12) int32 (texture.expand_atlas_bilinear); mid: (P,)
    int32; uv: (2, P) f32; lod: (P,) f32.  Returns (11, P) f32 in
    [0, 1].  CUDA tensors launch the kernel, CPU tensors (or
    impl="plain") take sample_packed_atlas.  A `mid` or `layer_stride`
    that points past the atlas fails on both paths: an IndexError on
    the CPU, a device-side assert on the card."""
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if kb.choose(impl, atlas, mid, uv, lod) == "plain":
        return sample_packed_atlas(atlas, mid, uv, lod, size=size,
                                   layer_stride=layer_stride,
                                   n_levels=n_levels,
                                   filter_mode=filter_mode)
    lib = kb.library()
    if (atlas.dtype != torch.int32 or mid.dtype != torch.int32
            or uv.dtype != torch.float32 or lod.dtype != torch.float32):
        raise TypeError("sample_atlas takes an int32 atlas and mid, "
                        "float32 uv and lod")
    P = mid.shape[0]
    if atlas.dim() != 2 or atlas.shape[1] != 12 or uv.shape != (2, P) \
            or lod.shape != (P,):
        raise ValueError(f"atlas {tuple(atlas.shape)}, mid {(P,)}, uv "
                         f"{tuple(uv.shape)}, lod {tuple(lod.shape)}: want "
                         f"(N, 12), (P,), (2, P), (P,)")
    if atlas.shape[0] >= 2 ** 31 // 3:
        raise ValueError("atlas rows overflow the kernel's int32 index")
    atlas = atlas.contiguous()
    mid = mid.contiguous()
    uv = uv.contiguous()
    lod = lod.contiguous()
    out = torch.empty((11, P), dtype=torch.float32, device=uv.device)
    code = lib.texsample_launch(
        atlas.data_ptr(), mid.data_ptr(), uv.data_ptr(), lod.data_ptr(),
        out.data_ptr(), P, atlas.shape[0], size, layer_stride, n_levels,
        FILTER_MODES[filter_mode], kb.stream_ptr(uv))
    kb.launches["texsample"] += 1
    kb.check(code, "texsample")
    return out
