"""The material texture tap (K5).

Counterpart of the JAX package's ``ops/texsample.py``, whose Pallas
``_tile_kernel`` samples a bf16 atlas page through per-16x16-tile
windows that a planner picks, with a dirty-tile fallback to the exact
gather.  None of that has a job on the card: a gather is native there,
so the CUDA kernel (``kernels/csrc/texsample.cu``) computes the exact
tap of ``gbuffer.sample_packed_atlas`` per pixel from the (N, 12) int32
atlas table, with no planner, page, caps or fallback.  The plain
version is ``sample_packed_atlas`` itself.

:data:`VARIANTS` and :func:`sample_atlas_variant`: the same kernel body
with its stages switched off, its stores in other layouts, or more
pixels a thread (``texsample.cu``'s template), for the port's
``tools/bench_texkernel_parts.py`` and ``tools/bench_texmm2.py``, the
counterparts of the JAX tools that took the TPU kernel apart.  They are
not on the frame's path, and their launches count apart from K5's
(``kernels/build.variant_launches``).
"""
from __future__ import annotations

from dataclasses import dataclass

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
    atlas, mid, uv, lod = _kernel_inputs(atlas, mid, uv, lod)
    P = mid.shape[0]
    out = torch.empty((11, P), dtype=torch.float32, device=uv.device)
    code = kb.library().texsample_launch(
        atlas.data_ptr(), mid.data_ptr(), uv.data_ptr(), lod.data_ptr(),
        out.data_ptr(), P, atlas.shape[0], size, layer_stride, n_levels,
        FILTER_MODES[filter_mode], kb.stream_ptr(uv))
    kb.launches["texsample"] += 1
    kb.check(code, "texsample")
    return out


def _kernel_inputs(atlas, mid, uv, lod):
    """The kernel's inputs checked (types, shapes, the int32 row index)
    and contiguous."""
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
    return (atlas.contiguous(), mid.contiguous(), uv.contiguous(),
            lod.contiguous())


@dataclass(frozen=True)
class TapVariant:
    """One instantiation of texsample.cu's tap template.

    id: its `variant` in texsample_variant_launch; store: "planar" (11,
    P) f32, "interleaved" (P, 12) f32 or "interleaved_bf16" (P, 12) bf16
    (lane 11 zero), "sum" (P,) f32 (the channels' sum) or "guard" (P,)
    f32 written nowhere (a store under a test the data never meets,
    which keeps the work before it alive); px: pixels a thread; lanes:
    threads a pixel (3: one int4 of the row each); skip: the stages
    switched off ("loads", "address", "vblend", "hblend", "unpack",
    "tap"); tpu: the JAX tool's variant it stands for; doc: what it
    times."""
    name: str
    id: int
    store: str
    px: int
    lanes: int
    skip: tuple
    tpu: str
    doc: str

    @property
    def full(self) -> bool:
        """Computes the whole tap and stores all of it: it has a plain
        version and is held to it."""
        return not self.skip and self.store in (
            "planar", "interleaved", "interleaved_bf16")


# texsample.cu's template arguments: kStore by store, kSkip bits by stage
STORE_IDS = {"planar": 0, "interleaved": 1, "interleaved_bf16": 2, "sum": 3,
             "guard": 4}
SKIP_BITS = {"loads": 1, "address": 2, "vblend": 4, "hblend": 8,
             "unpack": 16, "tap": 32}


def variant_symbol(v: TapVariant) -> str:
    """The part of the variant's mangled kernel name that its template
    arguments make (tap_kernel<kStore, kPx, kLanes, kSkip>)."""
    skip = sum(SKIP_BITS[s] for s in v.skip)
    return (f"tap_kernelILi{STORE_IDS[v.store]}ELi{v.px}ELi{v.lanes}"
            f"ELi{skip}E")


_V = TapVariant
VARIANTS = {v.name: v for v in (
    _V("planar", 0, "planar", 1, 1, (), "full kernel (mm2=lhs tps=1); mm2"
       "=lhs", "K5 as the frame runs it: (11, P) f32, one pixel a thread"),
    _V("interleaved", 1, "interleaved", 1, 1, (), "mm2=rhs (P,CH out); "
       "mm2=pad", "pixel-major (P, 12) f32, lane 11 zero: three 16-byte "
       "stores a pixel in place of eleven 4-byte ones"),
    _V("lanes3", 2, "planar", 1, 3, (), "mm2=fold (lane rolls)",
       "a pixel's 48-byte row split over 3 lanes, one int4 and its four "
       "channels each; planar out"),
    _V("planar_px2", 3, "planar", 2, 1, (), "tps=2",
       "2 pixels a thread, a block-width apart"),
    _V("planar_px4", 4, "planar", 4, 1, (), "tps=4",
       "4 pixels a thread, a block-width apart"),
    _V("interleaved_px4", 5, "interleaved", 4, 1, (), "mm2=rhs tps=4",
       "interleaved with 4 pixels a thread"),
    _V("lanes3_px4", 6, "planar", 4, 3, (), "mm2=fold tps=4",
       "the 3-lane split with 4 pixels a lane group"),
    _V("interleaved_bf16", 7, "interleaved_bf16", 1, 1, (), "mm2=padb",
       "pixel-major (P, 12) bf16 (__float2bfloat16_rn): 24 bytes a "
       "pixel written against 44"),
    _V("no_loads", 8, "planar", 1, 1, ("loads",), "no DMA",
       "no atlas loads: the 12 words made from the row index"),
    _V("no_address", 9, "planar", 1, 1, ("address",),
       "no U construct (const U)", "no row address: row = (pixel index "
       "/ 32) mod rows (a warp's pixels share a row; a frame's taps read "
       "~50 pixels a row), fx, fy the wrapped u, v; mid and lod not "
       "read"),
    _V("no_vblend", 10, "planar", 1, 1, ("vblend",),
       "no mm1 (skip row matmul)", "no vertical blend (fy = 0)"),
    _V("no_hblend", 11, "planar", 1, 1, ("hblend",),
       "no Vw (const col weight)", "no horizontal blend (fx = 0)"),
    _V("no_unpack", 12, "planar", 1, 1, ("unpack",),
       "no mm2 (slice channels)", "no unpack or blend: the 11 packed "
       "words stored bit-cast"),
    _V("only_loads", 13, "guard", 1, 1, ("unpack",),
       "only DMA (no compute)", "the row address and the loads only"),
    _V("nothing", 14, "guard", 1, 1, ("tap",), "nothing (grid overhead)",
       "the launch and the input reads only"),
    _V("nothing_px4", 15, "guard", 4, 1, ("tap",), "nothing tps=4",
       "the launch and the input reads only, 4 pixels a thread"),
    _V("floor", 16, "sum", 1, 1, (), "mm2=floor",
       "the whole tap computed, one f32 a pixel stored (the channels' "
       "sum)"),
)}
del _V


def variant_bytes(variant: str, P: int, rows: int,
                  atlas_rows: int) -> int:
    """The bytes variant `variant` must move for P pixels whose taps read
    `rows` distinct rows of an `atlas_rows`-row atlas: each input read
    once (mid, uv, lod: 16 bytes a pixel; uv alone without the address),
    each distinct row's 48 bytes (no_address: its own rows, one a 32
    pixels; none without loads), each output byte written once."""
    v = VARIANTS[variant]
    inputs = 8 if "address" in v.skip else 16
    if "loads" in v.skip or "tap" in v.skip:
        rows = 0
    elif "address" in v.skip:
        rows = min(-(-P // 32), atlas_rows)
    out = {"planar": 44, "interleaved": 48, "interleaved_bf16": 24,
           "sum": 4, "guard": 0}[v.store]
    return P * (inputs + out) + rows * 48


def sample_atlas_variant(atlas, mid, uv, lod, *, variant: str, size: int,
                         layer_stride: int, n_levels: int,
                         filter_mode: str = "bilinear",
                         impl: str | None = None):
    """The tap through variant `variant` of VARIANTS (arguments as
    sample_atlas).  Returns the variant's store: (11, P) f32, (P, 12)
    f32 or bf16, or (P,) f32 ("guard": never written, timing only).
    CUDA tensors launch texsample_variant_launch, counted in
    kernels/build.variant_launches under the variant's name (never as
    K5); CPU tensors (or impl="plain") take the plain version of a full
    variant (variant_plain), and an ablated variant, which has none,
    raises there."""
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    v = VARIANTS[variant]
    if kb.choose(impl, atlas, mid, uv, lod) == "plain":
        return variant_plain(atlas, mid, uv, lod, variant=variant,
                             size=size, layer_stride=layer_stride,
                             n_levels=n_levels, filter_mode=filter_mode)
    atlas, mid, uv, lod = _kernel_inputs(atlas, mid, uv, lod)
    P = mid.shape[0]
    shape, dtype = {
        "planar": ((11, P), torch.float32),
        "interleaved": ((P, 12), torch.float32),
        "interleaved_bf16": ((P, 12), torch.bfloat16),
        "sum": ((P,), torch.float32),
        "guard": ((P,), torch.float32)}[v.store]
    out = torch.empty(shape, dtype=dtype, device=uv.device)
    code = kb.library().texsample_variant_launch(
        atlas.data_ptr(), mid.data_ptr(), uv.data_ptr(), lod.data_ptr(),
        out.data_ptr(), P, atlas.shape[0], size, layer_stride, n_levels,
        FILTER_MODES[filter_mode], v.id, kb.stream_ptr(uv))
    kb.variant_launches[variant] += 1
    kb.check(code, f"texsample variant {variant}")
    return out


def variant_plain(atlas, mid, uv, lod, *, variant: str, size: int,
                  layer_stride: int, n_levels: int,
                  filter_mode: str = "bilinear"):
    """The plain version of a full variant's store: sample_packed_atlas,
    as it is for the planar ones, transposed with a zero lane 11 for the
    interleaved ones (bf16 by PyTorch's cast, round to nearest even)."""
    v = VARIANTS[variant]
    if not v.full:
        raise ValueError(f"texsample variant {variant!r} leaves stages "
                         f"out: it is timing-only and has no plain version")
    tap = sample_packed_atlas(atlas, mid, uv, lod, size=size,
                              layer_stride=layer_stride, n_levels=n_levels,
                              filter_mode=filter_mode)
    if v.store == "planar":
        return tap
    out = torch.cat([tap.T, torch.zeros_like(tap[:1].T)], dim=1)
    return out.to(torch.bfloat16) if v.store == "interleaved_bf16" else out
