"""Texture pipeline: decode -> mip chain -> packed material atlas (host
numpy).

Counterpart of the JAX package's ``models/texture.py``: images decode to
(H, W, 4) uint8 RGBA (:func:`decode_image`: PIL where it imports, else
PNG by hand through :mod:`..utils.png`), fanned out over a thread pool
at model load (:func:`decode_images_parallel`); every material's four
textures are resized to one atlas size, mip-chained by 2x2 box
reduction (``native/assetpipe.cpp`` through :mod:`..utils.native`) and
packed into one flat table; :func:`expand_atlas_bilinear` turns it into
the (N, 12) int32 row-major device table whose one row holds all 11
sampled channels x 4 bilinear corners.
"""
from __future__ import annotations

import concurrent.futures
import io
import sys
import threading
from dataclasses import dataclass

import numpy as np


def decode_image(data: bytes) -> np.ndarray:
    """Encoded bytes -> (H, W, 4) uint8 RGBA (stb's forced 4 channels).
    PIL where ``import PIL`` works; without it PNG decodes by hand and
    anything else (JPEG) raises ``ValueError`` naming PIL."""
    try:
        from PIL import Image
    except ImportError:
        from ..utils import png
        if data[:8] == png.SIGNATURE:
            return png.decode_png(data)
        raise ValueError(
            "this image is not a PNG (JPEG?); decoding it needs PIL, "
            "which does not import here") from None
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def decode_images_parallel(blobs: list[bytes], workers: int = 8
                           ) -> list[np.ndarray]:
    """Thread-pool fan-out decode (the reference's ThreadPool texture
    loading, model.cpp:74-176)."""
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(decode_image, blobs))


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * x ** (1 / 2.4) - 0.055).astype(np.float32)


def resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Separable bilinear resize of (H, W, C) float32 (host, numpy)."""
    H, W = img.shape[:2]
    if (H, W) == (h, w):
        return img
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    b = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return (a * (1 - fy) + b * fy).astype(np.float32)


def build_mips(img: np.ndarray) -> list[np.ndarray]:
    """Full mip chain by 2x2 box filter down to 1x1. img: (S, S, C)
    float32, S a power of two."""
    levels = [img]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        s = cur.shape[0] // 2
        levels.append(cur.reshape(s, 2, s, 2, -1).mean(axis=(1, 3)))
    return levels


@dataclass(frozen=True)
class PackedMaterialAtlas:
    """(16, N) uint8: rows 0-3 albedo RGBA (sRGB-encoded), 4-7 normal,
    8-11 metallic-roughness, 12-15 emissive (sRGB-encoded).  Texel
    (mid, level, y, x) is at ``mid * layer_stride + level_off(level) +
    y * (S >> level) + x``, ``level_off(l) = (4 S^2 - 4 (S >> l)^2) / 3``."""
    packed: np.ndarray
    size: int
    num_materials: int
    layer_stride: int
    n_levels: int


def _mip_stack_u8(img_u8, size):
    """(H, W, 4) uint8 -> flat (layer_stride, 4) u8 of all mips."""
    from ..utils import native
    base = native.resize_bilinear_u8(np.ascontiguousarray(img_u8),
                                     size, size)
    return native.build_mip_chain_u8(base)


def pack_material_atlas(materials, images_u8, size: int = 1024,
                        workers: int = 8) -> PackedMaterialAtlas:
    """materials: list of gltf.MaterialData; images_u8: list of decoded
    (H, W, 4) uint8 (sRGB-encoded where applicable)."""
    n_levels = int(np.log2(size)) + 1
    layer_stride = sum((size >> k) * (size >> k) for k in range(n_levels))
    M = max(len(materials), 1)
    packed = np.zeros((16, M * layer_stride), np.uint8)

    flat_white = np.full((layer_stride, 4), 255, np.uint8)
    flat_normal = np.tile(np.array([128, 128, 255, 255], np.uint8),
                          (layer_stride, 1))
    flat_zero = np.zeros((layer_stride, 4), np.uint8)

    # one resize + mip chain per distinct image, shared across slots
    stack_cache: dict[int, np.ndarray] = {}
    cache_lock = threading.Lock()

    def mips_of(img_idx, fallback):
        if img_idx < 0 or img_idx >= len(images_u8):
            return fallback
        with cache_lock:
            hit = stack_cache.get(img_idx)
        if hit is not None:
            return hit
        st = _mip_stack_u8(images_u8[img_idx], size)
        with cache_lock:
            stack_cache[img_idx] = st
        return st

    def build_one(mi_m):
        mi, m = mi_m
        s = mi * layer_stride
        packed[0:4, s:s + layer_stride] = mips_of(m.albedo_image,
                                                  flat_white).T
        packed[4:8, s:s + layer_stride] = mips_of(m.normal_image,
                                                  flat_normal).T
        packed[8:12, s:s + layer_stride] = mips_of(
            m.metallic_roughness_image, flat_zero).T
        packed[12:16, s:s + layer_stride] = mips_of(m.emissive_image,
                                                    flat_zero).T

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        list(ex.map(build_one, enumerate(materials)))

    return PackedMaterialAtlas(packed=packed, size=size, num_materials=M,
                               layer_stride=layer_stride, n_levels=n_levels)


# rows of the packed (16, N) atlas that shading reads: albedo RGB,
# normal RGB, metallic-roughness G/B, emissive RGB
SAMPLED_ROWS = (0, 1, 2,
                4, 5, 6,
                9, 10,
                12, 13, 14)
N_SAMPLED = len(SAMPLED_ROWS)


def expand_atlas_bilinear(atlas: PackedMaterialAtlas) -> np.ndarray:
    """(16, N) packed atlas -> (N, 12) int32 row-major table: each texel
    row packs the 11 sampled channels x the four wrap-shifted bilinear
    corners as u32 lanes ``c00 | c10 << 8 | c01 << 16 | c11 << 24``
    (lane 11 = pad)."""
    size, n_levels = atlas.size, atlas.n_levels
    stride, M = atlas.layer_stride, atlas.num_materials
    mx = np.empty(stride, np.int32)
    my = np.empty(stride, np.int32)
    mxy = np.empty(stride, np.int32)
    off = 0
    for level in range(n_levels):
        s = size >> level
        y, x = np.mgrid[0:s, 0:s]
        x1 = (x + 1) % s
        y1 = (y + 1) % s
        sl = slice(off, off + s * s)
        mx[sl] = off + (y * s + x1).ravel()
        my[sl] = off + (y1 * s + x).ravel()
        mxy[sl] = off + (y1 * s + x1).ravel()
        off += s * s
    p = atlas.packed[list(SAMPLED_ROWS)]            # (11, N) u8
    N = M * stride
    out = np.zeros((N, 12), np.int32)
    if sys.byteorder == "little":
        # the u32 corner word is 4 little-endian bytes [c00, c10, c01, c11]
        ob = out.view(np.uint8).reshape(N, 48)
        for r in range(N_SAMPLED):
            q = p[r].reshape(M, stride)
            ob[:, 4 * r + 0] = p[r]
            ob[:, 4 * r + 1] = q[:, mx].ravel()
            ob[:, 4 * r + 2] = q[:, my].ravel()
            ob[:, 4 * r + 3] = q[:, mxy].ravel()
        return out
    base = np.arange(M, dtype=np.int64)[:, None] * stride
    c00 = p.astype(np.uint32)
    c10 = p[:, (base + mx[None, :].astype(np.int64)).ravel()].astype(np.uint32)
    c01 = p[:, (base + my[None, :].astype(np.int64)).ravel()].astype(np.uint32)
    c11 = p[:, (base + mxy[None, :].astype(np.int64)).ravel()].astype(np.uint32)
    packed = (c00 | (c10 << 8) | (c01 << 16) | (c11 << 24))
    out[:, :11] = packed.astype(np.int32).T
    return out
