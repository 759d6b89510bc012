"""Terrain: heightmap-displaced grid + height->normal + terrain material.

Counterpart of the JAX package's ``models/terrain.py`` (host numpy): a
heightmap from an EXR or PNG (:func:`load_heightmap`) or a
deterministic fBm one, the ``height_to_normal.inl`` stencil, the
99x99-patch grid with the tess level baked as a subdivision factor, and
``(h - midpoint) * height_scale`` displacement.  The albedo and normal
images go to the atlas packer as uint8 arrays directly (the JAX version
round-trips them through a lossless PNG encode).
"""
from __future__ import annotations

import numpy as np

from .gltf import MaterialData, ModelData, PrimitiveRange

TERRAIN_SIZE = 100  # renderer.cpp:199 (grid loops terrain_size-1 patches)


def procedural_heightmap(n: int = 1024, seed: int = 3, octaves: int = 6
                         ) -> np.ndarray:
    """Deterministic fBm value-noise heightmap in [0, 1]."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, n), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        res = 4 * (2 ** o)
        grid = rng.random((res + 1, res + 1)).astype(np.float32)
        ys = np.linspace(0, res, n, endpoint=False)
        xs = np.linspace(0, res, n, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        fy = fy * fy * (3 - 2 * fy)
        fx = fx * fx * (3 - 2 * fx)
        a = grid[y0][:, x0]
        b = grid[y0][:, x0 + 1]
        c = grid[y0 + 1][:, x0]
        d = grid[y0 + 1][:, x0 + 1]
        out += amp * ((a * (1 - fx) + b * fx) * (1 - fy)
                      + (c * (1 - fx) + d * fx) * fy)
        total += amp
        amp *= 0.5
    return out / total


def load_heightmap(path: str | None, n: int = 1024) -> np.ndarray:
    """EXR/PNG heightmap (R channel) or the procedural fallback."""
    if path is None:
        return procedural_heightmap(n)
    if path.endswith(".exr"):
        from ..utils import exr
        return exr.read_exr_rgba(path)[..., 0]
    from .texture import decode_image
    with open(path, "rb") as f:
        img = decode_image(f.read())
    return img[..., 0].astype(np.float32) / 255.0


def height_to_normal(height: np.ndarray) -> np.ndarray:
    """height_to_normal.inl:52-82: (N, N) heights in [0,1] -> (N, N, 3)
    world normals from central differences of (x/N, h, y/N)."""
    n = height.shape[0]

    def shift(dy, dx):
        ys = np.clip(np.arange(n) + dy, 0, n - 1)
        xs = np.clip(np.arange(n) + dx, 0, n - 1)
        pos = np.empty((n, n, 3), np.float32)
        pos[..., 0] = (xs[None, :] / n)
        pos[..., 2] = (ys[:, None] / n)
        pos[..., 1] = height[ys][:, xs]
        return pos

    up = shift(1, 0)
    down = shift(-1, 0)
    right = shift(0, 1)
    left = shift(0, -1)

    def norm(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                              1e-12)

    vertical = norm(up - down)
    horizontal = norm(right - left)
    return norm(np.cross(vertical, horizontal))


def build_terrain_model(heightmap: np.ndarray, albedo_rgba: np.ndarray,
                        *, scale=(100.0, 100.0), offset=(0.0, 0.0, 0.0),
                        height_scale: float = 70.0, midpoint: float = 0.2,
                        tess_level: int = 3) -> ModelData:
    """Bake the displaced terrain grid into a triangle model:
    (TERRAIN_SIZE-1) patches x tess_level subdivisions per side,
    x = u*scale.x - offset.x, z = v*scale.y - offset.z,
    y = offset.y + (h - midpoint)*height_scale."""
    n = (TERRAIN_SIZE - 1) * tess_level + 1
    u = np.linspace(0.0, 1.0, n, dtype=np.float32)
    uu, vv = np.meshgrid(u, u, indexing="xy")

    hm = heightmap
    N = hm.shape[0]
    hx = np.clip((uu * N).astype(int), 0, N - 1)
    hy = np.clip((vv * N).astype(int), 0, N - 1)
    h = hm[hy, hx]
    x = uu * scale[0] - offset[0]
    z = vv * scale[1] - offset[2]
    y = offset[1] + (h - midpoint) * height_scale
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32)

    # two triangles (i0, i2, i1), (i1, i2, i3) per quad, rows outer
    jj, ii = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    i0 = jj * n + ii
    i1 = i0 + 1
    i2 = i0 + n
    i3 = i2 + 1
    indices = np.stack([i0, i2, i1, i1, i2, i3], -1).reshape(-1).astype(
        np.uint32)

    nrm = np.zeros_like(pos)
    nrm[:, 1] = 1.0  # geometric normal unused: shading reads the map

    nm = height_to_normal(hm)
    nm_u8 = np.concatenate([
        ((nm * 0.5 + 0.5) * 255).astype(np.uint8),
        np.full((N, N, 1), 255, np.uint8)], -1)
    alb_u8 = (np.clip(albedo_rgba, 0, 1) * 255).astype(np.uint8)
    materials = [MaterialData(albedo_image=0, normal_image=1)]

    return ModelData(
        positions=pos, normals=nrm, uvs=uv, indices=indices,
        primitives=[PrimitiveRange(0, 0, len(indices), len(pos), 0)],
        materials=materials, images=[alb_u8, nm_u8], terrain=True)


def default_albedo(heightmap: np.ndarray) -> np.ndarray:
    """Height/slope-based coloring when no albedo image exists."""
    nm = height_to_normal(heightmap)
    slope = 1.0 - np.abs(nm[..., 1])
    h = heightmap
    grass = np.array([0.15, 0.32, 0.08], np.float32)
    rock = np.array([0.32, 0.28, 0.24], np.float32)
    snow = np.array([0.85, 0.85, 0.9], np.float32)
    c = (grass[None, None] * (1 - slope[..., None])
         + rock[None, None] * slope[..., None])
    sw = np.clip((h - 0.65) * 8.0, 0, 1)[..., None]
    c = c * (1 - sw) + snow[None, None] * sw
    out = np.concatenate([c, np.ones_like(h)[..., None]], -1)
    return out.astype(np.float32)
