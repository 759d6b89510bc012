"""Procedural geometry (host numpy): the Sponza-scale atrium stand-in and
test primitives.

Counterpart of the JAX package's ``models/proc.py``, byte for byte on
the geometry.  The reference's Sponza assets keep their textures and
glTF JSON but not their geometry, so :func:`build_atrium` synthesizes a
Sponza-scale atrium textured with the first five opaque Sponza
materials that carry albedo, metallic-roughness and normal maps
(:func:`_sponza_materials`); without ``Sponza.gltf``, the first five
``*.jpg`` files of ``texture_dir`` as albedo-only materials, else five
flat materials.  Images are decoded (RGBA uint8).
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from .gltf import MaterialData, ModelData, PrimitiveRange
from .texture import decode_images_parallel


def _mesh_from_quads(quads, uv_scale=1.0):
    """quads: (Q, 4, 3) corners, CCW seen from outside ->
    (positions, normals, uvs, indices) with 4 vertices per quad."""
    p = np.asarray(quads, np.float32)
    if p.size == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0, 2), np.float32), np.zeros((0,), np.uint32))
    Q = p.shape[0]
    n = np.cross(p[:, 1] - p[:, 0], p[:, 3] - p[:, 0])
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(ln > 0, n / np.where(ln > 0, ln, 1.0),
                 np.array([0, 1, 0], np.float32)).astype(np.float32)
    e0 = (np.linalg.norm(p[:, 1] - p[:, 0], axis=-1)
          * np.float32(uv_scale)).astype(np.float32)
    e1 = (np.linalg.norm(p[:, 3] - p[:, 0], axis=-1)
          * np.float32(uv_scale)).astype(np.float32)
    z = np.zeros_like(e0)
    uv = np.stack([np.stack([z, z], -1), np.stack([e0, z], -1),
                   np.stack([e0, e1], -1), np.stack([z, e1], -1)], axis=1)
    base = (np.arange(Q, dtype=np.uint32) * 4)[:, None]
    idx = base + np.array([0, 1, 2, 0, 2, 3], np.uint32)[None, :]
    return (p.reshape(-1, 3), np.repeat(n, 4, axis=0),
            uv.reshape(-1, 2).astype(np.float32), idx.reshape(-1))


def subdivide_quad(p0, p1, p2, p3, nx, ny):
    """Grid-subdivide a quad into nx*ny quads -> (nx*ny, 4, 3) float32,
    row-major in (j, i)."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    u = (np.arange(nx + 1) / nx).astype(np.float32)[:, None]
    v = (np.arange(ny + 1) / ny).astype(np.float32)[:, None, None]
    a = p0 * (1 - u) + p1 * u
    b = p3 * (1 - u) + p2 * u
    grid = a * (1 - v) + b * v
    q = np.stack([grid[:-1, :-1], grid[:-1, 1:],
                  grid[1:, 1:], grid[1:, :-1]], axis=2)
    return q.reshape(-1, 4, 3)


def _cylinder(center, radius, height, segments=24, vdiv=8):
    quads = []
    cx, cy, cz = center
    for k in range(segments):
        a0 = 2 * np.pi * k / segments
        a1 = 2 * np.pi * (k + 1) / segments
        x0, z0 = cx + radius * np.cos(a0), cz + radius * np.sin(a0)
        x1, z1 = cx + radius * np.cos(a1), cz + radius * np.sin(a1)
        for v in range(vdiv):
            y0 = cy + height * v / vdiv
            y1 = cy + height * (v + 1) / vdiv
            quads.append(([x1, y0, z1], [x0, y0, z0], [x0, y1, z0],
                          [x1, y1, z1]))
    return quads


def _box(cx, cz, s, h):
    x0, x1, z0, z1 = cx - s, cx + s, cz - s, cz + s
    return [
        ([x0, 0, z1], [x1, 0, z1], [x1, h, z1], [x0, h, z1]),
        ([x1, 0, z0], [x0, 0, z0], [x0, h, z0], [x1, h, z0]),
        ([x0, 0, z0], [x0, 0, z1], [x0, h, z1], [x0, h, z0]),
        ([x1, 0, z1], [x1, 0, z0], [x1, h, z0], [x1, h, z1]),
        ([x0, h, z1], [x1, h, z1], [x1, h, z0], [x0, h, z0]),
    ]


def _sponza_materials(texture_dir: str, count: int = 5):
    """(decoded images, materials) of the first `count` opaque materials
    of ``texture_dir/Sponza.gltf`` that carry albedo, metallic-roughness
    and normal maps, or None when the glTF is absent or has fewer.  An
    image is one entry per (file, sRGB) pair, in first-use order, as in
    the JAX package, so image indices and atlas bytes agree."""
    path = os.path.join(texture_dir, "Sponza.gltf")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        g = json.load(f)
    uris = [i.get("uri") for i in g.get("images", [])]
    tsrc = [t.get("source", -1) for t in g.get("textures", [])]

    def uri(slot):
        if slot is None:
            return None
        src = tsrc[slot["index"]]
        if src < 0:
            # a texture whose image lives in an extension: skip the
            # material rather than alias the last image
            return None
        return uris[src]

    picks = []
    for m in g.get("materials", []):
        if m.get("alphaMode", "OPAQUE") != "OPAQUE":
            continue        # cutout foliage on opaque walls looks wrong
        pbr = m.get("pbrMetallicRoughness", {})
        a = uri(pbr.get("baseColorTexture"))
        mr = uri(pbr.get("metallicRoughnessTexture"))
        n = uri(m.get("normalTexture"))
        if a and mr and n:
            picks.append((a, mr, n))
        if len(picks) == count:
            break
    if len(picks) < count:
        return None

    names, index_of = [], {}

    def img(name, srgb):
        key = (name, srgb)
        if key not in index_of:
            names.append(name)
            index_of[key] = len(names) - 1
        return index_of[key]

    materials = [MaterialData(albedo_image=img(a, True),
                              metallic_roughness_image=img(mr, False),
                              normal_image=img(n, False))
                 for a, mr, n in picks]
    blobs = []
    for name in names:
        with open(os.path.join(texture_dir, name), "rb") as f:
            blobs.append(f.read())
    return decode_images_parallel(blobs), materials


def model_from_groups(groups, materials, uv_scale=1 / 300.0,
                      images=None) -> ModelData:
    """groups: [(quads (Q, 4, 3), material index)] -> one ModelData with
    a primitive per group."""
    pos_l, nrm_l, uv_l, idx_l, prims = [], [], [], [], []
    voff = ioff = 0
    for quads, mat in groups:
        p, n, u, ix = _mesh_from_quads(quads, uv_scale=uv_scale)
        pos_l.append(p)
        nrm_l.append(n)
        uv_l.append(u)
        idx_l.append(ix + voff)
        prims.append(PrimitiveRange(first_index=ioff, first_vertex=voff,
                                    index_count=len(ix), vertex_count=len(p),
                                    material_index=mat))
        voff += len(p)
        ioff += len(ix)
    return ModelData(
        positions=np.concatenate(pos_l), normals=np.concatenate(nrm_l),
        uvs=np.concatenate(uv_l),
        indices=np.concatenate(idx_l).astype(np.uint32),
        primitives=prims, materials=materials, images=images or [])


def build_atrium(texture_dir: str | None = None, target_tris: int = 260_000,
                 seed: int = 7) -> ModelData:
    """Sponza-scale atrium: floor, ceiling, walls, two colonnade rows,
    randomized crates, in Sponza's pre-scale units (metres * 100; the
    entity scale 0.01 of application.cpp:16).  Interior faces wind CCW
    as seen from inside.  Materials: :func:`_sponza_materials` of
    `texture_dir`, else its first five ``*.jpg`` as albedo-only, else
    (and with texture_dir=None) five flat ones."""
    rng = np.random.default_rng(seed)
    L, W, H = 2400.0, 1200.0, 900.0      # post-scale: 24 x 12 x 9 m
    groups = []
    floor = subdivide_quad([-L / 2, 0, W / 2], [L / 2, 0, W / 2],
                           [L / 2, 0, -W / 2], [-L / 2, 0, -W / 2], 96, 48)
    groups.append((floor, 0))
    ceil_q = subdivide_quad([-L / 2, H, -W / 2], [L / 2, H, -W / 2],
                            [L / 2, H, W / 2], [-L / 2, H, W / 2], 96, 48)
    groups.append((ceil_q, 1))
    walls = np.concatenate([
        subdivide_quad([-L / 2, H, -W / 2], [-L / 2, H, W / 2],
                       [-L / 2, 0, W / 2], [-L / 2, 0, -W / 2], 24, 18),
        subdivide_quad([L / 2, H, W / 2], [L / 2, H, -W / 2],
                       [L / 2, 0, -W / 2], [L / 2, 0, W / 2], 24, 18),
        subdivide_quad([-L / 2, H, W / 2], [L / 2, H, W / 2],
                       [L / 2, 0, W / 2], [-L / 2, 0, W / 2], 48, 18),
        subdivide_quad([L / 2, H, -W / 2], [-L / 2, H, -W / 2],
                       [-L / 2, 0, -W / 2], [L / 2, 0, -W / 2], 48, 18)])
    groups.append((walls, 2))

    cols = []
    for row_z in (-W / 4, W / 4):
        for i in range(12):
            x = -L / 2 + (i + 0.5) * L / 12
            cols += _cylinder((x, 0.0, row_z), 40.0, H * 0.85,
                              segments=64, vdiv=40)
    groups.append((cols, 3))

    crates = []
    for _ in range(40):
        cx = rng.uniform(-L / 2 + 150, L / 2 - 150)
        cz = rng.uniform(-W / 2 + 150, W / 2 - 150)
        s = rng.uniform(30, 90)
        h = rng.uniform(40, 160)
        for q in _box(cx, cz, s, h):
            crates.append(subdivide_quad(*q, 4, 4))
    groups.append((np.concatenate(crates), 4))

    got = _sponza_materials(texture_dir, count=5) if texture_dir else None
    if got is not None:
        images, materials = got
    else:
        tex_files = sorted(glob.glob(os.path.join(texture_dir, "*.jpg"))
                           )[:5] if texture_dir else []
        blobs = []
        for name in tex_files:
            with open(name, "rb") as f:
                blobs.append(f.read())
        images = decode_images_parallel(blobs)
        materials = [MaterialData(albedo_image=i) if i < len(images)
                     else MaterialData() for i in range(5)]
    return model_from_groups(groups, materials, images=images)


def metal_tile_image(seed: int = 5, size: int = 64) -> np.ndarray:
    """(size, size, 4) uint8 metallic-roughness image of 8 x 8-texel
    tiles from `seed` (glTF channels: G roughness, B metallic): each
    tile's roughness in [0.1, 0.5], its metallic ~0.9, with a quarter of
    the tiles dielectric (metallic 0).  The ``full_ssr`` preset's floor."""
    rng = np.random.default_rng(seed)
    tiles = size // 8
    rough = rng.integers(25, 128, (tiles, tiles))
    metal = np.where(rng.random((tiles, tiles)) < 0.25, 0,
                     rng.integers(215, 256, (tiles, tiles)))
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = np.kron(rough, np.ones((8, 8), np.int64))
    img[..., 2] = np.kron(metal, np.ones((8, 8), np.int64))
    img[..., 3] = 255
    return img


def unit_quad(z: float = -1.0, size: float = 0.5) -> ModelData:
    """Two-triangle quad facing the +z viewer (tests)."""
    s = size
    pos = np.array([[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]],
                   np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    return ModelData(positions=pos, normals=nrm, uvs=uv, indices=idx,
                     primitives=[PrimitiveRange(0, 0, 6, 4, 0)],
                     materials=[MaterialData()], images=[])
