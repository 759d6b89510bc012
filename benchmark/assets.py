"""The synthetic asset tree, a frozen copy of the port's
``tools/synth_assets.py`` (with its PNG encoder, ``utils/png.encode_png``),
so that the inputs of the glTF presets do not move when the program
does.  The benchmark writes it once, from seed 0, into
``build/benchmark/assets`` of the checkout (:func:`ensure`), and later
runs there reuse it.

What the port's module says of the tree: The presets ``helmet``, ``helmet_lifted``, ``sponza`` and ``full`` read
``DamagedHelmet/glTF/DamagedHelmet.gltf``, ``Sponza/glTF/Sponza.gltf``
(its materials and textures) and ``Clouds/noise.png`` under
``scenes.ASSETS``.  :func:`write_asset_tree` writes stand-ins for all
three, made from a seed, so the presets build where the real files are
absent:

* the helmet: a closed UV sphere of radius 1 (``2 * rings * segments``
  triangles, u16 indices) whose positions, normals and UVs share one
  interleaved bufferView (byteStride 32), one material with the five
  texture slots; the maps are PNGs of mixed colour types (RGBA albedo,
  RGB metallic-roughness, normal and emissive, grey occlusion), map i
  written with PNG filter type i;
* Sponza: ``Sponza.gltf`` with five opaque materials, each with its own
  albedo, metallic-roughness and normal PNG, after one alpha-masked
  material that the atrium skips;
* the cloud noise: a tiled grey PNG.

At the defaults the sizes are those of the real assets: the published
DamagedHelmet has 15,452 triangles and 2048^2 maps, Sponza 1024^2 maps,
the noise texture 64^2.  The tree's root holds a ``SYNTHETIC`` file
(:func:`is_synthetic`), so that a measurement taken on it says so.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

HELMET = "DamagedHelmet/glTF"
SPONZA = "Sponza/glTF"
NOISE = "Clouds/noise.png"
# the files the presets read (under scenes.ASSETS)
PRESET_FILES = (HELMET + "/DamagedHelmet.gltf", SPONZA + "/Sponza.gltf",
                NOISE)
MARKER = "SYNTHETIC"


def is_synthetic(root) -> bool:
    """Whether `root` is a tree that :func:`write_asset_tree` wrote."""
    return os.path.exists(os.path.join(root, MARKER))


def _smooth(rng, size, cells, channels):
    """(size, size, channels) float32 in [0, 1]: a random `cells`^2 grid,
    bilinearly upsampled and wrapped, plus fine noise."""
    grid = rng.random((cells + 1, cells + 1, channels), np.float32)
    grid[-1], grid[:, -1] = grid[0], grid[:, 0]
    t = np.arange(size, dtype=np.float32) * np.float32(cells / size)
    i = t.astype(np.int64)
    f = (t - i)[:, None, None]
    rows = grid[i] * (1 - f) + grid[i + 1] * f                  # (S, C+1, ch)
    fx = f.transpose(1, 0, 2)
    img = rows[:, i] * (1 - fx) + rows[:, i + 1] * fx
    img += rng.standard_normal(img.shape, np.float32) * np.float32(0.03)
    return np.clip(img, 0.0, 1.0)


def _u8(x):
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def helmet_map(name, rng, size):
    """(size, size, C) uint8 helmet map `name` (one of HELMET_MAPS)."""
    if name == "albedo":
        base = _smooth(rng, size, 16, 3) * 0.8 + 0.1
        return _u8(np.concatenate([base, np.ones_like(base[..., :1])], -1))
    if name == "metal_roughness":
        rm = _smooth(rng, size, 8, 2)
        mr = np.zeros((size, size, 3), np.float32)
        mr[..., 1] = 0.2 + 0.7 * rm[..., 0]                   # roughness
        mr[..., 2] = rm[..., 1] > 0.5                         # metallic
        return _u8(mr)
    if name == "normal":
        tilt = _smooth(rng, size, 32, 2) - 0.5
        return _u8(np.stack([0.5 + 0.3 * tilt[..., 0],
                             0.5 + 0.3 * tilt[..., 1],
                             np.ones_like(tilt[..., 0])], -1))
    if name == "occlusion":
        return _u8(0.6 + 0.4 * _smooth(rng, size, 8, 1))[..., 0]
    glow = _smooth(rng, size, 8, 1)
    return _u8(np.where(glow > 0.75, glow, 0.0)
               * np.array([1.0, 0.6, 0.2], np.float32))


# the glTF slots in order; map i is written with PNG filter type i
HELMET_MAPS = ("albedo", "metal_roughness", "normal", "occlusion",
               "emissive")


def _write_png(path, make, filter_type):
    with open(path, "wb") as f:
        f.write(encode_png(make(), filter_type=filter_type, level=1))


def uv_sphere(rings, segments):
    """(positions (V, 3), normals (V, 3), uvs (V, 2), indices (T*3,)) of
    a closed unit sphere, seam and pole vertices duplicated, faces
    counter-clockwise seen from outside."""
    th = np.linspace(0.0, np.pi, rings + 1, dtype=np.float32)
    ph = np.linspace(0.0, 2 * np.pi, segments + 1, dtype=np.float32)
    t, p = np.meshgrid(th, ph, indexing="ij")
    nrm = np.stack([np.sin(t) * np.cos(p), np.cos(t), -np.sin(t) * np.sin(p)],
                   -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([p / (2 * np.pi), t / np.pi], -1).reshape(-1, 2)
    r, s = np.meshgrid(np.arange(rings), np.arange(segments), indexing="ij")
    a = r * (segments + 1) + s
    b = a + segments + 1
    idx = np.stack([a, b, b + 1, a, b + 1, a + 1], -1).reshape(-1)
    return nrm.copy(), nrm, uv.astype(np.float32), idx


def write_helmet(root, jobs, seed, rings, segments, map_size):
    """DamagedHelmet.gltf + .bin under root/HELMET; its five PNG maps are
    appended to `jobs` as (path, make, filter type)."""
    d = os.path.join(root, HELMET)
    os.makedirs(d, exist_ok=True)
    pos, nrm, uv, idx = uv_sphere(rings, segments)
    v = len(pos)
    if v > 65535:
        raise ValueError(f"{v} vertices do not fit u16 indices")
    inter = np.zeros((v, 8), np.float32)
    inter[:, 0:3], inter[:, 3:6], inter[:, 6:8] = pos, nrm, uv
    vbytes = inter.tobytes()
    ibytes = idx.astype(np.uint16).tobytes()
    blob = vbytes + ibytes + b"\0" * (-len(ibytes) % 4)
    with open(os.path.join(d, "DamagedHelmet.bin"), "wb") as f:
        f.write(blob)
    images = []
    for ft, name in enumerate(HELMET_MAPS):
        fname = f"helmet_{name}.png"
        rng = np.random.default_rng([seed, ft])
        jobs.append((os.path.join(d, fname),
                     lambda n=name, r=rng: helmet_map(n, r, map_size), ft))
        images.append({"uri": fname, "name": name})
    lo, hi = pos.min(0), pos.max(0)
    doc = {
        "asset": {"version": "2.0", "generator": "synth_assets"},
        "scene": 0, "scenes": [{"nodes": [0]}],
        # a node transform the reference (and the loader's default) ignores
        "nodes": [{"mesh": 0, "rotation": [0.7071068, 0.0, 0.0, 0.7071068]}],
        "buffers": [{"uri": "DamagedHelmet.bin", "byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(vbytes),
             "byteStride": 32, "target": 34962},
            {"buffer": 0, "byteOffset": len(vbytes),
             "byteLength": len(ibytes), "target": 34963}],
        "accessors": [
            {"bufferView": 0, "byteOffset": 0, "componentType": 5126,
             "count": v, "type": "VEC3", "min": lo.tolist(),
             "max": hi.tolist()},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
             "count": v, "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 24, "componentType": 5126,
             "count": v, "type": "VEC2"},
            {"bufferView": 1, "componentType": 5123, "count": len(idx),
             "type": "SCALAR"}],
        "meshes": [{"primitives": [{"attributes": {
            "POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2}, "indices": 3,
            "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                     "metallicRoughnessTexture": {"index": 1}},
            "normalTexture": {"index": 2}, "occlusionTexture": {"index": 3},
            "emissiveTexture": {"index": 4},
            "emissiveFactor": [1.0, 1.0, 1.0]}],
        "samplers": [{}],
        "textures": [{"sampler": 0, "source": i} for i in range(5)],
        "images": images,
    }
    path = os.path.join(d, "DamagedHelmet.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def sponza_map(key, rng, size):
    """(size, size, C) uint8 Sponza map: "albedo", "mr" or "normal"."""
    if key == "albedo":
        tint = rng.uniform(0.3, 0.9, 3).astype(np.float32)
        return _u8(_smooth(rng, size, 8, 3) * 0.5 + tint * 0.5)
    if key == "mr":
        mr = np.zeros((size, size, 3), np.float32)
        mr[..., 1] = 0.4 + 0.5 * _smooth(rng, size, 4, 1)[..., 0]
        return _u8(mr)
    return _u8(np.concatenate([
        0.5 + 0.2 * (_smooth(rng, size, 16, 2) - 0.5),
        np.ones((size, size, 1), np.float32)], -1))


def write_sponza(root, jobs, seed, map_size, count=5):
    """Sponza.gltf (materials, textures, images; no geometry, like the
    reference's copy) under root/SPONZA; its three PNG maps per material
    are appended to `jobs`."""
    d = os.path.join(root, SPONZA)
    os.makedirs(d, exist_ok=True)
    images, materials = [], [{
        "name": "foliage", "alphaMode": "MASK",
        "pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                 "metallicRoughnessTexture": {"index": 1}},
        "normalTexture": {"index": 2}}]
    for m in range(count):
        for key in ("albedo", "mr", "normal"):
            fname = f"material{m}_{key}.png"
            rng = np.random.default_rng([seed, 100 + len(images)])
            jobs.append((os.path.join(d, fname),
                         lambda k=key, r=rng: sponza_map(k, r, map_size),
                         len(images) % 5))
            images.append({"uri": fname})
        k = len(images) - 3
        materials.append({
            "name": f"material{m}",
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": k},
                "metallicRoughnessTexture": {"index": k + 1}},
            "normalTexture": {"index": k + 2}})
    doc = {"asset": {"version": "2.0", "generator": "synth_assets"},
           "materials": materials,
           "textures": [{"source": i} for i in range(len(images))],
           "images": images}
    path = os.path.join(d, "Sponza.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_noise(root, seed, size):
    """Clouds/noise.png: a tiled grey value-noise field."""
    path = os.path.join(root, NOISE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng([seed, 200])
    with open(path, "wb") as f:
        f.write(encode_png(_u8(_smooth(rng, size, 8, 1))[..., 0]))
    return path


def write_asset_tree(root, *, rings=60, segments=129, helmet_map=2048,
                     sponza_map=1024, noise=64, sponza=True, seed=0,
                     workers=8) -> dict:
    """Write the tree under `root`; returns {"helmet", "sponza", "noise":
    path}.  The defaults: a 15,480-triangle helmet with 2048^2 maps,
    Sponza's 1024^2 maps, a 64^2 noise texture.  sponza=False leaves out
    ``Sponza/`` (the presets then give the atrium five flat materials).
    The maps are made and encoded on `workers` threads (zlib level 1);
    each map has its own generator, so the bytes do not depend on the
    order the threads run in."""
    jobs = []
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, MARKER), "w") as f:
        f.write("written by tools/synth_assets.py from a seed: stand-ins "
                "at the real assets' sizes, not the real assets\n")
    out = {"helmet": write_helmet(root, jobs, seed, rings, segments,
                                  helmet_map)}
    if sponza:
        out["sponza"] = write_sponza(root, jobs, seed, sponza_map)
    out["noise"] = write_noise(root, seed, noise)
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        for fut in [ex.submit(_write_png, *job) for job in jobs]:
            fut.result()
    return out


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _filter_rows(img: np.ndarray, filter_type: int) -> np.ndarray:
    """(H, W, C) uint8 -> (H, 1 + W*C) uint8 rows, each filtered with
    `filter_type` (0 None .. 4 Paeth) against the unfiltered bytes."""
    h = img.shape[0]
    bpp = img.shape[2]
    x = img.reshape(h, -1).astype(np.int16)      # a + b - c fits int16
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if filter_type == 0:
        pred = 0
    elif filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    elif filter_type == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"unknown PNG filter type {filter_type}")
    rows = np.empty((h, x.shape[1] + 1), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = (x - pred) & 255
    return rows


def encode_png(img: np.ndarray, filter_type: int = 0,
               level: int = 6) -> bytes:
    """(H, W) grey, or (H, W, C) with C = 1 grey, 2 grey-alpha, 3 RGB, 4
    RGBA, uint8 -> 8-bit PNG bytes, every row filtered with
    `filter_type` (default 0, None)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"encode_png takes (H, W[, 1-4]), got {img.shape}")
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = _filter_rows(np.ascontiguousarray(img), filter_type)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def ensure(root) -> bool:
    """The tree at `root`, written there (seed 0, the real sizes) unless a
    complete one is there; True when this call wrote it.  It is written
    into ``<root>.partial`` and renamed, so a run cut off while writing
    leaves no tree that looks whole, and the next run starts it anew."""
    if is_synthetic(root):
        return False
    part = f"{root}.partial"
    shutil.rmtree(part, ignore_errors=True)
    write_asset_tree(part)
    shutil.rmtree(root, ignore_errors=True)
    os.replace(part, root)
    return True
