"""glTF 2.0 / GLB model loader (host side, numpy) and the model containers.

Counterpart of the JAX package's ``models/gltf.py``, itself a rebuild of
the reference's fastgltf-based loader (``src/graphics/model.{hpp,cpp}``
there) against the glTF 2.0 spec:

* ``.gltf`` (JSON + external buffers/images, percent-encoded URIs, data
  URIs) and ``.glb`` binary containers (``model.cpp:26-50``);
* accessors with byteStride interleaving (read to the spec's exact
  ``stride*(count-1)+itemsize`` end), normalised integer types and
  sparse values that take the parent's component type; indices in
  u8/u16/u32 rebased to one merged vertex pool;
* materials with the five reference texture slots and the pbr factors;
* the default scene only, child nodes visited once; node transforms are
  ignored like the reference does (``model.cpp:290-296``) unless
  ``apply_node_transforms``.

Unlike the JAX package, ``ModelData.images`` holds DECODED (H, W, 4)
uint8 arrays (decoded at load, :func:`.texture.decode_images_parallel`),
and ``ModelData`` carries no tangents: no pass of either package reads
them.
"""
from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path
from urllib.parse import unquote

import numpy as np

from .texture import decode_images_parallel

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


@dataclass
class MaterialData:
    albedo_image: int = -1            # index into ModelData.images, -1 = none
    metallic_roughness_image: int = -1
    normal_image: int = -1
    occlusion_image: int = -1
    emissive_image: int = -1
    # factors kept for completeness (the reference samples textures only)
    base_color_factor: tuple = (1.0, 1.0, 1.0, 1.0)
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    emissive_factor: tuple = (0.0, 0.0, 0.0)

    IMAGE_SLOTS = ("albedo_image", "metallic_roughness_image",
                   "normal_image", "occlusion_image", "emissive_image")


@dataclass
class PrimitiveRange:
    first_index: int
    first_vertex: int
    index_count: int
    vertex_count: int
    material_index: int


@dataclass
class ModelData:
    positions: np.ndarray     # (V, 3) f32
    normals: np.ndarray       # (V, 3) f32
    uvs: np.ndarray           # (V, 2) f32
    indices: np.ndarray       # (I,) u32
    primitives: list[PrimitiveRange] = field(default_factory=list)
    materials: list[MaterialData] = field(default_factory=list)
    images: list[np.ndarray] = field(default_factory=list)  # RGBA u8
    terrain: bool = False

    @property
    def triangles(self) -> np.ndarray:
        return self.indices.reshape(-1, 3)

    @property
    def tri_material(self) -> np.ndarray:
        """(T,) int32 material index per triangle."""
        out = np.zeros(len(self.indices) // 3, np.int32)
        for p in self.primitives:
            t0 = p.first_index // 3
            out[t0:t0 + p.index_count // 3] = p.material_index
        return out


def _read_accessor(gltf: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    """Decode accessor idx -> (count, ncomp) float32/int array.

    Handles byteStride interleaving and KHR_mesh_quantization normalized
    integer types (normalized -> float in [-1,1]/[0,1] per spec).
    """
    acc = gltf["accessors"][idx]
    ncomp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    if "bufferView" not in acc:
        out = np.zeros((count, ncomp), dtype)
    else:
        view = gltf["bufferViews"][acc["bufferView"]]
        buf = buffers[view["buffer"]]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        itemsize = np.dtype(dtype).itemsize * ncomp
        stride = view.get("byteStride", itemsize)
        if stride == itemsize:
            out = np.frombuffer(buf, dtype, count * ncomp, offset)
            out = out.reshape(count, ncomp)
        else:
            # spec-legal views end stride*(count-1)+itemsize bytes in —
            # reading count*stride would overrun the final partial row
            nbytes = stride * (count - 1) + itemsize
            rows = np.frombuffer(buf, np.uint8, nbytes, offset)
            rows = np.lib.stride_tricks.as_strided(
                rows, (count, itemsize), (stride, 1), writeable=False
            ).copy()
            out = rows.view(dtype).reshape(count, ncomp)
    if "sparse" in acc:
        sp = acc["sparse"]
        out = out.copy()
        sidx = _read_raw(gltf, buffers, sp["indices"], sp["count"]).ravel()
        # spec: sparse.values has no componentType of its own — it
        # inherits the parent accessor's (indices carry their own)
        svals = _read_raw(gltf, buffers,
                          {**sp["values"],
                           "componentType": acc["componentType"]},
                          sp["count"] * ncomp)
        out[sidx.astype(np.int64)] = svals.reshape(sp["count"], ncomp)
    if acc.get("normalized") and np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        out = out.astype(np.float32) / info.max
        if info.min < 0:
            out = np.maximum(out, -1.0)
    return out


def _read_raw(gltf, buffers, ref, n):
    view = gltf["bufferViews"][ref["bufferView"]]
    dtype = _COMPONENT_DTYPES[ref.get("componentType", 5126)]
    offset = view.get("byteOffset", 0) + ref.get("byteOffset", 0)
    return np.frombuffer(buffers[view["buffer"]], dtype, n, offset)


def _load_buffers_and_blob(path: Path):
    """Returns (gltf json dict, [buffer bytes], glb_blob or None)."""
    raw = path.read_bytes()
    if raw[:4] == b"glTF":
        # GLB container: 12-byte header, then chunks (JSON, BIN).
        _, _, _ = struct.unpack("<4sII", raw[:12])
        off, gltf, blob = 12, None, None
        while off < len(raw):
            clen, ctype = struct.unpack_from("<I4s", raw, off)
            data = raw[off + 8:off + 8 + clen]
            if ctype == b"JSON":
                gltf = json.loads(data)
            elif ctype == b"BIN\x00":
                blob = data
            off += 8 + clen
    else:
        gltf, blob = json.loads(raw), None
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(blob)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            # glTF 2.0 URIs are percent-encoded ("scene%20data.bin" on
            # disk is "scene data.bin") — decode like _image_bytes does
            buffers.append((path.parent / unquote(uri)).read_bytes())
    return gltf, buffers, blob


def _image_bytes(gltf, buffers, path: Path, img: dict) -> bytes:
    uri = img.get("uri")
    if uri is None:
        view = gltf["bufferViews"][img["bufferView"]]
        off = view.get("byteOffset", 0)
        return bytes(buffers[view["buffer"]][off:off + view["byteLength"]])
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    return (path.parent / unquote(uri)).read_bytes()


def _node_world_matrices(gltf) -> dict[int, np.ndarray]:
    """Correct hierarchy walk (used only with apply_node_transforms)."""
    from ..utils import mathutil as mu
    nodes = gltf.get("nodes", [])
    children = {i: n.get("children", []) for i, n in enumerate(nodes)}
    roots = set(range(len(nodes)))
    for cs in children.values():
        roots -= set(cs)

    def local(n):
        if "matrix" in n:
            return np.array(n["matrix"], np.float32).reshape(4, 4).T
        m = np.eye(4, dtype=np.float32)
        if "scale" in n:
            m = m @ np.diag(list(n["scale"]) + [1.0]).astype(np.float32)
        if "rotation" in n:
            x, y, z, w = n["rotation"]
            r = np.eye(4, dtype=np.float32)
            r[:3, :3] = mu.quat_to_mat3((w, x, y, z))
            m = r @ m
        if "translation" in n:
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = n["translation"]
            m = t @ m
        return m

    world = {}

    def walk(i, parent):
        world[i] = parent @ local(nodes[i])
        for c in children.get(i, []):
            walk(c, world[i])

    for r in sorted(roots):
        walk(r, np.eye(4, dtype=np.float32))
    return world


def load_model(path: str | Path, apply_node_transforms: bool = False
               ) -> ModelData:
    """Load a .gltf/.glb file into a ModelData.

    apply_node_transforms=False reproduces the reference's behaviour of
    reading raw accessor data (model.cpp:290-345).  TANGENT is not read:
    no pass of either package samples it.
    """
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"couldn't load model at path {path}")
    gltf, buffers, _ = _load_buffers_and_blob(path)

    # --- images, decoded at load (the atlas packer takes RGBA uint8; the
    # sRGB/linear split by usage, model.cpp:52-72, is in the packer's
    # fixed slot layout)
    images = decode_images_parallel(
        [_image_bytes(gltf, buffers, path, img)
         for img in gltf.get("images", [])])
    textures = gltf.get("textures", [])

    def tex_image(tex_idx):
        if tex_idx is None:
            return -1
        src = textures[tex_idx].get("source", -1)
        return src if src is not None else -1

    materials = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})

        def tix(d):
            return tex_image(d.get("index")) if d else -1

        md = MaterialData(
            albedo_image=tix(pbr.get("baseColorTexture")),
            metallic_roughness_image=tix(pbr.get("metallicRoughnessTexture")),
            normal_image=tix(m.get("normalTexture")),
            occlusion_image=tix(m.get("occlusionTexture")),
            emissive_image=tix(m.get("emissiveTexture")),
            base_color_factor=tuple(pbr.get("baseColorFactor",
                                            (1.0, 1.0, 1.0, 1.0))),
            metallic_factor=pbr.get("metallicFactor", 1.0),
            roughness_factor=pbr.get("roughnessFactor", 1.0),
            emissive_factor=tuple(m.get("emissiveFactor", (0.0, 0.0, 0.0))),
        )
        materials.append(md)
    if not materials:
        materials.append(MaterialData())

    world = _node_world_matrices(gltf) if apply_node_transforms else {}

    # --- geometry: merged pools + primitive ranges
    positions, normals, uvs, indices = [], [], [], []
    prims = []
    vertex_offset = index_offset = 0
    # glTF spec: render the DEFAULT scene ("scene" index, else the
    # first); walking every scene double-loads nodes shared between
    # scenes.  With no "scenes" at all, the roots are the nodes never
    # referenced as children (seeding the DFS with EVERY node would
    # visit children twice: once as pseudo-root, once via the walk).
    if "scenes" in gltf:
        scene_list = [gltf["scenes"][gltf.get("scene", 0)]]
    else:
        nodes = gltf.get("nodes", [])
        child_set = {c for nd in nodes for c in nd.get("children", [])}
        scene_list = [{"nodes": [i for i in range(len(nodes))
                                 if i not in child_set]}]
    for scene in scene_list:
        for node_idx in scene.get("nodes", []):
            stack = [node_idx]
            while stack:
                ni = stack.pop()
                node = gltf["nodes"][ni]
                stack.extend(node.get("children", []))
                if "mesh" not in node:
                    continue
                mesh = gltf["meshes"][node["mesh"]]
                for prim in mesh["primitives"]:
                    if prim.get("mode", 4) != 4:  # triangles only
                        continue
                    attrs = prim["attributes"]
                    pos = _read_accessor(gltf, buffers, attrs["POSITION"])
                    pos = pos.astype(np.float32)
                    vc = len(pos)
                    nrm = (_read_accessor(gltf, buffers, attrs["NORMAL"])
                           .astype(np.float32) if "NORMAL" in attrs
                           else np.zeros((vc, 3), np.float32))
                    uv = (_read_accessor(gltf, buffers, attrs["TEXCOORD_0"])
                          .astype(np.float32) if "TEXCOORD_0" in attrs
                          else np.zeros((vc, 2), np.float32))
                    if apply_node_transforms and ni in world:
                        m = world[ni]
                        pos = pos @ m[:3, :3].T + m[:3, 3]
                        nm = np.linalg.inv(m[:3, :3]).T
                        nrm = nrm @ nm.T
                    if "indices" in prim:
                        idx = _read_accessor(gltf, buffers, prim["indices"])
                        idx = idx.ravel().astype(np.uint32)
                    else:
                        idx = np.arange(vc, dtype=np.uint32)
                    ic = len(idx)
                    positions.append(pos[:, :3])
                    normals.append(nrm[:, :3])
                    uvs.append(uv[:, :2])
                    indices.append(idx + vertex_offset)  # rebased to pool
                    prims.append(PrimitiveRange(
                        first_index=index_offset, first_vertex=vertex_offset,
                        index_count=ic, vertex_count=vc,
                        material_index=prim.get("material", 0)))
                    vertex_offset += vc
                    index_offset += ic

    def cat(parts, shape, dtype=np.float32):
        return np.concatenate(parts) if parts else np.zeros(shape, dtype)

    return ModelData(
        positions=cat(positions, (0, 3)), normals=cat(normals, (0, 3)),
        uvs=cat(uvs, (0, 2)), indices=cat(indices, (0,), np.uint32),
        primitives=prims, materials=materials, images=images)
