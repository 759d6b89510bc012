"""The port's glTF loader (``models/gltf.py``) against the JAX package's, on
files this test writes: the spec cases of tests/test_gltf_spec.py (a
percent-encoded buffer URI, child nodes loaded once, the default scene
only, sparse values that take the parent's component type, an
interleaved view read to its exact end), a .gltf / .glb pair of one mesh,
the node hierarchy with ``apply_node_transforms``, images from files,
data URIs and GLB buffer views (decoded at load in the port, equal to
the JAX package's ``decode_image`` of its ``ImageRef`` bytes), and the
synthetic helmet of ``tools/synth_assets.py``.  Every array must be
equal: both loaders are the same numpy code.
"""
import base64
import dataclasses
import json
import struct

import numpy as np
import pytest

from soc_real_time_renderer_tpu.models import gltf as jgltf
from soc_real_time_renderer_tpu.models import texture as jtexture
from soc_real_time_renderer_tpu_torch.models import gltf as pgltf
from soc_real_time_renderer_tpu_torch.tools import synth_assets
from soc_real_time_renderer_tpu_torch.utils import png

TRI = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
TRI2 = TRI + np.array([2.0, 0, 0], np.float32)


def _uri(raw: bytes, mime="application/octet-stream"):
    return f"data:{mime};base64," + base64.b64encode(raw).decode()


def _tri_doc(positions, extra=None):
    raw = positions.astype(np.float32).tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": _uri(raw), "byteLength": len(raw)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(raw)}],
        "accessors": [{"bufferView": 0, "componentType": 5126,
                       "count": len(positions), "type": "VEC3"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
    }
    doc.update(extra or {})
    return doc


def _write(tmp_path, doc, name="t.gltf"):
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return p


def assert_models_equal(jm, pm):
    """Every field the port keeps, equal; JAX images decoded through the
    JAX package's decode_image equal the port's decoded images."""
    for name in ("positions", "normals", "uvs", "indices"):
        a, b = getattr(jm, name), getattr(pm, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert [dataclasses.astuple(p) for p in jm.primitives] \
        == [dataclasses.astuple(p) for p in pm.primitives]
    assert [vars(m) for m in jm.materials] == [vars(m) for m in pm.materials]
    assert len(jm.images) == len(pm.images)
    for ref, img in zip(jm.images, pm.images):
        want = jtexture.decode_image(ref.data)
        assert img.dtype == np.uint8 and img.tobytes() == want.tobytes()
    assert jm.terrain == pm.terrain


def _load_both(path, **kw):
    jm, pm = jgltf.load_model(path, **kw), pgltf.load_model(path, **kw)
    assert_models_equal(jm, pm)
    return pm


def test_percent_encoded_buffer_uri(tmp_path):
    raw = TRI.tobytes()
    (tmp_path / "scene data.bin").write_bytes(raw)
    doc = _tri_doc(TRI, extra={"nodes": [{"mesh": 0}]})
    doc["buffers"] = [{"uri": "scene%20data.bin", "byteLength": len(raw)}]
    assert len(_load_both(_write(tmp_path, doc)).triangles) == 1


def test_no_scenes_child_nodes_load_once(tmp_path):
    doc = _tri_doc(np.concatenate([TRI, TRI2]), extra={
        "nodes": [{"mesh": 0, "children": [1]}, {"mesh": 0}]})
    assert len(_load_both(_write(tmp_path, doc)).triangles) == 4


def test_default_scene_only(tmp_path):
    doc = _tri_doc(np.concatenate([TRI, TRI2]), extra={
        "nodes": [{"mesh": 0}], "scenes": [{"nodes": [0]}, {"nodes": [0]}],
        "scene": 1})
    assert len(_load_both(_write(tmp_path, doc)).triangles) == 2


def test_sparse_values_inherit_component_type():
    base = np.zeros((3, 4), np.uint8)
    raws = [TRI.tobytes(), base.tobytes(), np.array([1], np.uint16).tobytes(),
            np.array([[255, 128, 0, 64]], np.uint8).tobytes()]
    off = np.cumsum([0] + [len(r) for r in raws])
    blob = b"".join(raws)
    doc = {
        "bufferViews": [{"buffer": 0, "byteOffset": int(off[i]),
                         "byteLength": len(raws[i])} for i in range(4)],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5121, "count": 3,
             "type": "VEC4", "normalized": True,
             "sparse": {"count": 1,
                        "indices": {"bufferView": 2, "componentType": 5123},
                        "values": {"bufferView": 3}}}],
    }
    a = jgltf._read_accessor(doc, [blob], 1)
    b = pgltf._read_accessor(doc, [blob], 1)
    assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    np.testing.assert_allclose(b[1], [1.0, 128 / 255, 0.0, 64 / 255],
                               atol=1e-6)


def test_interleaved_view_exact_length(tmp_path):
    count, stride = 3, 16
    raw = bytearray(stride * (count - 1) + 12)
    for i, v in enumerate(TRI):
        raw[i * stride:i * stride + 12] = v.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": _uri(bytes(raw)), "byteLength": len(raw)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(raw), "byteStride": stride}],
        "accessors": [{"bufferView": 0, "componentType": 5126,
                       "count": count, "type": "VEC3"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "nodes": [{"mesh": 0}], "scenes": [{"nodes": [0]}],
    }
    pm = _load_both(_write(tmp_path, doc))
    np.testing.assert_array_equal(pm.positions, TRI)


def _mesh_parts(rng):
    """A two-primitive mesh (u8 and u32 indices, normalised-short UVs) and
    a node hierarchy with TRS and matrix transforms, plus two images:
    one PNG in a buffer view, one as a data URI."""
    pos = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    nrm = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    uv = rng.integers(-32767, 32767, (6, 2)).astype(np.int16)
    idx8 = np.array([0, 1, 2], np.uint8)
    idx32 = np.array([3, 4, 5, 5, 4, 3], np.uint32)
    img_a = png.encode_png(rng.integers(0, 256, (9, 7, 3)).astype(np.uint8),
                           filter_type=4)
    img_b = png.encode_png(rng.integers(0, 256, (5, 11)).astype(np.uint8),
                           filter_type=3)
    parts = [pos.tobytes(), nrm.tobytes(), uv.tobytes(), idx8.tobytes(),
             idx32.tobytes(), img_a]
    blob, views = b"", []
    for p in parts:
        blob += b"\0" * (-len(blob) % 4)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(p)})
        blob += p
    doc = {
        "asset": {"version": "2.0"},
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 6,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 6,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5122, "count": 6,
             "type": "VEC2", "normalized": True},
            {"bufferView": 3, "componentType": 5121, "count": 3,
             "type": "SCALAR"},
            {"bufferView": 4, "componentType": 5125, "count": 6,
             "type": "SCALAR"}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
             "indices": 3, "material": 1},
            {"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 4},
            {"attributes": {"POSITION": 0}, "mode": 1}]}],
        "nodes": [
            {"children": [1, 2], "translation": [1.0, 2.0, 3.0],
             "rotation": [0.0, 0.3826834, 0.0, 0.9238795],
             "scale": [2.0, 1.0, 0.5]},
            {"mesh": 0, "matrix": [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0,
                                   0.5, 0, 0, 1]},
            {"mesh": 0, "translation": [0.0, -1.0, 0.0]}],
        "scenes": [{"nodes": [0]}],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                      "metallicFactor": 0.25}},
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.5, 0.25, 1.0, 1.0],
                "metallicRoughnessTexture": {"index": 1}},
             "emissiveTexture": {"index": 0},
             "emissiveFactor": [1.0, 0.5, 0.0]}],
        "textures": [{"source": 0}, {"source": 1}],
        "images": [{"bufferView": 5, "mimeType": "image/png"},
                   {"uri": _uri(img_b, "image/png")}],
    }
    return doc, blob


def _glb(doc, blob):
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    body = (struct.pack("<I4s", len(js), b"JSON") + js
            + struct.pack("<I4s", len(blob), b"BIN\x00") + blob)
    return struct.pack("<4sII", b"glTF", 2, 12 + len(body)) + body


def test_gltf_and_glb_agree_and_node_transforms(tmp_path):
    """The same mesh as a .gltf with an external buffer and as a .glb:
    equal models in both packages, with and without the node walk."""
    doc, blob = _mesh_parts(np.random.default_rng(1))
    (tmp_path / "m.bin").write_bytes(blob)
    gdoc = dict(doc, buffers=[{"uri": "m.bin", "byteLength": len(blob)}])
    gpath = _write(tmp_path, gdoc, "m.gltf")
    bpath = tmp_path / "m.glb"
    bpath.write_bytes(_glb(dict(doc, buffers=[{"byteLength": len(blob)}]),
                           blob))
    for kw in ({}, {"apply_node_transforms": True}):
        a, b = _load_both(gpath, **kw), _load_both(bpath, **kw)
        assert_models_equal_port(a, b)
        assert len(a.triangles) == 2 * 3 and len(a.images) == 2
    moved = pgltf.load_model(gpath, apply_node_transforms=True)
    raw = pgltf.load_model(gpath)
    assert not np.allclose(moved.positions, raw.positions)
    assert raw.materials[1].base_color_factor == (0.5, 0.25, 1.0, 1.0)
    assert raw.materials[0].metallic_factor == 0.25
    assert raw.images[1].shape == (5, 11, 4)


def assert_models_equal_port(a, b):
    for name in ("positions", "normals", "uvs", "indices"):
        assert getattr(a, name).tobytes() == getattr(b, name).tobytes()
    assert a.primitives == b.primitives and a.materials == b.materials
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a.images, b.images))


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope.gltf"):
        pgltf.load_model(tmp_path / "nope.gltf")


def test_synthetic_helmet_loads_equal(tmp_path):
    """tools/synth_assets.py's helmet (interleaved stride-32 view, u16
    indices, five maps of mixed colour types and filters, a node
    rotation the default load ignores) through both loaders."""
    paths = synth_assets.write_asset_tree(
        str(tmp_path), rings=6, segments=9, helmet_map=32, sponza=False)
    pm = _load_both(paths["helmet"])
    assert len(pm.triangles) == 2 * 6 * 9 and pm.indices.max() < 7 * 10
    assert [img.shape for img in pm.images] == [(32, 32, 4)] * 5
    np.testing.assert_allclose(np.linalg.norm(pm.positions, axis=1), 1.0,
                               atol=1e-6)
    _load_both(paths["helmet"], apply_node_transforms=True)
