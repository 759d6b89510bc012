"""Scene flattening: models -> one batch of triangle-expanded tensors.

Counterpart of the JAX package's ``models/scene_batch.py``: vertex
attributes are expanded per triangle in the planar (3 verts, comps, T)
layout, giant triangles are midpoint-split, per-triangle static shading
flags ride in a (5, T) block, and the material atlas is packed and
bilinear-expanded into one (N, 12) int32 table.  Models are merged in
mesh-entity order, each with its material offset and entity index.  The
JAX package's tile-sampler atlas page is not built: the texture kernel
K5 reads the (N, 12) table directly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .texture import PackedMaterialAtlas, expand_atlas_bilinear, \
    pack_material_atlas


@dataclass(frozen=True)
class SceneBatch:
    """Merged triangle-expanded scene geometry (static across frames)."""
    tri_pos: torch.Tensor       # (3 verts, 3 xyz, T) f32 object space
    tri_nrm: torch.Tensor       # (3, 3, T) f32 object-space vertex normals
    tri_uv: torch.Tensor        # (3 verts, 2, T) f32
    tri_entity: torch.Tensor    # (T,) i32 mesh-entity index
    static_rows: torch.Tensor   # (5, T) f32: [material_id, has_normal,
    #                              has_metallic_roughness, has_emissive,
    #                              is_terrain]
    atlas_packed: torch.Tensor  # (M * layer_stride, 12) int32
    cloud_noise: torch.Tensor | None = None  # (64, 64) f32 tiled noise

    @property
    def num_triangles(self):
        return self.tri_pos.shape[2]


def split_large_triangles(pos, nrm, uv, ent, mat, max_extent: float,
                          max_rounds: int = 4):
    """Midpoint-split triangles whose bbox extent exceeds max_extent
    (world units), at the longest edge.  Keeps the raster bin expansion
    bounded."""
    for _ in range(max_rounds):
        ext = (pos.max(axis=1) - pos.min(axis=1)).max(axis=-1)
        big = ext > max_extent
        if not big.any():
            break
        keep = ~big
        bp, bn, bu = pos[big], nrm[big], uv[big]
        be, bm = ent[big], mat[big]
        e0 = np.linalg.norm(bp[:, 1] - bp[:, 0], axis=-1)
        e1 = np.linalg.norm(bp[:, 2] - bp[:, 1], axis=-1)
        e2 = np.linalg.norm(bp[:, 0] - bp[:, 2], axis=-1)
        longest = np.argmax(np.stack([e0, e1, e2], -1), axis=-1)

        def mid(a, b):
            return (a + b) * 0.5

        new_p, new_n, new_u = [], [], []
        for arr, out in ((bp, new_p), (bn, new_n), (bu, new_u)):
            a, b, c = arr[:, 0], arr[:, 1], arr[:, 2]
            m01, m12, m20 = mid(a, b), mid(b, c), mid(c, a)
            t1 = np.where(longest[:, None, None] == 0,
                          np.stack([a, m01, c], 1),
                          np.where(longest[:, None, None] == 1,
                                   np.stack([a, b, m12], 1),
                                   np.stack([a, b, m20], 1)))
            t2 = np.where(longest[:, None, None] == 0,
                          np.stack([m01, b, c], 1),
                          np.where(longest[:, None, None] == 1,
                                   np.stack([a, m12, c], 1),
                                   np.stack([m20, b, c], 1)))
            out.append(np.concatenate([t1, t2]))
        pos = np.concatenate([pos[keep], new_p[0]])
        nrm = np.concatenate([nrm[keep], new_n[0]])
        uv = np.concatenate([uv[keep], new_u[0]])
        ent = np.concatenate([ent[keep], be, be])
        mat = np.concatenate([mat[keep], bm, bm])
    return pos, nrm, uv, ent, mat


def build_scene_batch(models, atlas_size: int = 1024, workers: int = 8,
                      split_extent_frac: float = 0.125, device="cpu",
                      ) -> tuple[SceneBatch, PackedMaterialAtlas]:
    """models[i] belongs to mesh-entity i (creation order)."""
    all_materials, all_images, mat_offsets = [], [], []
    for m in models:
        mat_offsets.append(len(all_materials))
        img_off = len(all_images)
        all_images.extend(m.images)
        for md in m.materials:
            all_materials.append(dataclasses.replace(md, **{
                k: (getattr(md, k) + img_off if getattr(md, k) >= 0 else -1)
                for k in md.IMAGE_SLOTS}))

    atlas = pack_material_atlas(all_materials, all_images, size=atlas_size,
                                workers=workers)

    pos_l, nrm_l, uv_l, ent_l, mat_l, ter_l = [], [], [], [], [], []
    for ei, (m, moff) in enumerate(zip(models, mat_offsets)):
        tris = m.triangles.astype(np.int64)
        pos_l.append(m.positions[tris])
        nrm_l.append(m.normals[tris])
        uv_l.append(m.uvs[tris])
        ent_l.append(np.full(len(tris), ei, np.int32))
        mat_l.append(m.tri_material.astype(np.int32) + moff)
        ter_l.append(np.full(len(tris), 1.0 if m.terrain else 0.0,
                             np.float32))

    pos = np.concatenate(pos_l).astype(np.float32)
    nrm = np.concatenate(nrm_l).astype(np.float32)
    uv = np.concatenate(uv_l).astype(np.float32)
    ent = np.concatenate(ent_l)
    mat = np.concatenate(mat_l)
    ter = np.concatenate(ter_l)

    if split_extent_frac:
        scene_ext = float((pos.reshape(-1, 3).max(0)
                           - pos.reshape(-1, 3).min(0)).max())
        pos, nrm, uv, ent, matter = split_large_triangles(
            pos, nrm, uv, ent, np.stack([mat.astype(np.float32), ter], -1),
            scene_ext * split_extent_frac)
        mat = matter[:, 0].astype(np.int32)
        ter = matter[:, 1]

    def flag(attr):
        tbl = np.array([1.0 if getattr(mm, attr) >= 0 else 0.0
                        for mm in all_materials], np.float32)
        return tbl[mat]

    has = np.stack([
        mat.astype(np.float32),
        flag("normal_image"),
        flag("metallic_roughness_image"),
        flag("emissive_image"),
        ter,
    ], axis=0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    batch = SceneBatch(
        tri_pos=t(pos.transpose(1, 2, 0)),
        tri_nrm=t(nrm.transpose(1, 2, 0)),
        tri_uv=t(uv.transpose(1, 2, 0)),
        tri_entity=t(ent), static_rows=t(has),
        atlas_packed=t(expand_atlas_bilinear(atlas)),
    )
    return batch, atlas
