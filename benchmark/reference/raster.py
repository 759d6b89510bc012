"""The reference raster: every pixel of every triangle's box, no bins.

The setup (:func:`triangle_setup_planar`, the homogeneous adjugate
coverage and the exact near-plane-aware box) and the per-pixel test
(:func:`_eval_records`) are frozen copies of the port's
``ops/raster2.py``.  The resolve is the benchmark's own: where the port
sorts (bin, triangle) pairs into 64x32 bins under data-sized caps, this
tests each pixel of each valid triangle's box, in chunks, and keeps per
pixel the smallest z, ties to the lower id (the port's rule).  It has no
caps, so a triangle the port's binning drops shows as a mismatch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

W_EPS = 1e-6


@dataclass(frozen=True)
class VisibilityBuffer:
    depth: torch.Tensor          # (*V, H, W) f32 in [0, 1]; 1.0: no hit
    tri_id: torch.Tensor | None  # (*V, H, W) int32; -1 where no hit
    overflow: torch.Tensor       # (*V,) int32 OVERFLOW_* bitmask


@dataclass(frozen=True)
class PlanarSetup:
    """Rows first, then the view axis if any (*V), then triangles."""
    adj: torch.Tensor     # (9, *V, T) adjugate rows * facing sign
    zs: torch.Tensor      # (3, *V, T) per-vertex clip z
    ws: torch.Tensor      # (3, *V, T) per-vertex clip w
    bbox: torch.Tensor    # (4, *V, T): x0, y0, x1, y1 (px, x1/y1 excl.)
    valid: torch.Tensor   # (*V, T) bool


def triangle_setup_planar(clip, width, height, cull: str = "front"
                          ) -> PlanarSetup:
    """clip: (3 verts, 4 comps, T) planar clip positions, or (B, 3, 4, T)
    for B views."""
    if clip.dim() == 4:
        clip = clip.permute(1, 2, 0, 3)          # (3, 4, B, T)
    w = clip[:, 3]
    X = (clip[:, 0] * 0.5 + 0.5 * w) * width
    Y = (clip[:, 1] * 0.5 + 0.5 * w) * height
    z = clip[:, 2]
    a, b, c = X[0], X[1], X[2]
    d, e, f = Y[0], Y[1], Y[2]
    g, h, i = w[0], w[1], w[2]
    r0 = (e * i - f * h, c * h - b * i, b * f - c * e)
    r1 = (f * g - d * i, a * i - c * g, c * d - a * f)
    r2 = (d * h - e * g, b * g - a * h, a * e - b * d)
    det = a * r0[0] + b * r1[0] + c * r2[0]

    if cull == "front":
        keep = det < 0
        s = torch.where(keep, -1.0, 0.0)
    elif cull == "back":
        keep = det > 0
        s = torch.where(keep, 1.0, 0.0)
    else:
        keep = det != 0
        s = torch.sign(det)
    adj = torch.stack(r0 + r1 + r2) * s[None]

    # exact screen bbox across the near plane: projected vertices with
    # w > eps plus the projections of edge crossings of the w = eps plane
    big = 1e9
    cand_x, cand_y, cand_ok = [], [], []
    for k in range(3):
        ok = w[k] > W_EPS
        wk = torch.where(ok, w[k], 1.0)
        cand_x.append(X[k] / wk)
        cand_y.append(Y[k] / wk)
        cand_ok.append(ok)
    for k, j in ((0, 1), (1, 2), (2, 0)):
        crosses = (w[k] > W_EPS) != (w[j] > W_EPS)
        dw = torch.where(torch.abs(w[j] - w[k]) > 1e-12, w[j] - w[k], 1.0)
        t = (W_EPS - w[k]) / dw
        xc = X[k] + t * (X[j] - X[k])
        yc = Y[k] + t * (Y[j] - Y[k])
        cand_x.append(xc / W_EPS)
        cand_y.append(yc / W_EPS)
        cand_ok.append(crosses)
    cx = torch.stack(cand_x)
    cy = torch.stack(cand_y)
    ok6 = torch.stack(cand_ok)
    x0 = torch.where(ok6, cx, big).amin(dim=0)
    x1 = torch.where(ok6, cx, -big).amax(dim=0)
    y0 = torch.where(ok6, cy, big).amin(dim=0)
    y1 = torch.where(ok6, cy, -big).amax(dim=0)
    any_ok = ok6.any(dim=0)
    x0 = torch.clamp(torch.floor(torch.where(any_ok, x0, 0.0)), 0, width)
    y0 = torch.clamp(torch.floor(torch.where(any_ok, y0, 0.0)), 0, height)
    x1 = torch.clamp(torch.ceil(torch.where(any_ok, x1, 0.0)) + 1.0, 0, width)
    y1 = torch.clamp(torch.ceil(torch.where(any_ok, y1, 0.0)) + 1.0, 0,
                     height)
    bbox = torch.stack([x0, y0, x1, y1])
    w_ok = (w > W_EPS).all(dim=0)
    wsafe = torch.where(torch.abs(w) > W_EPS, w, W_EPS)

    zndc = z / wsafe
    z_ok = torch.where(w_ok, ~((zndc < 0.0).all(0) | (zndc > 1.0).all(0)),
                       True)
    valid = keep & (x1 > x0) & (y1 > y0) & z_ok & (det != 0)
    return PlanarSetup(adj=adj, zs=z, ws=w, bbox=bbox, valid=valid)


def _eval_records(rec, px, py):
    """Coverage + depth of records (16, ...) at pixel centres, in the
    operation order of the TPU kernel (raster2.py:613-621)."""
    e0 = rec[0] * px + rec[1] * py + rec[2]
    e1 = rec[3] * px + rec[4] * py + rec[5]
    e2 = rec[6] * px + rec[7] * py + rec[8]
    cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
    ez = e0 * rec[9] + e1 * rec[10] + e2 * rec[11]
    ew = e0 * rec[12] + e1 * rec[13] + e2 * rec[14]
    cov = cov & (ew > 0)
    z = ez / torch.where(ew != 0, ew, 1.0)
    cov = cov & (z >= 0.0) & (z <= 1.0)
    return cov, z




def transform_triangles(batch, model_mats, normal_mats):
    """World transform of the planar triangle batch: per-triangle entity
    matrices, (3 verts, 3, T) positions and normals (the port's
    ``graph/frame.transform_triangles``)."""
    mats = model_mats.reshape(-1, 16)[batch.tri_entity.long()].T   # (16, T)
    nmats = normal_mats.reshape(-1, 16)[batch.tri_entity.long()].T

    def apply(m16, pts, translate):
        out = []
        for v in range(3):
            p = pts[v]
            rows = []
            for i in range(3):
                r = (m16[i * 4 + 0] * p[0] + m16[i * 4 + 1] * p[1]
                     + m16[i * 4 + 2] * p[2])
                if translate:
                    r = r + m16[i * 4 + 3]
                rows.append(r)
            out.append(torch.stack(rows))
        return torch.stack(out)                         # (3, 3, T)

    return apply(mats, batch.tri_pos, True), apply(nmats, batch.tri_nrm,
                                                   False)


def clip_of(world, view_proj):
    """world (3, 3, T) -> clip (3 verts, 4, T) planar."""
    m = view_proj[..., None]
    outs = []
    for v in range(3):
        p = world[v]
        outs.append(torch.stack([
            m[i, 0] * p[0] + m[i, 1] * p[1] + m[i, 2] * p[2] + m[i, 3]
            for i in range(4)]))
    return torch.stack(outs)


def resolve(setup: PlanarSetup, width: int, height: int, quantize=None,
            budget: int = 1 << 23):
    """(depth (H, W), tri_id (H, W), covered): per pixel the smallest z
    of the valid triangles that cover its centre, ties to the lower id
    (1.0 and -1 where none does), and the number of (triangle, pixel)
    pairs found covered.  Each valid triangle's box is tested pixel by
    pixel, `budget` tests a chunk.  quantize: applied to each z before
    the depth test and to the stored depth (the control's 16-bit depth
    buffer), None for float32."""
    dev = setup.adj.device
    rec = torch.cat([setup.adj, setup.zs, setup.ws], dim=0)      # (15, T)
    x0, y0, x1, y1 = (setup.bbox[i].to(torch.int64) for i in range(4))
    bw = torch.clamp(x1 - x0, min=0)
    area = torch.where(setup.valid, bw * torch.clamp(y1 - y0, min=0), 0)
    tris = torch.nonzero(area > 0).squeeze(1)
    ends = torch.cumsum(area[tris], 0).cpu()
    # chunk boundaries: runs of triangles of at most `budget` tests (a
    # triangle larger than that is a chunk of its own)
    cuts, lo = [0], 0
    while lo < len(tris):
        base = int(ends[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(ends, base + budget, right=True))
        lo = max(hi, lo + 1)
        cuts.append(lo)
    zbuf = torch.full((height * width,), float("inf"), device=dev)
    ibuf = torch.full((height * width,), 2 ** 30, dtype=torch.int32,
                      device=dev)

    def chunks():
        for a, b in zip(cuts, cuts[1:]):
            t = tris[a:b]
            n = area[t]
            start = torch.cumsum(n, 0) - n
            k = torch.arange(int(n.sum()), device=dev)
            j = torch.searchsorted(start, k, right=True) - 1
            tj = t[j]
            local = k - start[j]
            px = x0[tj] + local % bw[tj]
            py = y0[tj] + torch.div(local, bw[tj], rounding_mode="floor")
            cov, z = _eval_records(rec[:, tj], px.to(torch.float32) + 0.5,
                                   py.to(torch.float32) + 0.5)
            if quantize is not None:
                z = quantize(z)
            yield tj, cov, z, py * width + px

    covered = 0
    for _, cov, z, flat in chunks():
        zbuf.scatter_reduce_(0, flat[cov], z[cov], reduce="amin")
        covered += int(cov.sum())
    for tj, cov, z, flat in chunks():
        win = cov & (z == zbuf[flat])
        ibuf.scatter_reduce_(0, flat[win], tj[win].to(torch.int32),
                             reduce="amin")
    hit = ibuf < 2 ** 30
    depth = torch.where(hit, zbuf, 1.0).reshape(height, width)
    tri_id = torch.where(hit, ibuf, -1).reshape(height, width)
    return depth, tri_id, covered
