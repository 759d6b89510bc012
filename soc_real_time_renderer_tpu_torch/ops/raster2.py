"""Sort-binned rasterizer: planar setup -> (bin, tri) pairs -> bin resolve.

Counterpart of the JAX package's ``ops/raster2.py`` with the f32 record
layout only:

1. **Setup** (:func:`triangle_setup_planar`): homogeneous adjugate
   coverage, exact near-plane-aware screen bboxes, no clipping.
2. **Binning** (:func:`build_pairs`): each valid triangle emits its bin
   keys ``bin * ZQ + zq`` (4 inline slots, or ``med_slots`` slots for
   the first ``med_cap`` larger triangles, and for the first
   ``large_cap`` of those that span more than ``med_slots`` bins, every
   other bin of their bbox), one stable ``torch.sort`` groups them per
   bin, ``torch.searchsorted`` gives the starts; the ``pair_cap``
   truncation and the PAIRS and MED_CAP bits are the JAX package's.
   The third tier is the port's own: the JAX package cuts a medium
   triangle at ``med_slots`` bins and sets ``OVERFLOW_MED_SLOTS``, which
   here is set only when more triangles need the tier than
   ``large_cap`` holds, so a frame without it loses no coverage.
3. **Records** (:func:`build_records`): (20, T + 1) f32 [adj 9 | z 3 |
   w 3 | box 4 | id], gathered into bin order.  The box rows are the
   port's own: a record covers a pixel only inside its triangle's pixel
   box (the setup's bbox), where the JAX package's records (16 rows)
   let a sliver's float32 edge functions leak past it.
4. **Resolve** (:func:`resolve`): kernel K1 (``kernels/csrc/resolve.cu``)
   on a card, :func:`resolve_plain` on the CPU: per pixel the minimum-z
   covering record of its bin, ties to the lower id, clear 1.0 / -1.
   The shadow view's depth-only resolve (:func:`resolve_depth`) is
   kernel K4 in the same source, :func:`resolve_depth_plain` on the CPU.

Row bands (the row split of one frame over a mesh, parallel/mesh.py):
:func:`resolve` and :func:`resolve_depth` take a band of bin rows
(``row0``, ``band_by``) of the whole starts table and write the band's
rows alone, at the pixels' global centres; :func:`resolve_row_sharded`
launches once per band on the band's device, and ``rasterize(...,
shard=(mesh, axis))`` pads the bin grid to a multiple of the axis's
bands first.  Setup, binning, starts and records stay whole (made once,
replicated to each distinct device of the axis).

Views: every step takes an optional leading view axis (B views of one
scene, ``parallel/mesh.py``).  Clip positions (B, 3, 4, T) give a setup
whose rows are (k, B, T), per-view pair streams (B, S) sorted along
their last axis (each view's stream is its single-view stream), starts
(B, bins + 1), records (B, 20, cap) and one resolve launch for the B
views, (B, H, W) out.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..kernels import build as kb
from ..parallel import halo

W_EPS = 1e-6
# bin keys are bin_id * ZQ + quantized conservative min z, so each bin's
# records arrive near-to-far (the order the TPU kernel's early-out uses;
# the resolve here does not depend on it)
ZQ = 16384

# rows of a record: adjugate 9, z 3, w 3, box 4 (x0, y0, x1, y1), id
REC_ROWS = 20
OVERFLOW_PAIRS = 1       # sorted pair stream exceeded BinGrid.pair_cap
OVERFLOW_MED_CAP = 2     # more medium triangles than BinGrid.med_cap
OVERFLOW_MED_SLOTS = 4   # coverage dropped: more triangles span
#                          > med_slots bins than large_cap holds


def _cdiv(a, b):
    return -(-a // b)


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


@dataclass(frozen=True)
class BinGrid:
    """Static binning configuration for one render-target size (the JAX
    package's BinGrid without the TPU record-format knobs)."""
    width: int
    height: int
    bin_size: int = 64
    group: int = 2              # bins per row group (bx is a multiple)
    chunk: int = 128            # record-array width granularity
    pair_cap: int = 262144      # gathered record columns (sorted prefix)
    med_cap: int = 8192         # max "medium" triangles (bbox > n_small bins)
    med_slots: int = 64         # bins covered per medium triangle
    bin_w: int | None = None
    bin_h: int | None = None
    n_small: int = 4            # inline small-path slots per triangle
    large_cap: int = 64         # medium triangles given all their bins
    #                             past med_slots (the port's own field)

    def __post_init__(self):
        assert self.pair_cap >= self.chunk
        assert self.pair_cap % self.chunk == 0

    @property
    def bw(self):
        return self.bin_w or self.bin_size

    @property
    def bh(self):
        return self.bin_h or self.bin_size

    @property
    def bx(self):
        return _cdiv(self.width, self.bw * self.group) * self.group

    @property
    def by(self):
        return _cdiv(self.height, self.bh)

    @property
    def num_bins(self):
        return self.bx * self.by


def default_grid(width, height, kind="main"):
    """The JAX package's presets: 128-px bins for the shadow view,
    short-wide 64x32 bins for the main view."""
    if kind == "shadow":
        return BinGrid(width=width, height=height, bin_size=128, group=1)
    return BinGrid(width=width, height=height, bin_w=64, bin_h=32, group=2)


def build_records(setup: PlanarSetup) -> torch.Tensor:
    """(*V, 20, T+1) f32 [adj 9 | z 3 | w 3 | box 4: the setup's bbox
    x0, y0, x1, y1 in whole pixels, x1 and y1 exclusive | id as an exact
    float value]; column T is an always-miss sentinel."""
    T = setup.adj.shape[-1]
    ids = torch.arange(T, dtype=torch.float32, device=setup.adj.device)
    rec = torch.cat([setup.adj, setup.zs, setup.ws, setup.bbox,
                     ids.expand(1, *setup.adj.shape[1:])], dim=0)
    rec = torch.cat([rec, torch.zeros_like(rec[..., :1])], dim=-1)
    return rec.movedim(0, -2)


def build_pairs(setup: PlanarSetup, grid: BinGrid):
    """Returns (starts (*V, B+1) i32 clamped to pair_cap, sorted_tids
    (*V, S) i32, overflow (*V,) i32) with S = n_small*T +
    med_cap*med_slots + large_cap*max(0, B - med_slots), each view's
    stream sorted on its own."""
    dev = setup.adj.device
    T = setup.adj.shape[-1]
    V = setup.valid.shape[:-1]
    bw, bh = grid.bw, grid.bh
    BX, BY, B = grid.bx, grid.by, grid.num_bins
    i32 = torch.int32

    def bin_of(v, size, n):
        # x // size then int32 (the JAX floor-divide-and-convert), clipped
        return torch.clamp(torch.div(v, size, rounding_mode="floor").to(i32),
                           0, n - 1)

    x0, y0, x1, y1 = setup.bbox
    bx0 = bin_of(x0, bw, BX)
    by0 = bin_of(y0, bh, BY)
    bx1 = bin_of(x1 - 1.0, bw, BX)
    by1 = bin_of(y1 - 1.0, bh, BY)
    w = bx1 - bx0 + 1
    h = by1 - by0 + 1
    nb = w * h
    valid = setup.valid

    def slot_keys(bx0g, by0g, wg, hg, n_slots, first=0):
        """(n_slots - first, *V, N) bin keys of slots first.. (B =
        invalid)."""
        s = torch.arange(first, max(first, n_slots), dtype=i32,
                         device=dev).reshape((-1,) + (1,) * wg.dim())
        # wg is 0 only for invalid triangles (an empty bbox on the right
        # edge of a viewport narrower than its bin row), whose keys the
        # callers mask; the CPU's integer division by 0 raises
        wg = torch.clamp(wg, min=1)
        dx = s % wg[None, :]
        dy = torch.div(s, wg[None, :], rounding_mode="floor")
        ok = dy < hg[None, :]
        key = (by0g[None, :] + dy) * BX + bx0g[None, :] + dx
        return torch.where(ok, key, B)

    assert B <= (2 ** 31 - 1) // ZQ, "bin count overflows the z-sort key"
    wsafe = torch.where(torch.abs(setup.ws) > W_EPS, setup.ws, W_EPS)
    zndc = setup.zs / wsafe
    w_ok = (setup.ws > W_EPS).all(dim=0)
    zmin = torch.where(w_ok, torch.clamp(zndc.amin(dim=0), 0.0, 1.0), 0.0)
    zq = (zmin * (ZQ - 1)).to(i32)

    ns, mc, ms, lc = grid.n_small, grid.med_cap, grid.med_slots, \
        grid.large_cap
    tri_ids = torch.arange(T, dtype=i32, device=dev)
    small = valid & (nb <= ns)
    k_small = torch.where(small[None],
                          slot_keys(bx0, by0, w, h, ns) * ZQ + zq[None],
                          B * ZQ)

    def first_of(mask, cap):
        """The ids of the first `cap` triangles of `mask` in each view
        (id order), padded with T: triangle t goes to slot (members
        before it), the others to a spare slot `cap` that is dropped;
        and whether each triangle got a slot."""
        rank = torch.cumsum(mask.to(i32), dim=-1) - 1
        kept = mask & (rank < cap)
        slot = torch.where(kept, rank, cap).long()
        ids = torch.full((*V, cap + 1), T, dtype=i32, device=dev)
        return ids.scatter(-1, slot, tri_ids.expand(*V, T))[..., :cap], kept

    def tier_keys(ids, n_slots, first=0):
        i = torch.clamp(ids, max=T - 1).long()

        def at(x):
            return torch.gather(x, -1, i)

        k = slot_keys(at(bx0), at(by0), at(w), at(h), n_slots, first)
        return torch.where((ids < T)[None], k * ZQ + at(zq)[None], B * ZQ)

    med = valid & (nb > ns)
    med_ids, med_kept = first_of(med, mc)
    k_med = tier_keys(med_ids, ms)
    # the third tier: kept medium triangles past med_slots bins get their
    # remaining bins, slots med_slots .. B - 1, so no pair repeats
    large = med_kept & (nb > ms)
    large_ids, _ = first_of(large, lc)
    k_large = tier_keys(large_ids, B, first=ms)

    def stream(k, ids):
        """Per view: the tier's keys slot-major, and their ids."""
        n = k.shape[0]
        return (k.movedim(0, -2).reshape(*V, n * ids.shape[-1]),
                ids.unsqueeze(-2).expand(*V, n, ids.shape[-1])
                .reshape(*V, -1))

    parts = [stream(k_small, tri_ids.expand(*V, T)),
             stream(k_med, med_ids), stream(k_large, large_ids)]
    keys = torch.cat([k for k, _ in parts], dim=-1)
    tids = torch.cat([t for _, t in parts], dim=-1)
    sk, order = torch.sort(keys, dim=-1, stable=True)
    st = torch.gather(tids, -1, order)
    edges = torch.arange(B + 1, dtype=i32, device=dev) * ZQ
    starts = torch.searchsorted(sk, edges.expand(*V, B + 1).contiguous())
    total_pairs = starts[..., B]
    starts = torch.clamp(starts, max=grid.pair_cap).to(i32)

    zero = torch.zeros((), dtype=i32, device=dev)
    overflow = (torch.where(total_pairs > grid.pair_cap, OVERFLOW_PAIRS, zero)
                | torch.where(med.to(i32).sum(dim=-1) > mc,
                              OVERFLOW_MED_CAP, zero)
                | torch.where(large.to(i32).sum(dim=-1) > lc,
                              OVERFLOW_MED_SLOTS, zero))
    return starts, st, overflow.to(i32)


def _eval_records(rec, px, py):
    """Coverage + depth of records (20, ...) at pixel centres, in the
    operation order of the TPU kernel (raster2.py:613-621), and only
    inside the record's pixel box: a sliver's float32 edge functions can
    pass at pixels past its triangle (the JAX kernel leaks there)."""
    e0 = rec[0] * px + rec[1] * py + rec[2]
    e1 = rec[3] * px + rec[4] * py + rec[5]
    e2 = rec[6] * px + rec[7] * py + rec[8]
    cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
    cov = cov & (px > rec[15]) & (px < rec[17]) & (py > rec[16]) \
        & (py < rec[18])
    ez = e0 * rec[9] + e1 * rec[10] + e2 * rec[11]
    ew = e0 * rec[12] + e1 * rec[13] + e2 * rec[14]
    cov = cov & (ew > 0)
    z = ez / torch.where(ew != 0, ew, 1.0)
    cov = cov & (z >= 0.0) & (z <= 1.0)
    return cov, z


def _per_view(fn, starts, recs, *args, **kw):
    """fn over the leading view axis of (starts, recs), outputs stacked
    (the plain versions resolve one view at a time)."""
    if starts.dim() == 1:
        return fn(starts, recs, *args, **kw)
    outs = [fn(s, r, *args, **kw) for s, r in zip(starts, recs)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _band(grid: BinGrid, row0: int, band_by: int | None) -> int:
    """The band's bin-row count, after checking that bin rows [row0,
    row0 + band_by) lie in the grid (band_by None: to the last row)."""
    band_by = grid.by - row0 if band_by is None else band_by
    if row0 < 0 or band_by < 0 or row0 + band_by > grid.by:
        raise ValueError(f"bin rows [{row0}, {row0 + band_by}) outside the "
                         f"grid's {grid.by}")
    return band_by


def _band_pairs(starts, grid: BinGrid, row0: int, band_by: int, pix_w: int):
    """(pair range of the band's bins, and per chunk of pairs: their bin,
    pixel x, band-local pixel row, global pixel row) for the plain
    resolves; pix_w: the pixels of a bin."""
    BX, bw, bh = grid.bx, grid.bw, grid.bh
    p_lo = int(starts[row0 * BX])
    p_hi = int(starts[(row0 + band_by) * BX])
    pix = torch.arange(pix_w, device=starts.device)
    lx, ly = pix % bw, torch.div(pix, bw, rounding_mode="floor")

    def locate(p):
        b = torch.searchsorted(starts, p.to(starts.dtype), right=True) - 1
        gx = (b % BX * bw)[:, None] + lx[None, :]
        oy = ((torch.div(b, BX, rounding_mode="floor") - row0) * bh)[:, None] \
            + ly[None, :]
        return gx, oy, oy + row0 * bh

    return p_lo, p_hi, locate


def resolve_plain(starts, recs, grid: BinGrid, pair_chunk: int = 4096,
                  row0: int = 0, band_by: int | None = None):
    """K1's reference in plain PyTorch: every (pair, bin-pixel) test,
    chunked over pairs, reduced with scatter_reduce("amin") — first the
    min z per pixel, then the min id among the covering records at that
    z.  Returns (depth, tri_id) padded to the bin grid; with a leading
    view axis on starts and recs, view by view, (B, Hp, Wp) each.  A band
    (row0, band_by; see :func:`resolve`) gives its rows alone."""
    if starts.dim() > 1:
        return _per_view(resolve_plain, starts, recs, grid, pair_chunk,
                         row0=row0, band_by=band_by)
    dev = recs.device
    band_by = _band(grid, row0, band_by)
    bw, bh, BX = grid.bw, grid.bh, grid.bx
    Hp, Wp = band_by * bh, BX * bw
    p_lo, p_hi, locate = _band_pairs(starts, grid, row0, band_by, bw * bh)
    big_id = 2 ** 30
    zbuf = torch.full((Hp * Wp,), float("inf"), device=dev)
    ibuf = torch.full((Hp * Wp,), big_id, dtype=torch.int32, device=dev)

    def chunks():
        for p0 in range(p_lo, p_hi, pair_chunk):
            p = torch.arange(p0, min(p0 + pair_chunk, p_hi), device=dev)
            gx, oy, gy = locate(p)
            rec = recs[:, p][:, :, None]                      # (20, n, 1)
            cov, z = _eval_records(rec, gx.to(torch.float32) + 0.5,
                                   gy.to(torch.float32) + 0.5)
            yield rec, cov, z, (oy * Wp + gx)

    for _, cov, z, flat in chunks():
        zbuf.scatter_reduce_(0, flat[cov], z[cov], reduce="amin")
    for rec, cov, z, flat in chunks():
        win = cov & (z == zbuf[flat])
        ids = rec[REC_ROWS - 1].to(torch.int32).expand_as(z)
        ibuf.scatter_reduce_(0, flat[win], ids[win], reduce="amin")
    hit = ibuf < big_id
    depth = torch.where(hit, zbuf, 1.0).reshape(Hp, Wp)
    tri_id = torch.where(hit, ibuf, -1).reshape(Hp, Wp)
    return depth, tri_id


def _check_resolve_inputs(what, starts, recs, grid):
    """The view count of K1's / K4's inputs, after checking them: starts
    (*V, bins + 1) int32, recs (*V, REC_ROWS, cap) float32."""
    if starts.dtype != torch.int32 or recs.dtype != torch.float32:
        raise TypeError(f"{what} takes int32 starts and float32 records")
    if (starts.shape[-1] != grid.num_bins + 1 or recs.dim() < 2
            or recs.shape[-2] != REC_ROWS or starts.dim() > 2
            or starts.shape[:-1] != recs.shape[:-2]):
        raise ValueError(f"starts {tuple(starts.shape)} / records "
                         f"{tuple(recs.shape)} do not match the grid")
    return starts.shape[0] if starts.dim() == 2 else 1


def resolve(starts, recs, grid: BinGrid, impl: str | None = None,
            row0: int = 0, band_by: int | None = None):
    """K1 dispatch: bin resolve -> (depth, tri_id) padded to the bin
    grid.  CUDA tensors launch the kernel, CPU tensors (or impl="plain")
    take resolve_plain.  starts (*V, bins + 1), recs (*V, 20, cap): with
    a view axis one launch resolves every view, (B, Hp, Wp) out.

    A band: bin rows [row0, row0 + band_by) of the grid (band_by None:
    to the last row); starts and records stay the whole grid's, the
    output is the band's band_by * bh rows (the JAX kernel's ``row0``,
    raster2.py:568-575)."""
    if kb.choose(impl, starts, recs) == "plain":
        return resolve_plain(starts, recs, grid, row0=row0, band_by=band_by)
    lib = kb.library()
    views = _check_resolve_inputs("resolve", starts, recs, grid)
    band_by = _band(grid, row0, band_by)
    starts = starts.contiguous()
    recs = recs.contiguous()
    Hp, Wp = band_by * grid.bh, grid.bx * grid.bw
    shape = (*starts.shape[:-1], Hp, Wp)
    depth = torch.empty(shape, dtype=torch.float32, device=recs.device)
    tri_id = torch.empty(shape, dtype=torch.int32, device=recs.device)
    code = lib.resolve_launch(starts.data_ptr(), recs.data_ptr(),
                              depth.data_ptr(), tri_id.data_ptr(),
                              recs.shape[-1], grid.num_bins, grid.bx,
                              grid.bw, grid.bh, Wp, views, row0, band_by,
                              kb.stream_ptr(recs))
    kb.launches["resolve"] += 1
    kb.check(code, "resolve")
    return depth, tri_id


def resolve_depth_plain(starts, recs, grid: BinGrid,
                        pixels_per_chunk: int = 1 << 24, row0: int = 0,
                        band_by: int | None = None):
    """K4's reference in plain PyTorch: the depth-only resolve of the
    shadow view — per pixel the minimum z over the covering records of
    its bin, 1.0 where none covers.  Pairs go in chunks of
    pixels_per_chunk // (bin pixels) (1,024 pairs of a 128x128 bin), so
    one chunk's temporaries stay near 1 GB at the 4096^2 shadow map.
    Returns depth padded to the bin grid (view by view with a leading
    view axis); a band (row0, band_by) gives its rows alone."""
    if starts.dim() > 1:
        return _per_view(resolve_depth_plain, starts, recs, grid,
                         pixels_per_chunk, row0=row0, band_by=band_by)
    dev = recs.device
    band_by = _band(grid, row0, band_by)
    bw, bh, BX = grid.bw, grid.bh, grid.bx
    Hp, Wp = band_by * bh, BX * bw
    p_lo, p_hi, locate = _band_pairs(starts, grid, row0, band_by, bw * bh)
    zbuf = torch.full((Hp * Wp,), float("inf"), device=dev)
    pair_chunk = max(1, pixels_per_chunk // (bw * bh))
    for p0 in range(p_lo, p_hi, pair_chunk):
        p = torch.arange(p0, min(p0 + pair_chunk, p_hi), device=dev)
        gx, oy, gy = locate(p)
        cov, z = _eval_records(recs[:, p][:, :, None],
                               gx.to(torch.float32) + 0.5,
                               gy.to(torch.float32) + 0.5)
        zbuf.scatter_reduce_(0, (oy * Wp + gx).reshape(-1),
                             torch.where(cov, z, float("inf")).reshape(-1),
                             reduce="amin")
    return torch.where(torch.isfinite(zbuf), zbuf, 1.0).reshape(Hp, Wp)


def resolve_depth(starts, recs, grid: BinGrid, impl: str | None = None,
                  row0: int = 0, band_by: int | None = None):
    """K4 dispatch: depth-only bin resolve -> depth padded to the bin
    grid.  CUDA tensors launch the kernel (``resolve.cu``: K1's body
    without the id row, any bin size), CPU tensors (or impl="plain") take
    resolve_depth_plain.  Views and bands as in :func:`resolve`: one
    launch."""
    if kb.choose(impl, starts, recs) == "plain":
        return resolve_depth_plain(starts, recs, grid, row0=row0,
                                   band_by=band_by)
    lib = kb.library()
    views = _check_resolve_inputs("resolve_depth", starts, recs, grid)
    band_by = _band(grid, row0, band_by)
    starts = starts.contiguous()
    recs = recs.contiguous()
    Hp, Wp = band_by * grid.bh, grid.bx * grid.bw
    depth = torch.empty((*starts.shape[:-1], Hp, Wp), dtype=torch.float32,
                        device=recs.device)
    code = lib.resolve_depth_launch(starts.data_ptr(), recs.data_ptr(),
                                    depth.data_ptr(), recs.shape[-1],
                                    grid.num_bins, grid.bx, grid.bw,
                                    grid.bh, Wp, views, row0, band_by,
                                    kb.stream_ptr(recs))
    kb.launches["resolve_depth"] += 1
    kb.check(code, "resolve_depth")
    return depth


def gather_records(setup: PlanarSetup, grid: BinGrid):
    """Bin + sort + gather: (starts, bin-ordered records (*V, 20, cap),
    overflow, cropped grid) as the JAX rasterize prepares the resolve's
    inputs, with the box rows besides (the record array spans a chunk
    multiple, at most pair_cap columns)."""
    T = setup.adj.shape[-1]
    starts, sorted_tids, overflow = build_pairs(setup, grid)
    records = build_records(setup)
    S = sorted_tids.shape[-1]
    cap = min(grid.pair_cap, _cdiv(S, grid.chunk) * grid.chunk)
    cols = torch.clamp(sorted_tids[..., :min(S, cap)], max=T).long()
    recs = torch.gather(records, -1,
                        cols.unsqueeze(-2).expand(*cols.shape[:-1],
                                                  REC_ROWS, -1))
    if recs.shape[-1] < cap:
        recs = torch.cat([recs, recs.new_zeros(
            (*recs.shape[:-1], cap - recs.shape[-1]))], dim=-1)
    return starts, recs, overflow, dataclasses.replace(grid, pair_cap=cap)


def resolve_row_sharded(starts, recs, grid: BinGrid, mesh, axis: str,
                        impl: str | None = None, depth_only: bool = False):
    """The resolve with the grid's bin rows split over the devices of
    mesh axis `axis` (the JAX package's ``resolve_row_sharded``): band i
    is bin rows [i * by / n, (i + 1) * by / n), resolved by one K1 (K4
    with depth_only) launch on the band's device from the whole starts
    table and records, which stay whole (tensors, copied once to each
    distinct device of the axis, or halo.replicate's {device: tensor}).
    `grid.by` must be a multiple of the axis size (rasterize pads the bin
    grid).  Returns (depth bands, tri_id bands or None): lists of (*V,
    by / n * bh, Wp) tensors, band i on the axis's device i."""
    devices = mesh.band_devices(axis)
    n = len(devices)
    if grid.by % n:
        raise ValueError(f"{grid.by} bin rows do not split into {n} bands "
                         f"(rasterize pads the grid)")
    BYs = grid.by // n
    starts = halo.replicate(starts, devices)
    recs = halo.replicate(recs, devices)
    depth, tid = [], []
    for i, dev in enumerate(devices):
        kw = dict(impl=impl, row0=i * BYs, band_by=BYs)
        if depth_only:
            depth.append(resolve_depth(starts[dev], recs[dev], grid, **kw))
        else:
            d, t = resolve(starts[dev], recs[dev], grid, **kw)
            depth.append(d)
            tid.append(t)
    return depth, (None if depth_only else tid)


def rasterize(clip, grid: BinGrid, cull: str = "front",
              impl: str | None = None, depth_only: bool = False,
              shard=None) -> tuple[VisibilityBuffer, PlanarSetup]:
    """Full raster: clip (3 verts, 4 comps, T) planar clip positions (or
    (B, 3, 4, T), B views in one resolve launch) -> visibility buffer
    cropped to the viewport.  depth_only: the shadow view's id-free
    resolve (K4); the buffer's tri_id is None.

    shard: (mesh, axis) — the resolve split over the axis's devices by
    bin rows (:func:`resolve_row_sharded`) after the bin grid is padded
    to a multiple of the axis size (the padded rows get no pairs: the
    bboxes are clamped to the viewport); setup, binning and records run
    on clip's device.  The buffer's depth and tri_id are then lists of
    row bands cropped to the viewport (a band past the viewport is
    empty), band i on the axis's device i.

    The two steps, :func:`bin_triangles` and :func:`resolve_binned`, are
    also called one by one (the shadow view times each)."""
    binned = bin_triangles(clip, grid, cull, shard=shard)
    return resolve_binned(binned, impl=impl, depth_only=depth_only,
                          shard=shard), binned.setup


@dataclass(frozen=True)
class Binned:
    """The resolve's inputs (:func:`bin_triangles`)."""
    setup: PlanarSetup
    starts: torch.Tensor
    records: torch.Tensor
    overflow: torch.Tensor
    grid: BinGrid           # padded to the row split's bands
    viewport: tuple         # (height, width) of the viewport


def bin_triangles(clip, grid: BinGrid, cull: str = "front",
                  shard=None) -> Binned:
    """:func:`rasterize`'s first step: triangle setup, binning, the
    sorted record stream (the bin grid padded for `shard`)."""
    setup = triangle_setup_planar(clip, grid.width, grid.height, cull)
    viewport = (grid.height, grid.width)
    if shard is not None:
        mesh, axis = shard
        n = len(mesh.band_devices(axis))
        grid = dataclasses.replace(
            grid, height=_cdiv(grid.by, n) * n * grid.bh)
    starts, recs, overflow, rgrid = gather_records(setup, grid)
    return Binned(setup, starts, recs, overflow, rgrid, viewport)


def resolve_binned(binned: Binned, impl: str | None = None,
                   depth_only: bool = False,
                   shard=None) -> VisibilityBuffer:
    """:func:`rasterize`'s second step: the resolve (K1, or K4 with
    depth_only; per band with `shard`), cropped to the viewport."""
    (vh, vw), rgrid = binned.viewport, binned.grid
    starts, recs, overflow = binned.starts, binned.records, binned.overflow
    if shard is not None:
        mesh, axis = shard
        n = len(mesh.band_devices(axis))
        depth, tid = resolve_row_sharded(starts, recs, rgrid, mesh, axis,
                                         impl=impl, depth_only=depth_only)
        band_h = rgrid.height // n

        def crop(bands):
            return [b[..., :max(0, min(band_h, vh - i * band_h)), :vw]
                    for i, b in enumerate(bands)]

        return VisibilityBuffer(
            depth=crop(depth), tri_id=None if tid is None else crop(tid),
            overflow=overflow)
    if depth_only:
        depth = resolve_depth(starts, recs, rgrid, impl=impl)
        return VisibilityBuffer(depth=depth[..., :vh, :vw], tri_id=None,
                                overflow=overflow)
    depth, tid = resolve(starts, recs, rgrid, impl=impl)
    return VisibilityBuffer(depth=depth[..., :vh, :vw],
                            tri_id=tid[..., :vh, :vw], overflow=overflow)
