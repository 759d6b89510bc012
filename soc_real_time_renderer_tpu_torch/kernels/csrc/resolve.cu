// K1: bin resolve of the sort-binned rasterizer (visibility buffer), and
// K4, the depth-only resolve of the shadow view: one kernel body
// (`resolve_body`), two instantiations.
//
// K1 replaces soc_real_time_renderer_tpu/ops/raster2.py `_resolve_kernel`
// (Pallas, TPU; launched by `resolve`).  Same result: per pixel centre,
// the minimum-depth covering triangle of the pixel's screen bin, ties to
// the lower triangle id, clear 1.0 / -1.
//
// K4 replaces soc_real_time_renderer_tpu/ops/raster2.py
// `_resolve_depth_kernel` (Pallas, TPU; launched by `resolve(...,
// depth_only=True)`).  Same result: per pixel centre the minimum z of
// the covering records of its bin, 1.0 where none covers; no triangle
// id, so no tie rule (the minimum of a set does not depend on order).
//
// Inputs: `starts` (num_bins + 1) int32 offsets into the bin-sorted pair
// records `recs` (20, cap) float32, rows [adjugate 3x3 | z0..2 | w0..2 |
// pixel box x0, y0, x1, y1 | id as an exact float] (K4 reads rows 0-18).
// A record covers a pixel only inside its box (x0 < px < x1, y0 < py <
// y1 at the pixel's centre; the setup's bbox, whole pixels): the
// Pallas kernels have no box, and a sliver's float32 edge functions can
// pass at pixels past its triangle, where they pick it.  Outputs `depth`
// f32 and, for K1, `tri_id` i32, both (band_by * bh, out_w) with out_w =
// bins per row * bw.  Views: `views` such sets back to back, (views,
// num_bins + 1) starts, (views, 20, cap) records, (views, band_by * bh,
// out_w)
// outputs, resolved by one launch whose blockIdx.y is the view (the B
// views of parallel/mesh.py; one frame is views = 1).
//
// Row bands: a launch resolves the `band_by` bin rows from global bin row
// `row0` on (the JAX kernels' `row0` scalar, raster2.py:468, 568-575):
// its blocks read only those bins of the whole `starts` table, evaluate
// the edge functions at the pixels' global centres and write the band's
// rows.  One frame is row0 = 0, band_by = all bin rows; the row split of
// one frame over a mesh (ops/raster2.resolve_row_sharded) launches once
// per band.
//
// The work.  What an exact resolve must do is small: of the (pair,
// pixel) tests a bin resolve could make, only 0.5-1.8% fall inside a
// triangle at 1920x1088 (3-4% of (pair, 8x4 tile) combinations touch
// one), and the inputs are ~64 B per pair plus 8 B per pixel (~30 MB,
// ~0.01 ms at 3.35 TB/s).  The pair stream is skewed: the main view's
// bins hold from 0 to 18,000 pairs against a mean near 200, the 4096^2
// shadow view's 128x128 bins up to 1,900 against a mean of 83, and most
// of the shadow map's bins are empty: K4's bound is the 67 MB of depth
// it must write.
//
// Why the first designs lost their time in a few blocks.  K1 ran one
// block of 256 threads per bin and tested every record at every bin
// pixel.  Triangles wholly behind the camera keep their setup's fallback
// bbox (0, 0, 1, 1) and stay valid in the binning (the reference's
// rule), so they all land in bin 0: 6-18k pairs that can cover nothing,
// each tested at 2,048 pixels by one block while the rest of the card
// idled.  K4 cut a bin into four 128x32 slabs, 16 pixels a thread, and
// likewise tested every record of the bin at every pixel: the heaviest
// bin's four blocks set its time, at 100x its bound.
//
// The design:
// 1. Exact rejects before any per-pixel work, in two levels.  A block
//    owns a region of 32 x (8 * kTiles) pixels: each of its 256 threads
//    takes one record of the staged window and keeps it only if some
//    w > 0 (a record with no w > 0 covers nothing: with every e >= 0 and
//    every w <= 0 or NaN, each e*w is <= 0 or NaN and so is their sum,
//    so `ew > 0` fails at every pixel in f32), its box holds a pixel
//    centre of the region, and it may cover the region (edge_may_cover
//    at the region's corners, with a stated rounding margin); the kept
//    records are compacted into a shared
//    list by ballots.  Then each warp owns kTiles tiles of 8x4 pixels,
//    8 rows apart (one pixel of each per lane): its 32 lanes test 32
//    listed records against a tile's corners, and the warp walks the
//    ballot's bits, reading each kept record from shared memory as a
//    broadcast and testing it at the tile's 32 pixels (the depth only
//    where all three edges pass).
// 2. The bin's pixels are split over several blocks, each reading the
//    bin's records through L2.  K1 takes kTiles = 1 (a 64x32 bin is 8
//    blocks of 32x8, 8,160 at 1920x1088): no block carries a heavy
//    bin's pixels alone, and bin 0's dead records cost one compare per
//    (record, block).  K4 takes kTiles = SOC_K4_TILES (a 128x128 bin is
//    32 blocks of 32x16 at the default 2): fewer blocks stage the same
//    windows than with 32x8, at the price of a coarser first reject and
//    a longer walk per warp; on the atrium's 4096^2 shadow view 2 beat
//    1, 4 and 8 (kernel_ab.py --other-flags=-DSOC_K4_TILES=1 times the
//    choice).
// 3. Records reach shared memory by cp.async, double-buffered, in
//    256-aligned windows of 256 (16 B copies when the row stride
//    allows), so the next window loads while this one is tested.
// 4. A region of an empty bin stages nothing and writes its clear as
//    whole 128 B rows.
//
// What bounds it on this card is then the per-pixel work of the records
// the tile test keeps, and the staging and barriers of each window, not
// bytes.  The heaviest bin with live records still sets much of the
// time: resolved alone it takes more than half of the whole frame's K1
// time and half of K4's (kernel_ab.py), its blocks running after most
// of the grid has left.  Two ways to shorten a heavy region's time
// inside its block were measured slower and are not here: dealing the
// kept records over the block's warps (each testing all of the
// region's tiles, merged through shared memory), and evaluating four
// kept records at a time without early outs.  So the block's
// instruction rate, not one warp's latency, is what a heavy region
// waits for, and the remedy is more blocks for a heavy bin's pair range
// (merged by an atomicMin of (z bits, id)) or starting the heavy bins
// first; neither is built.
//
// The winner test is order independent (the minimum z, then for K1 the
// minimum id), so neither the sort's order, the windows nor the ballots
// can change the result, and the TPU kernel's near-to-far early out is
// left out.  Built with --fmad=false so the edge functions round exactly
// as the plain versions' separate multiply and add
// (raster2.resolve_plain, raster2.resolve_depth_plain).
#include <cstdint>

#include "common.cuh"

// K4's tiles per warp: its block's region is 32 x (8 * SOC_K4_TILES) pixels
#ifndef SOC_K4_TILES
#define SOC_K4_TILES 2
#endif

namespace {

constexpr int kRec = 20;               // rows of a record
constexpr int kThreads = 256;
constexpr int kWindow = 256;           // records per staged window
constexpr int kTileW = 8, kTileH = 4;  // a warp's tile, lane = pixel
constexpr int kWarpsX = 4;             // a block is 4 x 2 warps
constexpr int kBlockW = kTileW * kWarpsX;
constexpr int kBlockH = kTileH * (kThreads / 32 / kWarpsX);
static_assert(kWindow == kThreads, "the region test: one record a thread");
static_assert(kThreads % kBlockW == 0, "the clear: whole rows a pass");

__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool vec, bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    if (vec) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(s), "l"(gmem), "r"(in ? 16 : 0));
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(s), "l"(gmem), "r"(in ? 4 : 0));
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

// Columns [c0, c0 + kWindow) of the first kR rows into dst; columns at or
// past `cap` are zero-filled (they lie past `end` and are never tested).
// vec: 16 B copies, for a 16 B aligned base and cap % 4 == 0, so a quad
// of columns is wholly inside or wholly past cap.
template <int kR>
__device__ __forceinline__ void stage_window(float (*dst)[kWindow],
                                             const float* recs, int cap,
                                             int c0, bool vec) {
    const int per = vec ? 4 : 1;
    const int n = kR * kWindow / per;
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const int r = i / (kWindow / per);
        const int q = i % (kWindow / per) * per;
        const bool in = c0 + q < cap;
        cp_async(&dst[r][q], recs + (size_t)r * cap + (in ? c0 + q : 0), vec,
                 in);
    }
}

// May the edge function e = a0*px + a1*py + a2, evaluated as the
// per-pixel test evaluates it (three roundings, no FMA), be >= 0 at any
// pixel centre of [xl, xh] x [yl, yh]?  False only when it cannot.
//
// The exact E is affine, so over the rectangle it peaks at the corner c
// picked by the signs of a0 and a1.  With S = |a0| xh + |a1| yh + |a2|
// (px, py > 0), three roundings put both the per-pixel value e(p) and
// the corner value ec within g3 S of the exact ones, g3 = 3u / (1 - 3u),
// u = 2^-24, plus at most 2^-149 from subnormal products.  So e(p) <=
// E(p) + g3 S <= E(c) + g3 S <= ec + 2 g3 S + 2^-148.  The margin
// 2^-21 S + 2^-126 (computed from S rounded down by under 3u) exceeds
// 2 g3 S + 2^-148 ~ 0.75 * 2^-21 S + 2^-148, so ec < -margin implies
// e(p) < 0 at every pixel centre of the rectangle.  NaN or infinite
// values never compare below -margin and are left to the per-pixel
// test.  (Evaluated
// in the per-pixel order without FMA, each rounding step is monotone, so
// ec >= e(p) holds even without the margin; the margin keeps the test
// exact should the corner ever be evaluated in another order.)
__device__ __forceinline__ bool edge_may_cover(float a0, float a1, float a2,
                                               float xl, float xh, float yl,
                                               float yh) {
    const float ec = a0 * (a0 >= 0.0f ? xh : xl)
                     + a1 * (a1 >= 0.0f ? yh : yl) + a2;
    const float s = fabsf(a0) * xh + fabsf(a1) * yh + fabsf(a2);
    return !(ec < -(s * 0x1p-21f + 0x1p-126f));
}

// kIds: K1 (the id row is staged, ties go to the lower id, tri_id is
// written); else K4 (19 rows, the minimum z alone).  kTiles: 8x4 tiles a
// warp owns, 8 rows apart; the block's region is 32 x (8 * kTiles).
template <bool kIds, int kTiles>
__global__ void __launch_bounds__(kThreads)
resolve_body(const int* __restrict__ starts, const float* __restrict__ recs,
             int cap, int vec, int num_bins, int bx, int bw, int bh,
             int row0, int parts_x, int parts, int out_w, size_t out_view,
             float* __restrict__ depth, int* __restrict__ tri_id) {
    constexpr int kR = kIds ? kRec : kRec - 1;
    constexpr int kRegionH = kBlockH * kTiles;
    __shared__ __align__(16) float s[2][kR][kWindow];
    __shared__ int kept[kWindow];             // window columns kept
    __shared__ int kept_by_warp[kThreads / 32];
    // this block's view: its starts, records and output planes
    starts += (size_t)blockIdx.y * (num_bins + 1);
    recs += (size_t)blockIdx.y * kRec * cap;
    depth += blockIdx.y * out_view;
    if (kIds) tri_id += blockIdx.y * out_view;
    // the band's bin bl, global bin b: output rows from the band's first
    // row (oy0), pixel centres at the screen's rows (gy0)
    const int bl = blockIdx.x / parts;
    const int b = bl + row0 * bx;
    const int part = blockIdx.x % parts;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int gx0 = (bl % bx) * bw;
    const int oy0 = (bl / bx) * bh;
    const int gy0 = oy0 + row0 * bh;
    // this block's region in bin pixels
    const int rx = part % parts_x * kBlockW;
    const int ry = part / parts_x * kRegionH;
    const int start = starts[b];
    const int end = starts[b + 1];

    if (end <= start) {   // an empty bin: the clear, a 128 B row a warp
        for (int y0 = 0; y0 < kRegionH; y0 += kThreads / kBlockW) {
            const int x = rx + threadIdx.x % kBlockW;
            const int y = ry + y0 + threadIdx.x / kBlockW;
            if (x < bw && y < bh) {
                const size_t o = (size_t)(y + oy0) * out_w + (x + gx0);
                depth[o] = 1.0f;
                if (kIds) tri_id[o] = -1;
            }
        }
        return;
    }

    // this warp's tiles (tile t lies t * kBlockH rows below the first)
    // and this lane's pixel in each; pixel centres (l + o) + 0.5 are
    // exact in float like the plain version's
    const int tx = rx + warp % kWarpsX * kTileW;
    const int ty = ry + warp / kWarpsX * kTileH;
    const int lx = tx + lane % kTileW;
    const int ly = ty + lane / kTileW;
    const float px = (float)(lx + gx0) + 0.5f;
    const float rxl = (float)(rx + gx0) + 0.5f;
    const float rxh = (float)(rx + kBlockW - 1 + gx0) + 0.5f;
    const float ryl = (float)(ry + gy0) + 0.5f;
    const float ryh = (float)(ry + kRegionH - 1 + gy0) + 0.5f;
    const float txl = (float)(tx + gx0) + 0.5f;
    const float txh = (float)(tx + kTileW - 1 + gx0) + 0.5f;
    float py[kTiles], tyl[kTiles], tyh[kTiles], zb[kTiles];
    int ib[kTiles];
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
        py[t] = (float)(ly + t * kBlockH + gy0) + 0.5f;
        tyl[t] = (float)(ty + t * kBlockH + gy0) + 0.5f;
        tyh[t] = (float)(ty + t * kBlockH + kTileH - 1 + gy0) + 0.5f;
        zb[t] = CUDART_INF_F;
        ib[t] = -1;
    }

    const int w0 = start / kWindow * kWindow;
    const int nwin = (end - w0 + kWindow - 1) / kWindow;
    stage_window<kR>(s[0], recs, cap, w0, vec);
    cp_async_commit();
    for (int k = 0; k < nwin; ++k) {
        const int c0 = w0 + k * kWindow;
        if (k + 1 < nwin) {
            stage_window<kR>(s[(k + 1) & 1], recs, cap, c0 + kWindow, vec);
        }
        cp_async_commit();
        cp_async_wait_all_but_one();  // window k has landed
        __syncthreads();
        const float (*r)[kWindow] = s[k & 1];

        // level 1: the block's region, one record per thread
        const int j = threadIdx.x;
        const int c = c0 + j;
        const bool keep =
            c >= start && c < end
            && (r[12][j] > 0.0f || r[13][j] > 0.0f || r[14][j] > 0.0f)
            && r[15][j] < rxh && r[17][j] > rxl && r[16][j] < ryh
            && r[18][j] > ryl
            && edge_may_cover(r[0][j], r[1][j], r[2][j], rxl, rxh, ryl, ryh)
            && edge_may_cover(r[3][j], r[4][j], r[5][j], rxl, rxh, ryl, ryh)
            && edge_may_cover(r[6][j], r[7][j], r[8][j], rxl, rxh, ryl, ryh);
        const unsigned km = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) kept_by_warp[warp] = __popc(km);
        __syncthreads();
        int n_kept = 0, slot = 0;
#pragma unroll
        for (int q = 0; q < kThreads / 32; ++q) {
            const int nq = kept_by_warp[q];
            slot += q < warp ? nq : 0;
            n_kept += nq;
        }
        if (keep) kept[slot + __popc(km & ((1u << lane) - 1))] = j;
        __syncthreads();

        // level 2: the warp's tiles, 32 kept records at a time
        for (int i0 = 0; i0 < n_kept; i0 += 32) {
            const int i = i0 + lane;
            const int q = i < n_kept ? kept[i] : 0;
#pragma unroll
            for (int t = 0; t < kTiles; ++t) {
                const bool may =
                    i < n_kept
                    && edge_may_cover(r[0][q], r[1][q], r[2][q], txl, txh,
                                      tyl[t], tyh[t])
                    && edge_may_cover(r[3][q], r[4][q], r[5][q], txl, txh,
                                      tyl[t], tyh[t])
                    && edge_may_cover(r[6][q], r[7][q], r[8][q], txl, txh,
                                      tyl[t], tyh[t]);
                unsigned m = __ballot_sync(0xffffffffu, may);
                while (m) {
                    const int u = __shfl_sync(0xffffffffu, q, __ffs(m) - 1);
                    m &= m - 1;
                    const float e0 = r[0][u] * px + r[1][u] * py[t] + r[2][u];
                    const float e1 = r[3][u] * px + r[4][u] * py[t] + r[5][u];
                    const float e2 = r[6][u] * px + r[7][u] * py[t] + r[8][u];
                    if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f
                        && px > r[15][u] && px < r[17][u]
                        && py[t] > r[16][u] && py[t] < r[18][u]) {
                        const float ez =
                            e0 * r[9][u] + e1 * r[10][u] + e2 * r[11][u];
                        const float ew =
                            e0 * r[12][u] + e1 * r[13][u] + e2 * r[14][u];
                        if (ew > 0.0f) {
                            const float z = ez / ew;
                            if (kIds) {
                                const int id = (int)r[kR - 1][u];
                                if (z >= 0.0f && z <= 1.0f
                                    && (z < zb[t]
                                        || (z == zb[t] && id < ib[t]))) {
                                    zb[t] = z;
                                    ib[t] = id;
                                }
                            } else if (z >= 0.0f && z <= 1.0f && z < zb[t]) {
                                zb[t] = z;
                            }
                        }
                    }
                }
            }
        }
        __syncthreads();  // window k and the list are consumed
    }

#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
        const int y = ly + t * kBlockH;
        if (lx < bw && y < bh) {
            const size_t o = (size_t)(y + oy0) * out_w + (lx + gx0);
            if (kIds) {
                depth[o] = ib[t] >= 0 ? zb[t] : 1.0f;
                tri_id[o] = ib[t];
            } else {
                depth[o] = zb[t] < CUDART_INF_F ? zb[t] : 1.0f;
            }
        }
    }
}

template <bool kIds, int kTiles>
int launch(const void* starts, const void* recs, void* depth, void* tri_id,
           int cap, int num_bins, int bx, int bw, int bh, int out_w,
           int views, int row0, int band_by, void* stream) {
    if (bw <= 0 || bh <= 0 || bx <= 0 || views > 65535 || row0 < 0
        || band_by < 0 || (long long)(row0 + band_by) * bx > num_bins)
        return (int)cudaErrorInvalidValue;
    const int band_bins = band_by * bx;
    if (band_bins <= 0 || views <= 0) return 0;
    const int region_h = kBlockH * kTiles;
    const int parts_x = (bw + kBlockW - 1) / kBlockW;
    const int parts = parts_x * ((bh + region_h - 1) / region_h);
    if ((long long)band_bins * parts > 0x7fffffff) {
        return (int)cudaErrorInvalidValue;
    }
    // a view's records start kRec * cap floats apart: aligned alike
    const int vec = cap % 4 == 0 && (uintptr_t)recs % 16 == 0;
    const size_t out_view = (size_t)band_by * bh * out_w;
    resolve_body<kIds, kTiles>
        <<<dim3(band_bins * parts, views), kThreads, 0,
           (cudaStream_t)stream>>>(
            (const int*)starts, (const float*)recs, cap, vec, num_bins, bx,
            bw, bh, row0, parts_x, parts, out_w, out_view, (float*)depth,
            (int*)tri_id);
    return (int)cudaGetLastError();
}

}  // namespace

SOC_EXPORT int resolve_depth_launch(const void* starts, const void* recs,
                                    void* depth, int cap, int num_bins,
                                    int bx, int bw, int bh, int out_w,
                                    int views, int row0, int band_by,
                                    void* stream) {
    return launch<false, SOC_K4_TILES>(starts, recs, depth, nullptr, cap,
                                       num_bins, bx, bw, bh, out_w, views,
                                       row0, band_by, stream);
}

SOC_EXPORT int resolve_launch(const void* starts, const void* recs,
                              void* depth, void* tri_id, int cap,
                              int num_bins, int bx, int bw, int bh,
                              int out_w, int views, int row0, int band_by,
                              void* stream) {
    return launch<true, 1>(starts, recs, depth, tri_id, cap, num_bins, bx,
                           bw, bh, out_w, views, row0, band_by, stream);
}

SOC_EXPORT const char* soc_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
