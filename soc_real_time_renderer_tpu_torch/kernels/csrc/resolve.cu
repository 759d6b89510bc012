// K1: bin resolve of the sort-binned rasterizer (visibility buffer), and
// below it K4, the depth-only resolve of the shadow view.
//
// Replaces soc_real_time_renderer_tpu/ops/raster2.py `_resolve_kernel`
// (Pallas, TPU; launched by `resolve`).  Same result: per pixel centre,
// the minimum-depth covering triangle of the pixel's screen bin, ties to
// the lower triangle id, clear 1.0 / -1.
//
// Inputs: `starts` (num_bins + 1) int32 offsets into the bin-sorted pair
// records `recs` (16, cap) float32, rows [adjugate 3x3 | z0..2 | w0..2 |
// id as an exact float].  Outputs `depth` f32 and `tri_id` i32, both
// (rows of bins * bh, out_w) with out_w = bins per row * bw.
//
// The work.  What an exact resolve must do is small: of the (pair,
// pixel) tests a bin resolve could make, only 0.5-1.8% fall inside a
// triangle at 1920x1088 (3-4% of (pair, 8x4 tile) combinations touch
// one), and the inputs are ~64 B per pair plus 8 B per pixel (~30 MB,
// ~0.01 ms at 3.35 TB/s).  The pair stream is skewed: bins hold from 0
// to 18,000 pairs against a mean near 200.
//
// Why the first design lost its time in one block.  It ran one block of
// 256 threads per bin and tested every record at every bin pixel.
// Triangles wholly behind the camera keep their setup's fallback bbox
// (0, 0, 1, 1) and stay valid in the binning (the reference's rule), so
// they all land in bin 0: 6-18k pairs that can cover nothing, each
// tested at 2,048 pixels by one block while the rest of the card idled.
// Its time tracked bin 0's pair count (0.47 us per pair in three scenes).
//
// The design:
// 1. Exact rejects before any per-pixel work, in two levels.  A block
//    owns a 32x8 pixel region: each of its 256 threads takes one record
//    of the staged window and keeps it only if some w > 0 (a record with
//    no w > 0 covers nothing: with every e >= 0 and every w <= 0 or NaN,
//    each e*w is <= 0 or NaN and so is their sum, so `ew > 0` fails at
//    every pixel in f32) and it may cover the region (edge_may_cover at
//    the region's corners, with a stated rounding margin); the kept
//    records are compacted into a shared list by ballots.  Then each
//    warp owns an 8x4 tile of the region (one pixel per lane): its 32
//    lanes test 32 listed records against the tile's corners, and the
//    warp walks the ballot's bits, reading each kept record from shared
//    memory as a broadcast and testing it at its 32 pixels (the depth
//    only where all three edges pass).
// 2. The bin's pixels are split over several blocks: a 64x32 bin is 8
//    blocks (8,160 at 1920x1088), each reading the bin's records through
//    L2.  No block carries a heavy bin's pixels alone, and bin 0's dead
//    records cost one compare per (record, block).
// 3. Records reach shared memory by cp.async, double-buffered, in
//    256-aligned windows of 256 (16 B copies when the row stride
//    allows), so the next window loads while this one is tested.
//
// What bounds it on this card is then the per-pixel work of the records
// the tile test keeps, and the staging and barriers of each window, not
// bytes.  The heaviest bin with live records still sets much of the
// time: resolved alone it takes more than half of the whole frame's K1
// time (kernel_ab.py), because each warp walks its tile's kept records
// one after another.  Splitting a heavy bin's pair range over more
// blocks, merged by a 64-bit atomicMin of (z bits, id), would shorten
// that walk; it is not built.
//
// The winner test is order independent (the minimum z, then the minimum
// id), so neither the sort's order, the windows nor the ballots can
// change the result, and the TPU kernel's near-to-far early out is left
// out.  Built with --fmad=false so the edge functions round exactly as
// the plain version's separate multiply and add (raster2.resolve_plain).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;
constexpr int kRows = 16;
constexpr int kWindow = 256;           // K1: records per staged window
constexpr int kTileW = 8, kTileH = 4;  // K1: a warp's tile, lane = pixel
constexpr int kWarpsX = 4;             // K1: a block is 4 x 2 warp tiles
constexpr int kBlockW = kTileW * kWarpsX;
constexpr int kBlockH = kTileH * (kThreads / 32 / kWarpsX);
static_assert(kWindow == kThreads, "K1's region test: one record a thread");

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

// Columns [c0, c0 + kWindow) of all 16 rows into dst; columns at or past
// `cap` are zero-filled (they lie past `end` and are never tested).  vec:
// 16 B copies, for a 16 B aligned base and cap % 4 == 0, so a quad of
// columns is wholly inside or wholly past cap.
__device__ __forceinline__ void stage_window(float (*dst)[kWindow],
                                             const float* recs, int cap,
                                             int c0, bool vec) {
    const int per = vec ? 4 : 1;
    const int n = kRows * kWindow / per;
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

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ starts, const float* __restrict__ recs,
               int cap, int vec, int bx, int bw, int bh, int parts_x,
               int parts, int out_w, float* __restrict__ depth,
               int* __restrict__ tri_id) {
    __shared__ __align__(16) float s[2][kRows][kWindow];
    __shared__ int kept[kWindow];             // window columns kept
    __shared__ int kept_by_warp[kThreads / 32];
    const int b = blockIdx.x / parts;
    const int part = blockIdx.x % parts;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int gx0 = (b % bx) * bw;
    const int gy0 = (b / bx) * bh;
    // this block's region and this warp's tile in bin pixels, and this
    // lane's pixel in the tile; pixel centres (l + o) + 0.5 are exact in
    // float like the plain version's
    const int rx = part % parts_x * kBlockW;
    const int ry = part / parts_x * kBlockH;
    const int tx = rx + warp % kWarpsX * kTileW;
    const int ty = ry + warp / kWarpsX * kTileH;
    const int lx = tx + lane % kTileW;
    const int ly = ty + lane / kTileW;
    const float px = (float)(lx + gx0) + 0.5f;
    const float py = (float)(ly + gy0) + 0.5f;
    const float rxl = (float)(rx + gx0) + 0.5f;
    const float rxh = (float)(rx + kBlockW - 1 + gx0) + 0.5f;
    const float ryl = (float)(ry + gy0) + 0.5f;
    const float ryh = (float)(ry + kBlockH - 1 + gy0) + 0.5f;
    const float txl = (float)(tx + gx0) + 0.5f;
    const float txh = (float)(tx + kTileW - 1 + gx0) + 0.5f;
    const float tyl = (float)(ty + gy0) + 0.5f;
    const float tyh = (float)(ty + kTileH - 1 + gy0) + 0.5f;
    float zb = CUDART_INF_F;
    int ib = -1;

    const int start = starts[b];
    const int end = starts[b + 1];
    const int w0 = start / kWindow * kWindow;
    const int nwin = end > start ? (end - w0 + kWindow - 1) / kWindow : 0;
    if (nwin > 0) stage_window(s[0], recs, cap, w0, vec);
    cp_async_commit();
    for (int k = 0; k < nwin; ++k) {
        const int c0 = w0 + k * kWindow;
        if (k + 1 < nwin) {
            stage_window(s[(k + 1) & 1], recs, cap, c0 + kWindow, vec);
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

        // level 2: the warp's tile, 32 kept records at a time
        for (int i0 = 0; i0 < n_kept; i0 += 32) {
            const int i = i0 + lane;
            const int q = i < n_kept ? kept[i] : 0;
            const bool may =
                i < n_kept
                && edge_may_cover(r[0][q], r[1][q], r[2][q], txl, txh, tyl,
                                  tyh)
                && edge_may_cover(r[3][q], r[4][q], r[5][q], txl, txh, tyl,
                                  tyh)
                && edge_may_cover(r[6][q], r[7][q], r[8][q], txl, txh, tyl,
                                  tyh);
            unsigned m = __ballot_sync(0xffffffffu, may);
            while (m) {
                const int t = __shfl_sync(0xffffffffu, q, __ffs(m) - 1);
                m &= m - 1;
                const float e0 = r[0][t] * px + r[1][t] * py + r[2][t];
                const float e1 = r[3][t] * px + r[4][t] * py + r[5][t];
                const float e2 = r[6][t] * px + r[7][t] * py + r[8][t];
                if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) {
                    const float ez =
                        e0 * r[9][t] + e1 * r[10][t] + e2 * r[11][t];
                    const float ew =
                        e0 * r[12][t] + e1 * r[13][t] + e2 * r[14][t];
                    if (ew > 0.0f) {
                        const float z = ez / ew;
                        const int id = (int)r[15][t];
                        if (z >= 0.0f && z <= 1.0f
                            && (z < zb || (z == zb && id < ib))) {
                            zb = z;
                            ib = id;
                        }
                    }
                }
            }
        }
        __syncthreads();  // window k and the list are consumed
    }

    if (lx < bw && ly < bh) {
        const size_t o = (size_t)(ly + gy0) * out_w + (lx + gx0);
        depth[o] = ib >= 0 ? zb : 1.0f;
        tri_id[o] = ib;
    }
}

// K4: depth-only resolve of the sun shadow view.
//
// Replaces soc_real_time_renderer_tpu/ops/raster2.py
// `_resolve_depth_kernel` (Pallas, TPU; launched by `resolve(...,
// depth_only=True)`).  Same result: per pixel centre the minimum z of the
// covering records of its bin, 1.0 where none covers; no triangle id.
//
// Design: the 128x128-px shadow bins are 16,384 pixels, too many for one
// block's registers, so each bin is cut into slabs of 16 * 256 / bw rows
// (128x32 at bw = 128: 4 slabs per bin, 4,096 blocks at 4096^2), one
// block per slab, 256 threads with 16 pixels each: a thread owns one
// column (lx = tid % bw) and every (256 / bw)-th row, so a*px of each
// edge function is taken once per record.  The bin's records stream
// through shared memory as in K1 (rows 0..14; the id row is not read).
// Empty bins run zero chunks.  The winner is the order-free minimum z
// (no id, no early out).  Bound: arithmetic, ~20 flops per (pair,
// pixel) plus a division where covered; the pair stream is concentrated
// (a scene covers a fraction of the 4096^2 map), and slabs of empty bins
// only write their 1.0 clear.  Evaluated in the plain version's order
// (raster2.resolve_depth_plain) with --fmad=false.
constexpr int kDepthPPT = 16;
constexpr int kDepthRows = 15;

__global__ void __launch_bounds__(kThreads)
resolve_depth_kernel(const int* __restrict__ starts,
                     const float* __restrict__ recs, int cap, int bx,
                     int bw, int bh, int out_w, float* __restrict__ depth) {
    __shared__ float s[kDepthRows][kChunk];
    const int b = blockIdx.x;
    const int start = starts[b];
    const int end = starts[b + 1];
    const int gx0 = (b % bx) * bw;
    const int gy0 = (b / bx) * bh;
    const int step = kThreads / bw;               // rows per k step
    const int lx = threadIdx.x % bw;
    const int ly0 = blockIdx.y * step * kDepthPPT + threadIdx.x / bw;
    const float px = (float)(lx + gx0) + 0.5f;

    float py[kDepthPPT], zb[kDepthPPT];
#pragma unroll
    for (int k = 0; k < kDepthPPT; ++k) {
        py[k] = (float)(ly0 + k * step + gy0) + 0.5f;
        zb[k] = CUDART_INF_F;
    }

    for (int c0 = start; c0 < end; c0 += kChunk) {
        const int n = min(kChunk, end - c0);
        __syncthreads();  // the previous chunk is consumed
        for (int i = threadIdx.x; i < kDepthRows * kChunk; i += kThreads) {
            const int r = i / kChunk;
            const int j = i % kChunk;
            s[r][j] = j < n ? recs[(size_t)r * cap + c0 + j] : 0.0f;
        }
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            const float a0 = s[0][j], a1 = s[1][j], a2 = s[2][j];
            const float a3 = s[3][j], a4 = s[4][j], a5 = s[5][j];
            const float a6 = s[6][j], a7 = s[7][j], a8 = s[8][j];
            const float z0 = s[9][j], z1 = s[10][j], z2 = s[11][j];
            const float w0 = s[12][j], w1 = s[13][j], w2 = s[14][j];
            // a*px is the same product for all of a thread's pixels
            const float c0x = a0 * px, c1x = a3 * px, c2x = a6 * px;
#pragma unroll
            for (int k = 0; k < kDepthPPT; ++k) {
                const float e0 = c0x + a1 * py[k] + a2;
                const float e1 = c1x + a4 * py[k] + a5;
                const float e2 = c2x + a7 * py[k] + a8;
                if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) {
                    const float ez = e0 * z0 + e1 * z1 + e2 * z2;
                    const float ew = e0 * w0 + e1 * w1 + e2 * w2;
                    if (ew > 0.0f) {
                        const float z = ez / ew;
                        if (z >= 0.0f && z <= 1.0f && z < zb[k]) zb[k] = z;
                    }
                }
            }
        }
    }

#pragma unroll
    for (int k = 0; k < kDepthPPT; ++k) {
        const int ly = ly0 + k * step;
        if (ly < bh) {
            depth[(size_t)(gy0 + ly) * out_w + gx0 + lx] =
                zb[k] < CUDART_INF_F ? zb[k] : 1.0f;
        }
    }
}

}  // namespace

SOC_EXPORT int resolve_depth_launch(const void* starts, const void* recs,
                                    void* depth, int cap, int num_bins,
                                    int bx, int bw, int bh, int out_w,
                                    void* stream) {
    if (bw <= 0 || kThreads % bw != 0) return (int)cudaErrorInvalidValue;
    if (num_bins <= 0) return 0;
    const int rows = kThreads / bw * kDepthPPT;   // rows per block
    const dim3 grid(num_bins, (bh + rows - 1) / rows);
    resolve_depth_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)starts, (const float*)recs, cap, bx, bw, bh, out_w,
        (float*)depth);
    return (int)cudaGetLastError();
}

SOC_EXPORT int resolve_launch(const void* starts, const void* recs,
                              void* depth, void* tri_id, int cap,
                              int num_bins, int bx, int bw, int bh,
                              int out_w, void* stream) {
    if (bw <= 0 || bh <= 0) return (int)cudaErrorInvalidValue;
    if (num_bins <= 0) return 0;
    const int parts_x = (bw + kBlockW - 1) / kBlockW;
    const int parts = parts_x * ((bh + kBlockH - 1) / kBlockH);
    if ((long long)num_bins * parts > 0x7fffffff) {
        return (int)cudaErrorInvalidValue;
    }
    const int vec = cap % 4 == 0 && (uintptr_t)recs % 16 == 0;
    resolve_kernel<<<num_bins * parts, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)starts, (const float*)recs, cap, vec, bx, bw, bh,
        parts_x, parts, out_w, (float*)depth, (int*)tri_id);
    return (int)cudaGetLastError();
}

SOC_EXPORT const char* soc_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
