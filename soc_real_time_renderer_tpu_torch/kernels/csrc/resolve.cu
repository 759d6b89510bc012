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
// Design: one thread block per bin, 256 threads, PPT pixels per thread
// (8 for the 64x32 main-view bins), each thread carrying (min z, min id)
// of its pixels in registers.  The bin's records stream through shared
// memory 128 at a time (8 KB, coalesced row loads); every thread reads
// each record as a broadcast.  The winner test is order independent
// (global min z, then min id), so neither the sort's tie order nor the
// chunking can change the result, and the TPU kernel's near-to-far early
// out is left out.  Bound: arithmetic, about 20 flops and one division
// per (pair, pixel); at 1920x1088 the frame's bins hold a few hundred
// thousand pairs of 2048 pixels each.  Built with --fmad=false so the
// edge functions round exactly as the plain version's separate multiply
// and add (raster2.resolve_plain).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;
constexpr int kRows = 16;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ starts, const float* __restrict__ recs,
               int cap, int bx, int bw, int bh, int out_w,
               float* __restrict__ depth, int* __restrict__ tri_id) {
    __shared__ float s[kRows][kChunk];
    const int b = blockIdx.x;
    const int start = starts[b];
    const int end = starts[b + 1];
    const int gx0 = (b % bx) * bw;
    const int gy0 = (b / bx) * bh;
    const int P = bw * bh;

    float px[PPT], py[PPT], zb[PPT];
    int ib[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        const int p = threadIdx.x + k * kThreads;
        // (lx + ox) + 0.5, exact in float like the plain version
        px[k] = (float)(p % bw + gx0) + 0.5f;
        py[k] = (float)(p / bw + gy0) + 0.5f;
        zb[k] = CUDART_INF_F;
        ib[k] = -1;
    }

    for (int c0 = start; c0 < end; c0 += kChunk) {
        const int n = min(kChunk, end - c0);
        __syncthreads();  // the previous chunk is consumed
        for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
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
            const int id = (int)s[15][j];
#pragma unroll
            for (int k = 0; k < PPT; ++k) {
                const float e0 = a0 * px[k] + a1 * py[k] + a2;
                const float e1 = a3 * px[k] + a4 * py[k] + a5;
                const float e2 = a6 * px[k] + a7 * py[k] + a8;
                const float ez = e0 * z0 + e1 * z1 + e2 * z2;
                const float ew = e0 * w0 + e1 * w1 + e2 * w2;
                if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && ew > 0.0f) {
                    const float z = ez / ew;
                    if (z >= 0.0f && z <= 1.0f
                        && (z < zb[k] || (z == zb[k] && id < ib[k]))) {
                        zb[k] = z;
                        ib[k] = id;
                    }
                }
            }
        }
    }

#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        const int p = threadIdx.x + k * kThreads;
        if (p < P) {
            const size_t o = (size_t)(p / bw + gy0) * out_w + (p % bw + gx0);
            depth[o] = ib[k] >= 0 ? zb[k] : 1.0f;
            tri_id[o] = ib[k];
        }
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
    const int P = bw * bh;
    if (num_bins <= 0) return 0;
    const dim3 grid(num_bins);
    cudaStream_t st = (cudaStream_t)stream;
    auto s = (const int*)starts;
    auto r = (const float*)recs;
    auto d = (float*)depth;
    auto t = (int*)tri_id;
#define SOC_RESOLVE(PPT)                                                  \
    resolve_kernel<PPT><<<grid, kThreads, 0, st>>>(s, r, cap, bx, bw, bh, \
                                                   out_w, d, t)
    if (P <= kThreads) SOC_RESOLVE(1);
    else if (P <= 2 * kThreads) SOC_RESOLVE(2);
    else if (P <= 4 * kThreads) SOC_RESOLVE(4);
    else if (P <= 8 * kThreads) SOC_RESOLVE(8);
    else if (P <= 16 * kThreads) SOC_RESOLVE(16);
    else return (int)cudaErrorInvalidValue;  // bins above 4096 px
#undef SOC_RESOLVE
    return (int)cudaGetLastError();
}

SOC_EXPORT const char* soc_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
