// K5: the material texture tap.
//
// Replaces soc_real_time_renderer_tpu/ops/texsample.py `_tile_kernel`
// (Pallas, TPU; launched by `sample_atlas_page`, driven by
// `sample_atlas_tiled`).  The TPU kernel exists because a large-table
// gather is slow there: it plans per-16x16-tile windows of a bf16 atlas
// page, blends in bf16 and falls back to the gather for dirty tiles.  On
// the card a gather is native, so this kernel computes the exact tap of
// ops/gbuffer.sample_packed_atlas per pixel, with no planner, page, caps
// or fallback.
//
// Inputs: `atlas` (N, 12) int32, each row the 11 sampled channels x 4
// bilinear corners packed c00 | c10 << 8 | c01 << 16 | c11 << 24 (lane 11
// pad; texture.expand_atlas_bilinear); per pixel `mid` int32, `uv` (2, P)
// f32, `lod` (P,) f32.  Output (11, P) f32 in [0, 1].
//
// Design: one thread per pixel.  lod is clamped to [0, n_levels - 1] and
// rounded half to even (bilinear, nearest) or split into floor/floor+1
// (trilinear); each tap is one 48-byte row read as three 16-byte int4
// loads through the read-only cache; the 11 channels x 4 corners unpack
// and blend in f32 in sample_packed_atlas' order.  The texel coordinate
// wraps with a non-negative remainder (x0 = -1 at the left edge is
// s - 1).  Index arithmetic: the plain version uses int64; here the row
// index fits int32 (mid * layer_stride + level offset + texel < N, and N
// = 6 x 1,398,101 at six 1024^2 materials; the wrapper refuses N >=
// 2^31 / 3 so that the int4 index stays in int32 too).  Bound: memory,
// one (or two) 48-byte row reads and 44 bytes written per pixel; the rows
// of neighbouring pixels are neighbours in the atlas, so L2 serves most
// reads.  Built with --fmad=false; "/ 255.0" is the multiply by the f32
// reciprocal that PyTorch's CUDA division by a Python scalar performs.
// A row past the atlas (a bad mid or layer_stride) is a device-side
// assert, as in the plain version's gather: no clamp reads a wrong
// material in silence.
#include <cassert>

#include "common.cuh"

namespace {

constexpr int kChannels = 11;

__device__ __forceinline__ int wrap(int v, int s) {
    const int r = v % s;
    return r < 0 ? r + s : r;
}

// One level's tap: out[c] = the blended channel c / 255.
__device__ __forceinline__ void level_fetch(const int4* __restrict__ atlas,
                                            int rows, int base_m, int size,
                                            int lv, float uw, float vw,
                                            bool bilinear, float* out) {
    const int s = size >> lv;
    const int off = (4 * size * size - 4 * s * s) / 3;
    const float sf = (float)s;
    const float x = uw * sf - 0.5f;
    const float y = vw * sf - 0.5f;
    const float inv255 = 1.0f / 255.0f;
    int xi, yi;
    if (bilinear) {
        xi = (int)floorf(x);
        yi = (int)floorf(y);
    } else {
        xi = (int)rintf(x);
        yi = (int)rintf(y);
    }
    const int row = base_m + off + wrap(yi, s) * s + wrap(xi, s);
    assert(row >= 0 && row < rows);
    const int4 q0 = __ldg(atlas + 3 * (size_t)row);
    const int4 q1 = __ldg(atlas + 3 * (size_t)row + 1);
    const int4 q2 = __ldg(atlas + 3 * (size_t)row + 2);
    const int c[kChannels] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                              q1.z, q1.w, q2.x, q2.y, q2.z};
    if (!bilinear) {
#pragma unroll
        for (int ch = 0; ch < kChannels; ++ch)
            out[ch] = (float)(c[ch] & 255) * inv255;
        return;
    }
    const float fx = x - floorf(x);
    const float fy = y - floorf(y);
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch) {
        const float c00 = (float)(c[ch] & 255);
        const float c10 = (float)((c[ch] >> 8) & 255);
        const float c01 = (float)((c[ch] >> 16) & 255);
        const float c11 = (float)((c[ch] >> 24) & 255);
        out[ch] = ((c00 * (1.0f - fx) + c10 * fx) * (1.0f - fy)
                   + (c01 * (1.0f - fx) + c11 * fx) * fy) * inv255;
    }
}

// mode: 0 nearest, 1 bilinear, 2 trilinear
__global__ void texsample_kernel(const int4* __restrict__ atlas,
                                 const int* __restrict__ mid,
                                 const float* __restrict__ uv,
                                 const float* __restrict__ lod,
                                 float* __restrict__ out, int P, int rows,
                                 int size, int layer_stride, int n_levels,
                                 int mode) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= P) return;
    const float u = uv[i];
    const float v = uv[(size_t)P + i];
    const float uw = u - floorf(u);
    const float vw = v - floorf(v);
    const int base_m = mid[i] * layer_stride;
    const float l = fminf(fmaxf(lod[i], 0.0f), (float)(n_levels - 1));
    float t0[kChannels];
    if (mode != 2) {
        level_fetch(atlas, rows, base_m, size, (int)rintf(l), uw, vw,
                    mode == 1, t0);
    } else {
        float t1[kChannels];
        const int l0 = (int)floorf(l);
        const int l1 = min(l0 + 1, n_levels - 1);
        const float f = l - (float)l0;
        level_fetch(atlas, rows, base_m, size, l0, uw, vw, true, t0);
        level_fetch(atlas, rows, base_m, size, l1, uw, vw, true, t1);
#pragma unroll
        for (int ch = 0; ch < kChannels; ++ch)
            t0[ch] = t0[ch] * (1.0f - f) + t1[ch] * f;
    }
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch) out[(size_t)ch * P + i] = t0[ch];
}

}  // namespace

SOC_EXPORT int texsample_launch(const void* atlas, const void* mid,
                                const void* uv, const void* lod, void* out,
                                int P, int rows, int size, int layer_stride,
                                int n_levels, int mode, void* stream) {
    if (mode < 0 || mode > 2 || rows <= 0 || n_levels <= 0)
        return (int)cudaErrorInvalidValue;
    if (P <= 0) return 0;
    const int threads = 256;
    texsample_kernel<<<(P + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
        (const int4*)atlas, (const int*)mid, (const float*)uv,
        (const float*)lod, (float*)out, P, rows, size, layer_stride,
        n_levels, mode);
    return (int)cudaGetLastError();
}
