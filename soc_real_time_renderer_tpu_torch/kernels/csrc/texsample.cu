// K5: the material texture tap, and the variants that take it apart.
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
//
// Variants (texsample_variant_launch; ops/texsample.VARIANTS names them).
// The JAX package's tools/bench_texkernel_parts.py (`make_variant`) and
// tools/bench_texmm2.py (`make`) took the TPU kernel apart by its stages
// (the page DMA, the U build, the row matmul, the Vw build, the channel
// select) to see what each costs.  Here the body is one template over
// its own stages:
//   (a) the inputs and the row address: lod clamp and round, level
//       offset, wrap;
//   (b) the three 16-byte __ldg of the 48-byte row;
//   (c) the 11 x 4 unpack and the bilinear blend, vertical and horizontal;
//   (d) the stores: planar (11, P) f32, interleaved (P, 12) f32 or bf16
//       (lane 11 zero), the channels' sum (one f32 a pixel), or a guarded
//       store that never happens;
// and the pixels a thread (kPx: 1, 2, 4; a block's pixels stay
// coalesced: pixel k of a thread is k block-widths on) and the lanes a
// pixel (kLanes: 1, or 3, each taking one int4 of the row and its four
// channels).  texsample_launch instantiates today's choices (planar,
// 1 px, 1 lane, every stage) and nothing else.
// Dead code: a variant that stores nothing would let the compiler delete
// the loads and the arithmetic before it.  The ablated variants keep what
// they compute alive: "no unpack" stores the packed words bit-cast; the
// guarded store (kGuard) writes a pixel's sum only where its bits equal a
// sentinel, a NaN payload (kNeverBits) that the sum of finite inputs, or
// the canonical NaN the card's adds make, cannot take; the sentinel is a
// kernel argument, so the compiler cannot fold the test away.
#include <cassert>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kChannels = 11;

// stages a variant switches off (kSkip bits)
constexpr int kNoLoads = 1;    // (b): the words made from the row index
constexpr int kNoAddr = 2;     // (a): row = (pixel index / 32) mod rows
                               //      (a warp's pixels share a row, near a
                               //      frame's locality), fx, fy the wrapped
                               //      u, v; mid, lod unread
constexpr int kNoVBlend = 4;   // (c): fy = 0; c01, c11 not unpacked
constexpr int kNoHBlend = 8;   // (c): fx = 0; c10, c11 not unpacked
constexpr int kNoUnpack = 16;  // (c): the packed words, bit-cast to f32
constexpr int kNoTap = 32;     // (a)-(c): no tap; the inputs read

// stores (kStore)
constexpr int kPlanar = 0;           // (11, P) f32
constexpr int kInterleaved = 1;      // (P, 12) f32, lane 11 zero
constexpr int kInterleavedBf16 = 2;  // (P, 12) bf16, round to nearest even
constexpr int kSum = 3;              // (P,) f32, the channels' sum
constexpr int kGuard = 4;            // (P,) f32, written where never

constexpr int kNeverBits = 0x7fc0dead;

struct TapArgs {
    const int4* atlas;
    const int* mid;
    const float* uv;
    const float* lod;
    void* out;
    int P, rows, size, layer_stride, n_levels, mode, sentinel;
};

__device__ __forceinline__ int wrap(int v, int s) {
    const int r = v % s;
    return r < 0 ? r + s : r;
}

// One level's tap of lane `part`'s channels: out[c] = the blended
// channel / 255 (kLanes 1: all 11; kLanes 3: four of int4 `part`).
template <int kSkip, int kLanes>
__device__ __forceinline__ void level_fetch(const TapArgs& a, int base_m,
                                            int lv, float uw, float vw,
                                            bool bilinear, int pix, int part,
                                            float* out) {
    constexpr int kN = kLanes == 1 ? kChannels : 4;
    const float inv255 = 1.0f / 255.0f;
    int row;
    float fx, fy;
    if (kSkip & kNoAddr) {
        row = (pix >> 5) % a.rows;
        fx = uw;
        fy = vw;
    } else {
        const int size = a.size;
        const int s = size >> lv;
        const int off = (4 * size * size - 4 * s * s) / 3;
        const float sf = (float)s;
        const float x = uw * sf - 0.5f;
        const float y = vw * sf - 0.5f;
        int xi, yi;
        if (bilinear) {
            xi = (int)floorf(x);
            yi = (int)floorf(y);
        } else {
            xi = (int)rintf(x);
            yi = (int)rintf(y);
        }
        row = base_m + off + wrap(yi, s) * s + wrap(xi, s);
        assert(row >= 0 && row < a.rows);
        fx = x - floorf(x);
        fy = y - floorf(y);
    }
    int c[kLanes == 1 ? 12 : 4];
    if (kSkip & kNoLoads) {
#pragma unroll
        for (int w = 0; w < (kLanes == 1 ? 12 : 4); ++w)
            c[w] = row * 12 + 4 * part + w;
    } else if (kLanes == 1) {
        const int4 q0 = __ldg(a.atlas + 3 * (size_t)row);
        const int4 q1 = __ldg(a.atlas + 3 * (size_t)row + 1);
        const int4 q2 = __ldg(a.atlas + 3 * (size_t)row + 2);
        c[0] = q0.x; c[1] = q0.y; c[2] = q0.z; c[3] = q0.w;
        c[4] = q1.x; c[5] = q1.y; c[6] = q1.z; c[7] = q1.w;
        c[8] = q2.x; c[9] = q2.y; c[10] = q2.z; c[11] = q2.w;
    } else {
        const int4 q = __ldg(a.atlas + 3 * (size_t)row + part);
        c[0] = q.x; c[1] = q.y; c[2] = q.z; c[3] = q.w;
    }
    if (kSkip & kNoUnpack) {
#pragma unroll
        for (int ch = 0; ch < kN; ++ch) out[ch] = __int_as_float(c[ch]);
        return;
    }
    if (!bilinear) {
#pragma unroll
        for (int ch = 0; ch < kN; ++ch)
            out[ch] = (float)(c[ch] & 255) * inv255;
        return;
    }
#pragma unroll
    for (int ch = 0; ch < kN; ++ch) {
        const float c00 = (float)(c[ch] & 255);
        if (kSkip & kNoVBlend) {
            const float c10 = (float)((c[ch] >> 8) & 255);
            out[ch] = (c00 * (1.0f - fx) + c10 * fx) * inv255;
        } else if (kSkip & kNoHBlend) {
            const float c01 = (float)((c[ch] >> 16) & 255);
            out[ch] = (c00 * (1.0f - fy) + c01 * fy) * inv255;
        } else {
            const float c10 = (float)((c[ch] >> 8) & 255);
            const float c01 = (float)((c[ch] >> 16) & 255);
            const float c11 = (float)((c[ch] >> 24) & 255);
            out[ch] = ((c00 * (1.0f - fx) + c10 * fx) * (1.0f - fy)
                       + (c01 * (1.0f - fx) + c11 * fx) * fy) * inv255;
        }
    }
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
           | ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Pixel i, lane `part`: the tap (mode: 0 nearest, 1 bilinear, 2
// trilinear) and its store.
template <int kStore, int kLanes, int kSkip>
__device__ __forceinline__ void tap_pixel(const TapArgs& a, int i, int part) {
    constexpr int kN = kLanes == 1 ? kChannels : 4;
    const int P = a.P;
    const float u = a.uv[i];
    const float v = a.uv[(size_t)P + i];
    float* out = (float*)a.out;
    if (kSkip & kNoTap) {
        const float s = u + v + a.lod[i] + (float)a.mid[i];
        if (__float_as_int(s) == a.sentinel) out[i] = s;
        return;
    }
    const float uw = u - floorf(u);
    const float vw = v - floorf(v);
    int base_m = 0;
    float l = 0.0f;
    if (!(kSkip & kNoAddr)) {
        base_m = a.mid[i] * a.layer_stride;
        l = fminf(fmaxf(a.lod[i], 0.0f), (float)(a.n_levels - 1));
    }
    float t0[kN];
    if (a.mode != 2) {
        level_fetch<kSkip, kLanes>(a, base_m, (int)rintf(l), uw, vw,
                                   a.mode == 1, i, part, t0);
    } else {
        float t1[kN];
        const int l0 = (int)floorf(l);
        const int l1 = min(l0 + 1, a.n_levels - 1);
        const float f = l - (float)l0;
        level_fetch<kSkip, kLanes>(a, base_m, l0, uw, vw, true, i, part, t0);
        level_fetch<kSkip, kLanes>(a, base_m, l1, uw, vw, true, i, part, t1);
#pragma unroll
        for (int ch = 0; ch < kN; ++ch)
            t0[ch] = t0[ch] * (1.0f - f) + t1[ch] * f;
    }
    if (kStore == kPlanar) {
#pragma unroll
        for (int ch = 0; ch < kN; ++ch) {
            const int c = kLanes == 1 ? ch : 4 * part + ch;
            if (c < kChannels) out[(size_t)c * P + i] = t0[ch];
        }
    } else if (kStore == kInterleaved) {
        float4* o = (float4*)a.out + 3 * (size_t)i;
        o[0] = make_float4(t0[0], t0[1], t0[2], t0[3]);
        o[1] = make_float4(t0[4], t0[5], t0[6], t0[7]);
        o[2] = make_float4(t0[8], t0[9], t0[10], 0.0f);
    } else if (kStore == kInterleavedBf16) {
        uint2* o = (uint2*)a.out + 3 * (size_t)i;
        o[0] = make_uint2(bf16_pair(t0[0], t0[1]), bf16_pair(t0[2], t0[3]));
        o[1] = make_uint2(bf16_pair(t0[4], t0[5]), bf16_pair(t0[6], t0[7]));
        o[2] = make_uint2(bf16_pair(t0[8], t0[9]), bf16_pair(t0[10], 0.0f));
    } else {
        float s = 0.0f;
#pragma unroll
        for (int ch = 0; ch < kN; ++ch) s += t0[ch];
        if (kStore == kSum) {
            out[i] = s;
        } else {
            s = s + u + v;
            if (__float_as_int(s) == a.sentinel) out[i] = s;
        }
    }
}

__host__ __device__ constexpr int threads_of(int lanes) {
    return lanes == 1 ? 256 : 192;
}

template <int kStore, int kPx, int kLanes, int kSkip>
__global__ void tap_kernel(TapArgs a) {
    static_assert(kLanes == 1 || kStore == kPlanar,
                  "the lane split stores planar");
    constexpr int kGroups = threads_of(kLanes) / kLanes;
    const int part = kLanes == 1 ? 0 : (int)threadIdx.x % kLanes;
    const int first = blockIdx.x * (kGroups * kPx)
                      + (int)threadIdx.x / kLanes;
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
        const int i = first + k * kGroups;
        if (i >= a.P) return;
        tap_pixel<kStore, kLanes, kSkip>(a, i, part);
    }
}

template <int kStore, int kPx, int kLanes, int kSkip>
int launch_tap(const TapArgs& a, cudaStream_t stream) {
    constexpr int kThreads = threads_of(kLanes);
    constexpr int kPerBlock = kThreads / kLanes * kPx;
    tap_kernel<kStore, kPx, kLanes, kSkip>
        <<<(a.P + kPerBlock - 1) / kPerBlock, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

SOC_EXPORT int texsample_launch(const void* atlas, const void* mid,
                                const void* uv, const void* lod, void* out,
                                int P, int rows, int size, int layer_stride,
                                int n_levels, int mode, void* stream) {
    if (mode < 0 || mode > 2 || rows <= 0 || n_levels <= 0)
        return (int)cudaErrorInvalidValue;
    if (P <= 0) return 0;
    const TapArgs a{(const int4*)atlas, (const int*)mid, (const float*)uv,
                    (const float*)lod, out, P, rows, size, layer_stride,
                    n_levels, mode, kNeverBits};
    return launch_tap<kPlanar, 1, 1, 0>(a, (cudaStream_t)stream);
}

// `variant`: the index of the variant in ops/texsample.VARIANTS (each case
// names it); kStore, kPx, kLanes, kSkip as above.
SOC_EXPORT int texsample_variant_launch(const void* atlas, const void* mid,
                                        const void* uv, const void* lod,
                                        void* out, int P, int rows, int size,
                                        int layer_stride, int n_levels,
                                        int mode, int variant, void* stream) {
    if (mode < 0 || mode > 2 || rows <= 0 || n_levels <= 0)
        return (int)cudaErrorInvalidValue;
    if (P <= 0) return 0;
    const TapArgs a{(const int4*)atlas, (const int*)mid, (const float*)uv,
                    (const float*)lod, out, P, rows, size, layer_stride,
                    n_levels, mode, kNeverBits};
    const cudaStream_t st = (cudaStream_t)stream;
    switch (variant) {
        case 0: return launch_tap<kPlanar, 1, 1, 0>(a, st);  // planar
        case 1: return launch_tap<kInterleaved, 1, 1, 0>(a, st);  // interleaved
        case 2: return launch_tap<kPlanar, 1, 3, 0>(a, st);  // lanes3
        case 3: return launch_tap<kPlanar, 2, 1, 0>(a, st);  // planar_px2
        case 4: return launch_tap<kPlanar, 4, 1, 0>(a, st);  // planar_px4
        case 5: return launch_tap<kInterleaved, 4, 1, 0>(a, st);  // interleaved_px4
        case 6: return launch_tap<kPlanar, 4, 3, 0>(a, st);  // lanes3_px4
        case 7: return launch_tap<kInterleavedBf16, 1, 1, 0>(a, st);  // interleaved_bf16
        case 8: return launch_tap<kPlanar, 1, 1, kNoLoads>(a, st);  // no_loads
        case 9: return launch_tap<kPlanar, 1, 1, kNoAddr>(a, st);  // no_address
        case 10: return launch_tap<kPlanar, 1, 1, kNoVBlend>(a, st);  // no_vblend
        case 11: return launch_tap<kPlanar, 1, 1, kNoHBlend>(a, st);  // no_hblend
        case 12: return launch_tap<kPlanar, 1, 1, kNoUnpack>(a, st);  // no_unpack
        case 13: return launch_tap<kGuard, 1, 1, kNoUnpack>(a, st);  // only_loads
        case 14: return launch_tap<kGuard, 1, 1, kNoTap>(a, st);  // nothing
        case 15: return launch_tap<kGuard, 4, 1, kNoTap>(a, st);  // nothing_px4
        case 16: return launch_tap<kSum, 1, 1, 0>(a, st);  // floor
    }
    return (int)cudaErrorInvalidValue;
}
