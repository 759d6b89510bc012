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
// Design: one thread per pixel; the tap itself (the lod clamp and
// round, the level offset, the wrap, the row's three 16-byte loads, the
// 11 x 4 unpack and blend in sample_packed_atlas' order) is
// texsample.cuh's tap_value, which K9 (gbuffer.cu) calls too.  Index
// arithmetic: the plain version uses int64; here the row index fits
// int32 (mid * layer_stride + level offset + texel < N, and N = 6 x
// 1,398,101 at six 1024^2 materials).  Bound: memory, one (or two)
// 48-byte row reads and 44 bytes written per pixel; the rows of
// neighbouring pixels are neighbours in the atlas, so L2 serves most
// reads.  Built with --fmad=false.
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
#include <cuda_bf16.h>

#include "texsample.cuh"

namespace {

// stores (kStore)
constexpr int kPlanar = 0;           // (11, P) f32
constexpr int kInterleaved = 1;      // (P, 12) f32, lane 11 zero
constexpr int kInterleavedBf16 = 2;  // (P, 12) bf16, round to nearest even
constexpr int kSum = 3;              // (P,) f32, the channels' sum
constexpr int kGuard = 4;            // (P,) f32, written where never

constexpr int kNeverBits = 0x7fc0dead;

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
    const bool addr = !(kSkip & kNoAddr);
    float t0[kN];
    tap_value<kSkip, kLanes>(a, addr ? a.mid[i] : 0, u, v,
                             addr ? a.lod[i] : 0.0f, i, part, t0);
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
