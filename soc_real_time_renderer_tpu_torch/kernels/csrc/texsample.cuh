// The material texture tap's device code, shared by K5 (texsample.cu:
// the tap alone and its variants) and K9 (gbuffer.cu: the tap inside the
// G-buffer resolve), so that both compute one tap.
//
// The exact tap of ops/gbuffer.sample_packed_atlas from the (N, 12) int32
// atlas table, each row the 11 sampled channels x 4 bilinear corners
// packed c00 | c10 << 8 | c01 << 16 | c11 << 24 (lane 11 pad;
// texture.expand_atlas_bilinear).  lod is clamped to [0, n_levels - 1]
// and rounded half to even (bilinear, nearest) or split into
// floor/floor+1 (trilinear); each tap is one 48-byte row read as three
// 16-byte int4 loads through the read-only cache; the 11 channels x 4
// corners unpack and blend in f32 in sample_packed_atlas' order.  The
// texel coordinate wraps with a non-negative remainder (x0 = -1 at the
// left edge is s - 1).  The row index fits int32 (the wrappers refuse N
// >= 2^31 / 3, so that the int4 index does too).  "/ 255.0" is the
// multiply by the f32 reciprocal that PyTorch's CUDA division by a
// Python scalar performs.  A row past the atlas (a bad mid or
// layer_stride) is a device-side assert, as in the plain version's
// gather: no clamp reads a wrong material in silence.
#pragma once

#include <cassert>

#include "common.cuh"

namespace {

constexpr int kChannels = 11;

// stages a K5 variant switches off (kSkip bits; 0 computes the tap)
constexpr int kNoLoads = 1;    // the words made from the row index
constexpr int kNoAddr = 2;     // row = (pixel index / 32) mod rows (a
                               // warp's pixels share a row, near a
                               // frame's locality), fx, fy the wrapped
                               // u, v; mid, lod unread
constexpr int kNoVBlend = 4;   // fy = 0; c01, c11 not unpacked
constexpr int kNoHBlend = 8;   // fx = 0; c10, c11 not unpacked
constexpr int kNoUnpack = 16;  // the packed words, bit-cast to f32
constexpr int kNoTap = 32;     // no tap; the inputs read

struct TapArgs {
    const int4* atlas;
    const int* mid;      // K5's per-pixel inputs and output (K9: null)
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

// The tap at (mid, u, v, lod) of lane `part` (a.mode: 0 nearest, 1
// bilinear, 2 trilinear) into t[kN]; `pix` is the pixel's index (the
// kNoAddr row).
template <int kSkip, int kLanes>
__device__ __forceinline__ void tap_value(const TapArgs& a, int mid, float u,
                                          float v, float lod, int pix,
                                          int part, float* t) {
    constexpr int kN = kLanes == 1 ? kChannels : 4;
    const float uw = u - floorf(u);
    const float vw = v - floorf(v);
    int base_m = 0;
    float l = 0.0f;
    if (!(kSkip & kNoAddr)) {
        base_m = mid * a.layer_stride;
        l = fminf(fmaxf(lod, 0.0f), (float)(a.n_levels - 1));
    }
    if (a.mode != 2) {
        level_fetch<kSkip, kLanes>(a, base_m, (int)rintf(l), uw, vw,
                                   a.mode == 1, pix, part, t);
        return;
    }
    float t1[kN];
    const int l0 = (int)floorf(l);
    const int l1 = min(l0 + 1, a.n_levels - 1);
    const float f = l - (float)l0;
    level_fetch<kSkip, kLanes>(a, base_m, l0, uw, vw, true, pix, part, t);
    level_fetch<kSkip, kLanes>(a, base_m, l1, uw, vw, true, pix, part, t1);
#pragma unroll
    for (int ch = 0; ch < kN; ++ch)
        t[ch] = t[ch] * (1.0f - f) + t1[ch] * f;
}

}  // namespace
