// K9: the G-buffer resolve in one launch.
//
// Replaces no TPU kernel: the JAX package's resolve_gbuffer
// (soc_real_time_renderer_tpu/ops/gbuffer.py) is XLA around the tap's
// Pallas `_tile_kernel`.  Added for the card's measurement: its plain
// version, ops/gbuffer.resolve_gbuffer, took ~3.6 device ms a 1920x1088
// view in some 300-400 elementwise launches and a (40, P) record gather
// of 334 MB, the frame's largest pass, against a bound near 0.05 ms.
//
// Per pixel, in the plain version's order: tri_id; the triangle's record
// rows from the planar (40, *V, T+1) f32 records (column T, all zeros,
// the miss sentinel); the edge values and their x / y derivatives at the
// pixel's screen centre; the perspective-correct uv and its derivatives,
// the lod, the material tap through K5's own device code (texsample.cuh:
// one tap code for K5 and K9); the sRGB decode, the emissive and
// metallic-roughness masks; the position and its derivatives, the
// normal, the TBN normal map or the terrain's decoded normal; the
// velocity against prev_view_proj (zero on the terrain); the sky clear
// where no triangle covers the pixel; the five targets written planar
// (C, *V, H, W), as the plain version lays them out.
//
// Equality: bit for bit with the plain version on the card, so every op
// is what PyTorch's CUDA kernel does: a tensor divided by a Python scalar
// is a multiply by the scalar's reciprocal taken in double and rounded to
// f32 (x / 12.92, / 1.055, px / W; 1.0f / 1.055f is another float);
// x ** 2 is x * x, x ** 2.4 powf; 1.0 / t is a true division
// (Tensor.__rdiv__ is a reciprocal); torch.round is rintf, torch.log2
// log2f; clamp and maximum pass a NaN through; utils/vec.normalize3
// clamps the squared norm at 0 and the norm at 1e-8.  Built with
// --fmad=false.
//
// Views on blockIdx.z (per-view adjugate rows and prev_view_proj, stride
// 16 or 0), a row band through row0 (its first screen row) and full_h
// (the screen's rows), filter modes 0 nearest, 1 bilinear, 2 trilinear
// and 3 none (the attribution probe: a constant 0.5 texel, no tap).
// Design: one thread a pixel, a block 32 x 8 pixels, each warp an 8 x 4
// tile, so a warp's record loads mostly hit one or a few triangles (the
// records stay planar: a triangle's row is one 4-byte load, broadcast
// over the warp) and each store is four 32-byte row segments.  Each
// attribute's nine record values are read where it is interpolated, to
// keep registers down.  Bound: bytes, 56 a pixel (tri_id read, 13 f32
// written; depth passes through), plus 152 a distinct visible triangle
// and the tap's 48-byte atlas rows.
#include "texsample.cuh"

namespace {

constexpr int kModeNone = 3;    // no tap: the texel is 0.5

struct ResolveArgs {
    const int* tri_id;          // (V, H, W)
    const float* recs;          // (40, V, T1)
    const float* prev_vp;       // (V, 4, 4) or (4, 4)
    float* albedo;              // (3, V, H, W)
    float* emissive;            // (3, V, H, W)
    float* normal;              // (3, V, H, W)
    float* mr;                  // (2, V, H, W)
    float* velocity;            // (2, V, H, W)
    TapArgs tap;
    int H, W, views, T1, row0, vp_stride, mode;
    float inv_w, inv_h;         // 1 / W, 1 / full_h: double, then f32
};

// torch.clamp(x, min=lo) and torch.maximum: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float maximum(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// gbuffer._srgb_to_linear
__device__ __forceinline__ float srgb_to_linear(float x) {
    return x <= (float)0.04045
               ? x * (float)(1.0 / 12.92)
               : powf((x + (float)0.055) * (float)(1.0 / 1.055),
                      (float)2.4);
}

// utils/vec.normalize3, in place
__device__ __forceinline__ void normalize3(float* a) {
    const float d = a[0] * a[0] + a[1] * a[1] + a[2] * a[2];
    const float n = clamp_min(sqrtf(clamp_min(d, 0.0f)), (float)1e-8);
    a[0] = a[0] / n;
    a[1] = a[1] / n;
    a[2] = a[2] / n;
}

// The edge values at the pixel and their derivatives (gbuffer.py's e,
// ex, ey, Dx, Dy and invD), with the record's row reader.
struct Edges {
    const float* rec;           // row 0 of the pixel's triangle
    size_t stride;              // between rows: views * T1
    float e[3], ex[3], ey[3], Dx, Dy, invD;

    __device__ __forceinline__ float row(int r) const {
        return __ldg(rec + (size_t)r * stride);
    }

    // gbuffer.py's interp: the perspective-correct value and d/dx, d/dy
    // of rows r, r + k, r + 2k
    __device__ __forceinline__ float interp(int r, int k, float* dx,
                                            float* dy) const {
        const float r0 = row(r), r1 = row(r + k), r2 = row(r + 2 * k);
        const float N = e[0] * r0 + e[1] * r1 + e[2] * r2;
        const float val = N * invD;
        if (dx != nullptr) {
            const float Nx = ex[0] * r0 + ex[1] * r1 + ex[2] * r2;
            const float Ny = ey[0] * r0 + ey[1] * r1 + ey[2] * r2;
            *dx = (Nx - val * Dx) * invD;
            *dy = (Ny - val * Dy) * invD;
        }
        return val;
    }
};

__global__ void gbuffer_resolve_kernel(ResolveArgs a) {
    const int warp = (int)threadIdx.x >> 5;
    const int lane = (int)threadIdx.x & 31;
    const int x = (int)blockIdx.x * 32 + (warp & 3) * 8 + (lane & 7);
    const int y = (int)blockIdx.y * 8 + (warp >> 2) * 4 + (lane >> 3);
    const int b = (int)blockIdx.z;
    if (x >= a.W || y >= a.H) return;
    const size_t plane = (size_t)a.views * a.H * a.W;
    const size_t pix = ((size_t)b * a.H + y) * a.W + x;

    const int tri = a.tri_id[pix];
    const bool miss = tri < 0;
    const int t = miss ? a.T1 - 1 : tri;
    Edges E;
    E.stride = (size_t)a.views * a.T1;
    E.rec = a.recs + (size_t)b * a.T1 + t;
    const float px = (float)x + 0.5f;
    const float py = (float)(a.row0 + y) + 0.5f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        E.ex[k] = E.row(3 * k);
        E.ey[k] = E.row(3 * k + 1);
        E.e[k] = E.ex[k] * px + E.ey[k] * py + E.row(3 * k + 2);
    }
    const float D = E.e[0] + E.e[1] + E.e[2];
    E.Dx = E.ex[0] + E.ex[1] + E.ex[2];
    E.Dy = E.ey[0] + E.ey[1] + E.ey[2];
    E.invD = 1.0f / (D != 0.0f ? D : 1.0f);

    // uv, lod and the material tap
    float du_dx, du_dy, dv_dx, dv_dy;
    const float u = E.interp(27, 2, &du_dx, &du_dy);
    const float v = E.interp(28, 2, &dv_dx, &dv_dy);
    const float lod_sq = maximum(du_dx * du_dx + dv_dx * dv_dx,
                                 du_dy * du_dy + dv_dy * dv_dy)
                         * (float)(a.tap.size * a.tap.size);
    const float lod = 0.5f * log2f(clamp_min(lod_sq, (float)1e-12));
    float tex[kChannels];
    if (a.mode == kModeNone) {
#pragma unroll
        for (int c = 0; c < kChannels; ++c) tex[c] = 0.5f;
    } else {
        const int mid = (int)rintf(E.row(33));
        tap_value<0, 1>(a.tap, mid, u, v, lod, 0, 0, tex);
    }

    const float has_n = E.row(34), has_mr = E.row(35), has_e = E.row(36);
    const float is_ter = E.row(37);
    const float live = miss ? 0.0f : 1.0f;
    const float sky[3] = {(float)0.2, (float)0.4, (float)1.0};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float emissive = srgb_to_linear(tex[8 + c]) * has_e;
        const float albedo = srgb_to_linear(tex[c]) + emissive;
        const size_t o = c * plane + pix;
        a.albedo[o] = albedo * live + sky[c] * (1.0f - live);
        a.emissive[o] = emissive * live;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
        a.mr[c * plane + pix] = tex[6 + c] * has_mr * live;

    // position and its derivatives; the normal map (inl:198-213)
    float pos[3], pos_dx[3], pos_dy[3], n[3], tn[3], tvec[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        pos[c] = E.interp(9 + c, 3, &pos_dx[c], &pos_dy[c]);
        n[c] = E.interp(18 + c, 3, nullptr, nullptr);
        tn[c] = tex[3 + c] * 2.0f - 1.0f;
        tvec[c] = pos_dx[c] * dv_dy - pos_dy[c] * dv_dx;
    }
    normalize3(n);
    normalize3(tvec);
    float bvec[3] = {n[1] * tvec[2] - n[2] * tvec[1],
                     n[2] * tvec[0] - n[0] * tvec[2],
                     n[0] * tvec[1] - n[1] * tvec[0]};
    normalize3(bvec);
    float mapped[3], ter[3] = {tn[0], tn[1], tn[2]};
#pragma unroll
    for (int c = 0; c < 3; ++c)
        mapped[c] = tvec[c] * tn[0] + bvec[c] * tn[1] + n[c] * tn[2];
    normalize3(mapped);
    normalize3(ter);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float nm = mapped[c] * has_n + n[c] * (1.0f - has_n);
        a.normal[c * plane + pix] =
            (ter[c] * is_ter + nm * (1.0f - is_ter)) * live;
    }

    // velocity against the previous camera (inl:226-229)
    const float* m = a.prev_vp + (size_t)b * a.vp_stride;
    const float pc_x = m[0] * pos[0] + m[1] * pos[1] + m[2] * pos[2] + m[3];
    const float pc_y = m[4] * pos[0] + m[5] * pos[1] + m[6] * pos[2] + m[7];
    const float pc_w = m[12] * pos[0] + m[13] * pos[1] + m[14] * pos[2]
                       + m[15];
    const float wsafe = pc_w != 0.0f ? pc_w : 1.0f;
    const float cur_u = px * a.inv_w;
    const float cur_v = py * a.inv_h;
    const float not_ter = 1.0f - is_ter;
    const float vel_u = cur_u - (pc_x / wsafe * 0.5f + 0.5f);
    const float vel_v = cur_v - (pc_y / wsafe * 0.5f + 0.5f);
    a.velocity[pix] = vel_u * not_ter * live;
    a.velocity[plane + pix] = vel_v * not_ter * live;
}

}  // namespace

SOC_EXPORT int gbuffer_resolve_launch(
        const void* tri_id, const void* recs, const void* atlas,
        const void* prev_vp, void* albedo, void* emissive, void* normal,
        void* mr, void* velocity, int H, int W, int views, int T1, int row0,
        int full_h, int vp_stride, int rows, int size, int layer_stride,
        int n_levels, int mode, void* stream) {
    if (mode < 0 || mode > kModeNone || views <= 0 || T1 <= 0 || row0 < 0
        || full_h < row0 + H || (vp_stride != 0 && vp_stride != 16)
        || (mode != kModeNone && (rows <= 0 || n_levels <= 0)))
        return (int)cudaErrorInvalidValue;
    if (H <= 0 || W <= 0) return 0;
    const TapArgs tap{(const int4*)atlas, nullptr, nullptr, nullptr, nullptr,
                      0, rows, size, layer_stride, n_levels,
                      mode == kModeNone ? 1 : mode, 0};
    const ResolveArgs a{(const int*)tri_id, (const float*)recs,
                        (const float*)prev_vp, (float*)albedo,
                        (float*)emissive, (float*)normal, (float*)mr,
                        (float*)velocity, tap, H, W, views, T1, row0,
                        vp_stride, mode, (float)(1.0 / W),
                        (float)(1.0 / full_h)};
    const dim3 grid((W + 31) / 32, (H + 7) / 8, views);
    gbuffer_resolve_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
