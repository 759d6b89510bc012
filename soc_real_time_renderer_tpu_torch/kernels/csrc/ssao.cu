// K2: the SSAO hemisphere taps.
//
// Replaces soc_real_time_renderer_tpu/ops/ssao.py `_ssao_kernel`
// (Pallas, TPU; launched by `ssao_generate_pallas`).  It computes what
// the JAX package's exact tail `ssao_generate` computes (ssao.py:150-193),
// not the TPU kernel's approximations: the occluder depth is
// point-sampled from the FULL-resolution depth at
// clip(int(u * W - 0.5)) with no window and no clamp to one.
//
// Inputs: `planes` (12, h, w) f32 = [view-space fragment position 3 |
// tangent 3 | bitangent 3 | view normal 3] from the preamble (plain
// PyTorch, ops/ssao._preamble); `depth` (H, W) f32 full resolution;
// `params` 34 f32 = [projection 4x4 | inverse projection 4x4 | radius |
// bias]; `kern` (k, 3) f32 hemisphere vectors.  Output (h, w) f32 =
// 1 - occlusion / k.  Views: `views` sets of planes, depth, parameters
// and output back to back (a 34-float parameter row per view), one
// launch, blockIdx.z the view; the kernel vectors are shared.
//
// Bound: operations, on this card the schedulers' instruction rate.  The 26-tap
// instantiation is ~150 SASS instructions a tap: ~70 uncontracted f32
// adds and multiplies (--fmad=false), four IEEE divisions of ~12 each
// (reciprocal, five FMAs, range check, branch to a slow path), index
// and control.  None of the divisions may be traded: the plain version,
// ops/ssao.ssao_taps_plain, divides, and the result is held bit for
// bit.  The one scattered depth read per tap lands in L1/L2
// (neighbouring pixels tap neighbouring texels); with every tap reading
// the pixel's own texel instead the kernel is only 12% faster, and a
// depth tile staged in shared memory was slower than L1.
//
// Design: one thread per half-resolution pixel.  The tap count is a
// template parameter (26, the renderer's; one generic instantiation of
// the same body takes any other 1 <= k <= 64), so the loop unrolls.
// Taps go in groups of SOC_K2_GROUP: first every tap's sample point,
// projection, texel address and its depth read, so the group's gathers
// and divisions are in flight together; then the range checks, and the
// occlusion sum in tap order, as the plain version sums.  The 34
// parameters and 3k kernel vectors come from device memory through
// shared memory, read once per block: no constant-memory copy on the
// stream ahead of the launch.  SOC_K2_GROUP, SOC_K2_BX and SOC_K2_BY
// are compile-time so that kernel_ab.py --other-flags can time another
// group or block shape against the default.
#include "common.cuh"

#ifndef SOC_K2_GROUP
#define SOC_K2_GROUP 13
#endif
#ifndef SOC_K2_BX
#define SOC_K2_BX 32
#endif
#ifndef SOC_K2_BY
#define SOC_K2_BY 8
#endif

namespace {

constexpr int kMaxTaps = 64;
constexpr int kParams = 34;
constexpr int kGroup = SOC_K2_GROUP;
constexpr int kThreads = SOC_K2_BX * SOC_K2_BY;

// soc_to_index in three instructions: the hardware conversion already
// truncates toward zero, saturates and turns NaN into 0.
__device__ __forceinline__ int tap_index(float v, int n) {
    return min(max(__float2int_rz(v), 0), n - 1);
}

// kTaps > 0: the tap count, known to the compiler; 0: k_rt taps.
template <int kTaps>
__global__ void __launch_bounds__(kThreads)
ssao_taps_kernel(const float* __restrict__ planes,
                 const float* __restrict__ depth,
                 const float* __restrict__ params,
                 const float* __restrict__ kern, float* __restrict__ out,
                 int h, int w, int H, int W, int k_rt) {
    __shared__ float s_par[kParams];
    __shared__ float s_kern[kMaxTaps * 3];
    const int k = kTaps > 0 ? kTaps : k_rt;
    const int tid = threadIdx.y * SOC_K2_BX + threadIdx.x;
    const size_t hw_view = (size_t)h * w;
    planes += blockIdx.z * 12 * hw_view;
    depth += blockIdx.z * (size_t)H * W;
    params += blockIdx.z * kParams;
    out += blockIdx.z * hw_view;
    for (int i = tid; i < kParams; i += kThreads) s_par[i] = params[i];
    for (int i = tid; i < 3 * k; i += kThreads) s_kern[i] = kern[i];
    __syncthreads();

    const int x = blockIdx.x * SOC_K2_BX + threadIdx.x;
    const int y = blockIdx.y * SOC_K2_BY + threadIdx.y;
    if (x >= w || y >= h) return;
    const size_t hw = (size_t)h * w;
    const size_t i = (size_t)y * w + x;
    const float f0 = planes[i], f1 = planes[hw + i], f2 = planes[2 * hw + i];
    const float t0 = planes[3 * hw + i], t1 = planes[4 * hw + i],
                t2 = planes[5 * hw + i];
    const float b0 = planes[6 * hw + i], b1 = planes[7 * hw + i],
                b2 = planes[8 * hw + i];
    const float n0 = planes[9 * hw + i], n1 = planes[10 * hw + i],
                n2 = planes[11 * hw + i];
    // projection rows 0, 1, 3 and inverse-projection rows 2, 3
    const float p00 = s_par[0], p01 = s_par[1], p02 = s_par[2],
                p03 = s_par[3], p10 = s_par[4], p11 = s_par[5],
                p12 = s_par[6], p13 = s_par[7], p30 = s_par[12],
                p31 = s_par[13], p32 = s_par[14], p33 = s_par[15];
    const float q20 = s_par[24], q21 = s_par[25], q22 = s_par[26],
                q23 = s_par[27], q30 = s_par[28], q31 = s_par[29],
                q32 = s_par[30], q33 = s_par[31];
    const float radius = s_par[32];
    const float bias = s_par[33];
    const float Wf = (float)W, Hf = (float)H;

    float occ = 0.0f;
#pragma unroll
    for (int s0 = 0; s0 < k; s0 += kGroup) {
        float sz[kGroup], ou[kGroup], ov[kGroup], sd[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
            const int s = s0 + j;
            if (s < k) {
                const float k0 = s_kern[3 * s], k1 = s_kern[3 * s + 1],
                            k2 = s_kern[3 * s + 2];
                const float sx = f0 + (t0 * k0 + b0 * k1 + n0 * k2) * radius;
                const float sy = f1 + (t1 * k0 + b1 * k1 + n1 * k2) * radius;
                sz[j] = f2 + (t2 * k0 + b2 * k1 + n2 * k2) * radius;
                const float ox = p00 * sx + p01 * sy + p02 * sz[j] + p03;
                const float oy = p10 * sx + p11 * sy + p12 * sz[j] + p13;
                const float ow = p30 * sx + p31 * sy + p32 * sz[j] + p33;
                const float ows = ow != 0.0f ? ow : 1.0f;
                ou[j] = ox / ows * 0.5f + 0.5f;
                ov[j] = oy / ows * 0.5f + 0.5f;
                const int xi = tap_index(ou[j] * Wf - 0.5f, W);
                const int yi = tap_index(ov[j] * Hf - 0.5f, H);
                sd[j] = __ldg(depth + (yi * W + xi));   // H * W < 2^31
            }
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
            if (s0 + j < k) {
                const float nx = ou[j] * 2.0f - 1.0f;
                const float ny = ov[j] * 2.0f - 1.0f;
                const float vz = q20 * nx + q21 * ny + q22 * sd[j] + q23;
                const float vw = q30 * nx + q31 * ny + q32 * sd[j] + q33;
                const float sdep = vz / (vw != 0.0f ? vw : 1.0f);
                const float denom = fmaxf(fabsf(f2 - sdep), 1e-8f);
                const float t = fminf(fmaxf(radius / denom, 0.0f), 1.0f);
                const float rc = t * t * (3.0f - 2.0f * t);
                if (sdep >= sz[j] + bias) occ += rc;
            }
        }
    }
    out[i] = 1.0f - occ / (float)k;
}

}  // namespace

SOC_EXPORT int ssao_taps_launch(const void* planes, const void* depth,
                                const void* params, const void* kern,
                                void* out, int h, int w, int H, int W,
                                int k, int views, void* stream) {
    if (k <= 0 || k > kMaxTaps || views > 65535)
        return (int)cudaErrorInvalidValue;
    if (h <= 0 || w <= 0 || views <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 block(SOC_K2_BX, SOC_K2_BY);
    const dim3 grid((w + SOC_K2_BX - 1) / SOC_K2_BX,
                    (h + SOC_K2_BY - 1) / SOC_K2_BY, views);
    const float* pl = (const float*)planes;
    const float* dp = (const float*)depth;
    const float* pa = (const float*)params;
    const float* ke = (const float*)kern;
    if (k == 26)
        ssao_taps_kernel<26><<<grid, block, 0, st>>>(pl, dp, pa, ke,
                                                     (float*)out, h, w, H,
                                                     W, k);
    else
        ssao_taps_kernel<0><<<grid, block, 0, st>>>(pl, dp, pa, ke,
                                                    (float*)out, h, w, H,
                                                    W, k);
    return (int)cudaGetLastError();
}
