// K3: TAA history reprojection.
//
// Replaces soc_real_time_renderer_tpu/ops/taa_pallas.py `_taa_kernel`
// (Pallas, TPU; launched by `reproject_history_pallas`).  It computes
// what the JAX package's exact path computes (`taa(impl="xla")`): the
// packed bf16 history (prev colour 3 + prev velocity 2) sampled
// bilinearly, clamp-to-edge exactly as ops/sampling.sample_screen, at
// uv - velocity.  The TPU kernel's out-of-window flag is an artifact of
// its VMEM window and has no counterpart here.
//
// Inputs: `hist` (C, full_h, W) bf16, the whole screen's history; `vel`
// (2, H, W) f32 (the dilated velocity) of a band of H rows whose first
// row is screen row `row0`.  Output (C, H, W) f32.  A pixel's uv and the
// reprojected row are the screen's, `(y + row0 + 0.5) / full_h`, and the
// fetch clamps at the screen's edges (the JAX kernel's `row0` / `full_h`,
// taa_pallas.py:44-64; one frame is row0 = 0, H = full_h; the row split
// of one frame over a mesh launches once per band).  Views: `views` such
// sets back to back ((views, C, full_h, W) history, (views, 2, H, W)
// velocity, ...), one launch, blockIdx.z the view.
//
// Design: one thread per pixel computes the tap position and weights
// once and fetches the 4 corners of each of the C channels, so that each
// load and store instruction of a warp covers 32 neighbouring pixels (the
// corner gathers of neighbouring pixels share their 32-byte sectors).
// Bound: memory, 2C x 4 bytes of scattered-but-local bf16 reads, 8 bytes
// of velocity and 4C bytes written per pixel.  Measured on the H100 at
// 1920x1088 and not kept: four contiguous pixels a thread with 16-byte
// velocity and output vectors and bf16x2 corner pairs (about 2x slower:
// the gathers of a warp instruction spread over four times the sectors,
// the pair loads diverge on odd x0), and all corner loads issued before
// the first store (a few per cent faster only with C fixed at five, about
// 30% slower with a loop bound on C).  Built with --fmad=false in the
// plain version's operation order (ops/taa.reproject_plain).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ int floor_index(float v, int n) {
    return soc_to_index(floorf(v), n);
}

__global__ void taa_reproject_kernel(const __nv_bfloat16* __restrict__ hist,
                                     const float* __restrict__ vel,
                                     float* __restrict__ out, int C, int H,
                                     int W, int row0, int full_h) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const size_t HW = (size_t)H * W;             // the band's plane
    const size_t FW = (size_t)full_h * W;        // the history's plane
    hist += blockIdx.z * C * FW;
    vel += blockIdx.z * 2 * HW;
    out += blockIdx.z * C * HW;
    const size_t i = (size_t)y * W + x;
    const float u = ((float)x + 0.5f) / (float)W - vel[i];
    const float v = ((float)(y + row0) + 0.5f) / (float)full_h - vel[HW + i];
    const float xf = u * (float)W - 0.5f;
    const float yf = v * (float)full_h - 0.5f;
    const int x0 = floor_index(xf, W);
    const int y0 = floor_index(yf, full_h);
    const int x1 = min(x0 + 1, W - 1);
    const int y1 = min(y0 + 1, full_h - 1);
    const float fx = fminf(fmaxf(xf - (float)x0, 0.0f), 1.0f);
    const float fy = fminf(fmaxf(yf - (float)y0, 0.0f), 1.0f);
    const size_t o00 = (size_t)y0 * W + x0, o10 = (size_t)y0 * W + x1;
    const size_t o01 = (size_t)y1 * W + x0, o11 = (size_t)y1 * W + x1;
    for (int c = 0; c < C; ++c) {
        const __nv_bfloat16* p = hist + c * FW;
        const float c00 = __bfloat162float(p[o00]);
        const float c10 = __bfloat162float(p[o10]);
        const float c01 = __bfloat162float(p[o01]);
        const float c11 = __bfloat162float(p[o11]);
        const float top = c00 * (1.0f - fx) + c10 * fx;
        const float bot = c01 * (1.0f - fx) + c11 * fx;
        out[c * HW + i] = top * (1.0f - fy) + bot * fy;
    }
}

}  // namespace

SOC_EXPORT int taa_reproject_launch(const void* hist, const void* vel,
                                    void* out, int C, int H, int W,
                                    int views, int row0, int full_h,
                                    void* stream) {
    if (views > 65535 || row0 < 0 || full_h <= 0 || row0 + H > full_h)
        return (int)cudaErrorInvalidValue;
    if (H <= 0 || W <= 0 || views <= 0) return 0;
    const dim3 block(32, 8);
    const dim3 grid((W + 31) / 32, (H + 7) / 8, views);
    taa_reproject_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)hist, (const float*)vel, (float*)out, C, H, W,
        row0, full_h);
    return (int)cudaGetLastError();
}
