// K3: TAA history reprojection, and K3f: the whole TAA resolve around it.
//
// K3 replaces soc_real_time_renderer_tpu/ops/taa_pallas.py `_taa_kernel`
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
//
// K3f, `taa_resolve_kernel`, is the frame's TAA pass in one launch: the
// 3x3 neighbourhood (Gaussian blur, colour AABB, the neighbors[5] quirk
// texel, closest-depth dilation), the velocity at the dilated texel,
// K3's fetch of the previous colour and velocity (the same device
// functions as K3), the blend factor from the frame counter read on the
// card, the AABB clamp, the blend and the disocclusion lerp.  It
// replaces no TPU kernel by itself: on the TPU that resolve is XLA
// around `_taa_kernel` (soc_real_time_renderer_tpu/ops/taa.py).  Its
// plain version, ops/taa.neighbourhood and _resolve_plain, is ~417
// PyTorch launches that each read and write whole planes.
//
// Inputs: `color` (3, H, W) f32, `depth` (H, W), `vel` (2, H, W) f32 of
// a band of H rows; `prev_c` (3, full_h, W) and `prev_v` (2, full_h, W)
// bf16, the whole screen's history, each through its own pointer;
// `frame_counter` int32.  Output (3, H - 2 crop, W) f32: the band's rows
// without `crop` rows at either end (a band's halo), whose first row is
// screen row `row0`.  The 3x3 clamps at the band's own rows (its halo
// rows hold the neighbours', or repeat the screen's edge), uv and the
// fetch use screen rows.  Views: blockIdx.z; every input has its own
// view stride in elements (the frame counter's is 0 where one counter
// serves every view), the output is dense.
//
// Bound: memory, 46 bytes a pixel (colour 12, depth 4, velocity 8, the
// bf16 history 10 read; colour 12 written), ~200 f32 operations a
// pixel.  The neighbourhood's 36 reads a pixel hit L1: neighbouring
// threads read neighbouring texels of the same three rows.  Bit for bit
// the plain version: --fmad=false, its operation order, true divisions,
// and min / max / clamp that return NaN as torch.minimum, torch.maximum
// and torch.clamp do (fminf and fmaxf drop it).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a || a > b) ? a : b;
}

// torch.clamp(v, lo, hi): NaN stays NaN
__device__ __forceinline__ float nan_clamp(float v, float lo, float hi) {
    return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ int floor_index(float v, int n) {
    return soc_to_index(floorf(v), n);
}

// the bilinear clamp-to-edge taps at (u, v) of a (full_h, W) plane
struct Tap {
    size_t o00, o10, o01, o11;
    float fx, fy;
};

__device__ __forceinline__ Tap history_tap(float u, float v, int W,
                                           int full_h) {
    const float xf = u * (float)W - 0.5f;
    const float yf = v * (float)full_h - 0.5f;
    const int x0 = floor_index(xf, W);
    const int y0 = floor_index(yf, full_h);
    const int x1 = min(x0 + 1, W - 1);
    const int y1 = min(y0 + 1, full_h - 1);
    Tap t;
    t.fx = nan_clamp(xf - (float)x0, 0.0f, 1.0f);
    t.fy = nan_clamp(yf - (float)y0, 0.0f, 1.0f);
    t.o00 = (size_t)y0 * W + x0;
    t.o10 = (size_t)y0 * W + x1;
    t.o01 = (size_t)y1 * W + x0;
    t.o11 = (size_t)y1 * W + x1;
    return t;
}

__device__ __forceinline__ float history_fetch(
        const __nv_bfloat16* __restrict__ p, const Tap& t) {
    const float c00 = __bfloat162float(p[t.o00]);
    const float c10 = __bfloat162float(p[t.o10]);
    const float c01 = __bfloat162float(p[t.o01]);
    const float c11 = __bfloat162float(p[t.o11]);
    const float top = c00 * (1.0f - t.fx) + c10 * t.fx;
    const float bot = c01 * (1.0f - t.fx) + c11 * t.fx;
    return top * (1.0f - t.fy) + bot * t.fy;
}

// the screen uv of pixel (x, ys) less the velocity (du, dv)
__device__ __forceinline__ float2 reprojected_uv(int x, int ys, int W,
                                                 int full_h, float du,
                                                 float dv) {
    return make_float2(((float)x + 0.5f) / (float)W - du,
                       ((float)ys + 0.5f) / (float)full_h - dv);
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
    const float2 uv = reprojected_uv(x, y + row0, W, full_h, vel[i],
                                     vel[HW + i]);
    const Tap t = history_tap(uv.x, uv.y, W, full_h);
    for (int c = 0; c < C; ++c)
        out[c * HW + i] = history_fetch(hist + c * FW, t);
}

__global__ void __launch_bounds__(256) taa_resolve_kernel(
        const float* __restrict__ color, const float* __restrict__ depth,
        const float* __restrict__ vel,
        const __nv_bfloat16* __restrict__ prev_c,
        const __nv_bfloat16* __restrict__ prev_v,
        const int* __restrict__ frame_counter, float* __restrict__ out,
        int H, int W, int crop, int row0, int full_h, int color_vs,
        int depth_vs, int vel_vs, int prev_c_vs, int prev_v_vs,
        int counter_vs) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;   // output row
    const int out_h = H - 2 * crop;
    if (x >= W || j >= out_h) return;
    const size_t HW = (size_t)H * W;
    const size_t FW = (size_t)full_h * W;
    const size_t OW = (size_t)out_h * W;
    const size_t view = blockIdx.z;
    color += view * color_vs;
    depth += view * depth_vs;
    vel += view * vel_vs;
    prev_c += view * prev_c_vs;
    prev_v += view * prev_v_vs;
    out += view * 3 * OW;
    const int y = j + crop;                                // input row

    // the 3x3 pass, in the shader's loop order (y: 1..-1, x: 1..-1);
    // "d <= closest" favours the latest minimum
    float blurred[3] = {0.0f, 0.0f, 0.0f};
    float min_c[3] = {1e6f, 1e6f, 1e6f};
    float max_c[3] = {-1e6f, -1e6f, -1e6f};
    float center[3];
    float closest = 1.0f;
    int ddx = 0, ddy = 0;
#pragma unroll
    for (int dy = 1; dy >= -1; --dy) {
        const size_t row = (size_t)min(max(y + dy, 0), H - 1) * W;
#pragma unroll
        for (int dx = 1; dx >= -1; --dx) {
            const size_t k = row + min(max(x + dx, 0), W - 1);
            const float d = depth[k];
            if (d <= closest) {
                ddx = dx;
                ddy = dy;
            }
            closest = nan_min(closest, d);
            // GAUSS: 1/16 at the corners, 1/8 at the edges, 1/4 inside
            const float g = (dx == 0 && dy == 0) ? 0.25f
                            : (dx == 0 || dy == 0) ? 0.125f : 0.0625f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float v = color[c * HW + k];
                min_c[c] = nan_min(min_c[c], v);
                max_c[c] = nan_max(max_c[c], v);
                blurred[c] = blurred[c] + g * v;
                if (dx == 1 && dy == 0) center[c] = v;  // neighbors[5]
            }
        }
    }
    const size_t kv = (size_t)min(max(y + ddy, 0), H - 1) * W
                      + min(max(x + ddx, 0), W - 1);
    const float vx = vel[kv], vy = vel[HW + kv];

    const float2 uv = reprojected_uv(x, row0 + j, W, full_h, vx, vy);
    float accum = fminf((float)frame_counter[view * counter_vs], 0.1f);
    if (uv.x < 0.0f || uv.y < 0.0f || uv.x > 1.0f || uv.y > 1.0f)
        accum = 1.0f;
    const Tap t = history_tap(uv.x, uv.y, W, full_h);
    const float dvx = history_fetch(prev_v, t) - vx;
    const float dvy = history_fetch(prev_v + FW, t) - vy;
    const float vel_len = sqrtf(dvx * dvx + dvy * dvy);
    const float disocc = nan_clamp((vel_len - 0.001f) * 10.0f, 0.0f, 1.0f);
    const size_t o = (size_t)j * W + x;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float h = history_fetch(prev_c + c * FW, t);
        const float acc = nan_min(nan_max(h, min_c[c]), max_c[c]);
        const float res = center[c] * accum + acc * (1.0f - accum);
        out[c * OW + o] = res + (blurred[c] - res) * disocc;
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

SOC_EXPORT int taa_resolve_launch(const void* color, const void* depth,
                                  const void* vel, const void* prev_c,
                                  const void* prev_v,
                                  const void* frame_counter, void* out,
                                  int H, int W, int crop, int row0,
                                  int full_h, int views, int color_vs,
                                  int depth_vs, int vel_vs, int prev_c_vs,
                                  int prev_v_vs, int counter_vs,
                                  void* stream) {
    const int out_h = H - 2 * crop;
    if (views > 65535 || crop < 0 || out_h < 0 || row0 < 0 || full_h <= 0
            || row0 + out_h > full_h)
        return (int)cudaErrorInvalidValue;
    if (out_h == 0 || W <= 0 || views <= 0) return 0;
    const dim3 block(32, 8);
    const dim3 grid((W + 31) / 32, (out_h + 7) / 8, views);
    taa_resolve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)color, (const float*)depth, (const float*)vel,
        (const __nv_bfloat16*)prev_c, (const __nv_bfloat16*)prev_v,
        (const int*)frame_counter, (float*)out, H, W, crop, row0, full_h,
        color_vs, depth_vs, vel_vs, prev_c_vs, prev_v_vs, counter_vs);
    return (int)cudaGetLastError();
}
