// K8: the screen-space reflection march (screen_space_reflection.inl:
// 74-186) in one launch.
//
// It replaces no TPU kernel: the JAX package marches its reflections in
// XLA (soc_real_time_renderer_tpu/ops/ssr.py `ssr`), and so does the
// port's plain version, ops/ssr._ssr_plain: 50 dependent steps of plain
// PyTorch over ray bundles, ~9,600 kernels and 74-108 ms a 1920x1088
// frame whose floor reflects.
//
// Inputs: `depth` (views, H, W), `albedo` and `normal` (views, 3, H, W),
// `mr` (views, 2, H, W: roughness, metallic) f32, each with its own
// channel and view strides in elements (int; each H x W plane dense);
// the camera's projection, inverse projection and view matrices (views,
// 4, 4) or (4, 4) (`mats_vs` 16: one a view, 0: one for every view).
// Output `out` (3, views, H * W) dense: a dielectric pixel's (metallic <
// 0.01) albedo; a reflective pixel's albedo at its ray's hit (bilinear),
// or black where its ray misses or is past the cap.  Views: blockIdx.z.
//
// The cap (ops/ssr.ssr's `compact_cap`): 0 marches every pixel that is
// not dielectric.  Above 0, only the view's first `cap` reflective pixels
// (metallic >= 0.01) in row-major order march: `rank` is the view's
// inclusive prefix sum of that mask (views, H * W) int32, or null where
// cap >= H * W (every reflective pixel marches).  Where `count` is given,
// it gets the view's reflective pixels added (zeroed by the caller), and
// `overflow` OVERFLOW_SSR_CAP (16) where some reflective pixel is past
// the cap, that is where the count exceeds it.
//
// Design: one thread a pixel, blocks of 16 x 16 pixels and each warp an
// 8 x 4 patch of them, so that neighbouring rays, which leave in nearly
// the same direction, tap the same lines of depth.  A ray returns at its
// hit: the plain march's state after a hit never changes its hit uv, so
// the result is the same.  Bound: the march is a chain of dependent depth
// gathers (1 to 50 a ray), so latency, not bytes (44 a pixel) nor
// operations (127 a ray, 80 a probe: benchmark/roofline.py ssr_job).
// Bit for bit the plain version: --fmad=false, its operation order, true
// divisions, correctly rounded sqrtf, clamps that keep NaN as torch.clamp
// does, and the constants rounded from double to float as PyTorch
// rounds a Python scalar.
#include "common.cuh"

namespace {

constexpr int kTile = 16;                 // a block's tile is 16 x 16
constexpr int kThreads = kTile * kTile;
constexpr int kIterations = 50;
constexpr float kRayStep = (float)0.5;
constexpr float kGrowth = (float)1.05;
constexpr float kDistanceBias = (float)0.05;
constexpr float kMetallicMin = (float)0.01;
constexpr float kNormEps = (float)1e-8;
constexpr int kOverflowSsrCap = 16;

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return v != v ? v : fmaxf(v, lo);
}

// torch.clamp(v, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
    return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// utils/vec.normalize3's divisor: clamp(sqrt(clamp(a.a, 0)), 1e-8)
__device__ __forceinline__ float norm_divisor(float x, float y, float z) {
    return clamp_min(sqrtf(clamp_min(x * x + y * y + z * z, 0.0f)),
                     kNormEps);
}

// torch.where(w != 0, w, 1.0)
__device__ __forceinline__ float nonzero(float w) {
    return w != 0.0f ? w : 1.0f;
}

// sampling.sample_screen's bilinear tap weights at uv of an H x W plane
struct Tap {
    int i00, i10, i01, i11;
    float fx, fy;
};

__device__ __forceinline__ Tap tap_at(float u, float v, int H, int W) {
    const float x = u * (float)W - 0.5f;
    const float y = v * (float)H - 0.5f;
    const int x0 = soc_to_index(floorf(x), W);
    const int y0 = soc_to_index(floorf(y), H);
    const int x1 = min(x0 + 1, W - 1);
    const int y1 = min(y0 + 1, H - 1);
    Tap t;
    t.fx = clamp_to(x - (float)x0, 0.0f, 1.0f);
    t.fy = clamp_to(y - (float)y0, 0.0f, 1.0f);
    t.i00 = y0 * W + x0;
    t.i10 = y0 * W + x1;
    t.i01 = y1 * W + x0;
    t.i11 = y1 * W + x1;
    return t;
}

// sampling._lerp2 of one channel
__device__ __forceinline__ float lerp_tap(const float* __restrict__ img,
                                          const Tap& t) {
    const float top = img[t.i00] * (1.0f - t.fx) + img[t.i10] * t.fx;
    const float bot = img[t.i01] * (1.0f - t.fx) + img[t.i11] * t.fx;
    return top * (1.0f - t.fy) + bot * t.fy;
}

__global__ void __launch_bounds__(kThreads) ssr_march_kernel(
        const float* __restrict__ depth, const float* __restrict__ albedo,
        const float* __restrict__ normal, const float* __restrict__ mr,
        const float* __restrict__ proj, const float* __restrict__ inv_proj,
        const float* __restrict__ view_mat, const int* __restrict__ rank,
        int* __restrict__ count, int* __restrict__ overflow,
        float* __restrict__ out, int H, int W, int views, int cap,
        int mats_vs, int dep_vs, int alb_cs, int alb_vs, int nrm_cs,
        int nrm_vs, int mr_cs, int mr_vs) {
    const int view = blockIdx.z;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int x = blockIdx.x * kTile + (warp & 1) * 8 + (lane & 7);
    const int y = blockIdx.y * kTile + (warp >> 1) * 4 + (lane >> 3);
    const bool inside = x < W && y < H;
    const int P = H * W;
    const int p = y * W + x;

    const float metallic = inside
        ? mr[(size_t)view * mr_vs + mr_cs + p] : 0.0f;
    const bool active = inside && metallic >= kMetallicMin;
    if (count != nullptr) {
        const int n = __syncthreads_count(active);
        if (threadIdx.x == 0 && n > 0) atomicAdd(count + view, n);
    }
    if (!inside) return;

    const size_t cs = (size_t)views * P;
    float* o = out + (size_t)view * P + p;
    const float* alb = albedo + (size_t)view * alb_vs;
    if (metallic < kMetallicMin) {           // dielectric: the albedo
        o[0] = alb[p];
        o[cs] = alb[p + alb_cs];
        o[2 * cs] = alb[p + 2 * (size_t)alb_cs];
        return;
    }
    if (cap > 0) {
        bool live = active;
        if (live && rank != nullptr) {
            live = rank[(size_t)view * P + p] - 1 < cap;
            if (!live) overflow[view] = kOverflowSsrCap;
        }
        if (!live) {                         // past the cap: black
            o[0] = 0.0f;
            o[cs] = 0.0f;
            o[2 * cs] = 0.0f;
            return;
        }
    }

    const float* pm = proj + (size_t)view * mats_vs;
    const float* ip = inv_proj + (size_t)view * mats_vs;
    const float* vm = view_mat + (size_t)view * mats_vs;
    const float* dv = depth + (size_t)view * dep_vs;

    // the pixel's view-space position (composition.view_from_depth)
    const float u = ((float)x + 0.5f) / (float)W;
    const float v = ((float)y + 0.5f) / (float)H;
    const float d = dv[p];
    const float nx = u * 2.0f - 1.0f, ny = v * 2.0f - 1.0f;
    const float vw = nonzero(ip[12] * nx + ip[13] * ny + ip[14] * d
                             + ip[15]);
    const float px = (ip[0] * nx + ip[1] * ny + ip[2] * d + ip[3]) / vw;
    const float py = (ip[4] * nx + ip[5] * ny + ip[6] * d + ip[7]) / vw;
    const float pz = (ip[8] * nx + ip[9] * ny + ip[10] * d + ip[11]) / vw;

    // its view-space normal, normalised
    const float* nrm = normal + (size_t)view * nrm_vs + p;
    const float n0 = nrm[0], n1 = nrm[nrm_cs], n2 = nrm[2 * (size_t)nrm_cs];
    float qx = vm[0] * n0 + vm[1] * n1 + vm[2] * n2;
    float qy = vm[4] * n0 + vm[5] * n1 + vm[6] * n2;
    float qz = vm[8] * n0 + vm[9] * n1 + vm[10] * n2;
    const float qn = norm_divisor(qx, qy, qz);
    qx = qx / qn;
    qy = qy / qn;
    qz = qz / qn;

    // the reflected ray, normalised
    const float t2 = 2.0f * (px * qx + py * qy + pz * qz);
    float rx = px - t2 * qx, ry = py - t2 * qy, rz = pz - t2 * qz;
    const float rn = norm_divisor(rx, ry, rz);
    rx = rx / rn;
    ry = ry / rn;
    rz = rz / rn;

    // the projection's x, y and w rows; the inverse's z and w rows
    const float a0 = pm[0], a1 = pm[1], a2 = pm[2], a3 = pm[3];
    const float b0 = pm[4], b1 = pm[5], b2 = pm[6], b3 = pm[7];
    const float c0 = pm[12], c1 = pm[13], c2 = pm[14], c3 = pm[15];
    const float e0 = ip[8], e1 = ip[9], e2 = ip[10], e3 = ip[11];
    const float f0 = ip[12], f1 = ip[13], f2 = ip[14], f3 = ip[15];

    float sx = rx * kRayStep, sy = ry * kRayStep, sz = rz * kRayStep;
    float mx = px + sx, my = py + sy, mz = pz + sz;
    bool binary = false;
    for (int it = 0; it < kIterations; ++it) {
        // probe: the point on the screen, the depth there in view space
        const float ws = nonzero(c0 * mx + c1 * my + c2 * mz + c3);
        const float su = (a0 * mx + a1 * my + a2 * mz + a3) / ws * 0.5f
            + 0.5f;
        const float sv = (b0 * mx + b1 * my + b2 * mz + b3) / ws * 0.5f
            + 0.5f;
        const float sd = lerp_tap(dv, tap_at(su, sv, H, W));
        const float tx = su * 2.0f - 1.0f, ty = sv * 2.0f - 1.0f;
        const float sw = nonzero(f0 * tx + f1 * ty + f2 * sd + f3);
        const float sz_ = (e0 * tx + e1 * ty + e2 * sd + e3) / sw;
        const float delta = fabsf(mz) - fabsf(sz_);
        if (fabsf(delta) < kDistanceBias) {  // the hit: its albedo
            const Tap t = tap_at(su, sv, H, W);
            o[0] = lerp_tap(alb, t);
            o[cs] = lerp_tap(alb + alb_cs, t);
            o[2 * cs] = lerp_tap(alb + 2 * (size_t)alb_cs, t);
            return;
        }
        // torch.sign: NaN -> 0
        const float dsign = (float)((0.0f < delta) - (delta < 0.0f));
        if (!binary && !(delta > 0.0f)) {
            // marching: one step forward, the next 1.05 times longer
            const float f = 1.0f - kRayStep * fmaxf(dsign, 0.0f);
            sx = sx * f;
            sy = sy * f;
            sz = sz * f;
            const float g = -dsign;
            mx = mx + sx * g;
            my = my + sy * g;
            mz = mz + sz * g;
            sx = sx * kGrowth;
            sy = sy * kGrowth;
            sz = sz * kGrowth;
        } else {
            // the binary refinement: half the step, against delta's sign
            binary = true;
            sx = sx * 0.5f;
            sy = sy * 0.5f;
            sz = sz * 0.5f;
            mx = mx - sx * dsign;
            my = my - sy * dsign;
            mz = mz - sz * dsign;
        }
    }
    o[0] = 0.0f;                             // a miss: black
    o[cs] = 0.0f;
    o[2 * cs] = 0.0f;
}

}  // namespace

SOC_EXPORT int ssr_march_launch(
        const void* depth, const void* albedo, const void* normal,
        const void* mr, const void* proj, const void* inv_proj,
        const void* view_mat, const void* rank, void* count, void* overflow,
        void* out, int H, int W, int views, int cap, int mats_vs, int dep_vs,
        int alb_cs, int alb_vs, int nrm_cs, int nrm_vs, int mr_cs, int mr_vs,
        void* stream) {
    if (views > 65535 || (mats_vs != 0 && mats_vs != 16) || dep_vs < 0
            || alb_cs < 0 || alb_vs < 0 || nrm_cs < 0 || nrm_vs < 0
            || mr_cs < 0 || mr_vs < 0 || (rank != nullptr && cap <= 0)
            || ((rank != nullptr || count != nullptr)
                && (count == nullptr || overflow == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (H <= 0 || W <= 0 || views <= 0) return 0;
    const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile,
                    views);
    ssr_march_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)depth, (const float*)albedo, (const float*)normal,
        (const float*)mr, (const float*)proj, (const float*)inv_proj,
        (const float*)view_mat, (const int*)rank, (int*)count,
        (int*)overflow, (float*)out, H, W, views, cap, mats_vs, dep_vs,
        alb_cs, alb_vs, nrm_cs, nrm_vs, mr_cs, mr_vs);
    return (int)cudaGetLastError();
}
