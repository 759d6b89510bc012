// K7: composition's local lights (composition.inl:124-160) in one launch.
//
// It replaces no TPU kernel: the JAX package shades the lights in XLA, a
// lax.scan over the slots (soc_real_time_renderer_tpu/ops/composition.py
// `_local_lights`).  Its plain version, ops/composition._local_lights_plain,
// is a Python loop of ~44 whole-plane PyTorch ops a point light and ~67 a
// spot light, each reading and writing (3, P) planes: 14,347 kernels a
// frame with the globals' 128 point and 128 spot slots filled.
//
// Inputs: `albedo`, `normal` and `position` planar (3, views, P) f32, each
// with its own channel and view strides in elements (int; P dense); the
// camera's position (views, 3); the globals' light arrays, each (views,
// 128, ...) or (128, ...) and the two live counts (views,) or () int32,
// dense (`lights_vs` 1: one set a view, 0: one set for every view).
// Output `out` (3, views, P) dense: the sum over the live lights of
// albedo * colour * (diffuse + specular) / d^2 * intensity (* the cone).
// A row band is P of its pixels: the positions come in per band, so the
// row split needs nothing more.  Views: blockIdx.z.
//
// Design: one thread a pixel.  The block stages its view's lights in
// shared memory (slot order; a spot's normalised -direction and its
// cone's eps computed there once, by the same operations as the plain
// version's), then each thread loops over all live point lights, then
// all live spot lights.  The live counts are read on the card (no host
// read), and a slot at or past min(count, max) is skipped: the plain
// version adds it times 0, which leaves the sum as it is wherever the
// slot's term is finite (an empty slot's is: zero colour and intensity,
// d2 >= 1e-12).
//
// Bound: compute, 56 f32 operations a point light's (light, pixel) pair
// and 66 a spot light's, counting each of its two IEEE square roots,
// seven or eight IEEE divisions, its acosf and its expf as one
// (benchmark/metrics/lights_roofline.py); 48 bytes a pixel.
// Bit for bit the plain version: --fmad=false, its operation order, true
// divisions, correctly rounded sqrtf, the CUDA math library's acosf and
// expf (what PyTorch's own kernels call for f32), and clamps that return
// NaN as torch.clamp does (fmaxf alone drops it).
#include "common.cuh"

namespace {

constexpr int kSlots = 128;      // shared.inl:84-85
constexpr int kThreads = 256;

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return v != v ? v : fmaxf(v, lo);
}

// torch.clamp(v, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
    return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float dot(float ax, float ay, float az, float bx,
                                     float by, float bz) {
    return ax * bx + ay * by + az * bz;
}

// utils/vec.normalize3's divisor: clamp(sqrt(clamp(a.a, 0)), 1e-8)
__device__ __forceinline__ float norm_divisor(float x, float y, float z) {
    return clamp_min(sqrtf(clamp_min(dot(x, y, z, x, y, z), 0.0f)), 1e-8f);
}

__global__ void __launch_bounds__(kThreads) local_lights_kernel(
        const float* __restrict__ albedo, const float* __restrict__ normal,
        const float* __restrict__ position, const float* __restrict__ cam,
        const float* __restrict__ pt_pos, const float* __restrict__ pt_col,
        const float* __restrict__ pt_int, const int* __restrict__ pt_count,
        const float* __restrict__ sp_pos, const float* __restrict__ sp_dir,
        const float* __restrict__ sp_col, const float* __restrict__ sp_int,
        const float* __restrict__ sp_cut, const float* __restrict__ sp_ocut,
        const int* __restrict__ sp_count, float* __restrict__ out, int P,
        int views, int max_point, int max_spot, int lights_vs, int alb_cs,
        int alb_vs, int nrm_cs, int nrm_vs, int pos_cs, int pos_vs) {
    __shared__ float s_pp[3 * kSlots], s_pc[3 * kSlots], s_pi[kSlots];
    __shared__ float s_sp[3 * kSlots], s_sd[3 * kSlots], s_sc[3 * kSlots];
    __shared__ float s_si[kSlots], s_socut[kSlots], s_seps[kSlots];

    const int view = blockIdx.z;
    const int lv = view * lights_vs;            // this view's light set
    const int n_point = min(max(pt_count[lv], 0), max_point);
    const int n_spot = min(max(sp_count[lv], 0), max_spot);
    const int t = threadIdx.x;
    if (t < kSlots) {
        if (t < n_point) {
            const size_t o3 = (size_t)lv * 3 * kSlots + 3 * t;
            for (int c = 0; c < 3; ++c) {
                s_pp[3 * t + c] = pt_pos[o3 + c];
                s_pc[3 * t + c] = pt_col[o3 + c];
            }
            s_pi[t] = pt_int[(size_t)lv * kSlots + t];
        }
    } else if (t - kSlots < n_spot) {
        const int i = t - kSlots;
        const size_t o3 = (size_t)lv * 3 * kSlots + 3 * i;
        const size_t o1 = (size_t)lv * kSlots + i;
        // normalize3(-direction)
        const float mx = -sp_dir[o3], my = -sp_dir[o3 + 1],
                    mz = -sp_dir[o3 + 2];
        const float n = norm_divisor(mx, my, mz);
        s_sd[3 * i] = mx / n;
        s_sd[3 * i + 1] = my / n;
        s_sd[3 * i + 2] = mz / n;
        for (int c = 0; c < 3; ++c) {
            s_sp[3 * i + c] = sp_pos[o3 + c];
            s_sc[3 * i + c] = sp_col[o3 + c];
        }
        s_si[i] = sp_int[o1];
        const float cut = sp_cut[o1], ocut = sp_ocut[o1];
        s_socut[i] = ocut;
        s_seps[i] = (cut - ocut != 0.0f) ? cut - ocut : 1e-6f;
    }
    __syncthreads();

    const int p = blockIdx.x * kThreads + t;
    if (p >= P) return;
    const size_t ia = (size_t)view * alb_vs + p;
    const size_t in = (size_t)view * nrm_vs + p;
    const size_t ip = (size_t)view * pos_vs + p;
    const float ax = albedo[ia], ay = albedo[ia + alb_cs],
                az = albedo[ia + 2 * (size_t)alb_cs];
    const float nx = normal[in], ny = normal[in + nrm_cs],
                nz = normal[in + 2 * (size_t)nrm_cs];
    const float px = position[ip], py = position[ip + pos_cs],
                pz = position[ip + 2 * (size_t)pos_cs];

    // vdir = normalize3(camera - position)
    const float* cv = cam + 3 * lv;
    float vx = cv[0] - px, vy = cv[1] - py, vz = cv[2] - pz;
    const float vn = norm_divisor(vx, vy, vz);
    vx = vx / vn;
    vy = vy / vn;
    vz = vz / vn;

    float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
    // the shared part of both kinds (_light_terms): the light direction,
    // diffuse + specular, and d2
    float dx, dy, dz, lit, d2;
    auto terms = [&](const float* lp) {
        const float lx = lp[0] - px, ly = lp[1] - py, lz = lp[2] - pz;
        d2 = clamp_min(dot(lx, ly, lz, lx, ly, lz), 1e-12f);
        const float r = sqrtf(d2);
        dx = lx / r;
        dy = ly / r;
        dz = lz / r;
        float hx = dx + vx, hy = dy + vy, hz = dz + vz;
        const float hn = norm_divisor(hx, hy, hz);
        hx = hx / hn;
        hy = hy / hn;
        hz = hz / hn;
        const float diffuse = clamp_min(dot(dx, dy, dz, nx, ny, nz), 0.0f);
        const float nh = acosf(clamp_to(dot(hx, hy, hz, nx, ny, nz), -1.0f,
                                        1.0f));
        lit = diffuse + expf(-(nh * nh));
    };
    for (int i = 0; i < n_point; ++i) {
        terms(s_pp + 3 * i);
        const float s = lit / d2 * s_pi[i];
        r0 = r0 + ax * (s_pc[3 * i] * s);
        r1 = r1 + ay * (s_pc[3 * i + 1] * s);
        r2 = r2 + az * (s_pc[3 * i + 2] * s);
    }
    for (int i = 0; i < n_spot; ++i) {
        terms(s_sp + 3 * i);
        const float theta = dot(dx, dy, dz, s_sd[3 * i], s_sd[3 * i + 1],
                                s_sd[3 * i + 2]);
        const float cone = clamp_to((theta - s_socut[i]) / s_seps[i], 0.0f,
                                    1.0f);
        const float s = lit / d2 * s_si[i] * cone;
        r0 = r0 + ax * (s_sc[3 * i] * s);
        r1 = r1 + ay * (s_sc[3 * i + 1] * s);
        r2 = r2 + az * (s_sc[3 * i + 2] * s);
    }
    const size_t cs = (size_t)views * P;
    const size_t o = (size_t)view * P + p;
    out[o] = r0;
    out[o + cs] = r1;
    out[o + 2 * cs] = r2;
}

}  // namespace

SOC_EXPORT int local_lights_launch(
        const void* albedo, const void* normal, const void* position,
        const void* cam, const void* pt_pos, const void* pt_col,
        const void* pt_int, const void* pt_count, const void* sp_pos,
        const void* sp_dir, const void* sp_col, const void* sp_int,
        const void* sp_cut, const void* sp_ocut, const void* sp_count,
        void* out, int P, int views, int max_point, int max_spot,
        int lights_vs, int alb_cs, int alb_vs, int nrm_cs, int nrm_vs,
        int pos_cs, int pos_vs, void* stream) {
    if (views > 65535 || max_point < 0 || max_point > kSlots
            || max_spot < 0 || max_spot > kSlots
            || (lights_vs != 0 && lights_vs != 1) || alb_cs < 0
            || alb_vs < 0 || nrm_cs < 0 || nrm_vs < 0 || pos_cs < 0
            || pos_vs < 0)
        return (int)cudaErrorInvalidValue;
    if (P <= 0 || views <= 0) return 0;
    const dim3 grid((P + kThreads - 1) / kThreads, 1, views);
    local_lights_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)albedo, (const float*)normal, (const float*)position,
        (const float*)cam, (const float*)pt_pos, (const float*)pt_col,
        (const float*)pt_int, (const int*)pt_count, (const float*)sp_pos,
        (const float*)sp_dir, (const float*)sp_col, (const float*)sp_int,
        (const float*)sp_cut, (const float*)sp_ocut, (const int*)sp_count,
        (float*)out, P, views, max_point, max_spot, lights_vs, alb_cs,
        alb_vs, nrm_cs, nrm_vs, pos_cs, pos_vs);
    return (int)cudaGetLastError();
}
