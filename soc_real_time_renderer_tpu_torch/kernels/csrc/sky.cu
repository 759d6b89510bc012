// K6: the sky LUT over the tiled cloud-noise texture, and K6p: the same
// LUT over the procedural value noise.
//
// K6 replaces soc_real_time_renderer_tpu/ops/sky_pallas.py `_sky_kernel`
// (Pallas, TPU; launched by `render_sky_lut_pallas`).  The TPU kernel
// keeps the 64x64 noise tile in VMEM and takes each bilinear-repeat tap
// as a soft-one-hot MXU product in bf16.  This kernel computes the JAX
// package's exact XLA path instead, clouds.render_sky_lut(g,
// noise_tex=...), whose port (ops/clouds.render_sky_lut) is its plain
// version: per lat-long texel the 16x8-step atmosphere, then the 24-step
// cloud march between the cloud shells, each sample a 4-octave fBm over
// the noise (two z slices, four bilinear taps each) with a 10-step sun
// march, two-lobe HG phase, powder/Beer and the scatter integral.  The
// horizon factor is applied by the wrapper (ops/sky.py), as
// sky_pallas.py:391-394 does.
//
// K6p replaces no TPU kernel: without the noise texture both packages
// march in plain array code (the JAX package's LUT is XLA, not Pallas),
// and on the card that march was thousands of small PyTorch kernels a
// frame, half of the terrain frame.  Its plain version is
// clouds.render_sky_lut(g): the same march, each slice of the fBm four
// hashes of the integer lattice (_value_noise2 over _hash2) in place of
// four texture taps.  The noise source is the kernel's template
// parameter; everything else is shared.
//
// Inputs: `params` 16 f32 [sun_dir 3 | atmosphere origin 3 | camera x, z
// | elapsed | cloud drift | sky light * 0.25 / pi 3 | pad], computed by
// the wrapper with the plain version's own PyTorch operations; `noise`
// (64, 64) f32 (K6 alone).  Output (3, lut_h, lut_w) f32.  Views:
// `views` parameter rows and LUTs back to back, one launch, blockIdx.y
// the view (the noise is shared).
//
// What held the first design back: one thread per texel in 128 blocks
// put two warps on a scheduler, with nothing to hide the latency of a
// dependent chain of 16 x 9 atmosphere samples and up to 24 x 11 cloud
// densities (32 shared-memory reads and ~250 operations each); the
// blocks below the horizon left after the atmosphere; and a lane whose
// sample held cloud ran its 10-step sun march while the other 31 waited.
//
// Design: a warp per texel (each warp takes every (number of warps)-th
// texel in row-major order, so it gets rows below and above the horizon
// alike), the 16 KB noise tile in shared memory once per block (K6), and
// one texel's independent samples spread over the lanes; only the sums
// stay serial, replayed in the plain version's order, because f32
// addition is not associative and the result is held bit for bit:
// * atmosphere: lane l takes primary step l / 2 and four of its eight
//   light samples; the light sum passes from the even lane to the odd
//   one in order; the optical-depth prefix over the 16 steps runs by
//   shuffles; the six (channel, Rayleigh | Mie) totals are each summed
//   by one lane over the steps' products parked in shared memory;
// * clouds, for rays above the horizon: lanes 0-23 take the 24 primary
//   densities; a ballot finds the samples that hold cloud (a sample
//   with zero optical depth adds nothing, so its sun march, 80 of its
//   88 noise evaluations, is skipped as the plain version's `where`
//   discards it); the (hit sample, sun step) pairs are dealt over the
//   32 lanes and their densities parked in shared memory; each hit lane
//   sums its own ten in order and forms its scatter term; the scatter
//   and transmittance recurrence walks the hit samples in order by
//   shuffles.
// Bound: operations (the same count as before: this run's data decides
// how many sun marches there are).  K6's noise reads hit shared memory;
// K6p's density is 32 hashes, each a sinf whose argument passes sinf's
// fast range (|x| > 105615) on the top octave's far samples, where it
// takes the slow reduction: that is the function PyTorch's sin calls,
// and the hash turns any other rounding into a different value.
//
// Rounding: written in the plain version's operation order, built with
// --fmad=false, with the same CUDA math functions PyTorch's kernels call
// (expf, sqrtf, powf, sinf, cosf, fmodf); constants that the plain
// version forms in double (Python floats) are formed in double here and
// rounded once; a division of a tensor by a Python scalar is PyTorch's
// multiply by the f32 reciprocal on the card (`x * (1.0f / s)` below).
// The rays graze the cloud shells, where `_rsi` subtracts ~4e13-sized
// squares (ROADMAP fault C6): that is why the order matters.
#include "common.cuh"

namespace {

constexpr int kN = 64;
constexpr double kPiD = 3.14159265358979323846;
constexpr double kEarthD = 6371000.0;
constexpr double kCloudMinD = 1600.0;
constexpr double kCloudMaxD = 2100.0;
constexpr double kLn2D = 0.69314718055994530942;

constexpr float kPi = (float)kPiD;
constexpr float kHalfPi = (float)(kPiD / 2.0);
constexpr float kEarth = (float)kEarthD;
constexpr float kCloudMin = (float)kCloudMinD;
constexpr float kCloudMax = (float)kCloudMaxD;
constexpr float kShellMin2 = (float)((kEarthD + kCloudMinD)
                                     * (kEarthD + kCloudMinD));
constexpr float kShellMax2 = (float)((kEarthD + kCloudMaxD)
                                     * (kEarthD + kCloudMaxD));
constexpr float kRPlanet = (float)6371e3;
constexpr float kRAtmos2 = (float)(6471e3 * 6471e3);
constexpr float kRPlanet2 = (float)(6371e3 * 6371e3);

// atmosphere (clouds._atmosphere defaults)
constexpr double kGMieD = 0.758;
constexpr double kGGD = kGMieD * kGMieD;
constexpr float kKMie = (float)21e-6;
constexpr float kPRlh = (float)(3.0 / (16.0 * kPiD));
constexpr float kPMie = (float)(3.0 / (8.0 * kPiD));
constexpr float kOneMinusGG = (float)(1.0 - kGGD);
constexpr float kOnePlusGG = (float)(1.0 + kGGD);
constexpr float kTwoPlusGG = (float)(2.0 + kGGD);

// clouds: _hg(x, g) = 0.25 (1 - g^2) (1 + g^2 - 2 g x)^-1.5 for the two
// lobes of _phase_two_lobes, g = 0.8 * gm and -0.5 * gm (gm = 0.8)
constexpr double kHgG1 = 0.8 * 0.8;
constexpr double kHgG2 = -0.5 * 0.8;
constexpr float kHg1A = (float)(0.25 * (1.0 - kHgG1 * kHgG1));
constexpr float kHg1B = (float)(1.0 + kHgG1 * kHgG1);
constexpr float kHg1C = (float)(2.0 * kHgG1);
constexpr float kHg2A = (float)(0.25 * (1.0 - kHgG2 * kHgG2));
constexpr float kHg2B = (float)(1.0 + kHgG2 * kHgG2);
constexpr float kHg2C = (float)(2.0 * kHgG2);
constexpr float kScatA = (float)(-1.11 * (1.0 / kLn2D));
constexpr float kScatB = (float)(-1.0 / 1.11);
constexpr float kScatC = (float)(1.0 / 1.11);
constexpr float kLn2 = (float)kLn2D;
constexpr float kSunBright = 3.0f;
constexpr float kZStretch = (float)(17.0 * (1.0 / 64.0));
constexpr float kInvRes = (float)(1.0 / 64.0);

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                     float by, float bz) {
    return ax * bx + ay * by + az * bz;
}

// clouds._rsi: (near, far), -1 on a miss; r2 the squared radius
__device__ __forceinline__ void rsi(float px, float py, float pz, float dx,
                                    float dy, float dz, float r2,
                                    float* near_, float* far_) {
    const float pod = dot3(px, py, pz, dx, dy, dz);
    const float delta = pod * pod + r2 - dot3(px, py, pz, px, py, pz);
    const bool ok = delta >= 0.0f;
    const float sq = sqrtf(fmaxf(delta, 0.0f));
    *near_ = ok ? -pod - sq : -1.0f;
    *far_ = ok ? -pod + sq : -1.0f;
}

__device__ __forceinline__ float hg(float x, float a, float b, float c) {
    return a * powf(b - c * x, -1.5f);
}

// clouds._sample_repeat on the shared-memory tile
__device__ __forceinline__ float sample_repeat(const float* tex, float u,
                                               float v) {
    const float x = u * (float)kN - 0.5f;
    const float y = v * (float)kN - 0.5f;
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float fx = x - x0;
    const float fy = y - y0;
    const int x0i = (int)x0 & (kN - 1);
    const int x1i = (x0i + 1) & (kN - 1);
    const int y0i = (int)y0 & (kN - 1);
    const int y1i = (y0i + 1) & (kN - 1);
    const float c00 = tex[y0i * kN + x0i];
    const float c10 = tex[y0i * kN + x1i];
    const float c01 = tex[y1i * kN + x0i];
    const float c11 = tex[y1i * kN + x1i];
    return (c00 * (1.0f - fx) + c10 * fx) * (1.0f - fy)
           + (c01 * (1.0f - fx) + c11 * fx) * fy;
}

// clouds._hash2: sin(x * 12.9898 + y * 78.233) * 43758.5453 modulo 1
// (sampling.mod: the truncated remainder, plus 1 where it is negative)
constexpr float kHashX = (float)12.9898;
constexpr float kHashY = (float)78.233;
constexpr float kHashScale = (float)43758.5453;

__device__ __forceinline__ float hash2(float x, float y) {
    const float r = fmodf(sinf(x * kHashX + y * kHashY) * kHashScale, 1.0f);
    return r < 0.0f ? r + 1.0f : r;
}

// clouds._value_noise2: smoothstep-weighted bilinear value noise over the
// integer lattice
__device__ __forceinline__ float value_noise2(float u, float v) {
    const float iu = floorf(u);
    const float iv = floorf(v);
    float fu = u - iu;
    float fv = v - iv;
    fu = fu * fu * (3.0f - 2.0f * fu);
    fv = fv * fv * (3.0f - 2.0f * fv);
    const float a = hash2(iu, iv);
    const float b = hash2(iu + 1.0f, iv);
    const float c = hash2(iu, iv + 1.0f);
    const float d = hash2(iu + 1.0f, iv + 1.0f);
    return (a + (b - a) * fu) * (1.0f - fv) + (c + (d - c) * fu) * fv;
}

// clouds._get_3d_noise: two z slices of the tiled texture (K6) or of the
// value noise at the same lattice coordinates times 64 (K6p)
template <bool kProcedural>
__device__ __forceinline__ float noise3(const float* tex, float x, float y,
                                        float z) {
    const float p = floorf(z);
    const float f = z - p;
    const float cu = x * kInvRes + p * kZStretch;
    const float cv = y * kInvRes + p * kZStretch;
    float n0, n1;
    if constexpr (kProcedural) {
        n0 = value_noise2(cu * 64.0f, cv * 64.0f);
        n1 = value_noise2((cu + kZStretch) * 64.0f,
                          (cv + kZStretch) * 64.0f);
    } else {
        n0 = sample_repeat(tex, cu, cv);
        n1 = sample_repeat(tex, cu + kZStretch, cv + kZStretch);
    }
    return n0 + (n1 - n0) * f;
}

// clouds._get_clouds: density at a ray-relative position
template <bool kProcedural>
__device__ float get_clouds(const float* tex, float px, float py, float pz,
                            float cam_x, float cam_z, float drift) {
    const float qy = py + kEarth;
    const float h = sqrtf(px * px + qy * qy + pz * pz) - kEarth;
    const float wx = px + cam_x;
    const float wz = pz + cam_z;
    const bool inside = h >= kCloudMin && h <= kCloudMax;
    const float cx = wx * 0.001f + drift;
    const float cy = h * 0.001f + 0.0f;
    const float cz = wz * 0.001f + drift;
    float n = noise3<kProcedural>(tex, cx, cy, cz) * 0.5f;
    n = n + noise3<kProcedural>(tex, cx * 2.0f + drift, cy * 2.0f + 0.0f,
                                cz * 2.0f + drift) * 0.25f;
    n = n + noise3<kProcedural>(tex, cx * 7.0f - drift, cy * 7.0f - 0.0f,
                                cz * 7.0f - drift) * 0.125f;
    n = n + noise3<kProcedural>(tex, (cx + drift) * 16.0f,
                                (cy + 0.0f) * 16.0f,
                                (cz + drift) * 16.0f) * 0.0625f;
    const float hh = h - kCloudMin;
    const float thresh = (1.0f - expf(-0.01f * hh)) * expf(-0.004f * hh);
    const float t = fminf(fmaxf((n - 0.55f) * (1.0f / 0.05f), 0.0f), 1.0f);
    const float clouds = (t * t * (3.0f - 2.0f * t)) * thresh;
    return inside ? clouds * 0.03f : 0.0f;
}

constexpr int kWarps = 8;              // warps (texels in flight) a block
constexpr int kTexelsPerWarp = 2;      // the grid is sized for this many
constexpr int kISteps = 16, kJSteps = 8;
constexpr int kSteps = 24, kSunSteps = 10;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kISteps * 2 == 32 && kJSteps == 8,
              "atmosphere: two lanes a primary step, four samples a lane");
static_assert(kSteps <= 32, "clouds: a lane a primary sample");

// kProcedural: K6p (the value noise, `noise` unread) or K6 (the texture)
template <bool kProcedural>
__global__ void __launch_bounds__(kWarps * 32)
sky_lut_kernel(const float* __restrict__ params,
               const float* __restrict__ noise, float* __restrict__ out,
               int lut_w, int lut_h) {
    __shared__ float tex[kProcedural ? 1 : kN * kN];
    // per warp: the sun-march densities [sample][sun step]; before them
    // the atmosphere's products [step][channel, Rayleigh | Mie]
    __shared__ float scratch[kWarps][kSteps * kSunSteps];
    static_assert(kISteps * 6 <= kSteps * kSunSteps, "scratch is shared");
    if constexpr (!kProcedural) {
        for (int i = threadIdx.x; i < kN * kN; i += kWarps * 32)
            tex[i] = noise[i];
        __syncthreads();
    }
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float* park = scratch[warp];

    params += blockIdx.y * 16;
    out += (size_t)blockIdx.y * 3 * lut_w * lut_h;
    const float sx = params[0], sy = params[1], sz = params[2];
    const float ox = params[3], oy = params[4], oz = params[5];
    const float cam_x = params[6], cam_z = params[7];
    const float elapsed = params[8], drift = params[9];
    const float skl[3] = {params[10], params[11], params[12]};
    const float k_rlh[3] = {(float)5.5e-6, (float)13.0e-6, (float)22.4e-6};
    const size_t plane = (size_t)lut_w * lut_h;
    const int n_texels = lut_w * lut_h;

    for (int texel = blockIdx.x * kWarps + warp; texel < n_texels;
         texel += gridDim.x * kWarps) {
        const int ix = texel % lut_w;
        const int iy = texel / lut_w;

        // ---- the lat-long ray (render_sky_lut), the same in every lane
        const float az = ((float)ix + 0.5f) * (1.0f / (float)lut_w) * 2.0f
                         * kPi - kPi;
        const float el = ((float)iy + 0.5f) * (1.0f / (float)lut_h) * kPi
                         - kHalfPi;
        const float ce = cosf(el);
        const float dx = ce * cosf(az);
        const float dy = sinf(el);
        const float dz = ce * sinf(az);

        // ---- atmosphere (clouds._atmosphere, 16 x 8)
        const float nrm = fmaxf(sqrtf(dot3(dx, dy, dz, dx, dy, dz)), 1e-12f);
        const float rx = dx / nrm, ry = dy / nrm, rz = dz / nrm;
        float p_near, p_far, g_near, unused;
        rsi(ox, oy, oz, rx, ry, rz, kRAtmos2, &p_near, &p_far);
        const bool miss = p_near > p_far;
        rsi(ox, oy, oz, rx, ry, rz, kRPlanet2, &g_near, &unused);
        p_far = fminf(p_far, g_near);
        const float i_step = (p_far - p_near) * (1.0f / 16.0f);
        const float mu = dot3(rx, ry, rz, sx, sy, sz);
        const float mumu = mu * mu;
        const float p_rlh = kPRlh * (1.0f + mumu);
        const float p_mie =
            (kPMie * (kOneMinusGG * (mumu + 1.0f)))
            / (powf(kOnePlusGG - 2.0f * mu * (float)kGMieD, 1.5f)
               * kTwoPlusGG);

        // this lane's primary step and its start time: elapsed (the :368
        // iTime quirk) plus `step` additions of i_step, one by one
        const int step = lane / 2;
        float i_time = elapsed;
        for (int k = 0; k < kISteps - 1; ++k)
            i_time = k < step ? i_time + i_step : i_time;
        const float tmid = i_time + i_step * 0.5f;
        const float ipx = ox + rx * tmid;
        const float ipy = oy + ry * tmid;
        const float ipz = oz + rz * tmid;
        const float i_h = sqrtf(dot3(ipx, ipy, ipz, ipx, ipy, ipz)) - kRPlanet;
        const float od_r = expf(-i_h * (1.0f / 8000.0f)) * i_step;
        const float od_m = expf(-i_h * (1.0f / 1200.0f)) * i_step;
        float j_far;
        rsi(ipx, ipy, ipz, sx, sy, sz, kRAtmos2, &unused, &j_far);
        const float j_step = j_far * (1.0f / 8.0f);
        // four of the step's eight light samples: 0-3 on the even lane,
        // 4-7 on the odd one
        float e_r[4], e_m[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int jj = (lane & 1) * 4 + k;
            const float tt = j_step * (float)jj + j_step * 0.5f;
            const float jpx = ipx + sx * tt;
            const float jpy = ipy + sy * tt;
            const float jpz = ipz + sz * tt;
            const float j_h = sqrtf(dot3(jpx, jpy, jpz, jpx, jpy, jpz))
                              - kRPlanet;
            e_r[k] = expf(-j_h * (1.0f / 8000.0f)) * j_step;
            e_m[k] = expf(-j_h * (1.0f / 1200.0f)) * j_step;
        }
        // the light sum over j = 0..7 in order: the even lane's partial
        // sum goes on in the odd lane, which hands the whole sum back
        float jod_r = 0.0f, jod_m = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            jod_r = jod_r + e_r[k];
            jod_m = jod_m + e_m[k];
        }
        const float half_r = __shfl_sync(kFull, jod_r, lane & ~1);
        const float half_m = __shfl_sync(kFull, jod_m, lane & ~1);
        if (lane & 1) {
            jod_r = half_r;
            jod_m = half_m;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                jod_r = jod_r + e_r[k];
                jod_m = jod_m + e_m[k];
            }
        }
        jod_r = __shfl_sync(kFull, jod_r, lane | 1);
        jod_m = __shfl_sync(kFull, jod_m, lane | 1);
        // the primary optical depth up to and including this lane's step
        float iod_r = 0.0f, iod_m = 0.0f, run_r = 0.0f, run_m = 0.0f;
        for (int k = 0; k < kISteps; ++k) {
            run_r = run_r + __shfl_sync(kFull, od_r, 2 * k);
            run_m = run_m + __shfl_sync(kFull, od_m, 2 * k);
            if (k == step) {
                iod_r = run_r;
                iod_m = run_m;
            }
        }
        // the step's six products; then lanes 0-5 each sum one of them
        // over the steps in order
        if ((lane & 1) == 0) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float attn = expf(-(kKMie * (iod_m + jod_m)
                                          + k_rlh[c] * (iod_r + jod_r)));
                park[step * 6 + c] = od_r * attn;
                park[step * 6 + 3 + c] = od_m * attn;
            }
        }
        __syncwarp();
        float tot = 0.0f;
        if (lane < 6) {
            for (int k = 0; k < kISteps; ++k) tot = tot + park[k * 6 + lane];
        }
        __syncwarp();   // the products are read: the scratch is free
        float atmos[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float tot_r = __shfl_sync(kFull, tot, c);
            const float tot_m = __shfl_sync(kFull, tot, 3 + c);
            const float a = 22.0f * (p_rlh * k_rlh[c] * tot_r
                                     + p_mie * kKMie * tot_m);
            atmos[c] = miss ? 0.0f : a;
        }

        const size_t o = (size_t)iy * lut_w + ix;
        if (dy < 0.0f) {        // below the horizon: the atmosphere
#pragma unroll
            for (int c = 0; c < 3; ++c)
                if (lane == c) out[c * plane + o] = atmos[c];
            continue;
        }

        // ---- volumetric clouds (clouds._volumetric_clouds, dither 0.5)
        float bottom, top;
        rsi(0.0f, kEarth, 0.0f, dx, dy, dz, kShellMin2, &unused, &bottom);
        rsi(0.0f, kEarth, 0.0f, dx, dy, dz, kShellMax2, &unused, &top);
        const float stx = dx * bottom, sty = dy * bottom, stz = dz * bottom;
        const float incx = (dx * top - stx) * (1.0f / 24.0f);
        const float incy = (dy * top - sty) * (1.0f / 24.0f);
        const float incz = (dz * top - stz) * (1.0f / 24.0f);
        const float px0 = stx + incx * 0.5f;
        const float py0 = sty + incy * 0.5f;
        const float pz0 = stz + incz * 0.5f;
        const float step_len = sqrtf(dot3(incx, incy, incz, incx, incy,
                                          incz));
        const float ldotw = dot3(dx, dy, dz, sx, sy, sz);
        const float lobe1 = hg(ldotw, kHg1A, kHg1B, kHg1C);
        const float lobe2 = hg(ldotw, kHg2A, kHg2B, kHg2C);
        const float phase = lobe2 + (lobe1 - lobe2) * 0.5f;
        const float six = sx * 50.0f, siy = sy * 50.0f, siz = sz * 50.0f;

        // the 24 primary samples, one a lane
        float od = 0.0f;
        if (lane < kSteps) {
            const float fi = (float)lane;
            od = get_clouds<kProcedural>(tex, px0 + incx * fi,
                                         py0 + incy * fi, pz0 + incz * fi,
                                         cam_x, cam_z, drift)
                 * step_len;
        }
        const unsigned hits = __ballot_sync(kFull, od > 0.0f);
        // the sun marches of the samples that hold cloud, a (sample, sun
        // step) pair a lane
        const int n_pairs = __popc(hits) * kSunSteps;
        for (int p = lane; p < n_pairs; p += 32) {
            unsigned m = hits;
            for (int k = p / kSunSteps; k > 0; --k) m &= m - 1;
            const int i = __ffs(m) - 1;
            const int j = p % kSunSteps;
            const float fi = (float)i, fj = (float)j;
            const float cpx = px0 + incx * fi;
            const float cpy = py0 + incy * fi;
            const float cpz = pz0 + incz * fi;
            const float qx0 = cpx + six * 0.5f;
            const float qy0 = cpy + siy * 0.5f;
            const float qz0 = cpz + siz * 0.5f;
            park[i * kSunSteps + j] =
                get_clouds<kProcedural>(tex, qx0 + six * fj, qy0 + siy * fj,
                                        qz0 + siz * fj, cam_x, cam_z, drift);
        }
        __syncwarp();
        // each hit sample's scatter term and transmittance factor
        float scat[3] = {0.0f, 0.0f, 0.0f};
        float decay = 1.0f;
        if (od > 0.0f) {
            float strans = 0.0f;
            for (int j = 0; j < kSunSteps; ++j)
                strans = strans + park[lane * kSunSteps + j];
            const float sunv = expf(-strans * 50.0f);
            const float integral = expf(kScatA * od) * kScatB + kScatC;
            const float beers = 1.0f - expf(-(od * kLn2) * 2.0f);
            const float x = sunv * beers * phase;
            const float ipi = integral * kPi;
            const float sunlight = 0.8f * x * (float)(0.5 * kPiD) * kSunBright;
#pragma unroll
            for (int c = 0; c < 3; ++c) scat[c] = (sunlight + skl[c]) * ipi;
            decay = expf(-od);
        }
        __syncwarp();   // the densities are read: the scratch is free
        // the recurrence over the hit samples, near to far
        float sc[3] = {0.0f, 0.0f, 0.0f};
        float trans = 1.0f;
        for (unsigned m = hits; m; m &= m - 1) {
            const int i = __ffs(m) - 1;
#pragma unroll
            for (int c = 0; c < 3; ++c)
                sc[c] = sc[c] + __shfl_sync(kFull, scat[c], i) * trans;
            trans = trans * __shfl_sync(kFull, decay, i);
        }
        const float fade =
            fminf(fmaxf(sqrtf(dot3(stx, sty, stz, stx, sty, stz)) * 0.00001f
                        * 2.5f, 0.0f), 1.0f);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float mixed = atmos[c] * trans + sc[c];
            const float v = mixed + (atmos[c] - mixed) * fade;
            if (lane == c) out[c * plane + o] = v;
        }
    }
}

template <bool kProcedural>
int launch(const void* params, const void* noise, void* out, int lut_w,
           int lut_h, int views, void* stream) {
    if (lut_w <= 0 || lut_h <= 0 || views > 65535)
        return (int)cudaErrorInvalidValue;
    if (views <= 0) return 0;
    const long long texels = (long long)lut_w * lut_h;
    if (texels > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const long long per_block = kWarps * kTexelsPerWarp;
    const int grid = (int)((texels + per_block - 1) / per_block);
    sky_lut_kernel<kProcedural><<<dim3(grid, views), kWarps * 32, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)params, (const float*)noise, (float*)out, lut_w,
        lut_h);
    return (int)cudaGetLastError();
}

}  // namespace

SOC_EXPORT int sky_lut_launch(const void* params, const void* noise,
                              void* out, int lut_w, int lut_h, int views,
                              void* stream) {
    return launch<false>(params, noise, out, lut_w, lut_h, views, stream);
}

SOC_EXPORT int sky_lut_procedural_launch(const void* params, void* out,
                                         int lut_w, int lut_h, int views,
                                         void* stream) {
    return launch<true>(params, nullptr, out, lut_w, lut_h, views, stream);
}
