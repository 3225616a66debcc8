// The sphere megakernel (K1) for Hopper: the whole forward bounce loop of
// a sphere scene in one launch.
//
// Replaces raytpu/kernels/trace_spheres.py:_kernel (the Pallas TPU kernel
// launched by _trace_call, body _forward_body) with its recording mode
// (with_indices: per-bounce winner index and AO factor for the
// index-replay backward, csrc/trace_scene_bwd.cu) and its equirect-sky
// slot (sky_idx >= 0). The plain PyTorch version is
// raytpu_torch/kernels/trace_spheres.py:trace_spheres_reference; both keep
// raytpu's arithmetic forms (0.5/max(a,1e-20) root scale, the 1e-30
// discriminant floor, 1/sqrtf rather than rsqrtf, a strict t < best in
// sphere order, the n2s_safe select, the bright test on the throughput
// before its update) so the three implementations agree.
//
// What bounds it: per ray-bounce it solves about 10 quadratics (10 more
// per AO probe), does ~130 shading ops and hashes the bounce's draws from
// the ray's threefry key (csrc/threefry.cuh: 76 INT32 operations a draw,
// two a scattering bounce, one more where the material refracts, two per
// AO probe), against 68 bytes a ray (key 8 B, rays 24 B, 9 planes out;
// + 4 B of index a bounce when recording). At the 1200x900, 6-bounce
// frame its FP32 work sets its least time (~0.04 ms), above the hashing's
// issue time (~0.03 ms) and the bytes (~0.02 ms; chip_smoke._k1_bound).
// A (bounces * n_draws, B) buffer of the draws would be 72 B more a ray,
// and making it outside the kernel (eager int64 threefry, ~170 passes a
// sample) costs the frame far more than the kernel. The design:
//   * one thread per ray on a 1-D grid, the ragged edge masked here;
//   * the draws hashed in the kernel where the forward reads them (the
//     scatter's two only for a ray that scatters, the roulette only where
//     the material can refract), draw j of bounce b at counter
//     4 + b * n_draws + j with n_draws = integrator/path.n_bounce_draws;
//   * the sphere table in shared memory: cx cy cz r as one float4 a
//     sphere, so a sphere test is one 16-byte broadcast load, and the 10
//     material rows read once for the winner;
//   * the carried state (origin, direction, throughput, radiance, AOVs,
//     active/is_alpha flags, alpha depth, medium IOR) in registers;
//   * a ray whose loop is over (a miss or an emissive return: nothing it
//     carries can change after that) leaves the loop, writing -1 for the
//     bounces left when recording; in recording mode with AO it stays, as
//     the plain version records the AO factor of every ray;
//   * the refraction math only for rays that refract, the AO probes only
//     for rays that accumulate (their results are discarded elsewhere)
//     unless recording, which stores the factor of every ray;
//   * the equirect sky (kSky, a separate instantiation, so the sky-less
//     kernel keeps its registers): the 4096x2048 sky texture stays out of
//     the kernel. The sky sphere's emission is zeroed in the loop, and
//     each ray keeps one slot in registers, taken at its first sky event
//     (raytpu's take_e / take_a): the throughput scale (1 for an emissive
//     early return, else e_scale times the throughput before the bounce),
//     the unit hit direction (p - c) / r and the early flag. These 7
//     planes follow the 9, and raytpu_torch/kernels/trace_spheres.py:
//     compose_sky adds the texel outside, as raytpu does outside
//     pallas_call. One slot is exact because the sky sphere has black
//     diffuse (raytpu_torch/config.py enforces it): after its first sky
//     event a ray's throughput is 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (raytpu_torch/kernels/_build.py).
// No fast-math flags: IEEE sqrtf/division and accurate cosf/sinf. No FMA
// contraction: every product and sum rounds on its own, as in the plain
// version, so the recorded winners are the ones the plain version and the
// backward's replay (built the same way) compute.

#include <cuda_runtime.h>

#include "sphere_search.cuh"   // the search and AO probes, shared with K5
#include "threefry.cuh"        // the draws, hashed from the ray's key

namespace {

constexpr int kMaxSpheres = 64;
// the (14, S) table's rows: cx cy cz r | dif3 emi3 estr refl alpha ior
constexpr int kMatRows = 10;       // rows 4-13
constexpr int kThreads = 128;
constexpr float kTwoPi = 2.0f * 3.14159265358979323846f;  // 2 * f32(pi)

struct Knobs {
  int n_spheres, bounces, n_draws;
  float sphere_eps, alpha_lo, alpha_hi, bright_boost, bright_threshold;
  int use_ao, ao_samples;
  float ao_e_scale, ao_inv;
  int hsl_on;
  float hsl_l, hsl_s;
  int sky_idx;
};

__device__ __forceinline__ float safe_denom(float x) {
  return fabsf(x) > 1e-30f ? x : 1e-30f;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// raytpu/core/color.py:_hue_to_rgb
__device__ float hue_to_rgb(float t1, float t2, float hue) {
  hue = hue < 0.0f ? hue + 1.0f : hue;
  hue = hue > 1.0f ? hue - 1.0f : hue;
  const float r1 = t1 + (t2 - t1) * 6.0f * hue;
  const float r3 = t1 + (t2 - t1) * ((float)(2.0 / 3.0) - hue) * 6.0f;
  return 6.0f * hue < 1.0f ? r1
       : (2.0f * hue < 1.0f ? t2 : (3.0f * hue < 2.0f ? r3 : t1));
}

// raytpu/core/color.py:hsl_boost (rgb_to_hsl, scale L and S, hsl_to_rgb)
__device__ void hsl_boost(float& r, float& g, float& b, float l_f, float s_f) {
  const float cmax = fmaxf(r, fmaxf(g, b));
  const float cmin = fminf(r, fminf(g, b));
  float l = (cmax + cmin) * 0.5f;
  const float d = cmax - cmin;
  const bool gray = cmax == cmin;
  float s = gray ? 0.0f
          : (l < 0.5f ? d / safe_denom(cmax + cmin)
                      : d / safe_denom(2.0f - cmax - cmin));
  const float d_safe = safe_denom(d);
  const float h_r = (g - b) / d_safe + (g < b ? 6.0f : 0.0f);
  const float h_g = (b - r) / d_safe + 2.0f;
  const float h_b = (r - g) / d_safe + 4.0f;
  float h = cmax == r ? h_r : (cmax == g ? h_g : h_b);
  h = gray ? 0.0f : h / 6.0f;

  s = s * s_f;
  l = l * l_f;
  const float t2 = l < 0.5f ? l * (1.0f + s) : l + s - l * s;
  const float t1 = 2.0f * l - t2;
  const float third = (float)(1.0 / 3.0);
  if (s == 0.0f) {
    r = g = b = l;
  } else {
    r = hue_to_rgb(t1, t2, h + third);
    g = hue_to_rgb(t1, t2, h);
    b = hue_to_rgb(t1, t2, h - third);
  }
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float n2 = x * x + y * y + z * z;
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(fmaxf(n2, 1e-38f)) : 0.0f;
  x *= inv; y *= inv; z *= inv;
}

template <bool kSky>
__global__ void __launch_bounds__(kThreads)
trace_spheres_kernel(const float* __restrict__ sph,
                     const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const uint32_t* __restrict__ keys, float* __restrict__ out,
                     int* __restrict__ idx_out, float* __restrict__ aof_out,
                     int n_rays, Knobs k) {
  __shared__ float4 geo[kMaxSpheres];              // cx cy cz r
  __shared__ float mat[kMatRows * kMaxSpheres];    // row r: mat + r * ns
  const int ns = k.n_spheres;
  load_geo(geo, sph, ns, threadIdx.x, blockDim.x);
  for (int e = threadIdx.x; e < kMatRows * ns; e += blockDim.x) {
    mat[e] = sph[4 * ns + e];
  }
  __syncthreads();

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const size_t B = (size_t)n_rays;
  uint32_t k0, k1;
  load_key(keys, B, ray, k0, k1);

  float rox = ox[ray], roy = oy[ray], roz = oz[ray];
  float rdx = dx[ray], rdy = dy[ray], rdz = dz[ray];
  float rcx = 1.0f, rcy = 1.0f, rcz = 1.0f;      // throughput
  float ix = 0.0f, iy = 0.0f, iz = 0.0f;         // incoming radiance
  float ax = 0.0f, ay = 0.0f, az = 0.0f;         // albedo AOV
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;         // normal AOV
  bool active = true, is_alpha = false;
  int alpha_depth = 0;
  float medium_n2 = 1.0f;
  // the sky slot: scale, unit direction, early flag, taken flag
  float sklx = 0.0f, skly = 0.0f, sklz = 0.0f;
  float skdx = 0.0f, skdy = 0.0f, skdz = 0.0f;
  bool early = false, slot = false;
  // recording with AO stores every ray's factor, so no ray leaves early
  const bool may_leave = aof_out == nullptr || !k.use_ao;

  for (int i = 0; i < k.bounces; ++i) {
    // a ray out of its loop changes nothing more: leave, recording -1
    if (!active && may_leave) {
      if (idx_out != nullptr) {
        for (int j = i; j < k.bounces; ++j) idx_out[(size_t)j * B + ray] = -1;
      }
      break;
    }
    // ---- closest sphere: strict t < best in sphere order -------------
    float best;
    const int bidx = closest_sphere(geo, ns, rox, roy, roz, rdx, rdy, rdz,
                                    k.sphere_eps, best);

    // recording: the winner of every ray still in its bounce loop, -1 for
    // a miss and for rays whose loop is over (raytpu's with_indices)
    if (idx_out != nullptr) idx_out[(size_t)i * B + ray] = active ? bidx : -1;

    // ---- winner data; a miss reads an all-zero winner ------------------
    const bool did_hit = bidx >= 0;
    const int wi = did_hit ? bidx : 0;   // never index the table with -1
    const float4 gw = geo[wi];
    const float wcx = did_hit ? gw.x : 0.0f, wcy = did_hit ? gw.y : 0.0f;
    const float wcz = did_hit ? gw.z : 0.0f, wr = did_hit ? gw.w : 0.0f;
    float w[kMatRows];
#pragma unroll
    for (int r = 0; r < kMatRows; ++r) w[r] = did_hit ? mat[r * ns + wi] : 0.0f;
    const float dfx = w[0], dfy = w[1], dfz = w[2];
    float emx = w[3], emy = w[4], emz = w[5];
    const float estr = w[6], refl = w[7], alpha = w[8], ior = w[9];
    // the sky sphere's emission is its texel, added outside the kernel
    const bool sky_win = kSky && did_hit && bidx == k.sky_idx;
    if (sky_win) { emx = 0.0f; emy = 0.0f; emz = 0.0f; }
    const float safe_t = did_hit ? best : 0.0f;
    const float px = rox + rdx * safe_t;
    const float py = roy + rdy * safe_t;
    const float pz = roz + rdz * safe_t;

    // outward normal; zero on a miss
    const float nvx = px - wcx, nvy = py - wcy, nvz = pz - wcz;
    const float n2 = nvx * nvx + nvy * nvy + nvz * nvz;
    float inv_len = n2 > 0.0f ? 1.0f / sqrtf(fmaxf(n2, 1e-38f)) : 0.0f;
    inv_len = did_hit ? inv_len : 0.0f;
    const float nX = nvx * inv_len, nY = nvy * inv_len, nZ = nvz * inv_len;

    // ---- AOV base cases -------------------------------------------------
    if (i == 0) {
      ax = dfx; ay = dfy; az = dfz;
      nx = nX; ny = nY; nz = nZ;
    } else {
      const bool aov_alpha = active && i == alpha_depth && is_alpha;
      if (aov_alpha) {
        const bool em = estr > 0.0f;
        ax = em ? emx : dfx; ay = em ? emy : dfy; az = em ? emz : dfz;
        nx = nX; ny = nY; nz = nZ;
      }
      is_alpha = is_alpha && !aov_alpha;
    }

    // ---- emissive early return + HSL boost ------------------------------
    const bool emissive_ret = active && did_hit && i == alpha_depth && estr > 0.0f;
    if (emissive_ret) {
      float bx = emx, by = emy, bz = emz;
      if (k.hsl_on) hsl_boost(bx, by, bz, k.hsl_l, k.hsl_s);
      ix = bx; iy = by; iz = bz;
      ax = bx; ay = by; az = bz;
      nx = nX; ny = nY; nz = nZ;
    }
    active = active && !emissive_ret;
    const bool live = active && did_hit;

    // ---- the bounce's draws, hashed where read ---------------------------
    const KeyDraws draws = key_draws(k0, k1, i, k.n_draws);
    const float vdn = rdx * nX + rdy * nY + rdz * nZ;

    // ---- refraction (reduced pile.h medium stack) -----------------------
    const bool refr_case = live && alpha <= k.alpha_hi && alpha >= k.alpha_lo;
    const bool exiting = vdn > 0.0f;
    const bool do_refract = refr_case && draws(2) > alpha;   // the roulette
    float refx = 0.0f, refy = 0.0f, refz = 0.0f;
    if (do_refract) {
      const float nex = exiting ? -nX : nX;
      const float ney = exiting ? -nY : nY;
      const float nez = exiting ? -nZ : nZ;
      const float n1_ = exiting ? ior : medium_n2;
      const float n2_ = exiting ? medium_n2 : ior;
      const float n1s = n1_ * n1_;
      const float n2s = n2_ * n2_;
      const float n2s_safe = n2s > 1e-20f ? n2s : 1.0f;
      const float ratio = clampf(n1s / n2s_safe, 0.0f, 1e6f);
      const float ndotv = nex * rdx + ney * rdy + nez * rdz;
      const float radical = 1.0f - (ratio * ratio) * (1.0f - ndotv * ndotv);
      if (radical <= 0.0f) {
        // total internal reflection: mirror about the effective normal
        const float vdne = rdx * nex + rdy * ney + rdz * nez;
        refx = rdx - 2.0f * vdne * nex;
        refy = rdy - 2.0f * vdne * ney;
        refz = rdz - 2.0f * vdne * nez;
      } else {
        const float ct_scale = rdx * nex + rdy * ney + rdz * nez;
        const float sqr = sqrtf(fmaxf(radical, 1e-20f));
        refx = (rdx - nex * ct_scale) * ratio - nex * sqr;
        refy = (rdy - ney * ct_scale) * ratio - ney * sqr;
        refz = (rdz - nez * ct_scale) * ratio - nez * sqr;
      }
    }
    if (refr_case && !exiting) medium_n2 = ior;

    // ---- opaque / cutout --------------------------------------------------
    const bool cutout = live && alpha < k.alpha_lo;
    const bool opaque = live && alpha > k.alpha_hi;
    if (opaque) is_alpha = false;
    if (cutout) { is_alpha = true; alpha_depth += 1; }

    // ---- AO factor: for the rays that accumulate, and for every ray when
    // recording (the plain version records it on every lane) -------------
    const bool accum = live && !do_refract && !cutout;
    float factor = 0.0f;
    if (k.use_ao && (accum || aof_out != nullptr)) {
      factor = sphere_ao(geo, ns, px, py, pz, nX, nY, nZ, draws,
                         k.ao_samples, k.sphere_eps, k.ao_inv);
      if (aof_out != nullptr) aof_out[(size_t)i * B + ray] = factor;
    }

    // ---- the sky slot, at the ray's first sky event --------------------
    if (kSky && sky_win && !slot && (emissive_ret || accum)) {
      slot = true;
      early = emissive_ret;
      if (emissive_ret) {
        sklx = 1.0f; skly = 1.0f; sklz = 1.0f;
      } else {
        const float e_scale = k.use_ao ? estr * k.ao_e_scale : estr;
        sklx = e_scale * rcx; skly = e_scale * rcy; sklz = e_scale * rcz;
      }
      const float r_safe = wr > 0.0f ? wr : 1.0f;
      skdx = (px - wcx) / r_safe;
      skdy = (py - wcy) / r_safe;
      skdz = (pz - wcz) / r_safe;
    }

    // ---- accumulate (reads the throughput before its update) ------------
    if (accum) {
      const float e_scale = k.use_ao ? estr * k.ao_e_scale : estr;
      ix = ix + emx * e_scale * rcx;
      iy = iy + emy * e_scale * rcy;
      iz = iz + emz * e_scale * rcz;
      const float th = k.bright_threshold, bb = k.bright_boost;
      const bool bright = rcx > th || rcy > th || rcz > th;
      float nbx = bright ? dfx * (dfx * (rcx * bb)) : dfx * rcx;
      float nby = bright ? dfy * (dfy * (rcy * bb)) : dfy * rcy;
      float nbz = bright ? dfz * (dfz * (rcz * bb)) : dfz * rcz;
      if (k.use_ao) { nbx *= factor; nby *= factor; nbz *= factor; }
      rcx = nbx; rcy = nby; rcz = nbz;
    }

    // ---- next ray -------------------------------------------------------
    if (live) { rox = px; roy = py; roz = pz; }
    if (do_refract) {
      rdx = refx; rdy = refy; rdz = refz;
    } else if (accum) {
      // scatter: the diffuse direction about the normal, lerped towards
      // the mirror direction by the reflection
      const float theta = kTwoPi * draws(0);
      const float cph = clampf(2.0f * draws(1) - 1.0f, -1.0f, 1.0f);
      const float sph_ = sqrtf(fmaxf(1.0f - cph * cph, 0.0f));
      float ddx = nX + cosf(theta) * sph_;
      float ddy = nY + sinf(theta) * sph_;
      float ddz = nZ + cph;
      normalize3(ddx, ddy, ddz);
      const float rfx = rdx - 2.0f * vdn * nX;
      const float rfy = rdy - 2.0f * vdn * nY;
      const float rfz = rdz - 2.0f * vdn * nZ;
      rdx = ddx + (rfx - ddx) * refl;
      rdy = ddy + (rfy - ddy) * refl;
      rdz = ddz + (rfz - ddz) * refl;
    }
    active = active && did_hit;
  }

  out[0 * B + ray] = ix; out[1 * B + ray] = iy; out[2 * B + ray] = iz;
  out[3 * B + ray] = ax; out[4 * B + ray] = ay; out[5 * B + ray] = az;
  out[6 * B + ray] = nx; out[7 * B + ray] = ny; out[8 * B + ray] = nz;
  if (kSky) {
    out[9 * B + ray] = sklx; out[10 * B + ray] = skly; out[11 * B + ray] = sklz;
    out[12 * B + ray] = skdx; out[13 * B + ray] = skdy; out[14 * B + ray] = skdz;
    out[15 * B + ray] = early ? 1.0f : 0.0f;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. All pointers are device
// pointers: sph (14, n_spheres) f32; ox..dz (n_rays,) f32; keys
// (2, n_rays) uint32, each ray's threefry key (raytpu_torch/core/rng.py:
// sample_stream), whose draw 4 + b * n_draws + j is draw j of bounce b;
// out (9, n_rays) f32, or (16, n_rays)
// with the sky slot of sphere sky_idx (-1: no sky). Recording mode when
// idx_out is not null: idx_out (bounces, n_rays) i32 winner indices and,
// with use_ao, aof_out (bounces, n_rays) f32 AO factors (else null).
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t.
extern "C" int raytpu_trace_spheres(
    const float* sph, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const uint32_t* keys,
    float* out, int* idx_out, float* aof_out, int n_rays, int n_spheres, int bounces, int n_draws,
    float sphere_eps, float alpha_lo, float alpha_hi, float bright_boost,
    float bright_threshold, int use_ao, int ao_samples, float ao_e_scale,
    float ao_inv, int hsl_on, float hsl_l, float hsl_s, int sky_idx,
    void* stream) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || n_rays < 0 || bounces < 0 ||
      sky_idx < -1 || sky_idx >= n_spheres ||
      n_draws < 3 + (use_ao ? 2 * ao_samples : 0) ||
      (aof_out != nullptr && (idx_out == nullptr || !use_ao))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return (int)cudaSuccess;
  Knobs k{n_spheres, bounces, n_draws, sphere_eps, alpha_lo, alpha_hi,
          bright_boost, bright_threshold, use_ao, ao_samples, ao_e_scale,
          ao_inv, hsl_on, hsl_l, hsl_s, sky_idx};
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const auto kernel = sky_idx >= 0 ? trace_spheres_kernel<true>
                                   : trace_spheres_kernel<false>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sph, ox, oy, oz, dx, dy, dz, keys, out, idx_out, aof_out, n_rays, k);
  return (int)cudaGetLastError();
}
