// The AD sphere backward (K5) for Hopper: gradients of a sphere scene's
// render without recorded winners.
//
// Replaces raytpu/kernels/trace_spheres.py:_bwd_kernel (the Pallas TPU
// kernel launched by _bwd_call from _mk_bwd under RAYTPU_SPH_BWD=ad):
// jax.vjp of _forward_body inside the kernel, which runs the sphere search
// and the AO probes again instead of replaying the indices K1 recorded.
// The plain PyTorch version is raytpu_torch/kernels/trace_spheres.py:
// ad_reference, torch.autograd.grad through trace_spheres_reference.
//
// What it computes: per ray, the forward bounce loop with K1's search and
// AO probes (csrc/sphere_search.cuh, which K1 runs too, so the winners and
// AO factors are the ones K1's recording mode writes), keeping each bounce's
// winner, AO factor and carry in local memory (bounces <= 48), then the
// reverse sweep, bounce N-1 down to 0, with K2's hand-derived reverse step
// (csrc/replay.cuh, sphere mode, with the sky slot's cotangent under
// kSky): the cotangent of the 9 (12 with the sky's scale) planes goes to
// the 14 x S sphere table and to the ray origin and direction. The draws,
// hashed from each ray's threefry key where they are read as in K1 and
// K2 (csrc/threefry.cuh), get none: each use of a draw ends in a winner
// selection or a comparison.
// So K5 and K2 share the reverse step and differ in where the winners come
// from: K5 against K2 on K1's recording checks the search and record step,
// and K5 against its plain version (autograd) checks the reverse step.
//
// What bounds it on this card: per live ray-bounce K1's search and
// shading (~140 FP32 operations on the Cornell scene's 10 spheres) plus
// K2's replay, reverse replay and adjoint (~510), and the draws hashed
// twice (the forward pass and the reverse step), against 8 bytes of key and
// 36-48 bytes of cotangent per ray, so FP32 and INT32 operations bound it
// (chip_smoke.py's k5 bound). What holds it above that is K2's: ~120
// registers and the saved carries in local memory leave few warps on an SM
// to hide each thread's dependent chain. The design:
//   * one thread per ray; the sphere table in shared memory, read as
//     broadcasts (cx cy cz r as one float4 a sphere for the search);
//   * the search, the AO probes and the forward replay in one pass over
//     the bounces, up to the ray's first bounce out of its loop, writing
//     nothing to device memory until the ray cotangents;
//   * d_sph summed deterministically as in K2's sphere mode (replay.cuh:
//     warp_table_sum, block_table_sum, sum_blocks_kernel). Two launches on
//     the same inputs give the same bits; with K2's block size and the
//     same winners they give K2's bits.
//
// F4: gradients to 48 bounces (kMaxBounces), raised past that by the
// wrapper. F3: no serialisation fence; a NaN in one bounce's cotangent
// reaches only the bounces it flows through.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (raytpu_torch/kernels/_build.py);
// no fast-math flags.

#include "replay.cuh"          // K2's replay and reverse bounce
#include "sphere_search.cuh"   // K1's search and AO probes

namespace {

// The AO probes' knobs K2's Knobs does not carry.
struct AoKnobs {
  int samples;
  float inv;   // 1 / (ao_samples * ao_intensity)
};

// K1's AO factor at bounce winner bidx (distance best) of carry c, with
// K1's hit point and outward normal and the bounce's draws.
__device__ float ao_factor(const float4* geo, int ns, const Carry& c,
                           int bidx, float best, const KeyDraws& draws,
                           float eps, const AoKnobs& ao) {
  const float px = c.o[0] + c.d[0] * best;
  const float py = c.o[1] + c.d[1] * best;
  const float pz = c.o[2] + c.d[2] * best;
  const float4 w = geo[bidx];
  const float nvx = px - w.x, nvy = py - w.y, nvz = pz - w.z;
  const float n2 = nvx * nvx + nvy * nvy + nvz * nvz;
  const float inv_len = n2 > 0.0f ? 1.0f / sqrtf(fmaxf(n2, 1e-38f)) : 0.0f;
  return sphere_ao(geo, ns, px, py, pz, nvx * inv_len, nvy * inv_len,
                   nvz * inv_len, draws, ao.samples, eps, ao.inv);
}

// The search-and-reverse sweep, one thread per ray (kSphereThreads a
// block, as K2's sphere mode); kSky: the sky slot's cotangent (a separate
// instantiation, as in K2). Every thread runs the reverse loop over all
// bounces, so that each warp sums its table cotangents together.
template <bool kSky>
__global__ void __launch_bounds__(kSphereThreads, kSphereMinBlocks)
spheres_ad_kernel(
    const float* __restrict__ sph, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const uint32_t* __restrict__ keys,
    const float* __restrict__ gin, float* __restrict__ d_rays,
    float* __restrict__ partial, int n_rays, Knobs k, AoKnobs ao) {
  extern __shared__ float smem[];
  const int ns = k.n_spheres, nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const SphereSmem sm = sphere_smem(smem, ns, nt);
  load_geo(sm.geo, sph, ns, tid, nt);
  for (int e = tid; e < kRows * ns; e += nt) sm.tab[e] = sph[e];
  for (int e = tid; e < (nt >> 5) * kRows * ns; e += nt) sm.wsum[e] = 0.0f;
  __syncthreads();
  float* wsum = sm.wsum + warp * kRows * ns;
  float* stage = sm.stage + warp * kRows * kStagePitch;

  const int ray = blockIdx.x * nt + tid;
  const size_t B = (size_t)n_rays;
  uint32_t k0 = 0u, k1 = 0u;
  Carry saved[kMaxBounces];
  int win[kMaxBounces];
  float aofs[kMaxBounces];
  Carry c;
  int last = 0;   // the bounces of the ray's loop, as K2 replays them
  if (ray < n_rays) {
    load_key(keys, B, ray, k0, k1);
    init_carry(c, ray, ox, oy, oz, dx, dy, dz);
    for (int i = 0; i < k.bounces && c.active; ++i) {
      saved[i] = c;
      // K1's recording of a ray in its loop: the winner, and the AO factor
      // where the bounce can accumulate (K2 reads it only there)
      float best;
      const int bidx = closest_sphere(sm.geo, ns, c.o[0], c.o[1], c.o[2],
                                      c.d[0], c.d[1], c.d[2], k.sphere_eps,
                                      best);
      const KeyDraws draws = key_draws(k0, k1, i, k.n_draws);
      const float aof = (k.use_ao && bidx >= 0)
          ? ao_factor(sm.geo, ns, c, bidx, best, draws, k.sphere_eps, ao)
          : 1.0f;
      win[i] = bidx;
      aofs[i] = aof;
      replay_bounce<false, kSky>(i, c, bidx, sm.tab, nullptr, nullptr,
                                 nullptr, draws, aof, k, nullptr, nullptr,
                                 nullptr);
      last = i + 1;
    }
  }

  Cot g;
  if (ray < n_rays) init_cot<kSky>(g, ray, B, gin);
  float gw[kRows];
  TriCot gt;
  for (int i = k.bounces - 1; i >= 0; --i) {
    const int bidx = i < last ? win[i] : -1;
    if (i < last) {
      c = saved[i];
      replay_bounce<false, kSky>(i, c, bidx, sm.tab, nullptr, nullptr,
                                 nullptr, key_draws(k0, k1, i, k.n_draws),
                                 aofs[i], k, &g, gw, &gt);
    }
    warp_table_sum(wsum, stage, lane, i < last && is_hit(bidx, ns), bidx, gw);
  }
  if (ray < n_rays) {
    for (int j = 0; j < 3; ++j) {
      d_rays[j * B + ray] = g.o[j];
      d_rays[(3 + j) * B + ray] = g.d[j];
    }
  }
  __syncthreads();
  block_table_sum(sm.wsum, ns, nt, tid,
                  partial + (size_t)blockIdx.x * kRows * ns);
}

}  // namespace

// Blocks of the sweep for n_rays rays: the first dimension of the
// (blocks, 14 * n_spheres) `partial` buffer the caller allocates.
extern "C" int raytpu_spheres_ad_blocks(int n_rays, int n_spheres) {
  (void)n_spheres;
  return (n_rays + kSphereThreads - 1) / kSphereThreads;
}

// Plain C entry point, bound with ctypes. Device pointers: sph (14, S) f32;
// ox..dz (n_rays,) f32; keys (2, n_rays) uint32, the rays' threefry keys
// (draw 4 + b * n_draws + j is draw j of bounce b); g
// (9, n_rays) f32, the cotangent of (radiance, albedo, normal), or
// (12, n_rays) with the sky slot's scale when sky_idx >= 0 (the sky
// sphere; -1: no sky); d_rays (6, n_rays) f32 out; partial
// (raytpu_spheres_ad_blocks(n_rays, S), 14 * S) f32 scratch; d_sph (14, S)
// f32 out. Launches its two kernels on `stream` without synchronising and
// returns the first cudaError_t.
extern "C" int raytpu_spheres_ad(
    const float* sph, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const uint32_t* keys,
    const float* g, float* d_rays, float* partial, int n_rays, int n_spheres,
    int bounces, int n_draws, float sphere_eps, float alpha_lo,
    float alpha_hi, float bright_boost, float bright_threshold, int use_ao,
    int ao_samples, float e_scale_mult, float ao_inv, int hsl_on,
    float hsl_l, float hsl_s, int sky_idx, float* d_sph, void* stream) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || sky_idx < -1 ||
      sky_idx >= n_spheres || n_rays < 0 || bounces < 0 ||
      bounces > kMaxBounces || ao_samples < 0 ||
      n_draws < 3 + (use_ao ? 2 * ao_samples : 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const Knobs k{n_spheres, 0, 0, 0, 1, 1, bounces, n_draws, sphere_eps,
                0.0f, 0.0f, alpha_lo, alpha_hi, bright_boost,
                bright_threshold, use_ao, e_scale_mult, hsl_on, hsl_l, hsl_s,
                sky_idx};
  const AoKnobs ao{use_ao ? ao_samples : 0, ao_inv};
  const int n_e = kRows * n_spheres;
  const int nt = kSphereThreads;
  const int blocks = raytpu_spheres_ad_blocks(n_rays, n_spheres);
  cudaError_t err = cudaSuccess;
  if (blocks > 0) {
    const size_t smem = sphere_shared_floats(n_spheres, nt) * sizeof(float);
    const auto kernel = sky_idx >= 0 ? spheres_ad_kernel<true>
                                     : spheres_ad_kernel<false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, nt, smem, s>>>(sph, ox, oy, oz, dx, dy, dz, keys, g,
                                    d_rays, partial, n_rays, k, ao);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_blocks_kernel<<<n_e, kReduceThreads, 0, s>>>(partial, blocks, n_e, n_e,
                                                   d_sph, nullptr);
  return (int)cudaGetLastError();
}
