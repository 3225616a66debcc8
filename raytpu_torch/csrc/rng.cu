// The per-sample RNG kernel: each ray's threefry key and the draw rows its
// route reads, in one launch per sample.
//
// No Pallas kernel corresponds: raytpu makes its draws with jax.random
// outside its kernels (core/rng.py: pixel_keys, sample_keys,
// ray_uniforms), and the port did so with eager int64 tensor code
// (raytpu_torch/core/rng.py, about 170 passes a sample; its plain version
// here). Per ray: key = fold_in(fold_in(base key, pixel_id), sample_id),
// then draws 0 .. n_rows-1 of that key (csrc/threefry.cuh). K1, K2, K3
// and K5 hash their bounce draws from the key themselves and take only
// the 4 camera rows; the scan path (K4 and the eager shading) reads all 4
// + max_bounces * n_bounce_draws rows, in ray_uniforms's layout.
//
// What bounds it: 8 B of pixel id in, 8 B of key and 4 B per row out per
// ray, against 2 hashes for the key and one per row (73-76 integer
// instructions each). At 1.08 M rays the 4 camera rows are ~0.01 ms of
// bytes and ~0.015 ms of instruction issue, the scan path's 22 rows ~0.03
// and ~0.06 ms (chip_smoke._rng_bound). One thread per ray, rows written
// as coalesced planes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (raytpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rng_sample_kernel(const long long* __restrict__ key,
                  const long long* __restrict__ pixel_ids, int n_rays,
                  uint32_t sample_id, int n_rows,
                  uint32_t* __restrict__ ray_keys,
                  float* __restrict__ draws) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const size_t B = (size_t)n_rays;
  uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  fold_in(k0, k1, (uint32_t)pixel_ids[ray]);   // the pixel's key
  fold_in(k0, k1, sample_id);                  // the (pixel, sample) key
  ray_keys[ray] = k0;
  ray_keys[B + ray] = k1;
  for (int c = 0; c < n_rows; ++c) {
    draws[(size_t)c * B + ray] = uniform_draw(k0, k1, (uint32_t)c);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Device pointers: key (2,) int64,
// the base key's two uint32 words (rng.prng_key); pixel_ids (n_rays,)
// int64 (their low 32 bits are folded in, as jax.random.fold_in takes
// uint32 data); ray_keys (2, n_rays) uint32 out; draws (n_rows, n_rays)
// f32 out (unused when n_rows is 0). Launches on `stream` without
// synchronising and returns the launch's cudaError_t.
extern "C" int raytpu_rng_sample(const long long* key,
                                 const long long* pixel_ids, int n_rays,
                                 unsigned sample_id, int n_rows,
                                 uint32_t* ray_keys, float* draws,
                                 void* stream) {
  if (n_rays < 0 || n_rows < 0 || (n_rows > 0 && draws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return (int)cudaSuccess;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  rng_sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      key, pixel_ids, n_rays, sample_id, n_rows, ray_keys, draws);
  return (int)cudaGetLastError();
}
