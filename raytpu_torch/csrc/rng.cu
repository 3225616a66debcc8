// The per-sample RNG kernel, in two modes.
//
// The sample start (sample_start_kernel), what render runs first for every
// sample on every route: per ray its threefry key, its camera ray (origin
// and direction) from draws 0-3, and the draw rows its route reads, in
// one launch. The draws-only mode (rng_sample_kernel): the keys and draw
// rows 0 .. n_rows-1 (rng.sample_stream, for the JAX bit table and the
// tests; the main path does not call it).
//
// No Pallas kernel corresponds: raytpu makes its draws with jax.random
// outside its kernels (raytpu/core/rng.py: pixel_keys, sample_keys,
// ray_uniforms) and its camera rays with jnp
// (raytpu/integrator/render.py:46-60, sample_rays, camera.get_rays). The
// sample start takes the place of eager tensor code, ~57 elementwise
// kernels a sample for the camera rays after the keys and draws; its plain
// version is render.sample_start_reference (rng.stream_reference, then
// render.sample_rays). Per ray: key =
// fold_in(fold_in(base key, pixel_id), sample_id); draws 0-3 of that key
// (csrc/threefry.cuh); u = (i + (U0 - .5)) / (W - 1), v = (j + (U1 - .5))
// / (H - 1) with i, j the pixel's column and row, the aperture jitter
// (U2 - .5) * aperture_x, (U3 - .5) * aperture_y; the ray of
// camera.get_rays, its direction normalised as core/vec3.normalize does.
// K1, K2, K3 and K5 hash their bounce draws from the key themselves; the
// scan path (K4 and the eager shading) reads rows 4 .. 4 + max_bounces *
// n_bounce_draws - 1, in ray_uniforms's layout; with a camera leaf that
// requires grad, rows 0-3 are written too, for the camera's backward
// (render.camera_rays_vjp).
//
// The arithmetic is the plain version's, operation for operation, so that
// the planes are equal to the bit: built with -fmad=false; the divisions by
// W - 1 and H - 1 are IEEE divisions, as the plain version's by 0-dim
// device tensors; 1 / sqrt(max(n2, 1e-38)) an IEEE reciprocal of an IEEE
// square root, as torch's reciprocal of torch.sqrt; the camera's 12 values
// read from one device tensor packed once per render call, the scalars
// (W, H, apertures, focus distance) by value as f32, as torch converts a
// Python float operand.
//
// What bounds it: 8 B of pixel id in, 8 B of key, 24 B of ray and 4 B a
// written row out per ray, against 2 hashes for the key and one per draw
// (73-76 integer instructions each) and ~50 FP32 operations for the ray.
// At 1.08 M rays the megakernel routes' start is ~0.013 ms of bytes and
// ~0.015 ms of integer issue, the scan path's (18 bounce rows) ~0.03 and
// ~0.06 ms (chip_smoke._start_bound). One thread per ray, every output a
// coalesced plane, one allocation for all of them (the wrapper's).
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

// The pixel's column and row: Python's floor division and remainder of its
// id by the frame width, as torch's (width >= 1), in 32 bits where the id
// fits.
__device__ __forceinline__ void pixel_coords(long long pid, int width,
                                             long long& col, long long& row) {
  long long q = (pid >= 0 && pid <= 0x7fffffffLL)
                    ? (long long)((unsigned)pid / (unsigned)width)
                    : pid / width;
  long long r = pid - q * width;
  if (r < 0) {
    --q;
    r += width;
  }
  row = q;
  col = r;
}

// The sample start: planes of `out` (n_rays floats each): 0-1 the ray
// keys (uint32 bits), 2-4 the camera ray's origin, 5-7 its direction, then
// draw rows row0 .. n_rows-1 (row0 is 0 or 4).
__global__ void __launch_bounds__(kThreads)
sample_start_kernel(const long long* __restrict__ key,
                    const long long* __restrict__ pixel_ids,
                    const float* __restrict__ cam, int n_rays,
                    uint32_t sample_id, int width, float w1, float h1,
                    float ap_x, float ap_y, float focus, int row0,
                    int n_rows, float* __restrict__ out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const size_t B = (size_t)n_rays;
  const long long pid = pixel_ids[ray];
  uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  fold_in(k0, k1, (uint32_t)pid);          // the pixel's key
  fold_in(k0, k1, sample_id);              // the (pixel, sample) key
  uint32_t* words = reinterpret_cast<uint32_t*>(out);
  words[ray] = k0;
  words[B + ray] = k1;
  float d[kCamDraws];
#pragma unroll
  for (int c = 0; c < kCamDraws; ++c) d[c] = uniform_draw(k0, k1, (uint32_t)c);

  // render.sample_rays
  long long col, row;
  pixel_coords(pid, width, col, row);
  const float u = ((float)col + (d[0] - 0.5f)) / w1;
  const float v = ((float)row + (d[1] - 0.5f)) / h1;
  const float jit[3] = {(d[2] - 0.5f) * ap_x, (d[3] - 0.5f) * ap_y, 0.0f};
  // camera.get_rays: cam = origin, horizontal, vertical, lower_left
  float o[3], r[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float org = cam[a], hor = cam[3 + a], ver = cam[6 + a];
    const float dir = cam[9 + a] + (hor * u + (ver * v - org));
    const float dest = org + dir * focus;
    o[a] = org + jit[a];
    r[a] = dest - o[a];
  }
  // core/vec3.normalize: where(n2 > 0, 1 / sqrt(clamp(n2, 1e-38)), 0)
  const float n2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const float cl = n2 < 1e-38f ? 1e-38f : n2;   // NaN passes, as clamp
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(cl) : 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    out[(2 + a) * B + ray] = o[a];
    out[(5 + a) * B + ray] = r[a] * inv;
  }
  float* rows = out + 8 * B;
  for (int c = row0; c < n_rows; ++c) {
    rows[(size_t)(c - row0) * B + ray] =
        c < kCamDraws ? d[c] : uniform_draw(k0, k1, (uint32_t)c);
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

// The sample start, bound with ctypes. Device pointers: key (2,) int64 and
// pixel_ids (n_rays,) int64 as raytpu_rng_sample's; cam (12,) f32, the
// camera's origin, horizontal, vertical and lower_left (render.pack_camera);
// out (8 + n_rows - row0, n_rays) f32: the keys' two planes of uint32
// bits, origin x y z, direction x y z, then draw rows row0 .. n_rows-1.
// width: the frame's, for the pixel's column and row; w1, h1: W - 1 and
// H - 1; ap_x, ap_y, focus: the config's apertures and focus distance.
// row0 is 0 (rows 0-3 too, for the camera's backward) or 4; n_rows >= 4.
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t.
extern "C" int raytpu_sample_start(const long long* key,
                                   const long long* pixel_ids,
                                   const float* cam, int n_rays,
                                   unsigned sample_id, int width,
                                   float w1, float h1, float ap_x, float ap_y,
                                   float focus, int row0, int n_rows,
                                   float* out, void* stream) {
  if (n_rays < 0 || width < 1 || (row0 != 0 && row0 != kCamDraws) ||
      n_rows < kCamDraws) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return (int)cudaSuccess;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  sample_start_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      key, pixel_ids, cam, n_rays, sample_id, width, w1, h1, ap_x, ap_y,
      focus, row0, n_rows, out);
  return (int)cudaGetLastError();
}
