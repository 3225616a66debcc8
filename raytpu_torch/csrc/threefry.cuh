// JAX 0.9.0's threefry2x32 stream in native uint32, for the kernels that
// hash their random draws themselves: the RNG kernel (csrc/rng.cu), K1
// (csrc/trace_spheres.cu), K2's sphere mode (csrc/trace_scene_bwd.cu) and
// K5 (csrc/trace_spheres_bwd.cu). The plain version is
// raytpu_torch/core/rng.py (threefry2x32, fold_in, draws_at), which emulates
// the same uint32 arithmetic in int64 tensors; both follow jax/_src/prng.py
// (_threefry2x32_lowering, threefry_fold_in, the partitionable random bits)
// and jax/_src/random.py:_uniform, so every draw is JAX's bit for bit.
//
// A ray's key is fold_in(fold_in(PRNGKey(seed), pixel_id), sample_id); its
// draw c is uniform(key, (n,))[c], i.e. the hash of the counter words
// (0, c): draws 0-3 are the camera's, draw j of bounce b is draw
// 4 + b * n_draws + j (n_draws = integrator/path.n_bounce_draws: the
// scatter direction's u and v, the refraction roulette, then the AO
// probes' pairs).
//
// Integer work, in the instructions Hopper issues (LOP3 and IADD3 take
// three inputs): one hash is 73 (the third key word k0 ^ k1 ^ C in one
// LOP3, 2 key adds, 20 rounds of add / rotate / xor, 5 injections of two:
// x0 += ka and x1 += kb + (i + 1) in one IADD3); a draw adds 3 (xor, shift,
// or) and one FP32 subtraction.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCamDraws = 4;   // a ray key's draws 0-3 are the camera's

// Threefry-2x32, 20 rounds: (x0, x1) becomes the hash of the counter words
// under the key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define RAYTPU_TF_ROUND(r) \
  x0 += x1;                \
  x1 = __funnelshift_l(x1, x1, r); \
  x1 ^= x0;
#define RAYTPU_TF_ROUNDS_A \
  RAYTPU_TF_ROUND(13) RAYTPU_TF_ROUND(15) RAYTPU_TF_ROUND(26) RAYTPU_TF_ROUND(6)
#define RAYTPU_TF_ROUNDS_B \
  RAYTPU_TF_ROUND(17) RAYTPU_TF_ROUND(29) RAYTPU_TF_ROUND(16) RAYTPU_TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  RAYTPU_TF_ROUNDS_A x0 += k1; x1 += k2; x1 += 1u;
  RAYTPU_TF_ROUNDS_B x0 += k2; x1 += k0; x1 += 2u;
  RAYTPU_TF_ROUNDS_A x0 += k0; x1 += k1; x1 += 3u;
  RAYTPU_TF_ROUNDS_B x0 += k1; x1 += k2; x1 += 4u;
  RAYTPU_TF_ROUNDS_A x0 += k2; x1 += k0; x1 += 5u;
#undef RAYTPU_TF_ROUNDS_B
#undef RAYTPU_TF_ROUNDS_A
#undef RAYTPU_TF_ROUND
}

// jax.random.fold_in(key, d): the hash of (0, d), as the new key.
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// Draw c of the key (k0, k1): U[0, 1) from the 23 high bits of the hash of
// (0, c), under exponent 0, minus 1 (random._uniform; exact in f32).
__device__ __forceinline__ float uniform_draw(uint32_t k0, uint32_t k1,
                                              uint32_t c) {
  uint32_t x0 = 0u, x1 = c;
  threefry2x32(k0, k1, x0, x1);
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

// The draws of one bounce of one ray, hashed where they are read: draw j
// of the bounce is the key's draw base + j (base = 4 + b * n_draws). The
// kernels read a draw only where the forward uses it, so a bounce that
// does not scatter or refract hashes none of its draws.
struct KeyDraws {
  uint32_t k0, k1, base;
  __device__ __forceinline__ float operator()(int j) const {
    return uniform_draw(k0, k1, base + (uint32_t)j);
  }
};

// The draws of bounce i of the ray whose key is (k0, k1): draw j is the
// key's draw 4 + i * n_draws + j.
__device__ __forceinline__ KeyDraws key_draws(uint32_t k0, uint32_t k1,
                                              int i, int n_draws) {
  return KeyDraws{k0, k1, (uint32_t)(kCamDraws + i * n_draws)};
}

// The ray's key (k0, k1) from the (2, n_rays) key planes the RNG kernel
// writes (uint32 bits in int32 tensors).
__device__ __forceinline__ void load_key(const uint32_t* keys, size_t B,
                                         int ray, uint32_t& k0,
                                         uint32_t& k1) {
  k0 = keys[ray];
  k1 = keys[B + ray];
}

}  // namespace
