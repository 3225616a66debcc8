// The index-replay backward (K2) for Hopper: sphere mode and mesh mode.
//
// Replaces raytpu/kernels/trace_scene_bwd.py:_bwd_kernel (the Pallas TPU
// kernel launched by _bwd_call from mesh_backward): sphere mode for sphere
// scenes (n_tris == 0, after K1), mesh mode for spheres plus textured
// triangles (after K3), each with or without the equirect sky's
// cotangent (sky_idx >= 0). The plain PyTorch version is
// raytpu_torch/kernels/trace_scene_bwd.py:replay_reference, the replay
// under autograd; the forward it reverses is replay_bounce there, which
// is raytpu's _replay_bounce + shade_bounce op for op.
//
// What it computes: for each ray, the bounce loop replayed from the winner
// indices and AO factors K1 or K3 recorded (no search), then the reverse
// sweep, bounce N-1 down to 0, which pulls the cotangent of the
// (radiance, albedo, normal) planes back to the tables (the 14 x S sphere
// table; in mesh mode also the 25 x T triangle table, the 9 x M material
// table and the 4 x n_tex atlas) and to the ray origin and direction. The
// TPU kernel gets that reverse from jax.vjp in the kernel; CUDA has none,
// so each step below carries its adjoint, derived by hand. Each adjoint
// follows only the branch the forward took (the gradient of a select goes
// to the taken side), which also keeps the untaken branches' 0 * inf out
// of the sums. A bounce is split in two: the winner's surface (the
// sphere's or the triangle's hit point, normal and material; surface_*)
// and the shading every winner shares (shade).
//
// Rows of the mesh tables that get no cotangent, by construction: a
// triangle's raw b and c and its UVs reach only floor() and the texel
// index, and its edges b - a and c - a only the validity compares; its
// alpha texel, alpha_const, the two material flags and the material id
// enter only comparisons and indices. The triangle table's cotangent
// lives in rows 9-11 (the raw normal), the material table's in rows 0-5,
// the atlas's in rows 0-2. Rows 0-2 (the vertex a) get the hit distance's
// cotangent, which is zero in exact arithmetic: a triangle's hit point
// reaches the output only as the next ray's origin, and that origin's
// cotangent is zero, or, after a cutout (which keeps the direction, so
// moving the origin along the ray leaves the next hit where it is),
// orthogonal to the direction. They come out at rounding level, in this
// kernel as in the plain version. The CPU tests and the chip check compare
// every row with the plain version under autograd, and the chip check
// holds these rows under 1e-6 of the table's largest entry on both sides.
//
// What bounds it on this card: per live ray-bounce ~510 FP32 operations
// in sphere mode, ~1,000 in mesh mode (the replayed bounce, again in the
// reverse step, and its adjoint) against 16 bytes of index and draws, so
// the bytes it must move and its FP32 work set about the same least time
// (0.06 ms at the 1200x900, 6-bounce frame). What holds it above that is
// the per-thread state: ~118 registers (~160 in mesh mode), the saved
// carries in local memory and a 14 x S shared-memory column per thread
// leave few blocks on an SM,
// too few warps to hide each thread's dependent chain (PERF.md). The
// design:
//   * one thread per ray; the one-hot MXU winner extraction of the TPU
//     kernel is an indexed load: the sphere and material tables from
//     shared memory, the winner triangle's 25 channels and its texel from
//     global memory (cached), reloaded in the reverse step rather than
//     carried;
//   * the replay saves the carry each reverse step needs (origin,
//     direction, throughput, medium IOR, flags: 11 words) at every bounce
//     start, in a per-thread array in local memory (bounces <= 48), so
//     the reverse sweep recomputes one bounce at a time;
//   * the sphere-table cotangent is the transpose of the extraction, a sum
//     into d_sph[k][winner], and so are the material table's rows 0-5. Both
//     are deterministic without float atomics: each thread sums into its
//     own column of a (14*S + 6*M, T) shared array, each block sums the
//     columns in a fixed order into a (blocks, 14*S + 6*M) buffer, and a
//     second kernel sums the blocks in a fixed tree order. Two launches on
//     the same inputs give bit-identical d_sph and d_mat;
//   * d_tri (25 x 2048 floats at most) and d_atlas (4 x n_tex) do not fit
//     that scheme: they take global float atomicAdd (winners spread over
//     hundreds of triangles and thousands of texels, so few collide).
//     Atomics add in an order that changes from launch to launch, so two
//     mesh-mode launches agree on d_tri and d_atlas only to rounding (the
//     chip check bounds the difference); everything else is bit-identical.
//
// The equirect sky (kSky, a template flag like kMesh, so the sky-less
// instantiations keep their registers): K1 and K3 zero the sky sphere's
// emission and record, per ray, the throughput scale of its first sky
// event (raytpu's sky slot); the texel is added outside them, so the
// scale's cotangent g_skl arrives here beside the nine others (12 planes
// in; the slot's direction and early flag reach the image only through
// floor() and compares, and get none). The replay carries the slot's
// taken flag (Carry::slot; the scale itself is never read back: a take
// overwrites it) and the reverse carries g_skl (Cot::skl). At the bounce
// whose accumulation took the slot, skl = e_scale * rc with rc the
// throughput before the bounce, so the reverse adds g_skl * e_scale to
// rc's cotangent and (g_skl . rc) * e_scale_mult to the sky sphere's
// emission strength; a take by an emissive early return sets skl = 1.
// Either take ends g_skl. The zeroed emission passes no cotangent to the
// table.
//
// Numerics: a row of the table cotangent is a sum over rays in which a
// few grazing hits weigh most (a hit's distance gradient grows as
// 1/sqrt(disc), and a hit recomputed on the other side of the epsilon
// gate drops out), so rounding differences are magnified there. Built
// with -fmad=false, the replay rounds every operation as the plain
// version and K1/K3 do: on the card the two backward versions then agree
// to ~1e-6 of each row, where FMA contraction left them up to a third of
// a row apart.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (raytpu_torch/kernels/_build.py);
// no fast-math flags.

#include "replay.cuh"

namespace {

// The reverse sweep, one thread per ray; kMesh selects mesh mode and kSky
// the sky slot (separate instantiations, so each mode keeps its
// registers).
template <bool kMesh, bool kSky>
__global__ void backward_kernel(
    const float* __restrict__ sph, const float* __restrict__ tri,
    const float* __restrict__ mat_g, const float* __restrict__ atlas,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ draws, const int* __restrict__ idx,
    const float* __restrict__ aofs, const float* __restrict__ gin,
    float* __restrict__ d_rays, float* __restrict__ partial,
    float* __restrict__ d_tri, float* __restrict__ d_mat,
    float* __restrict__ d_atlas, int n_rays, Knobs k) {
  extern __shared__ float smem[];
  const int ns = k.n_spheres, nm = k.n_mats;
  const int n_sph = kRows * ns;
  const int n_e = column_entries(ns, nm);
  const int nt = blockDim.x;
  const int stride = nt + 1;   // column pitch: conflict-free in both phases
  const int tid = threadIdx.x;
  float* tab = smem;
  float* mats = tab + n_sph;
  float* col = mats + kMatRows * nm;   // col[e * stride + t]: thread t's sum
  for (int e = tid; e < n_sph; e += nt) tab[e] = sph[e];
  for (int e = tid; e < kMatRows * nm; e += nt) mats[e] = mat_g[e];
  for (int e = 0; e < n_e; ++e) col[e * stride + tid] = 0.0f;
  __syncthreads();

  const int ray = blockIdx.x * nt + tid;
  if (ray < n_rays) {
    const size_t B = (size_t)n_rays;
    const size_t n_tex = (size_t)k.n_tex;
    Carry saved[kMaxBounces];
    Carry c;
    init_carry(c, ray, ox, oy, oz, dx, dy, dz);
    // the bounce's scatter draws, read ahead of its replay so the loads
    // overlap the winner's surface (read inside the replay, after it,
    // they left sphere mode 11% slower: PERF.md)
    float dr[3];
    for (int i = 0; i < k.bounces; ++i) {
      saved[i] = c;
      const int bidx = idx[(size_t)i * B + ray];
      const float aof = k.use_ao ? aofs[(size_t)i * B + ray] : 1.0f;
      load_draws(draws, i, k.n_draws, B, ray, dr);
      replay_bounce<kMesh, kSky>(i, c, bidx, tab, tri, mats, atlas, dr, aof,
                                 k, nullptr, nullptr, nullptr);
    }

    Cot g;
    init_cot<kSky>(g, ray, B, gin);
    float gw[kRows];
    TriCot gt;
    for (int i = k.bounces - 1; i >= 0; --i) {
      const int bidx = idx[(size_t)i * B + ray];
      const float aof = k.use_ao ? aofs[(size_t)i * B + ray] : 1.0f;
      load_draws(draws, i, k.n_draws, B, ray, dr);
      c = saved[i];
      if (replay_bounce<kMesh, kSky>(i, c, bidx, tab, tri, mats, atlas, dr,
                                     aof, k, &g, gw, &gt)) {
        const size_t t = (size_t)(bidx - ns);
        if (t < (size_t)k.n_tris) {
          for (int j = 0; j < 3; ++j) {
            atomicAdd(&d_tri[j * k.n_tris + t], gt.a[j]);
            atomicAdd(&d_tri[(9 + j) * k.n_tris + t], gt.nraw[j]);
          }
        }
        if (gt.mat_id >= 0) {
          for (int r = 0; r < 6; ++r) {
            col[(n_sph + r * nm + gt.mat_id) * stride + tid] += gt.mat[r];
          }
        }
        if (gt.texel >= 0) {
          for (int j = 0; j < 3; ++j) atomicAdd(&d_atlas[j * n_tex + gt.texel], gt.tex[j]);
        }
      } else if (is_hit(bidx, ns)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) col[(r * ns + bidx) * stride + tid] += gw[r];
      }
    }
    for (int j = 0; j < 3; ++j) {
      d_rays[j * B + ray] = g.o[j];
      d_rays[(3 + j) * B + ray] = g.d[j];
    }
  }
  __syncthreads();

  // this block's column sums, each over the threads in a fixed order
  for (int e = tid; e < n_e; e += nt) {
    float s = 0.0f;
    for (int t = 0; t < nt; ++t) s += col[e * stride + t];
    partial[(size_t)blockIdx.x * n_e + e] = s;
  }
}

}  // namespace

// Blocks of the reverse sweep for n_rays rays: the first dimension of the
// (blocks, 14 * n_spheres + 6 * n_mats) `partial` buffer the caller
// allocates (n_mats is 0 in sphere mode).
extern "C" int raytpu_backward_blocks(int n_rays, int n_spheres, int n_mats) {
  const int nt = threads_per_block(n_spheres, n_mats);
  return (n_rays + nt - 1) / nt;
}

// Plain C entry point, bound with ctypes. Device pointers: sph (14, S),
// tri (25, T), mats (9, M) and atlas (4, n_tex) f32 (T = M = n_tex = 0 in
// sphere mode; atlas unread when n_tex is 0); ox..dz (n_rays,) f32; draws
// (bounces * n_draws, n_rays) f32, of which draws 0..2 of each bounce are
// read; idx (bounces, n_rays) i32, the winners K1 or K3 recorded (triangle
// t as n_spheres + t); aof (bounces, n_rays) f32 when use_ao, else null; g
// (9, n_rays) f32, the cotangent of (radiance, albedo, normal), or
// (12, n_rays) with the sky slot's scale when sky_idx >= 0 (the sky
// sphere; -1: no sky); d_rays
// (6, n_rays) f32 out; partial (raytpu_backward_blocks(n_rays, S, M),
// 14 * S + 6 * M) f32 scratch; d_sph (14, S), d_tri (25, T), d_mat (9, M)
// and d_atlas (4, n_tex) f32 out. It zeroes d_tri, d_atlas and d_mat's rows
// 6-8 on `stream`, then the kernels add into the first two and write d_sph
// and d_mat's rows 0-5. Launches its kernels on `stream` without
// synchronising and returns the first cudaError_t.
extern "C" int raytpu_backward(
    const float* sph, const float* tri, const float* mats, const float* atlas,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* draws, const int* idx,
    const float* aof, const float* g, float* d_rays, float* partial,
    int n_rays, int n_spheres, int n_tris, int n_mats, int n_tex, int atlas_w,
    int atlas_h, int bounces, int n_draws, float sphere_eps, float det_eps,
    float tri_eps, float alpha_lo, float alpha_hi, float bright_boost,
    float bright_threshold, int use_ao, float e_scale_mult, int hsl_on,
    float hsl_l, float hsl_s, int sky_idx, float* d_sph, float* d_tri,
    float* d_mat, float* d_atlas, void* stream) {
  if (n_spheres < 0 || n_spheres > kMaxSpheres || n_tris < 0 ||
      sky_idx < -1 || sky_idx >= n_spheres ||
      n_tris > kMaxTris || n_spheres + n_tris < 1 || n_mats < 0 ||
      n_mats > kMaxMats || n_tex < 0 ||
      (n_tex > 0 && (atlas == nullptr || atlas_w < 1 || atlas_h < 1)) ||
      n_rays < 0 || bounces < 0 || bounces > kMaxBounces || n_draws < 3 ||
      (use_ao && aof == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (n_tris > 0) {
    err = cudaMemsetAsync(d_tri, 0, sizeof(float) * kTriRows * n_tris, s);
  }
  if (err == cudaSuccess && n_mats > 0) {
    err = cudaMemsetAsync(d_mat + 6 * n_mats, 0, sizeof(float) * 3 * n_mats, s);
  }
  if (err == cudaSuccess && n_tex > 0) {
    err = cudaMemsetAsync(d_atlas, 0, sizeof(float) * 4 * (size_t)n_tex, s);
  }
  if (err != cudaSuccess) return (int)err;
  const Knobs k{n_spheres, n_tris, n_mats, n_tex, atlas_w, atlas_h, bounces,
                n_draws, sphere_eps, det_eps, tri_eps, alpha_lo, alpha_hi,
                bright_boost, bright_threshold, use_ao, e_scale_mult, hsl_on,
                hsl_l, hsl_s, sky_idx};
  // the reverse sweep, then the fixed-order sum of the column entries
  // over blocks
  const int n_e = column_entries(n_spheres, n_mats);
  const int nt = threads_per_block(n_spheres, n_mats);
  const int blocks = (n_rays + nt - 1) / nt;
  if (blocks > 0) {
    const size_t smem = shared_floats(n_spheres, n_mats, nt) * sizeof(float);
    const bool sky = sky_idx >= 0;
    const auto kernel = n_tris > 0 ? (sky ? backward_kernel<true, true>
                                          : backward_kernel<true, false>)
                                   : (sky ? backward_kernel<false, true>
                                          : backward_kernel<false, false>);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, nt, smem, s>>>(
        sph, tri, mats, atlas, ox, oy, oz, dx, dy, dz, draws, idx, aof, g,
        d_rays, partial, d_tri, d_mat, d_atlas, n_rays, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_e > 0) {
    sum_blocks_kernel<<<n_e, kReduceThreads, 0, s>>>(
        partial, blocks, n_e, kRows * n_spheres, d_sph, d_mat);
  }
  return (int)cudaGetLastError();
}
