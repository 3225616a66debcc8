// The fused closest-hit selection (K4) for Hopper: per ray, the nearest
// sphere or triangle and its distance, with no shading.
//
// Replaces raytpu/kernels/intersect.py:_intersect_kernel (the Pallas TPU
// kernel launched by _intersect_call, entry point pallas_select), which
// the scan path (raytpu/integrator/hit.py closest_hit and any_hit) runs in
// place of its (rays x primitives) distance matrices. The plain PyTorch
// version is raytpu_torch/kernels/intersect.py:intersect_reference, which
// scans every primitive with no cull. Both keep K4's arithmetic (not
// sphere_distances'): a = |d|^2 once per ray, inv_2a = 0.5/max(a, 1e-20),
// sqrt(max(disc, 0)), near root then far root at t >= sphere_eps where
// disc > 0; Moller-Trumbore with inv_det = 1/where(det >= det_eps, det,
// 1) and validity on det, dst, u, v and w. Spheres are scanned before
// triangles, and a later primitive wins only on a strictly smaller t, so
// ties go to the earlier one. A triangle t is reported as n_spheres + t;
// a miss as (3e38, -1).
//
// What bounds it: per ray, ~33 FP32 operations per sphere, 25 per chunk
// box (a slab test's least; box.cuh's NaN guard adds ~11) and ~46 per
// triangle of every chunk scanned, against 24 bytes of
// ray read and 8 bytes written: FP32 operations (PERF.md gives the count
// and the card's time). So:
//   * the triangle table is staged once per block, for all of its rays:
//     persistent blocks, as many as fit on the card, loop over the rays.
//     A triangle is three float4s in shared memory, (a, n.x), (b - a,
//     n.y), (c - a, n.z), read as one LDS.128 each (48 B x 4096 = 192 KB,
//     under the 227 KB a block may use), with the chunk boxes beside
//     them; every lane of a warp reads the same triangle (broadcast);
//   * no block barrier after the staging: each warp walks its own chunks;
//   * the cull is per warp and against the running best: the warp scans
//     a chunk when any of its lanes' lines enters the chunk's box with
//     tmin < best (__any_sync). Chunks are visited in index order, the
//     boxes are inflated by 1e-5 (|x| + 1) per side, and a triangle wins
//     only on a strictly smaller t, so the result is the full scan's, bit
//     for bit: the full scan's winner w has every earlier primitive at a
//     larger t, so when its chunk comes the running best is above t_w >=
//     tmin, and a lane that scans a chunk it did not need only folds in
//     primitives that cannot displace w. The box test is box.cuh's
//     meets_box, which leaves an axis with a NaN slab product
//     unconstrained;
//   * the sphere table (4 x S) read from global memory at a warp-uniform
//     index, so each load is one broadcast through L1;
//   * 1024 threads a block (32 warps, 64 registers a thread at most), so
//     a block with the 4096-triangle table alone on its SM still keeps 8
//     warps on each scheduler.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (raytpu_torch/kernels/_build.py).
// No fast-math flags and no FMA contraction: every product and sum rounds
// on its own, as in the plain version, so the two agree bit for bit.

#include <cuda_runtime.h>

#include "box.cuh"

namespace {

constexpr int kMaxPrims = 4096;    // raytpu's MAX_SMEM_PRIMS, per class
constexpr int kChunk = 32;         // triangles per cull box (intersect.py:
                                   // KERNEL_CHUNK; PERF.md: 32 beat 16, 64
                                   // and 128 on the card)
constexpr int kThreads = 1024;
constexpr float kBig = 3.0e38f;

__global__ void __launch_bounds__(kThreads) intersect_kernel(
    const float* __restrict__ sph, const float* __restrict__ tri,
    const float* __restrict__ boxes, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, float* __restrict__ t_out,
    int* __restrict__ idx_out, int n_rays, int n_spheres, int n_tris,
    float sphere_eps, float det_eps, float tri_eps) {
  extern __shared__ float4 s_tri[];   // 3 per triangle, then the boxes
  const int n_chunks = (n_tris + kChunk - 1) / kChunk;
  float* s_box = reinterpret_cast<float*>(s_tri + 3 * n_tris);
  for (int j = threadIdx.x; j < n_tris; j += kThreads) {
    const float* col = tri + j;
    s_tri[3 * j] = make_float4(col[0], col[n_tris], col[2 * n_tris],
                               col[9 * n_tris]);
    s_tri[3 * j + 1] = make_float4(col[3 * n_tris], col[4 * n_tris],
                                   col[5 * n_tris], col[10 * n_tris]);
    s_tri[3 * j + 2] = make_float4(col[6 * n_tris], col[7 * n_tris],
                                   col[8 * n_tris], col[11 * n_tris]);
  }
  for (int j = threadIdx.x; j < 6 * n_chunks; j += kThreads) s_box[j] = boxes[j];
  __syncthreads();

  // the block's rays: base is block-uniform, so every lane of a warp runs
  // every pass and __any_sync sees the whole warp
  for (int base = blockIdx.x * kThreads; base < n_rays;
       base += gridDim.x * kThreads) {
    const int i = base + threadIdx.x;
    const bool live = i < n_rays;
    const float rox = live ? ox[i] : 0.0f, roy = live ? oy[i] : 0.0f,
                roz = live ? oz[i] : 0.0f;
    const float rdx = live ? dx[i] : 1.0f, rdy = live ? dy[i] : 1.0f,
                rdz = live ? dz[i] : 1.0f;

    float best = kBig;
    int bidx = -1;
    const float a_quad = rdx * rdx + rdy * rdy + rdz * rdz;
    const float inv_2a = 0.5f / fmaxf(a_quad, 1e-20f);
    for (int s = 0; s < n_spheres; ++s) {
      const float cx = sph[s], cy = sph[n_spheres + s],
                  cz = sph[2 * n_spheres + s], r = sph[3 * n_spheres + s];
      const float ocx = rox - cx, ocy = roy - cy, ocz = roz - cz;
      const float b = 2.0f * (ocx * rdx + ocy * rdy + ocz * rdz);
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
      const float disc = b * b - 4.0f * a_quad * c;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float t1 = (-b - sq) * inv_2a;
      const float t2 = (-b + sq) * inv_2a;
      const bool hit = disc > 0.0f;
      const float t = (hit && t1 >= sphere_eps)   ? t1
                      : (hit && t2 >= sphere_eps) ? t2
                                                  : kBig;
      if (t < best) {
        best = t;
        bidx = s;
      }
    }

    const float inv_x = 1.0f / rdx, inv_y = 1.0f / rdy, inv_z = 1.0f / rdz;
    for (int c = 0; c < n_chunks; ++c) {
      float tmin;
      const bool in = live &&
                      meets_box(s_box, n_chunks, c, rox, roy, roz, inv_x,
                                inv_y, inv_z, tmin) && tmin < best;
      if (!__any_sync(0xffffffffu, in)) continue;   // warp-uniform
      const int end = min(n_tris, (c + 1) * kChunk);
      for (int j = c * kChunk; j < end; ++j) {
        const float4 p = s_tri[3 * j], q = s_tri[3 * j + 1],
                     e = s_tri[3 * j + 2];
        const float aox = rox - p.x, aoy = roy - p.y, aoz = roz - p.z;
        const float daox = aoy * rdz - aoz * rdy;
        const float daoy = aoz * rdx - aox * rdz;
        const float daoz = aox * rdy - aoy * rdx;
        const float det = -(rdx * p.w + rdy * q.w + rdz * e.w);
        const float inv_det = 1.0f / (det >= det_eps ? det : 1.0f);
        const float dst = (aox * p.w + aoy * q.w + aoz * e.w) * inv_det;
        const float u = (e.x * daox + e.y * daoy + e.z * daoz) * inv_det;
        const float v = -(q.x * daox + q.y * daoy + q.z * daoz) * inv_det;
        const float w = 1.0f - u - v;
        const bool valid = det >= det_eps && dst >= tri_eps && u >= tri_eps &&
                           v >= tri_eps && w >= tri_eps;
        if (valid && dst < best) {
          best = dst;
          bidx = n_spheres + j;
        }
      }
    }
    if (live) {
      t_out[i] = best;
      idx_out[i] = bidx;
    }
  }
}

}  // namespace

// sph (4, n_spheres): cx cy cz r; tri (12, n_tris): a3 ab3 ac3 n3; boxes
// (6, ceil(n_tris / kChunk)): lo3 hi3 of each run of kChunk triangles;
// six (n_rays,) ray planes; outputs (n_rays,) best t and winner index.
// Sets the kernel's dynamic shared memory (48 B a triangle and 24 B a
// box: up to ~195 KB at 4096 triangles), launches as many blocks as fit
// on the card at once (no more than the rays need) on `stream` without
// synchronising, and returns the cudaError_t of the launch.
extern "C" int raytpu_intersect(const float* sph, const float* tri,
                                const float* boxes, const float* ox,
                                const float* oy, const float* oz,
                                const float* dx, const float* dy,
                                const float* dz, float* t_out, int* idx_out,
                                int n_rays, int n_spheres, int n_tris,
                                float sphere_eps, float det_eps,
                                float tri_eps, void* stream) {
  if (n_rays < 0 || n_spheres < 0 || n_spheres > kMaxPrims || n_tris < 0 ||
      n_tris > kMaxPrims) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return (int)cudaSuccess;
  const int n_chunks = (n_tris + kChunk - 1) / kChunk;
  const size_t smem = 3 * sizeof(float4) * (size_t)n_tris +
                      6 * sizeof(float) * (size_t)n_chunks;
  cudaError_t err = cudaFuncSetAttribute(
      intersect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, intersect_kernel, kThreads, smem)) != cudaSuccess) {
    return (int)err;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int need = (n_rays + kThreads - 1) / kThreads;
  const int blocks = need < sms * per_sm ? need : sms * per_sm;
  intersect_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      sph, tri, boxes, ox, oy, oz, dx, dy, dz, t_out, idx_out, n_rays,
      n_spheres, n_tris, sphere_eps, det_eps, tri_eps);
  return (int)cudaGetLastError();
}

// The kernel's attributes as the driver holds them: out[0..3] = registers
// a thread, local (stack and spill) bytes a thread, static shared bytes,
// and the dynamic shared bytes the last raytpu_intersect set. Returns the
// cudaError_t of the query.
extern "C" int raytpu_intersect_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, intersect_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxDynamicSharedSizeBytes;
  return (int)cudaSuccess;
}
