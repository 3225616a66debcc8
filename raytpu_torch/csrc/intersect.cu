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
// What bounds it: per ray, ~33 FP32 operations per sphere, ~25 per
// 128-triangle chunk box and ~46 per triangle of every chunk scanned,
// against 24 bytes of ray read and 8 bytes written: FP32 operations
// (PERF.md gives the count and the card's time). So:
//   * one thread per ray, 256 rays a block, the ragged edge masked here;
//   * the sphere table (4 x S) read from global memory at a block-uniform
//     index, so each load is one broadcast through L1;
//   * the triangle table (12 x T: a, b - a, c - a, the raw normal; 192 KB
//     at 4096 triangles, too much to stage whole with enough blocks per
//     SM) staged one 128-triangle chunk (6 KB) at a time in shared memory,
//     read by every thread of the block at the same address (broadcast);
//   * the cull of the TPU kernel, at block granularity: a chunk is staged
//     and scanned when any ray of the block enters its box
//     (__syncthreads_or), the GPU form of the TPU's tile-level any. A
//     chunk that no ray of the block enters holds no triangle any of them
//     hits (the boxes are inflated by 1e-5 (|x| + 1) per side), so the
//     result is the full scan's, bit for bit. An axis on which the slab
//     product is NaN (the origin on a box plane and the direction's
//     component zero) is unconstrained: the line lies in that slab, so
//     it cannot cull (the TPU's NaN culls the ray, which its tile-level
//     any hides).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (raytpu_torch/kernels/_build.py).
// No fast-math flags and no FMA contraction: every product and sum rounds
// on its own, as in the plain version, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPrims = 4096;    // raytpu's MAX_SMEM_PRIMS, per class
constexpr int kChunk = 128;        // triangles per cull box
constexpr int kRows = 12;          // a3 ab3 ac3 n3 per triangle
constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;

// (entry, exit) parameters of the line o + t d in the slab [lo, hi] of
// one axis; (-inf, inf) where the product is NaN (see the header)
__device__ __forceinline__ void slab_axis(float lo, float hi, float o,
                                          float inv, float& t_near,
                                          float& t_far) {
  const float t0 = (lo - o) * inv;
  const float t1 = (hi - o) * inv;
  if (isnan(t0) || isnan(t1)) {
    t_near = -INFINITY;
    t_far = INFINITY;
  } else {
    t_near = fminf(t0, t1);
    t_far = fmaxf(t0, t1);
  }
}

__device__ __forceinline__ bool enters(const float* __restrict__ boxes,
                                       int n_chunks, int c, float ox,
                                       float oy, float oz, float inv_x,
                                       float inv_y, float inv_z) {
  float nx, fx, ny, fy, nz, fz;
  slab_axis(boxes[c], boxes[3 * n_chunks + c], ox, inv_x, nx, fx);
  slab_axis(boxes[n_chunks + c], boxes[4 * n_chunks + c], oy, inv_y, ny, fy);
  slab_axis(boxes[2 * n_chunks + c], boxes[5 * n_chunks + c], oz, inv_z, nz,
            fz);
  const float tmin = fmaxf(fmaxf(nx, ny), nz);
  const float tmax = fminf(fminf(fx, fy), fz);
  return tmax >= tmin && tmax >= 0.0f;
}

__global__ void __launch_bounds__(kThreads) intersect_kernel(
    const float* __restrict__ sph, const float* __restrict__ tri,
    const float* __restrict__ boxes, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, float* __restrict__ t_out,
    int* __restrict__ idx_out, int n_rays, int n_spheres, int n_tris,
    float sphere_eps, float det_eps, float tri_eps) {
  __shared__ float s_tri[kRows][kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
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

  const int n_chunks = (n_tris + kChunk - 1) / kChunk;
  const float inv_x = 1.0f / rdx, inv_y = 1.0f / rdy, inv_z = 1.0f / rdz;
  for (int c = 0; c < n_chunks; ++c) {
    const bool in = live && enters(boxes, n_chunks, c, rox, roy, roz, inv_x,
                                   inv_y, inv_z);
    if (!__syncthreads_or(in)) continue;   // block-uniform
    const int lo = c * kChunk;
    const int n = min(kChunk, n_tris - lo);
    for (int j = threadIdx.x; j < kRows * kChunk; j += kThreads) {
      const int row = j / kChunk, col = j % kChunk;
      s_tri[row][col] = col < n ? tri[(size_t)row * n_tris + lo + col] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float ax = s_tri[0][j], ay = s_tri[1][j], az = s_tri[2][j];
      const float abx = s_tri[3][j], aby = s_tri[4][j], abz = s_tri[5][j];
      const float acx = s_tri[6][j], acy = s_tri[7][j], acz = s_tri[8][j];
      const float nx = s_tri[9][j], ny = s_tri[10][j], nz = s_tri[11][j];
      const float aox = rox - ax, aoy = roy - ay, aoz = roz - az;
      const float daox = aoy * rdz - aoz * rdy;
      const float daoy = aoz * rdx - aox * rdz;
      const float daoz = aox * rdy - aoy * rdx;
      const float det = -(rdx * nx + rdy * ny + rdz * nz);
      const float inv_det = 1.0f / (det >= det_eps ? det : 1.0f);
      const float dst = (aox * nx + aoy * ny + aoz * nz) * inv_det;
      const float u = (acx * daox + acy * daoy + acz * daoz) * inv_det;
      const float v = -(abx * daox + aby * daoy + abz * daoz) * inv_det;
      const float w = 1.0f - u - v;
      const bool valid = det >= det_eps && dst >= tri_eps && u >= tri_eps &&
                         v >= tri_eps && w >= tri_eps;
      if (valid && dst < best) {
        best = dst;
        bidx = n_spheres + lo + j;
      }
    }
    __syncthreads();   // the chunk is read before the next one is staged
  }
  if (live) {
    t_out[i] = best;
    idx_out[i] = bidx;
  }
}

}  // namespace

// sph (4, n_spheres): cx cy cz r; tri (12, n_tris); boxes (6, ceil(n_tris
// / 128)): lo3 hi3; six (n_rays,) ray planes; outputs (n_rays,) best t and
// winner index. Returns the cudaError_t of the launch.
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
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  intersect_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sph, tri, boxes, ox, oy, oz, dx, dy, dz, t_out, idx_out, n_rays,
      n_spheres, n_tris, sphere_eps, det_eps, tri_eps);
  return (int)cudaGetLastError();
}
