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
// reverse step, and its adjoint), and the bounce's draws hashed (76 INT32
// operations a draw, csrc/threefry.cuh; sphere mode twice, mesh mode
// once), against 4 bytes of index a bounce and 8 of key a ray, so its FP32
// and INT32 work set its least time
// (chip_smoke._k2_bound, _k2_mesh_bound). What holds it above that is the
// per-thread state: ~100-128 registers and the saved carries leave few
// warps on an SM to hide each thread's dependent chain (PERF.md). The
// design:
//   * one thread per ray; the one-hot MXU winner extraction of the TPU
//     kernel is an indexed load: the sphere and material tables from
//     shared memory, the winner triangle's 25 channels and its texel from
//     global memory (cached), reloaded in the reverse step rather than
//     carried;
//   * the replay saves the carry each reverse step needs (origin,
//     direction, throughput, medium IOR, flags: 11 words) at every bounce
//     start, in a per-thread array in local memory, so the reverse sweep
//     recomputes one bounce at a time; 48 carries, kMaxBounces (an
//     8-carry array for short launches and a stack in shared memory both
//     measured no faster, PERF.md);
//   * the rays' threefry keys (8 B a ray) in place of a draw buffer, in
//     both modes (csrc/threefry.cuh, the counters K1 and K3 use). Sphere
//     mode hashes each bounce's draws where the shading reads them, in the
//     replay and again in the reverse step; mesh mode hashes a bounce's
//     three once, ahead of its replay, and keeps them for the reverse step
//     beside the carry (12 B a bounce; hashed where read, twice, it ran
//     2.4% slower: PERF.md);
//   * a ray's replay stops at its first bounce out of the loop (a miss or
//     an emissive return), since what follows is the identity on the carry
//     and on its cotangent, and its reverse sweep starts there;
//   * the table cotangents are the transpose of the extractions: sums
//     into d_sph[k][winner], and in mesh mode d_tri (rows 0-2 and 9-11) of
//     the winner triangle, d_mat (rows 0-5) of its material and d_atlas
//     (rows 0-2) of its texel. All are deterministic without float
//     atomics: two launches on the same inputs give the same bits. Sphere
//     mode: the lanes of a warp are grouped by winner at each reverse
//     bounce, lanes 0-13 sum each group's 14 entries in lane order into
//     the warp's S x 14 sum in shared memory (replay.cuh: warp_table_sum),
//     the block sums its warps in order into its row of a (blocks, 14 S)
//     buffer, and a second kernel sums the blocks in a fixed tree order.
//     Mesh mode (up to 6 x 2048 + 3 x n_tex floats of table, too many for a
//     sum per warp): persistent blocks, as many as the card holds, each
//     over a fixed set of rays, keep one table of all four in shared
//     memory (the texels in the block's row of the buffer where they do
//     not fit); at each reverse bounce the lanes of a warp are grouped by
//     entry, kind by kind, each group summed in lane order, and the warps
//     add their group sums to the block's table in warp order
//     (mesh_table_sum); the block writes its table to its row of a
//     (blocks, 14 S + 6 T + 6 M + 3 n_tex) buffer, and a second kernel sums
//     each entry over the blocks in block order. Neither mode's shared
//     memory grows with threads x entries.
//
// The equirect sky (kSky, a template flag of both modes' kernels, so the
// sky-less instantiations keep their registers): K1 and K3 zero the sky sphere's
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

// Sphere mode's reverse sweep, one thread per ray (kSphereThreads a
// block); kSky the sky slot. Every thread of the block runs the reverse
// loop over all bounces, rays past n_rays and bounces past a ray's loop
// included, so that each warp sums its table cotangents together.
template <bool kSky>
__global__ void __launch_bounds__(kSphereThreads, kSphereMinBlocks)
sphere_backward_kernel(
    const float* __restrict__ sph, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const uint32_t* __restrict__ keys,
    const int* __restrict__ idx, const float* __restrict__ aofs,
    const float* __restrict__ gin, float* __restrict__ d_rays,
    float* __restrict__ partial, int n_rays, Knobs k) {
  extern __shared__ float smem[];   // dynamic: 16-byte aligned at its base
  const int ns = k.n_spheres, nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const SphereSmem sm = sphere_smem(smem, ns, nt);
  for (int e = tid; e < kRows * ns; e += nt) sm.tab[e] = sph[e];
  for (int e = tid; e < (nt >> 5) * kRows * ns; e += nt) sm.wsum[e] = 0.0f;
  __syncthreads();
  float* wsum = sm.wsum + warp * kRows * ns;
  float* stage = sm.stage + warp * kWarpStage;

  const int ray = blockIdx.x * nt + tid;
  const size_t B = (size_t)n_rays;
  uint32_t k0 = 0u, k1 = 0u;
  Carry c;
  Carry saved[kMaxBounces];
  int last = 0;   // the bounces replayed: the ray's loop, up to its end
  if (ray < n_rays) {
    load_key(keys, B, ray, k0, k1);
    init_carry(c, ray, ox, oy, oz, dx, dy, dz);
    for (int i = 0; i < k.bounces && c.active; ++i) {
      saved[i] = c;
      const int bidx = idx[(size_t)i * B + ray];
      const float aof = k.use_ao ? aofs[(size_t)i * B + ray] : 1.0f;
      replay_bounce<false, kSky>(i, c, bidx, sm.tab, nullptr, nullptr,
                                 nullptr, key_draws(k0, k1, i, k.n_draws),
                                 aof, k, nullptr, nullptr, nullptr);
      last = i + 1;
    }
  }

  Cot g;
  if (ray < n_rays) init_cot<kSky>(g, ray, B, gin);
  float gw[kRows];
  TriCot gt;
  for (int i = k.bounces - 1; i >= 0; --i) {
    int bidx = -1;
    if (i < last) {
      bidx = idx[(size_t)i * B + ray];
      const float aof = k.use_ao ? aofs[(size_t)i * B + ray] : 1.0f;
      c = saved[i];
      replay_bounce<false, kSky>(i, c, bidx, sm.tab, nullptr, nullptr,
                                 nullptr, key_draws(k0, k1, i, k.n_draws),
                                 aof, k, &g, gw, &gt);
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

// ---- mesh mode ------------------------------------------------------------

constexpr int kMeshThreads = 256;   // mesh mode's block: 8 warps
constexpr int kMeshWarps = kMeshThreads / 32;
// blocks an SM holds of mesh mode's kernels: 2 caps them at 128 registers
// (PERF.md, kernel_variants.py)
constexpr int kMeshMinBlocks = 2;
// The cotangent kinds of a (ray, bounce) and their rows in the block's
// table: a sphere winner's 14, or a triangle winner's 6 (rows 0-2 and
// 9-11 of the triangle table), its material's 6 (rows 0-5) and its
// texel's 3 (rows 0-2 of the atlas).
constexpr int kKinds = 4;           // sphere, triangle, material, texel
constexpr int kStageRows = 15;      // a lane's staged cotangents: 14 or 6 + 6 + 3
constexpr int kWarpFloats = kStageRows * kStagePitch + kKinds * 32;

__host__ __device__ __forceinline__ int kind_rows(int q) {
  return q == 0 ? kRows : (q == 3 ? 3 : 6);
}
// the first staged row of kind q (a sphere lane's rows overlap a triangle
// lane's: a lane stages one or the other)
__host__ __device__ __forceinline__ int kind_stage(int q) {
  return q == 2 ? 6 : (q == 3 ? 12 : 0);
}

// The block's table, kind by kind: base[q][r * n[q] + id] is row r of
// entry id. The layout of a block's row of `partial`: the sphere table's
// 14 x S, the triangles' 6 x T, the materials' 6 x M, the texels' 3 x
// n_tex, each row-major.
struct MeshTable {
  float* base[kKinds];
  int n[kKinds];
};

// A bounce's draws 0..2 (the scatter direction's u and v, the refraction
// roulette), hashed once in the replay and kept for the reverse step.
struct BounceDraws {
  float v[3];
  __device__ __forceinline__ float operator()(int j) const { return v[j]; }
};

__device__ __forceinline__ BounceDraws hash_draws(uint32_t k0, uint32_t k1,
                                                  int i, int n_draws) {
  const CalledDraws d = called_draws(k0, k1, i, n_draws);
  return BounceDraws{{d(0), d(1), d(2)}};
}

__host__ __device__ inline int mesh_entries(int ns, int nt, int nm, int n_tex) {
  return kRows * ns + 6 * nt + 6 * nm + 3 * n_tex;
}

// Mesh mode's dynamic shared memory: the sphere table (14 x S) and the
// material table (9 x M), the block's table (without its texels when they
// live in global memory), then each warp's staging.
__host__ __device__ inline size_t mesh_shared_floats(int ns, int nt, int nm,
                                                     int n_tex,
                                                     bool tex_in_smem) {
  return (size_t)kRows * ns + (size_t)kMatRows * nm +
         (size_t)mesh_entries(ns, nt, nm, tex_in_smem ? n_tex : 0) +
         (size_t)kMeshWarps * kWarpFloats;
}

// Adds one reverse bounce's cotangents of every warp of the block to the
// block's table, in a fixed order and without atomics. Each lane has
// staged its cotangents (stage[row * kStagePitch + lane]) and holds key[q],
// the entry of kind q it adds to (-1: none). Within the warp, the lanes
// of each kind are grouped by entry (__match_any_sync) and each group's
// rows are summed over its lanes in lane order, the (group, row) pairs
// spread over the lanes; then the warps take turns, in warp order, one
// block barrier apart, and the leading lane of each group adds the
// group's sums to the table. Within a turn the entries a warp adds to are
// distinct, so every addition's order is fixed by the data: two launches
// give the same bits. All threads of the block call it together.
__device__ __forceinline__ void mesh_table_sum(float* stage, unsigned* gmask,
                                               int lane, int warp,
                                               const int (&key)[kKinds],
                                               const MeshTable& tab) {
  unsigned lead[kKinds];
  bool shared[kKinds];   // some entry of kind q has more than one lane
#pragma unroll
  for (int q = 0; q < kKinds; ++q) {
    lead[q] = 0u;
    shared[q] = false;
    if (!__any_sync(0xffffffffu, key[q] >= 0)) continue;
    const unsigned peers = __match_any_sync(0xffffffffu, key[q]);
    const bool leader = key[q] >= 0 && __ffs(peers) - 1 == lane;
    lead[q] = __ballot_sync(0xffffffffu, leader);
    shared[q] = __any_sync(0xffffffffu, leader && peers != (1u << lane));
    if (leader) gmask[q * 32 + __popc(lead[q] & ((1u << lane) - 1u))] = peers;
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kKinds; ++q) {
    // a group of one lane holds its sum already
    const int rows = kind_rows(q), s0 = kind_stage(q);
    const int pairs = shared[q] ? __popc(lead[q]) * rows : 0;
    for (int p = lane; p < pairs; p += 32) {
      const int grp = p / rows, r = p - grp * rows;
      const unsigned m = gmask[q * 32 + grp];
      float* row = stage + (s0 + r) * kStagePitch;
      float acc = row[__ffs(m) - 1];
      for (unsigned mm = m & (m - 1u); mm != 0u; mm &= mm - 1u) {
        acc += row[__ffs(mm) - 1];
      }
      row[__ffs(m) - 1] = acc;   // the leader's slot: read above only here
    }
  }
  __syncwarp();
  for (int w = 0; w < kMeshWarps; ++w) {
    if (w == warp) {
#pragma unroll
      for (int q = 0; q < kKinds; ++q) {
        if ((lead[q] >> lane) & 1u) {
          float* dst = tab.base[q] + key[q];
          const float* src = stage + kind_stage(q) * kStagePitch + lane;
          for (int r = 0; r < kind_rows(q); ++r) {
            dst[r * tab.n[q]] += src[r * kStagePitch];
          }
        }
      }
    }
    __syncthreads();
  }
}

// Mesh mode's reverse sweep, one thread per ray; kSky the sky slot (a
// separate instantiation, so each mode keeps its registers). Persistent
// blocks: block b takes the rays b * kMeshThreads + j * gridDim.x *
// kMeshThreads for j = 0, 1, ..., each thread one ray a round, and keeps
// one table of the whole grid's cotangents in shared memory (its texels
// in its row of `partial` when tex_in_smem is 0), which it writes to its
// row of `partial` at the end. Every thread of the block runs the reverse
// loop over the bounces of the block's deepest ray in the round, so that
// the block sums its cotangents together.
template <bool kSky>
__global__ void __launch_bounds__(kMeshThreads, kMeshMinBlocks)
backward_kernel(
    const float* __restrict__ sph, const float* __restrict__ tri,
    const float* __restrict__ mat_g, const float* __restrict__ atlas,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const uint32_t* __restrict__ keys, const int* __restrict__ idx,
    const float* __restrict__ aofs, const float* __restrict__ gin,
    float* __restrict__ d_rays, float* __restrict__ partial, int n_rays,
    int tex_in_smem, Knobs k) {
  constexpr bool kMesh = true;
  extern __shared__ float smem[];
  const int ns = k.n_spheres, nm = k.n_mats, ntr = k.n_tris;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_e = mesh_entries(ns, ntr, nm, k.n_tex);
  const int n_sm = mesh_entries(ns, ntr, nm, tex_in_smem ? k.n_tex : 0);
  float* tab = smem;
  float* mats = tab + kRows * ns;
  float* tbl = mats + kMatRows * nm;
  float* stage = tbl + n_sm + warp * kWarpFloats;
  unsigned* gmask = reinterpret_cast<unsigned*>(stage + kStageRows * kStagePitch);
  float* row = partial + (size_t)blockIdx.x * n_e;   // this block's partial
  const int off_tri = kRows * ns, off_mat = off_tri + 6 * ntr;
  const int off_tex = off_mat + 6 * nm;
  const MeshTable table{{tbl, tbl + off_tri, tbl + off_mat,
                         (tex_in_smem ? tbl : row) + off_tex},
                        {ns, ntr, nm, k.n_tex}};
  for (int e = tid; e < kRows * ns; e += kMeshThreads) tab[e] = sph[e];
  for (int e = tid; e < kMatRows * nm; e += kMeshThreads) mats[e] = mat_g[e];
  for (int e = tid; e < n_sm; e += kMeshThreads) tbl[e] = 0.0f;
  for (int e = n_sm + tid; e < n_e; e += kMeshThreads) row[e] = 0.0f;
  __syncthreads();

  const size_t B = (size_t)n_rays;
  for (int first = blockIdx.x * kMeshThreads; first < n_rays;
       first += gridDim.x * kMeshThreads) {
    const int ray = first + tid;
    Carry c;
    Carry saved[kMaxBounces];
    BounceDraws saved_draws[kMaxBounces];
    int last = 0;   // the bounces replayed: the ray's loop, up to its end
    if (ray < n_rays) {
      uint32_t k0, k1;
      load_key(keys, B, ray, k0, k1);
      init_carry(c, ray, ox, oy, oz, dx, dy, dz);
      for (int i = 0; i < k.bounces && c.active; ++i) {
        saved[i] = c;
        // hashed once, kept for the reverse step
        saved_draws[i] = hash_draws(k0, k1, i, k.n_draws);
        const int bidx = idx[(size_t)i * B + ray];
        const float aof = k.use_ao ? aofs[(size_t)i * B + ray] : 1.0f;
        replay_bounce<kMesh, kSky>(i, c, bidx, tab, tri, mats, atlas,
                                   saved_draws[i], aof, k, nullptr, nullptr,
                                   nullptr);
        last = i + 1;
      }
    }

    Cot g;
    if (ray < n_rays) init_cot<kSky>(g, ray, B, gin);
    float gw[kRows];
    TriCot gt;
    for (int i = k.bounces - 1; i >= 0; --i) {
      if (!__syncthreads_or(i < last)) continue;   // past every ray's loop
      int key[kKinds] = {-1, -1, -1, -1};
      if (i < last) {
        const int bidx = idx[(size_t)i * B + ray];
        const float aof = k.use_ao ? aofs[(size_t)i * B + ray] : 1.0f;
        c = saved[i];
        if (replay_bounce<kMesh, kSky>(i, c, bidx, tab, tri, mats, atlas,
                                       saved_draws[i], aof, k, &g, gw, &gt)) {
          // a triangle one past the table reads the zero row: nothing to add
          if ((unsigned)(bidx - ns) < (unsigned)ntr) {
            key[1] = bidx - ns;
            for (int j = 0; j < 3; ++j) {
              stage[j * kStagePitch + lane] = gt.a[j];
              stage[(3 + j) * kStagePitch + lane] = gt.nraw[j];
            }
          }
          if (gt.mat_id >= 0) {
            key[2] = gt.mat_id;
            for (int r = 0; r < 6; ++r) stage[(6 + r) * kStagePitch + lane] = gt.mat[r];
          }
          if (gt.texel >= 0) {
            key[3] = gt.texel;
            for (int j = 0; j < 3; ++j) stage[(12 + j) * kStagePitch + lane] = gt.tex[j];
          }
        } else if (is_hit(bidx, ns)) {
          key[0] = bidx;
#pragma unroll
          for (int r = 0; r < kRows; ++r) stage[r * kStagePitch + lane] = gw[r];
        }
      }
      __syncwarp();
      mesh_table_sum(stage, gmask, lane, warp, key, table);
    }
    if (ray < n_rays) {
      for (int j = 0; j < 3; ++j) {
        d_rays[j * B + ray] = g.o[j];
        d_rays[(3 + j) * B + ray] = g.d[j];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < n_sm; e += kMeshThreads) row[e] = tbl[e];
}

// The sum over blocks of partial[b][e] in block order, one thread an
// entry, into d_sph, d_tri's rows 0-2 and 9-11, d_mat's rows 0-5 and
// d_atlas's rows 0-2.
__global__ void __launch_bounds__(kReduceThreads)
mesh_sum_kernel(const float* __restrict__ partial, int blocks, int ns,
                int nt, int nm, int n_tex, float* __restrict__ d_sph,
                float* __restrict__ d_tri, float* __restrict__ d_mat,
                float* __restrict__ d_atlas) {
  const int n_e = mesh_entries(ns, nt, nm, n_tex);
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= n_e) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * n_e + e];
  const int off_tri = kRows * ns, off_mat = off_tri + 6 * nt;
  const int off_tex = off_mat + 6 * nm;
  if (e < off_tri) {
    d_sph[e] = s;
  } else if (e < off_mat) {
    const int r = (e - off_tri) / nt, t = e - off_tri - r * nt;
    d_tri[(r < 3 ? r : r + 6) * nt + t] = s;   // rows 0-2, then 9-11
  } else if (e < off_tex) {
    d_mat[e - off_mat] = s;
  } else {
    d_atlas[e - off_tex] = s;
  }
}

// Mesh mode's layout and grid: the texels' table in shared memory when
// the kernel's shared memory with it is at most smem_budget bytes; as many
// blocks as the card holds at once (the occupancy of the instantiation at
// that shared memory, times the SMs), at most one a kMeshThreads rays.
// Sets the kernel's shared-memory attribute.
cudaError_t mesh_shape(int n_rays, int ns, int nt, int nm, int n_tex,
                       int smem_budget, int sky, int* tex_in_smem,
                       size_t* smem, int* blocks) {
  *tex_in_smem = mesh_shared_floats(ns, nt, nm, n_tex, true) * sizeof(float)
                 <= (size_t)smem_budget;
  *smem = mesh_shared_floats(ns, nt, nm, n_tex, *tex_in_smem) * sizeof(float);
  const auto kernel = sky ? backward_kernel<true> : backward_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  int per_sm = 0, dev = 0, n_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kMeshThreads, *smem);
  }
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int want = (n_rays + kMeshThreads - 1) / kMeshThreads;
  *blocks = want < per_sm * n_sm ? want : per_sm * n_sm;
  return cudaSuccess;
}

}  // namespace

// Blocks of the reverse sweep for n_rays rays: the first dimension of the
// (blocks, entries) `partial` buffer the caller allocates, with entries
// 14 * n_spheres in sphere mode (n_tris 0) and 14 * S + 6 * T + 6 * M + 3
// * n_tex in mesh mode; mesh mode's depends on the card (its occupancy)
// and on smem_budget and sky (see raytpu_backward). A negative value is
// a cudaError_t's negation.
extern "C" int raytpu_backward_blocks(int n_rays, int n_spheres, int n_tris,
                                      int n_mats, int n_tex, int smem_budget,
                                      int sky) {
  if (n_tris == 0) return (n_rays + kSphereThreads - 1) / kSphereThreads;
  size_t smem = 0;
  int blocks = 0, tex_in_smem = 0;
  if (n_rays == 0) return 0;
  const cudaError_t err = mesh_shape(n_rays, n_spheres, n_tris, n_mats, n_tex,
                                     smem_budget, sky, &tex_in_smem, &smem,
                                     &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Plain C entry point, bound with ctypes. Device pointers: sph (14, S),
// tri (25, T), mats (9, M) and atlas (4, n_tex) f32 (T = M = n_tex = 0 in
// sphere mode; atlas unread when n_tex is 0); ox..dz (n_rays,) f32; keys
// (2, n_rays) uint32, the rays' threefry keys (K1's or K3's), whose draws
// 4 + b * n_draws + j, j = 0..2, are bounce b's scatter and roulette
// draws; idx (bounces, n_rays) i32, the winners K1 or K3 recorded
// (triangle t as n_spheres + t); aof (bounces, n_rays) f32 when use_ao,
// else null; g (9, n_rays) f32, the cotangent of (radiance, albedo,
// normal), or (12, n_rays) with the sky slot's scale when sky_idx >= 0
// (the sky sphere; -1: no sky); d_rays (6, n_rays) f32 out; partial
// (raytpu_backward_blocks(...), entries) f32 scratch; d_sph (14, S), d_tri
// (25, T), d_mat (9, M) and d_atlas (4, n_tex) f32 out. Mesh mode keeps
// a block's texel cotangents in shared memory when its shared memory with
// them is at most smem_budget bytes, else in its row of partial. It
// zeroes d_tri, d_atlas and d_mat's rows 6-8 on `stream`, then the second
// kernel writes the rest of the four tables.
// Launches its kernels on `stream` without synchronising and returns the
// first cudaError_t.
extern "C" int raytpu_backward(
    const float* sph, const float* tri, const float* mats, const float* atlas,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const uint32_t* keys, const int* idx,
    const float* aof, const float* g, float* d_rays, float* partial,
    int n_rays, int n_spheres, int n_tris, int n_mats, int n_tex, int atlas_w,
    int atlas_h, int bounces, int n_draws, float sphere_eps, float det_eps,
    float tri_eps, float alpha_lo, float alpha_hi, float bright_boost,
    float bright_threshold, int use_ao, float e_scale_mult, int hsl_on,
    float hsl_l, float hsl_s, int sky_idx, int smem_budget, float* d_sph,
    float* d_tri, float* d_mat, float* d_atlas, void* stream) {
  if (n_spheres < 0 || n_spheres > kMaxSpheres || n_tris < 0 ||
      sky_idx < -1 || sky_idx >= n_spheres ||
      n_tris > kMaxTris || n_spheres + n_tris < 1 || n_mats < 0 ||
      n_mats > kMaxMats || n_tex < 0 ||
      (n_tex > 0 && (atlas == nullptr || atlas_w < 1 || atlas_h < 1)) ||
      n_rays < 0 || bounces < 0 || bounces > kMaxBounces || n_draws < 3 ||
      (use_ao && aof == nullptr) || keys == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const Knobs k{n_spheres, n_tris, n_mats, n_tex, atlas_w, atlas_h, bounces,
                n_draws, sphere_eps, det_eps, tri_eps, alpha_lo, alpha_hi,
                bright_boost, bright_threshold, use_ao, e_scale_mult, hsl_on,
                hsl_l, hsl_s, sky_idx};
  const bool sky = sky_idx >= 0;
  cudaError_t err = cudaSuccess;
  if (n_tris > 0) {
    // mesh mode: the reverse sweep, then the fixed-order sum over blocks
    size_t smem = 0;
    int blocks = 0, tex_in_smem = 0;
    err = cudaMemsetAsync(d_tri, 0, sizeof(float) * kTriRows * n_tris, s);
    if (err == cudaSuccess && n_mats > 0) {
      err = cudaMemsetAsync(d_mat + 6 * n_mats, 0, sizeof(float) * 3 * n_mats, s);
    }
    if (err == cudaSuccess && n_tex > 0) {
      err = cudaMemsetAsync(d_atlas, 0, sizeof(float) * 4 * (size_t)n_tex, s);
    }
    if (err == cudaSuccess && n_rays > 0) {
      err = mesh_shape(n_rays, n_spheres, n_tris, n_mats, n_tex, smem_budget,
                       sky, &tex_in_smem, &smem, &blocks);
    }
    if (err != cudaSuccess) return (int)err;
    if (blocks > 0) {
      const auto kernel = sky ? backward_kernel<true> : backward_kernel<false>;
      kernel<<<blocks, kMeshThreads, smem, s>>>(
          sph, tri, mats, atlas, ox, oy, oz, dx, dy, dz, keys, idx, aof, g,
          d_rays, partial, n_rays, tex_in_smem, k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int n_e = mesh_entries(n_spheres, n_tris, n_mats, n_tex);
    mesh_sum_kernel<<<(n_e + kReduceThreads - 1) / kReduceThreads,
                      kReduceThreads, 0, s>>>(partial, blocks, n_spheres,
                                              n_tris, n_mats, n_tex, d_sph,
                                              d_tri, d_mat, d_atlas);
    return (int)cudaGetLastError();
  }
  // sphere mode: the reverse sweep, then the fixed-order sum over blocks
  const int n_e = kRows * n_spheres;
  const int blocks = (n_rays + kSphereThreads - 1) / kSphereThreads;
  if (blocks > 0) {
    const size_t smem =
        sphere_shared_floats(n_spheres, kSphereThreads) * sizeof(float);
    const auto kernel = sky ? sphere_backward_kernel<true>
                            : sphere_backward_kernel<false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kSphereThreads, smem, s>>>(
        sph, ox, oy, oz, dx, dy, dz, keys, idx, aof, g, d_rays, partial,
        n_rays, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_e > 0) {
    sum_blocks_kernel<<<n_e, kReduceThreads, 0, s>>>(partial, blocks, n_e,
                                                     d_sph);
  }
  return (int)cudaGetLastError();
}

// Mesh mode's attributes as cudaFuncGetAttributes reports them: out[0..3]
// = registers a thread, local (stack and spill) bytes a thread, static
// shared bytes, and the dynamic shared bytes its last launch set. Returns
// the cudaError_t of the query.
extern "C" int raytpu_backward_mesh_attrs(int sky, int* out) {
  const auto kernel = sky ? backward_kernel<true> : backward_kernel<false>;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxDynamicSharedSizeBytes;
  return (int)cudaSuccess;
}
