// The mesh megakernel (K3) for Hopper: the whole forward bounce loop of a
// scene of spheres plus up to 2048 textured triangles in one launch.
//
// Replaces raytpu/kernels/trace_scene.py:_kernel (the Pallas TPU kernel
// launched by _trace_call, body bounce_body, skip_body for finished rays)
// with its recording mode (with_indices), its equirect-sky slot and its
// merged-quad search (kMerged, below). The plain PyTorch version is
// raytpu_torch/kernels/trace_scene.py:trace_scene_reference; both keep
// raytpu's arithmetic forms (0.5/max(a,1e-20) root scale, spheres scanned
// before triangles with a strict t < best, inv_det = 1/where(det >=
// det_eps, det, 1) then products, the 1e-5 relative box inflation, raw b/c
// vertices in the barycentrics, the fmod wrap as u - trunc(u), the x1.3
// bright quirk on the throughput before its update) so the three agree.
//
// What bounds it: per live (ray, bounce) it runs a sphere test per
// sphere, one slab test per 32-triangle chunk and ~46 operations per
// triangle of every chunk the ray enters (55 triangles on the
// 600-triangle block world), and hashes the bounce's draws from the ray's
// threefry key (csrc/threefry.cuh: 76 INT32 operations a draw), against
// 8 bytes of key a ray, so it is bound by FP32 operations (PERF.md gives
// the count and the card's time). So:
//   * one thread per ray; the merged modes on a 1-D grid, the ragged edge
//     masked here; the per-triangle modes on persistent blocks (as many
//     as fit on the card), each of whose warps takes the launch counter's
//     next 32 consecutive rays until none are left, so each block stages
//     its tables once and the warps stay busy to the end;
//   * the draws hashed where the loop reads them, at K1's counters: draw
//     j of bounce b is the key's draw 4 + b * n_draws + j (the scatter's
//     two only for a ray that scatters, the roulette only where the
//     material can refract, the AO probes' pairs 3 + 2s and 4 + 2s only
//     where the probes run), in place of a (bounces * n_draws, B) buffer
//     of them that the RNG kernel would write and this kernel read;
//   * the search channels of every triangle (a, b - a, c - a, the raw
//     normal: T x 12 f32, 96 KB at 2048 triangles), the chunk boxes, the
//     sphere table and the material table staged in dynamic shared
//     memory; a triangle is three float4s, so a warp reads one triangle
//     as three broadcasts, or 32 consecutive ones without a bank conflict
//     (Staged);
//   * the cull decided per ray (a chunk is scanned only for the rays
//     whose line enters its box before their current best, a conservative
//     prune: a hit inside the box has t >= tmin), where the TPU decides per
//     8192-ray tile; the slab's min/max propagate NaN as the plain
//     version's torch.minimum/maximum do, so both skip the same chunks.
//     A warp whose lanes each scanned their own chunks would issue the
//     union of them (3-4x the tests its rays need past the first bounce,
//     PERF.md), so the warp searches together (warp_search): a chunk that
//     k.coop_min or more lanes enter is scanned by each of them, triangle
//     by triangle as broadcasts; for fewer, each lane holds one of the
//     chunk's triangles and the warp tests it against each entering
//     lane's ray in turn, a (t, index) argmin picking the chunk's
//     winner, which is the sequential strict fold's;
//   * after the search only the winner's raw b and c, UVs and material id
//     (global, cached) and its texel (the f32 atlas in global memory) are
//     read: the TPU's bf16 limbs and one-hot MXU extraction and fetch
//     become indexed loads;
//   * a ray whose loop is over leaves it (exact: raytpu's skip_body and
//     shade_bounce leave a finished ray's carry unchanged), and the AO
//     probes run only for rays that accumulate (their factor is discarded
//     elsewhere);
//   * recording mode (kRecord, for the backward K2; a separate
//     instantiation, so the forward keeps its registers): each bounce
//     writes the winner (n_spheres + t for triangle t, -1 for a miss) and
//     with AO the factor, which is then computed for every ray still in
//     its loop, as K1 does when recording (the plain version and raytpu
//     compute it on every lane; K2 reads it only where the bounce
//     accumulates, and a hit recorded here is a ray in its loop). The
//     bounces a ray skips after its loop is over record -1 and 0, as
//     raytpu's skip_body does;
//   * the equirect sky (kSky, sky_idx >= 0; two more instantiations, so
//     the sky-less ones keep their registers): K1's slot
//     (csrc/trace_spheres.cu), over spheres and triangles. The sky
//     sphere's emission is zeroed, and each ray keeps in registers the
//     throughput scale, unit hit direction and early flag of its first
//     sky event; the 7 planes follow the 9 and
//     raytpu_torch/kernels/trace_spheres.py:compose_sky adds the texel. A
//     ray that leaves the loop early still writes its slot, after the
//     loop, with the 9 planes;
//   * the merged-quad search (kMerged; four more instantiations, so the
//     per-triangle ones keep their registers), raytpu's use_merged branch:
//     the running winner is the fraction best / bden, compared by cross
//     products, and divided once per ray and bounce at the end. The
//     tables of trace_scene.py:pack_aa (in walk order: walk_tables) and
//     pack_quads (axis-aligned rects and unpaired triangles, general
//     parallelograms and leftovers with their chunk boxes) are staged in
//     shared memory in place of the per-triangle search channels, which
//     the winner's normal and the AO probes then read from global memory.
//     The six (normal axis, sign) groups of axis-aligned candidates come
//     first: their candidates share the denominator detg = -s d_k, so each
//     ~12-operation test ranks by numerator and the group's winner joins
//     the running one by one fraction compare. A group is skipped where
//     detg is below the least det_eps / u of its candidates (or NaN),
//     which every candidate needs to be valid: an exact skip, which halves
//     the groups a ray tests. Inside a group each sub-list (rects with
//     m = 0, rects with m = 1, triangles) is sorted by plane offset, so a
//     ray's numerator rises along it: an exact plane-order walk
//     (merged_search) scans it in chunks of kWalkChunk columns, each whole
//     and branch-free as the table-order scan, only where the chunk
//     reaches past tri_eps and the ray's line meets its box, and stops at
//     the winner's plane or where no candidate can pass the group's gate;
//     the six groups run in a loop (unrolled, they overflow the
//     instruction cache). Then
//     the general parallelograms and leftovers, ~30 operations each, in
//     order (fraction compares do not round transitively, so the fold is
//     sequential, as in the plain version), behind the per-thread chunk
//     cull tmin * bden < best once there are more than 64 of them. A
//     parallelogram's winner is the half on its side of the diagonal, so
//     the winner stays an original triangle index.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (raytpu_torch/kernels/_build.py).
// No fast-math flags and no FMA contraction, as for K1 and K2: every
// product and sum rounds on its own, as in the plain version.

#include <cuda_runtime.h>

#include <type_traits>

#include "box.cuh"
#include "threefry.cuh"        // the draws, hashed from the ray's key

namespace {

constexpr int kMaxSpheres = 64;
constexpr int kMaxTris = 2048;
constexpr int kMaxMats = 64;
constexpr int kChunk = 32;         // triangles per cull box
constexpr int kSearch = 12;        // a3 ab3 ac3 n3 per triangle in shared memory
constexpr int kSphRows = 14;       // cx cy cz r | dif3 emi3 estr refl alpha ior
constexpr int kMatRows = 9;        // emi3 estr refl ior alpha_c use_c eft
constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;

// the next 32-ray group of a per-triangle launch, zeroed before it
__device__ unsigned int g_next;
constexpr float kTwoPi = 2.0f * 3.14159265358979323846f;  // 2 * f32(pi)

struct Knobs {
  int n_spheres, n_tris, n_mats, n_tex, atlas_w, atlas_h, bounces, n_draws;
  float sphere_eps, det_eps, tri_eps, alpha_lo, alpha_hi, bright_boost,
      bright_threshold;
  int use_ao, ao_samples;
  float ao_e_scale, ao_inv;
  int hsl_on;
  float hsl_l, hsl_s;
  int sky_idx;
  int coop_min;   // the per-triangle search's lanes of a warp entering a
                  // chunk from which each scans it alone (warp_search;
                  // trace_scene.py: COOP_MIN)
};

// The merged search's tables (global; rows of n columns each) and layout.
constexpr int kGroups = 6;   // (normal axis, sign): (0,+) (0,-) (1,+) ... (2,-)
constexpr int kAaRows = 9, kAa3Rows = 10, kQuadRows = 14, kLeftRows = 13;
constexpr int kWalkChunk = 8;   // columns per chunk box of the walk
                                // (trace_scene.py:WALK_CHUNK)
struct Quads {
  const float *aa, *aa3, *quad, *qbox, *left, *lbox, *aa_box, *aa3_box;
  int n_aa, n_aa3, n_quad, n_left, n_aa_box, n_aa3_box;
  int layout[kGroups][3];   // rects with m = 0, rects with m = 1, triangles
  float hi_eps;             // 1 - tri_eps, rounded once as the plain version does
};

__device__ __forceinline__ float safe_denom(float x) {
  return fabsf(x) > 1e-30f ? x : 1e-30f;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
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

// Slab test of chunk c's box (rows lo3 hi3 of `box`, n_chunks columns):
// whether the line o + t d meets it ahead of the origin, and its entry t.
__device__ __forceinline__ bool slab(const float* box, int n_chunks, int c,
                                     float ox, float oy, float oz,
                                     float inv_x, float inv_y, float inv_z,
                                     float& tmin) {
  const float t0x = (box[c] - ox) * inv_x;
  const float t1x = (box[3 * n_chunks + c] - ox) * inv_x;
  const float t0y = (box[n_chunks + c] - oy) * inv_y;
  const float t1y = (box[4 * n_chunks + c] - oy) * inv_y;
  const float t0z = (box[2 * n_chunks + c] - oz) * inv_z;
  const float t1z = (box[5 * n_chunks + c] - oz) * inv_z;
  tmin = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                 nan_min(t0z, t1z));
  const float tmax = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                             nan_max(t0z, t1z));
  return tmax >= tmin && tmax >= 0.0f;
}

// The search channels a3 ab3 ac3 n3 of triangle t into s[0..11]:
// tri.load(t, s). The per-triangle search stages the (T, 12) table in
// shared memory and reads a triangle as three float4s (Staged: one
// LDS.128 each; a triangle is 48 bytes, so the 8 lanes of a quarter-warp
// that read 8 consecutive triangles' float4 touch 32 distinct banks: no
// conflict); the merged search reads the (T, 12) table in global memory
// (AoS).
struct Staged {
  const float4* p;
  __device__ __forceinline__ void load(int t, float* s) const {
    const float4 a = p[3 * t], b = p[3 * t + 1], c = p[3 * t + 2];
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
    s[8] = c.x; s[9] = c.y; s[10] = c.z; s[11] = c.w;
  }
};
struct AoS {
  const float* p;
  __device__ __forceinline__ void load(int t, float* s) const {
#pragma unroll
    for (int r = 0; r < kSearch; ++r) s[r] = p[t * kSearch + r];
  }
};

// Moller-Trumbore against one triangle's search channels s[0..11]: the
// distance of a valid hit, or kBig.
__device__ __forceinline__ float triangle_hit(const float* s, float ox,
                                              float oy, float oz, float dx,
                                              float dy, float dz,
                                              const Knobs& k) {
  const float aox = ox - s[0], aoy = oy - s[1], aoz = oz - s[2];
  const float daox = aoy * dz - aoz * dy;
  const float daoy = aoz * dx - aox * dz;
  const float daoz = aox * dy - aoy * dx;
  const float det = -(dx * s[9] + dy * s[10] + dz * s[11]);
  const float inv_det = 1.0f / (det >= k.det_eps ? det : 1.0f);
  const float dst = (aox * s[9] + aoy * s[10] + aoz * s[11]) * inv_det;
  const float u = (s[6] * daox + s[7] * daoy + s[8] * daoz) * inv_det;
  const float v = -(s[3] * daox + s[4] * daoy + s[5] * daoz) * inv_det;
  const float w = 1.0f - u - v;
  const bool valid = det >= k.det_eps && dst >= k.tri_eps && u >= k.tri_eps &&
                     v >= k.tri_eps && w >= k.tri_eps;
  return valid ? dst : kBig;
}

// The per-triangle search of one warp (the plain version's
// _closest_triangle, bit for bit): each lane continues its running (best,
// bidx) over the chunks its line enters before its best, in chunk order.
// For chunk c the warp takes the ballot of those lanes. Many (at least
// k.coop_min): each of them runs the chunk's triangles in order, reading
// them as broadcasts. Few: lane j holds triangle 32c + j in registers; for
// each lane l of the ballot, in lane order, l's ray goes to every lane by
// shuffles, every lane tests its triangle, and a warp argmin of (t,
// index) gives the chunk's first least t, which l folds in with the strict
// t < best: what the sequential fold keeps. A lane whose `go` is false
// takes part in the shuffles only.
template <class Tri>
__device__ __forceinline__ void warp_search(const Tri& tri_s, const float* box,
                                            int n_chunks, int lane, bool go,
                                            float rox, float roy, float roz,
                                            float rdx, float rdy, float rdz,
                                            float& best, int& bidx,
                                            const Knobs& k) {
  const int nt = k.n_tris, ns = k.n_spheres;
  const float inv_x = 1.0f / rdx, inv_y = 1.0f / rdy, inv_z = 1.0f / rdz;
  for (int c = 0; c < n_chunks; ++c) {
    float tmin;
    const bool in = go && slab(box, n_chunks, c, rox, roy, roz, inv_x, inv_y,
                               inv_z, tmin) && tmin < best;
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (m == 0u) continue;
    const int end = min(nt, (c + 1) * kChunk);
    if (__popc(m) >= k.coop_min) {
      if (in) {
        for (int t = c * kChunk; t < end; ++t) {
          float s[kSearch];
          tri_s.load(t, s);
          const float d = triangle_hit(s, rox, roy, roz, rdx, rdy, rdz, k);
          if (d < best) { best = d; bidx = ns + t; }
        }
      }
      continue;
    }
    const int mine = c * kChunk + lane;
    const bool has = mine < end;
    float s[kSearch];
    tri_s.load(has ? mine : c * kChunk, s);
    for (unsigned todo = m; todo != 0u; todo &= todo - 1u) {
      const int l = __ffs(todo) - 1;
      const float ox = __shfl_sync(0xffffffffu, rox, l);
      const float oy = __shfl_sync(0xffffffffu, roy, l);
      const float oz = __shfl_sync(0xffffffffu, roz, l);
      const float dx = __shfl_sync(0xffffffffu, rdx, l);
      const float dy = __shfl_sync(0xffffffffu, rdy, l);
      const float dz = __shfl_sync(0xffffffffu, rdz, l);
      float d = has ? triangle_hit(s, ox, oy, oz, dx, dy, dz, k) : kBig;
      int t = mine;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float d2 = __shfl_xor_sync(0xffffffffu, d, off);
        const int t2 = __shfl_xor_sync(0xffffffffu, t, off);
        if (d2 < d || (d2 == d && t2 < t)) { d = d2; t = t2; }
      }
      if (lane == l && d < best) { best = d; bidx = ns + t; }
    }
  }
}

// Ambient occlusion (main.c:94-116): hemisphere probes from the hit point,
// occluded by any sphere root at t >= eps or any valid triangle of the
// chunks the probe enters; occluded probes / (ao_samples * ao_intensity).
// Probe a reads the bounce's draws 3 + 2a and 4 + 2a.
template <class Tri, class Draws>
__device__ float ao_factor(const float* sph, const Tri& tri_s,
                           const float* box, int n_chunks, float px,
                           float py, float pz, float nX, float nY, float nZ,
                           const Draws& draws, const Knobs& k) {
  const int ns = k.n_spheres;
  float occ = 0.0f;
  for (int a = 0; a < k.ao_samples; ++a) {
    const float au = draws(3 + 2 * a), av = draws(4 + 2 * a);
    const float ath = kTwoPi * au;
    const float acp = clampf(2.0f * av - 1.0f, -1.0f, 1.0f);
    const float asp = sqrtf(fmaxf(1.0f - acp * acp, 0.0f));
    float aox = nX + cosf(ath) * asp;
    float aoy = nY + sinf(ath) * asp;
    float aoz = nZ + acp;
    normalize3(aox, aoy, aoz);
    const float aq = aox * aox + aoy * aoy + aoz * aoz;
    const float ai2a = 0.5f / fmaxf(aq, 1e-20f);
    bool hit = false;
    for (int s = 0; s < ns && !hit; ++s) {
      const float ocx = px - sph[s], ocy = py - sph[ns + s];
      const float ocz = pz - sph[2 * ns + s], r = sph[3 * ns + s];
      const float b2 = 2.0f * (ocx * aox + ocy * aoy + ocz * aoz);
      const float c2 = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
      const float d2 = b2 * b2 - 4.0f * aq * c2;
      const float sq2 = sqrtf(fmaxf(d2, 0.0f));
      const float tt1 = (-b2 - sq2) * ai2a;
      const float tt2 = (-b2 + sq2) * ai2a;
      hit = d2 > 0.0f && (tt1 >= k.sphere_eps || tt2 >= k.sphere_eps);
    }
    const float inv_x = 1.0f / aox, inv_y = 1.0f / aoy, inv_z = 1.0f / aoz;
    for (int c = 0; c < n_chunks && !hit; ++c) {
      float tmin;
      if (!slab(box, n_chunks, c, px, py, pz, inv_x, inv_y, inv_z, tmin)) continue;
      const int end = min(k.n_tris, (c + 1) * kChunk);
      for (int t = c * kChunk; t < end && !hit; ++t) {
        float s[kSearch];
        tri_s.load(t, s);
        hit = triangle_hit(s, px, py, pz, aox, aoy, aoz, k) < kBig;
      }
    }
    occ = occ + (hit ? 1.0f : 0.0f);
  }
  return occ * k.ao_inv;
}

// The merged search after the spheres (raytpu's use_merged branch of
// bounce_body), on the tables in shared memory: aa (9 x n_aa) and aa3
// (10 x n_aa3) in walk order (trace_scene.py:walk_tables; the last row
// each column's original column) with their chunk boxes aa_box and
// aa3_box, quad (14 x n_quad), qbox, left (13 x n_left), lbox and gmin
// (the least det_eps / u of each group). best and bidx hold the spheres'
// winner (a fraction with denominator 1) and become the search's.
__device__ __forceinline__ void merged_search(
    const float* aa, const float* aa3, const float* quad, const float* qbox,
    const float* left, const float* lbox, const float* aa_box,
    const float* aa3_box, const float* gmin, const Quads& q, const Knobs& k,
    float rox, float roy, float roz, float rdx, float rdy, float rdz,
    float& best, int& bidx) {
  const int ns = k.n_spheres;
  const float inv_x = 1.0f / rdx, inv_y = 1.0f / rdy, inv_z = 1.0f / rdz;
  float bden = 1.0f;
  int r_off = 0, t_off = 0, rb_off = 0, tb_off = 0;
  // not unrolled: six copies of the walk overflow the instruction cache
  // (PERF.md: 1.71 against 3.37 ms unrolled)
#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    const int kx = g >> 1;
    const bool pos = (g & 1) == 0;
    const int ca = q.layout[g][0], cb = q.layout[g][1], ct = q.layout[g][2];
    const int r0 = r_off, t0 = t_off, rb0 = rb_off, tb0 = tb_off;
    const int rb1 = rb0 + (ca + kWalkChunk - 1) / kWalkChunk;
    r_off += ca + cb;
    t_off += ct;
    rb_off = rb1 + (cb + kWalkChunk - 1) / kWalkChunk;
    tb_off += (ct + kWalkChunk - 1) / kWalkChunk;
    const float dk = kx == 0 ? rdx : (kx == 1 ? rdy : rdz);
    const float detg = pos ? -dk : dk;
    // exact: no candidate of the group is valid below its det_eps / u
    if (!(detg >= gmin[g])) continue;
    const float ok = kx == 0 ? rox : (kx == 1 ? roy : roz);
    const float so_k = pos ? ok : -ok;
    // the in-plane axes i1 < i2
    const float X1 = (kx == 0 ? roy : rox) * detg;
    const float X2 = (kx == 2 ? roy : roz) * detg;
    const float d1 = kx == 0 ? rdy : rdx, d2 = kx == 2 ? rdy : rdz;
    const float epsd = k.tri_eps * detg, hid = q.hi_eps * detg;
    const float deng = detg > 0.0f ? detg : 1.0f;
    const float bar = best * deng;   // the group's gate: numr * bden < bar
    float bg = kBig;
    int gi = -1;
    // The walk of one sub-list, columns [lo, hi) of `tab` (n columns a
    // row) in chunks of kWalkChunk with boxes box0.. of `box` (nb
    // columns), whose numerators numr = so_k - col[0] rise along it. The
    // sub-list's winner is its least valid numerator, ties to the least
    // original column (the table-order scan's strict numr < bg). The walk
    // scans, every column of it as the table-order scan does, each chunk
    // whose last numerator reaches epsd and whose box the ray's line meets,
    // until the chunk's first numerator is past the winner's so far, or
    // not below bg (a later sub-list wins only on a strictly smaller
    // numerator), or fails the gate numr * bden < bar: no later column can
    // change what the group gives. `test` returns validity and sets the
    // winning triangle.
    auto walk = [&](const float* tab, int n, int orig_row, int lo, int hi,
                    const float* box, int nb, int box0, auto test) {
      float sbg = kBig, spos = kBig;
      int sgi = -1;
      for (int cs = lo; cs < hi; cs += kWalkChunk) {
        const int ce = min(hi, cs + kWalkChunk);
        const float head = so_k - tab[cs];
        if ((sgi >= 0 && head > sbg) || !(head < bg && head * bden < bar)) {
          break;
        }
        float tmin;
        if (!(so_k - tab[ce - 1] >= epsd) ||
            !meets_box(box, nb, box0 + (cs - lo) / kWalkChunk, rox, roy, roz,
                       inv_x, inv_y, inv_z, tmin)) {
          continue;
        }
#pragma unroll
        for (int j = 0; j < kWalkChunk; ++j) {
          const int c = min(cs + j, ce - 1);   // a short chunk repeats its last
          const float* col = tab + c;
          const float numr = so_k - col[0];
          const float orig = col[orig_row * n];
          int win;
          if (test(col, numr, win) &&
              (numr < sbg || (numr == sbg && orig < spos))) {
            sbg = numr; spos = orig; sgi = win;
          }
        }
      }
      if (sgi >= 0 && sbg < bg) { bg = sbg; gi = sgi; }
    };
    // a rect: alpha * detg and beta * detg from its corner and edges
    auto rect = [&](float Xm, float dm, float Xo, float d_o) {
      return [=, &q](const float* col, float numr, int& win) {
        const int n = q.n_aa;
        const float pug = (Xm - col[2 * n] * detg + numr * dm) * col[3 * n];
        const float pvg = (Xo - col[4 * n] * detg + numr * d_o) * col[5 * n];
        win = (int)(pug + pvg <= detg ? col[6 * n] : col[7 * n]);
        return detg >= col[n] && numr >= epsd && pug >= epsd && pvg >= epsd &&
               pug <= hid && pvg <= hid;
      };
    };
    walk(aa, q.n_aa, 8, r0, r0 + ca, aa_box, q.n_aa_box, rb0,
         rect(X1, d1, X2, d2));
    walk(aa, q.n_aa, 8, r0 + ca, r0 + ca + cb, aa_box, q.n_aa_box, rb1,
         rect(X2, d2, X1, d1));
    walk(aa3, q.n_aa3, 9, t0, t0 + ct, aa3_box, q.n_aa3_box, tb0,
         [=, &q](const float* col, float numr, int& win) {
           const int n3 = q.n_aa3;
           const float P1 = X1 - col[2 * n3] * detg + numr * d1;
           const float P2 = X2 - col[3 * n3] * detg + numr * d2;
           const float ug = P1 * col[4 * n3] + P2 * col[5 * n3];
           const float vg = P1 * col[6 * n3] + P2 * col[7 * n3];
           win = (int)col[8 * n3];
           return detg >= col[n3] && numr >= epsd && ug >= epsd &&
                  vg >= epsd && ug + vg <= hid;
         });
    // the bg < kBig gate keeps a group's miss out of the fraction compare
    if (bg < kBig && bg * bden < bar) {
      best = bg; bden = deng; bidx = ns + gi;
    }
  }

  // the general candidates: (det, t * det, u * det, v * det) as in
  // Moller-Trumbore without the division; u pairs with rows 6-8 (a
  // parallelogram's e2, a triangle's c - a), v with rows 3-5
  auto terms = [&](const float* col, int n, float& det, float& num,
                   float& pu, float& pv) {
    const float aox = rox - col[0], aoy = roy - col[n], aoz = roz - col[2 * n];
    const float daox = aoy * rdz - aoz * rdy;
    const float daoy = aoz * rdx - aox * rdz;
    const float daoz = aox * rdy - aoy * rdx;
    const float nx = col[9 * n], ny = col[10 * n], nz = col[11 * n];
    det = -(rdx * nx + rdy * ny + rdz * nz);
    num = aox * nx + aoy * ny + aoz * nz;
    pu = col[6 * n] * daox + col[7 * n] * daoy + col[8 * n] * daoz;
    pv = -(col[3 * n] * daox + col[4 * n] * daoy + col[5 * n] * daoz);
  };
  auto fold = [&](float num_c, float den_c, int t) {
    if (num_c * bden < best * den_c) { best = num_c; bden = den_c; bidx = ns + t; }
  };
  auto quad_test = [&](int c) {
    const int n = q.n_quad;
    const float* col = quad + c;
    float det, num, pu, pv;
    terms(col, n, det, num, pu, pv);
    const float lo = k.tri_eps * det, hi = q.hi_eps * det;
    const bool valid = det >= k.det_eps && num >= lo && pu >= lo && pv >= lo &&
                       pu <= hi && pv <= hi;
    // the winning half: triangle i spans alpha + beta <= 1
    fold(valid ? num : kBig, valid ? det : 1.0f,
         (int)(pu + pv <= det ? col[12 * n] : col[13 * n]));
  };
  auto left_test = [&](int c) {
    const int n = q.n_left;
    const float* col = left + c;
    float det, num, pu, pv;
    terms(col, n, det, num, pu, pv);
    const float lo = k.tri_eps * det;
    const bool valid = det >= k.det_eps && num >= lo && pu >= lo && pv >= lo &&
                       pu + pv <= q.hi_eps * det;
    fold(valid ? num : kBig, valid ? det : 1.0f, (int)col[12 * n]);
  };
  // every candidate in order, or past 2 chunks those of the chunks whose
  // box the ray enters before its running fraction
  auto loop = [&](int n, const float* boxes, auto test) {
    const int n_ch = (n + kChunk - 1) / kChunk;
    const bool culled = n > 2 * kChunk;
    for (int c = 0; c < n_ch; ++c) {
      float tmin;
      if (culled && (!slab(boxes, n_ch, c, rox, roy, roz, inv_x, inv_y,
                           inv_z, tmin) || !(tmin * bden < best))) {
        continue;
      }
      const int end = min(n, (c + 1) * kChunk);
      for (int j = c * kChunk; j < end; ++j) test(j);
    }
  };
  loop(q.n_quad, qbox, quad_test);
  loop(q.n_left, lbox, left_test);
  best = best / bden;   // the deferred division; a miss keeps kBig / 1
}

// The kernel's body: trace_scene_kernel instantiates it for the
// per-triangle search, trace_scene_kernel_merged for the merged one. The
// merged modes run one ray a thread on a grid of one block per kThreads
// rays. The per-triangle modes are persistent (the host launches as many
// blocks as fit on the card): each block stages its tables once, then
// each warp takes the launch counter's next 32 consecutive rays and runs
// the bounce loop while any lane's ray is in its loop, its lanes
// searching together (warp_search).
template <bool kRecord, bool kSky, bool kMerged>
__device__ __forceinline__ void
trace_scene_body(const float* __restrict__ sph_g,
                 const float* __restrict__ search_g,
                 const float* __restrict__ tri,
                 const float* __restrict__ box_g,
                 const float* __restrict__ mat_g,
                 const float* __restrict__ atlas,
                 const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const uint32_t* __restrict__ keys, float* __restrict__ out,
                 int* __restrict__ idx_out, float* __restrict__ aof_out,
                 int n_rays, Knobs k, Quads q) {
  // shared: tri search (T x 12, per-triangle mode) | spheres (14 x S) |
  // boxes (6 x C) | mats (9 x M) | merged mode: aa | aa3 | quad | qbox |
  // left | lbox | aa_box | aa3_box | gmin (6)
  extern __shared__ __align__(16) float smem[];
  const int ns = k.n_spheres, nt = k.n_tris, nm = k.n_mats;
  const int n_chunks = (nt + kChunk - 1) / kChunk;
  // the search channels: the (T, 12) table staged (per-triangle mode), or
  // read in global memory (merged mode)
  using Tri = typename std::conditional<kMerged, AoS, Staged>::type;
  Tri tri_s;
  if constexpr (kMerged) {
    tri_s = AoS{search_g};
  } else {
    tri_s = Staged{reinterpret_cast<const float4*>(smem)};
  }
  float* sph = kMerged ? smem : smem + kSearch * nt;
  float* box = sph + kSphRows * ns;
  float* mats = box + 6 * n_chunks;
  if (!kMerged) {
    for (int e = threadIdx.x; e < kSearch * nt; e += blockDim.x) smem[e] = search_g[e];
  }
  for (int e = threadIdx.x; e < kSphRows * ns; e += blockDim.x) sph[e] = sph_g[e];
  for (int e = threadIdx.x; e < 6 * n_chunks; e += blockDim.x) box[e] = box_g[e];
  for (int e = threadIdx.x; e < kMatRows * nm; e += blockDim.x) mats[e] = mat_g[e];
  float* aa = mats + kMatRows * nm;
  float* aa3 = aa + kAaRows * q.n_aa;
  float* quad = aa3 + kAa3Rows * q.n_aa3;
  float* qbox = quad + kQuadRows * q.n_quad;
  const int q_chunks = (q.n_quad + kChunk - 1) / kChunk;
  float* left = qbox + 6 * q_chunks;
  float* lbox = left + kLeftRows * q.n_left;
  const int l_chunks = (q.n_left + kChunk - 1) / kChunk;
  float* aa_box = lbox + 6 * l_chunks;
  float* aa3_box = aa_box + 6 * q.n_aa_box;
  float* gmin = aa3_box + 6 * q.n_aa3_box;
  if (kMerged) {
    auto stage = [](float* dst, const float* src, int n) {
      for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
    };
    stage(aa, q.aa, kAaRows * q.n_aa);
    stage(aa3, q.aa3, kAa3Rows * q.n_aa3);
    stage(quad, q.quad, kQuadRows * q.n_quad);
    stage(qbox, q.qbox, 6 * q_chunks);
    stage(left, q.left, kLeftRows * q.n_left);
    stage(lbox, q.lbox, 6 * l_chunks);
    stage(aa_box, q.aa_box, 6 * q.n_aa_box);
    stage(aa3_box, q.aa3_box, 6 * q.n_aa3_box);
  }
  __syncthreads();
  if (kMerged) {
    if (threadIdx.x < kGroups) {   // the least det_eps / u of each group
      const int g = threadIdx.x;
      int r0 = 0, t0 = 0;
      for (int h = 0; h < g; ++h) {
        r0 += q.layout[h][0] + q.layout[h][1];
        t0 += q.layout[h][2];
      }
      float m = __int_as_float(0x7f800000);   // +inf: an empty group is skipped
      for (int c = r0; c < r0 + q.layout[g][0] + q.layout[g][1]; ++c) {
        m = fminf(m, aa[q.n_aa + c]);
      }
      for (int c = t0; c < t0 + q.layout[g][2]; ++c) m = fminf(m, aa3[q.n_aa3 + c]);
      gmin[g] = m;
    }
    __syncthreads();
  }

  const size_t B = (size_t)n_rays;
  const size_t n_tex = (size_t)k.n_tex;
  // the state of the thread's ray
  int ray = 0;
  uint32_t k0 = 0u, k1 = 0u;   // the ray's threefry key
  float rox = 0.0f, roy = 0.0f, roz = 0.0f, rdx = 1.0f, rdy = 1.0f, rdz = 1.0f;
  float rcx, rcy, rcz;      // throughput
  float ix, iy, iz;         // incoming radiance
  float ax, ay, az;         // albedo AOV
  float nx, ny, nz;         // normal AOV
  bool active = false, is_alpha;
  int alpha_depth;
  float medium_n2;
  // the sky slot: scale, unit direction, early flag, taken flag
  float sklx, skly, sklz, skdx, skdy, skdz;
  bool early, slot;
  int i = 0;
  auto start = [&](int r) {
    ray = r;
    load_key(keys, B, ray, k0, k1);
    rox = ox[ray]; roy = oy[ray]; roz = oz[ray];
    rdx = dx[ray]; rdy = dy[ray]; rdz = dz[ray];
    rcx = 1.0f; rcy = 1.0f; rcz = 1.0f;
    ix = 0.0f; iy = 0.0f; iz = 0.0f;
    ax = 0.0f; ay = 0.0f; az = 0.0f;
    nx = 0.0f; ny = 0.0f; nz = 0.0f;
    active = true; is_alpha = false;
    alpha_depth = 0;
    medium_n2 = 1.0f;
    sklx = 0.0f; skly = 0.0f; sklz = 0.0f;
    skdx = 0.0f; skdy = 0.0f; skdz = 0.0f;
    early = false; slot = false;
    i = 0;
  };

  // one bounce of the ray; `go`: the ray is in its loop (merged modes:
  // always; per-triangle modes: a lane whose ray is not joins the warp's
  // search and returns)
  auto bounce = [&](bool go) {
    // ---- closest sphere: strict t < best in sphere order -------------
    const float a_quad = rdx * rdx + rdy * rdy + rdz * rdz;
    const float inv_2a = 0.5f / fmaxf(a_quad, 1e-20f);
    float best = kBig;
    int bidx = -1;
    for (int s = 0; s < (go ? ns : 0); ++s) {
      const float ocx = rox - sph[s], ocy = roy - sph[ns + s];
      const float ocz = roz - sph[2 * ns + s], r = sph[3 * ns + s];
      const float b_ = 2.0f * (ocx * rdx + ocy * rdy + ocz * rdz);
      const float c_ = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
      const float disc = b_ * b_ - 4.0f * a_quad * c_;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float t1 = (-b_ - sq) * inv_2a;
      const float t2 = (-b_ + sq) * inv_2a;
      const bool hit = disc > 0.0f;
      const float t = (hit && t1 >= k.sphere_eps) ? t1
                    : ((hit && t2 >= k.sphere_eps) ? t2 : kBig);
      if (t < best) { best = t; bidx = s; }
    }

    if constexpr (kMerged) {
      merged_search(aa, aa3, quad, qbox, left, lbox, aa_box, aa3_box, gmin,
                    q, k, rox, roy, roz, rdx, rdy, rdz, best, bidx);
    } else {
      // ---- triangles of the chunks the ray enters before its best ----
      warp_search(tri_s, box, n_chunks, threadIdx.x & 31, go, rox, roy, roz,
                  rdx, rdy, rdz, best, bidx, k);
    }
    if (!go) return;

    if (kRecord) idx_out[(size_t)i * B + ray] = bidx;

    // ---- winner: point, normal, material ------------------------------
    const bool did_hit = bidx >= 0;
    const bool tri_wins = bidx >= ns;
    const float safe_t = did_hit ? best : 0.0f;
    const float px = rox + rdx * safe_t;
    const float py = roy + rdy * safe_t;
    const float pz = roz + rdz * safe_t;
    float nX, nY, nZ, dfx, dfy, dfz, emx, emy, emz, estr, refl, alpha, ior;
    float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // a sphere winner's centre, radius
    if (!tri_wins) {
      // a sphere, or a miss, which reads an all-zero winner
      float w[kSphRows];
#pragma unroll
      for (int r = 0; r < kSphRows; ++r) w[r] = did_hit ? sph[r * ns + bidx] : 0.0f;
      if (kSky) { sc[0] = w[0]; sc[1] = w[1]; sc[2] = w[2]; sc[3] = w[3]; }
      const float svx = px - w[0], svy = py - w[1], svz = pz - w[2];
      const float n2 = svx * svx + svy * svy + svz * svz;
      const float inv = (n2 > 0.0f && did_hit) ? 1.0f / sqrtf(fmaxf(n2, 1e-38f)) : 0.0f;
      nX = svx * inv; nY = svy * inv; nZ = svz * inv;
      dfx = w[4]; dfy = w[5]; dfz = w[6];
      emx = w[7]; emy = w[8]; emz = w[9];
      estr = w[10]; refl = w[11]; alpha = w[12]; ior = w[13];
    } else {
      const int t = bidx - ns;
      const size_t T = (size_t)nt;
      float ws[kSearch];
      tri_s.load(t, ws);
      const float wax = ws[0], way = ws[1], waz = ws[2];
      float tnX = ws[9], tnY = ws[10], tnZ = ws[11];
      normalize3(tnX, tnY, tnZ);
      float wt[13];   // raw b3 c3, ua va ub vb uc vc, mat (rows 12-24)
#pragma unroll
      for (int r = 0; r < 13; ++r) wt[r] = tri[(12 + r) * T + t];
      // area-ratio barycentrics (texture.h:16-27) with the raw vertices
      auto area = [&](float p1x, float p1y, float p1z, float qx, float qy,
                      float qz) {
        const float cxx = p1y * qz - p1z * qy;
        const float cyy = p1z * qx - p1x * qz;
        const float czz = p1x * qy - p1y * qx;
        return tnX * cxx + tnY * cyy + tnZ * czz;
      };
      const float area_abc = area(wt[0] - wax, wt[1] - way, wt[2] - waz,
                                  wt[3] - wax, wt[4] - way, wt[5] - waz);
      const float area_pbc = area(wt[0] - px, wt[1] - py, wt[2] - pz,
                                  wt[3] - px, wt[4] - py, wt[5] - pz);
      const float area_pca = area(wt[3] - px, wt[4] - py, wt[5] - pz,
                                  wax - px, way - py, waz - pz);
      const float inv_area = 1.0f / (fabsf(area_abc) > 1e-20f ? area_abc : 1.0f);
      const float w_a = area_pbc * inv_area;
      const float w_b = area_pca * inv_area;
      const float w_c = 1.0f - w_a - w_b;
      float uu = w_a * wt[6] + w_b * wt[8] + w_c * wt[10];
      float vv = w_a * wt[7] + w_b * wt[9] + w_c * wt[11];
      uu = uu - truncf(uu);     // fmod(u, 1), exactly
      uu = uu < 0.0f ? uu + 1.0f : uu;
      vv = vv - truncf(vv);
      vv = vv < 0.0f ? vv + 1.0f : vv;
      const int mat = (int)wt[12];

      // nearest texel (texture.h:61-69); outside the atlas reads zeros
      float tr, tg, tb, ta;
      if (n_tex > 0) {
        const int w = k.atlas_w, h = k.atlas_h;
        const int tx = min(max((int)floorf(uu * (float)w), 0), w - 1);
        const int ty = min(max((int)floorf(vv * (float)h), 0), h - 1);
        const long long idx = (long long)(ty * w + tx) + (long long)h * w * mat;
        const bool in = idx >= 0 && idx < (long long)n_tex;
        tr = in ? atlas[idx] : 0.0f;
        tg = in ? atlas[n_tex + idx] : 0.0f;
        tb = in ? atlas[2 * n_tex + idx] : 0.0f;
        ta = in ? atlas[3 * n_tex + idx] : 0.0f;
      } else {            // untextured mesh: mesh.h:207's default material
        tr = 0.784f; tg = 0.965f; tb = 1.0f; ta = 1.0f;
      }
      // material table (texture.h:71-88 as data); outside it reads zeros
      float mt[kMatRows];
#pragma unroll
      for (int r = 0; r < kMatRows; ++r) {
        mt[r] = (mat >= 0 && mat < nm) ? mats[r * nm + mat] : 0.0f;
      }
      const bool eft = mt[8] > 0.0f;
      nX = tnX; nY = tnY; nZ = tnZ;
      dfx = tr; dfy = tg; dfz = tb;
      emx = eft ? mt[0] * tr : mt[0];
      emy = eft ? mt[1] * tg : mt[1];
      emz = eft ? mt[2] * tb : mt[2];
      estr = mt[3]; refl = mt[4]; ior = mt[5];
      alpha = mt[7] > 0.0f ? mt[6] : ta;
    }
    // the sky sphere's emission is its texel, added outside the kernel
    const bool sky_win = kSky && did_hit && bidx == k.sky_idx;
    if (sky_win) { emx = 0.0f; emy = 0.0f; emz = 0.0f; }

    // ---- AOV base cases -------------------------------------------------
    if (i == 0) {
      ax = dfx; ay = dfy; az = dfz;
      nx = nX; ny = nY; nz = nZ;
    } else {
      const bool aov_alpha = i == alpha_depth && is_alpha;
      if (aov_alpha) {
        const bool em = estr > 0.0f;
        ax = em ? emx : dfx; ay = em ? emy : dfy; az = em ? emz : dfz;
        nx = nX; ny = nY; nz = nZ;
      }
      is_alpha = is_alpha && !aov_alpha;
    }

    // ---- emissive early return + HSL boost ------------------------------
    const bool emissive_ret = did_hit && i == alpha_depth && estr > 0.0f;
    if (emissive_ret) {
      float bx = emx, by = emy, bz = emz;
      if (k.hsl_on) hsl_boost(bx, by, bz, k.hsl_l, k.hsl_s);
      ix = bx; iy = by; iz = bz;
      ax = bx; ay = by; az = bz;
      nx = nX; ny = nY; nz = nZ;
    }
    active = !emissive_ret;
    const bool live = active && did_hit;

    // ---- the bounce's draws, hashed where read (one copy of the hash,
    // called: csrc/threefry.cuh) -----------------------------------------
    const CalledDraws draws = called_draws(k0, k1, i, k.n_draws);
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

    // ---- AO factor: for the rays that accumulate, and for every ray in
    // its loop when recording ---------------------------------------------
    const bool accum = live && !do_refract && !cutout;
    float factor = 0.0f;
    if (k.use_ao && (accum || kRecord)) {
      factor = ao_factor(sph, tri_s, box, n_chunks, px, py, pz, nX, nY, nZ,
                         draws, k);
      if (kRecord) aof_out[(size_t)i * B + ray] = factor;
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
      const float r_safe = sc[3] > 0.0f ? sc[3] : 1.0f;   // a sky win is a sphere's
      skdx = (px - sc[0]) / r_safe;
      skdy = (py - sc[1]) / r_safe;
      skdz = (pz - sc[2]) / r_safe;
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
    ++i;
  };

  auto finish = [&]() {
    for (; kRecord && i < k.bounces; ++i) {   // skip_body
      idx_out[(size_t)i * B + ray] = -1;
      if (k.use_ao) aof_out[(size_t)i * B + ray] = 0.0f;
    }
    out[0 * B + ray] = ix; out[1 * B + ray] = iy; out[2 * B + ray] = iz;
    out[3 * B + ray] = ax; out[4 * B + ray] = ay; out[5 * B + ray] = az;
    out[6 * B + ray] = nx; out[7 * B + ray] = ny; out[8 * B + ray] = nz;
    if (kSky) {
      out[9 * B + ray] = sklx; out[10 * B + ray] = skly; out[11 * B + ray] = sklz;
      out[12 * B + ray] = skdx; out[13 * B + ray] = skdy; out[14 * B + ray] = skdz;
      out[15 * B + ray] = early ? 1.0f : 0.0f;
    }
  };

  if constexpr (kMerged) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rays) return;
    start(r);
    while (i < k.bounces && active) bounce(true);
    finish();
  } else {
    // 32 consecutive rays a warp: the counter's next group
    const int lane = threadIdx.x & 31;
    const int n_groups = (n_rays + 31) >> 5;
    auto next_group = [&]() {
      unsigned v = 0u;
      if (lane == 0) v = atomicAdd(&g_next, 1u);
      return (int)__shfl_sync(0xffffffffu, v, 0);
    };
    for (int g = next_group(); g < n_groups; g = next_group()) {
      const int r = g * 32 + lane;
      const bool has = r < n_rays;
      if (has) start(r); else active = false;
      for (;;) {
        const bool go = has && i < k.bounces && active;
        if (!__any_sync(0xffffffffu, go)) break;
        bounce(go);
      }
      if (has) finish();
    }
  }
}

#define TRACE_SCENE_PARAMS                                                    \
  const float *__restrict__ sph_g, const float *__restrict__ search_g,        \
      const float *__restrict__ tri, const float *__restrict__ box_g,         \
      const float *__restrict__ mat_g, const float *__restrict__ atlas,       \
      const float *__restrict__ ox, const float *__restrict__ oy,             \
      const float *__restrict__ oz, const float *__restrict__ dx,             \
      const float *__restrict__ dy, const float *__restrict__ dz,             \
      const uint32_t *__restrict__ keys, float *__restrict__ out,             \
      int *__restrict__ idx_out, float *__restrict__ aof_out, int n_rays,     \
      Knobs k, Quads q
#define TRACE_SCENE_ARGS                                                      \
  sph_g, search_g, tri, box_g, mat_g, atlas, ox, oy, oz, dx, dy, dz, keys,   \
      out, idx_out, aof_out, n_rays, k, q

template <bool kRecord, bool kSky>
__global__ void __launch_bounds__(kThreads)
trace_scene_kernel(TRACE_SCENE_PARAMS) {
  trace_scene_body<kRecord, kSky, false>(TRACE_SCENE_ARGS);
}

// the merged search held to 4 blocks an SM (64 registers; its spills cost
// less than the occupancy they buy: PERF.md, 1.20 against 1.45 ms
// unbounded and 1.23 at 3 blocks)
constexpr int kMergedMinBlocks = 4;

template <bool kRecord, bool kSky>
__global__ void __launch_bounds__(kThreads, kMergedMinBlocks)
trace_scene_kernel_merged(TRACE_SCENE_PARAMS) {
  trace_scene_body<kRecord, kSky, true>(TRACE_SCENE_ARGS);
}

}  // namespace

// Plain C entry point, bound with ctypes. All pointers are device
// pointers to contiguous f32 but `layout`: sph (14, n_spheres); search
// (n_tris, 12); tri (25, n_tris); boxes (6, ceil(n_tris / 32)); mats
// (9, n_mats); atlas (4, n_tex), unread when n_tex is 0; ox..dz (n_rays,);
// keys (2, n_rays) uint32, each ray's threefry key
// (raytpu_torch/core/rng.py: sample_stream), whose draw 4 + b * n_draws
// + j is draw j of bounce b; out (9, n_rays), or (16, n_rays) with
// the sky slot of sphere sky_idx (-1: no sky); coop_min, 1 to 33, the
// per-triangle search's Knobs::coop_min. Recording mode when
// idx_out is not null: idx_out (bounces, n_rays) i32 winners and, with
// use_ao, aof_out (bounces, n_rays) f32 AO factors (else null). The
// merged search when `layout`, a host array of 6 x 3 ints (per (axis,
// sign) group: rects with m = 0, with m = 1, unpaired triangles), is not
// null: aa (9, n_aa), aa3 (10, n_aa3), quad (14, n_quad), qbox
// (6, ceil(n_quad / 32)), left (13, n_left), lbox (6, ceil(n_left /
// 32)), aa_box and aa3_box (6, the sub-lists' ceil(n / kWalkChunk)
// summed) are trace_scene.py's walk_tables / pack_quads tables, hi_eps
// is 1 - tri_eps. Sets the kernel's dynamic shared memory (up to ~105 KB
// at 2048 triangles, above the 48 KB default); the per-triangle search's
// grid is as many blocks as fit on the card (the occupancy API), its ray
// counter zeroed on `stream` first. Launches on `stream` without
// synchronising and returns the first failing call's cudaError_t.
extern "C" int raytpu_trace_scene(
    const float* sph, const float* search, const float* tri,
    const float* boxes, const float* mats, const float* atlas,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const uint32_t* keys, float* out,
    int* idx_out, float* aof_out, int n_rays, int n_spheres, int n_tris, int n_mats, int n_tex,
    int atlas_w, int atlas_h, int bounces, int n_draws, float sphere_eps,
    float det_eps, float tri_eps, float alpha_lo, float alpha_hi,
    float bright_boost, float bright_threshold, int use_ao, int ao_samples,
    float ao_e_scale, float ao_inv, int hsl_on, float hsl_l, float hsl_s,
    int sky_idx, int coop_min, const float* aa, const float* aa3,
    const float* quad, const float* qbox, const float* left, const float* lbox,
    const float* aa_box, const float* aa3_box, int n_aa, int n_aa3,
    int n_quad, int n_left, const int* layout, float hi_eps, void* stream) {
  if (n_spheres < 0 || n_spheres > kMaxSpheres || n_tris < 1 ||
      sky_idx < -1 || sky_idx >= n_spheres || coop_min < 1 ||
      coop_min > 33 || n_tris > kMaxTris || n_mats < 0 ||
      n_mats > kMaxMats || n_tex < 0 ||
      (n_tex > 0 && (atlas == nullptr || atlas_w < 1 || atlas_h < 1)) ||
      n_rays < 0 || bounces < 0 || keys == nullptr ||
      n_draws < 3 + (use_ao ? 2 * ao_samples : 0) ||
      (idx_out != nullptr && use_ao && aof_out == nullptr) ||
      (aof_out != nullptr && (idx_out == nullptr || !use_ao))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool merged = layout != nullptr;
  Quads q{aa, aa3, quad, qbox, left, lbox, aa_box, aa3_box, n_aa, n_aa3,
          n_quad, n_left, 0, 0, {}, hi_eps};
  if (merged) {
    int rects = 0, tris = 0;
    for (int g = 0; g < kGroups; ++g) {
      for (int j = 0; j < 3; ++j) {
        const int n = layout[3 * g + j];
        if (n < 0) return (int)cudaErrorInvalidValue;
        q.layout[g][j] = n;
        (j < 2 ? q.n_aa_box : q.n_aa3_box) += (n + kWalkChunk - 1) / kWalkChunk;
      }
      rects += layout[3 * g] + layout[3 * g + 1];
      tris += layout[3 * g + 2];
    }
    if (rects != n_aa || tris != n_aa3 || n_quad < 0 || n_left < 0 ||
        2 * (n_aa + n_quad) + n_aa3 + n_left != n_tris) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (n_rays == 0) return (int)cudaSuccess;
  Knobs k{n_spheres, n_tris, n_mats, n_tex, atlas_w, atlas_h, bounces,
          n_draws, sphere_eps, det_eps, tri_eps, alpha_lo, alpha_hi,
          bright_boost, bright_threshold, use_ao, ao_samples, ao_e_scale,
          ao_inv, hsl_on, hsl_l, hsl_s, sky_idx, coop_min};
  const int n_chunks = (n_tris + kChunk - 1) / kChunk;
  size_t floats = (size_t)kSphRows * n_spheres + 6 * (size_t)n_chunks +
                  (size_t)kMatRows * n_mats;
  if (merged) {
    floats += (size_t)kAaRows * n_aa + (size_t)kAa3Rows * n_aa3 +
              (size_t)kQuadRows * n_quad + 6 * (size_t)((n_quad + kChunk - 1) / kChunk) +
              (size_t)kLeftRows * n_left + 6 * (size_t)((n_left + kChunk - 1) / kChunk) +
              6 * (size_t)(q.n_aa_box + q.n_aa3_box) + kGroups;
  } else {
    floats += (size_t)kSearch * n_tris;
  }
  const size_t smem = sizeof(float) * floats;
  const bool record = idx_out != nullptr, sky = sky_idx >= 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto kernel =
      merged ? (record ? (sky ? trace_scene_kernel_merged<true, true>
                              : trace_scene_kernel_merged<true, false>)
                       : (sky ? trace_scene_kernel_merged<false, true>
                              : trace_scene_kernel_merged<false, false>))
             : (record ? (sky ? trace_scene_kernel<true, true>
                              : trace_scene_kernel<true, false>)
                       : (sky ? trace_scene_kernel<false, true>
                              : trace_scene_kernel<false, false>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n_rays + kThreads - 1) / kThreads;
  if (!merged) {   // as many blocks as fit on the card, the counter zeroed
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
      return (int)err;
    }
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = blocks < sms * per_sm ? blocks : sms * per_sm;
    void* next = nullptr;
    if ((err = cudaGetSymbolAddress(&next, g_next)) != cudaSuccess ||
        (err = cudaMemsetAsync(next, 0, sizeof(unsigned int), st)) != cudaSuccess) {
      return (int)err;
    }
  }
  kernel<<<blocks, kThreads, smem, st>>>(
      sph, search, tri, boxes, mats, atlas, ox, oy, oz, dx, dy, dz, keys,
      out, idx_out, aof_out, n_rays, k, q);
  return (int)cudaGetLastError();
}

// An instantiation's attributes as the CUDA runtime reports them (the merged or
// the per-triangle search, recording, sky): out[0..3] = registers a
// thread, local (stack and spill) bytes a thread, static shared bytes,
// and the dynamic shared bytes its last launch set. Returns the
// cudaError_t of the query.
extern "C" int raytpu_trace_scene_attrs(int merged, int record, int sky,
                                        int* out) {
  const auto kernel =
      merged ? (record ? (sky ? trace_scene_kernel_merged<true, true>
                              : trace_scene_kernel_merged<true, false>)
                       : (sky ? trace_scene_kernel_merged<false, true>
                              : trace_scene_kernel_merged<false, false>))
             : (record ? (sky ? trace_scene_kernel<true, true>
                              : trace_scene_kernel<true, false>)
                       : (sky ? trace_scene_kernel<false, true>
                              : trace_scene_kernel<false, false>));
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxDynamicSharedSizeBytes;
  return (int)cudaSuccess;
}
