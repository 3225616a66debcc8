// K1's sphere search and AO probes, shared by K1 (csrc/trace_spheres.cu)
// and K5 (csrc/trace_spheres_bwd.cu), so that K5 finds the winners and AO
// factors K1's recording mode writes, bit for bit (chip_smoke.py holds K5
// against K2 on K1's recording). raytpu's forms: 0.5 / max(a, 1e-20) root
// scale, the 1e-30 discriminant floor, a strict t < best in sphere order,
// 1/sqrtf rather than rsqrtf. The sphere table's rows cx, cy, cz, r are
// passed as one float4 a sphere (geo, n_spheres entries in shared memory),
// so each sphere test is one 16-byte broadcast load.

#pragma once

#include <cuda_runtime.h>

namespace {

// geo[s] = (cx, cy, cz, r) of sphere s from the (14, ns) table, for
// threads tid, tid + nt, ... of the block (the caller synchronises).
__device__ __forceinline__ void load_geo(float4* geo, const float* sph,
                                         int ns, int tid, int nt) {
  for (int s = tid; s < ns; s += nt) {
    geo[s] = make_float4(sph[s], sph[ns + s], sph[2 * ns + s], sph[3 * ns + s]);
  }
}

// The closest sphere hit at t >= eps along o + t d: its index, or -1 for a
// miss, with its distance in best (3e38 for a miss).
__device__ __forceinline__ int closest_sphere(
    const float4* geo, int ns, float rox, float roy, float roz, float rdx,
    float rdy, float rdz, float eps, float& best) {
  const float a_quad = rdx * rdx + rdy * rdy + rdz * rdz;
  const float inv_2a = 0.5f / fmaxf(a_quad, 1e-20f);
  best = 3.0e38f;
  int bidx = -1;
  for (int s = 0; s < ns; ++s) {
    const float4 g = geo[s];
    const float ocx = rox - g.x, ocy = roy - g.y, ocz = roz - g.z;
    const float b_ = 2.0f * (ocx * rdx + ocy * rdy + ocz * rdz);
    const float c_ = ocx * ocx + ocy * ocy + ocz * ocz - g.w * g.w;
    const float disc = b_ * b_ - 4.0f * a_quad * c_;
    const float sq = sqrtf(fmaxf(disc, 1e-30f));
    const float t1 = (-b_ - sq) * inv_2a;
    const float t2 = (-b_ + sq) * inv_2a;
    const bool hit = disc > 0.0f;
    const float t = (hit && t1 >= eps) ? t1
                  : ((hit && t2 >= eps) ? t2 : 3.0e38f);
    if (t < best) { best = t; bidx = s; }
  }
  return bidx;
}

// Ambient occlusion (main.c:94-116): `samples` hemisphere probes about the
// normal n from the hit point p, each occluded by any sphere root at
// t >= eps; occluded probes * inv (1 / (ao_samples * ao_intensity)).
// draws(j) is the bounce's draw j (csrc/threefry.cuh's KeyDraws): the probe
// a's u, v are draws 3 + 2a and 4 + 2a.
template <class Draws>
__device__ float sphere_ao(const float4* geo, int ns, float px, float py,
                           float pz, float nX, float nY, float nZ,
                           const Draws& draws, int samples, float eps,
                           float inv) {
  const float two_pi = 2.0f * 3.14159265358979323846f;   // 2 * f32(pi)
  float occ = 0.0f;
  for (int a = 0; a < samples; ++a) {
    const float au = draws(3 + 2 * a), av = draws(4 + 2 * a);
    const float ath = two_pi * au;
    const float acp = fminf(fmaxf(2.0f * av - 1.0f, -1.0f), 1.0f);
    const float asp = sqrtf(fmaxf(1.0f - acp * acp, 0.0f));
    float aox = nX + cosf(ath) * asp;
    float aoy = nY + sinf(ath) * asp;
    float aoz = nZ + acp;
    const float an2 = aox * aox + aoy * aoy + aoz * aoz;
    const float ainv = an2 > 0.0f ? 1.0f / sqrtf(fmaxf(an2, 1e-38f)) : 0.0f;
    aox *= ainv; aoy *= ainv; aoz *= ainv;
    const float aq = aox * aox + aoy * aoy + aoz * aoz;
    const float ai2a = 0.5f / fmaxf(aq, 1e-20f);
    bool occ_hit = false;
    for (int s = 0; s < ns && !occ_hit; ++s) {
      const float4 g = geo[s];
      const float ocx = px - g.x, ocy = py - g.y, ocz = pz - g.z;
      const float b2 = 2.0f * (ocx * aox + ocy * aoy + ocz * aoz);
      const float c2 = ocx * ocx + ocy * ocy + ocz * ocz - g.w * g.w;
      const float d2 = b2 * b2 - 4.0f * aq * c2;
      const float sq2 = sqrtf(fmaxf(d2, 1e-30f));
      const float tt1 = (-b2 - sq2) * ai2a;
      const float tt2 = (-b2 + sq2) * ai2a;
      occ_hit = d2 > 0.0f && (tt1 >= eps || tt2 >= eps);
    }
    occ = occ + (occ_hit ? 1.0f : 0.0f);
  }
  return occ * inv;
}

}  // namespace
