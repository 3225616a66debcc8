// The index-replay backward's per-ray pieces, shared by K2
// (csrc/trace_scene_bwd.cu) and K5 (csrc/trace_spheres_bwd.cu): the
// carry and cotangent records, the winner's surface (sphere or triangle)
// and the shading with their hand-derived adjoints (replay_bounce: one
// bounce forward, or its reverse step), the sphere kernels' deterministic
// table sums (grouped by winner within each warp, warp_table_sum) with the
// fixed-order sum over blocks (sum_blocks_kernel), and their shared-memory
// layout.
// csrc/trace_scene_bwd.cu's header says what each computes and why; a
// source that includes this file is rebuilt when it changes
// (raytpu_torch/kernels/_build.py hashes the headers a source includes).

#pragma once

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kMaxBounces = 48;   // MAX_BOUNCES in trace_scene_bwd.py
constexpr int kMaxSpheres = 64;
constexpr int kMaxTris = 2048;
constexpr int kMaxMats = 64;
constexpr int kRows = 14;         // cx cy cz r | dif3 emi3 estr refl alpha ior
constexpr int kTriRows = 25;      // a3 ab3 ac3 n3 b3 c3 ua va ub vb uc vc mat
constexpr int kMatRows = 9;       // emi3 estr refl ior alpha_c use_c eft
constexpr int kReduceThreads = 256;
constexpr int kSphereThreads = 128;   // K2's sphere mode and K5: one block size
// blocks an SM holds of K2's sphere-mode and K5's kernels: 5 caps them at
// 96 registers (a few spills) against 120-125 unbounded (4 blocks), faster
// on the Cornell sample; 6 (80 registers) spills more and is slower
// (PERF.md, kernel_variants.py)
constexpr int kSphereMinBlocks = 5;
constexpr int kStagePitch = 33;    // a warp's staged cotangent row: 32 lanes + 1
// a warp's staging in the sphere kernels: 14 rows, then the table of its
// lane groups (winner, first column, lanes) for warp_table_sum
constexpr int kWarpStage = kRows * kStagePitch + 3 * 32;
constexpr float kBig = 3.0e38f;
constexpr float kTwoPi = 2.0f * 3.14159265358979323846f;  // 2 * f32(pi)

struct Knobs {
  int n_spheres, n_tris, n_mats, n_tex, atlas_w, atlas_h, bounces, n_draws;
  float sphere_eps, det_eps, tri_eps, alpha_lo, alpha_hi, bright_boost,
      bright_threshold;
  int use_ao;
  float e_scale_mult;
  int hsl_on;
  float hsl_l, hsl_s;
  int sky_idx;
};

// The carry a reverse step needs; radiance and AOV sums are never read.
// slot: the ray's sky slot is taken (the sky modes only).
struct Carry {
  float o[3], d[3], rc[3], med;
  bool active, is_alpha, slot;
  int depth;
};

// Cotangents of the differentiable carry planes; skl, the sky slot's
// scale, in the sky modes only.
struct Cot {
  float o[3], d[3], rc[3], inc[3], alb[3], nrm[3], skl[3];
};

// The branches a bounce took that the sky slot reads.
struct Masks {
  bool emissive_ret, accum;
};

// The winner's surface at one bounce: what shade reads.
struct Surf {
  bool did_hit;
  float safe_t, p[3], n[3], df[3], em[3], estr, refl, alpha, ior;
};

// Cotangents of the surface (alpha enters only comparisons).
struct SurfCot {
  float p[3], n[3], df[3], em[3], estr, refl, ior;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float safe_denom(float x) {
  return fabsf(x) > 1e-30f ? x : 1e-30f;
}

// Weights of torch.maximum / torch.minimum's backward: a tie splits the
// cotangent in halves (as JAX's max does).
__device__ __forceinline__ void tie_weights(float a, float b, bool is_max,
                                            float& wa, float& wb) {
  if (a == b) { wa = wb = 0.5f; return; }
  const bool a_wins = is_max ? (a > b) : (a < b);
  wa = a_wins ? 1.0f : 0.0f;
  wb = a_wins ? 0.0f : 1.0f;
}

// Reverse of hue_to_rgb: adds d(out)/d(t1, t2, hue) * gout.
__device__ void hue_to_rgb_bwd(float t1, float t2, float hue, float gout,
                               float& gt1, float& gt2, float& ghue) {
  hue = hue < 0.0f ? hue + 1.0f : hue;   // the wraps pass the cotangent on
  hue = hue > 1.0f ? hue - 1.0f : hue;
  if (6.0f * hue < 1.0f) {               // t1 + ((t2 - t1) * 6) * hue
    gt1 += gout;
    const float gdiff = gout * hue * 6.0f;
    gt2 += gdiff; gt1 -= gdiff;
    ghue += gout * ((t2 - t1) * 6.0f);
  } else if (2.0f * hue < 1.0f) {        // t2
    gt2 += gout;
  } else if (3.0f * hue < 2.0f) {        // t1 + ((t2 - t1) * (2/3 - hue)) * 6
    gt1 += gout;
    const float gp = gout * 6.0f;
    const float gdiff = gp * ((float)(2.0 / 3.0) - hue);
    gt2 += gdiff; gt1 -= gdiff;
    ghue -= gp * (t2 - t1);
  } else {                               // t1
    gt1 += gout;
  }
}

// Reverse of raytpu/core/color.py:hsl_boost (rgb -> hsl, scale s and l,
// hsl -> rgb) at (r, g, b): adds d(boost)/d(rgb)^T gout to grgb.
__device__ void hsl_boost_bwd(float r, float g, float b, float l_f, float s_f,
                              const float* gout, float* grgb) {
  // ---- forward, rgb_to_hsl -------------------------------------------
  const float inner_max = fmaxf(g, b), inner_min = fminf(g, b);
  const float cmax = fmaxf(r, inner_max), cmin = fminf(r, inner_min);
  const float l = (cmax + cmin) * 0.5f;
  const float d = cmax - cmin;
  const bool gray = cmax == cmin;
  const float den_lo = safe_denom(cmax + cmin);
  const float den_hi = safe_denom(2.0f - cmax - cmin);
  const float s = gray ? 0.0f : (l < 0.5f ? d / den_lo : d / den_hi);
  const float d_safe = safe_denom(d);
  const int hsel = cmax == r ? 0 : (cmax == g ? 1 : 2);
  const float h_r = (g - b) / d_safe + (g < b ? 6.0f : 0.0f);
  const float h_g = (b - r) / d_safe + 2.0f;
  const float h_b = (r - g) / d_safe + 4.0f;
  const float h = gray ? 0.0f : (hsel == 0 ? h_r : (hsel == 1 ? h_g : h_b)) / 6.0f;
  const float s2 = s * s_f, l2 = l * l_f;
  const float t2 = l2 < 0.5f ? l2 * (1.0f + s2) : l2 + s2 - l2 * s2;
  const float t1 = 2.0f * l2 - t2;
  const float third = (float)(1.0 / 3.0);

  // ---- reverse, hsl_to_rgb ----------------------------------------------
  float gl2 = 0.0f, gs2 = 0.0f, gh = 0.0f;
  if (s2 == 0.0f) {
    gl2 = gout[0] + gout[1] + gout[2];
  } else {
    float gt1 = 0.0f, gt2 = 0.0f;
    hue_to_rgb_bwd(t1, t2, h + third, gout[0], gt1, gt2, gh);
    hue_to_rgb_bwd(t1, t2, h, gout[1], gt1, gt2, gh);
    hue_to_rgb_bwd(t1, t2, h - third, gout[2], gt1, gt2, gh);
    gl2 += 2.0f * gt1;
    gt2 -= gt1;
    if (l2 < 0.5f) {
      gl2 += gt2 * (1.0f + s2);
      gs2 += gt2 * l2;
    } else {
      gl2 += gt2 - gt2 * s2;
      gs2 += gt2 - gt2 * l2;
    }
  }
  const float gl = gl2 * l_f, gs = gs2 * s_f;

  // ---- reverse, rgb_to_hsl ----------------------------------------------
  float gr = 0.0f, gg = 0.0f, gb = 0.0f, gcmax = 0.0f, gcmin = 0.0f, gd = 0.0f;
  if (!gray) {
    const float ghs = gh / 6.0f;
    float gds = 0.0f;
    if (hsel == 0) {
      gg += ghs / d_safe; gb -= ghs / d_safe;
      gds -= ghs * ((g - b) / d_safe) / d_safe;
    } else if (hsel == 1) {
      gb += ghs / d_safe; gr -= ghs / d_safe;
      gds -= ghs * ((b - r) / d_safe) / d_safe;
    } else {
      gr += ghs / d_safe; gg -= ghs / d_safe;
      gds -= ghs * ((r - g) / d_safe) / d_safe;
    }
    if (fabsf(d) > 1e-30f) gd += gds;
    if (l < 0.5f) {
      gd += gs / den_lo;
      const float gden = -gs * (d / den_lo) / den_lo;
      if (fabsf(cmax + cmin) > 1e-30f) { gcmax += gden; gcmin += gden; }
    } else {
      gd += gs / den_hi;
      const float gden = -gs * (d / den_hi) / den_hi;
      if (fabsf(2.0f - cmax - cmin) > 1e-30f) { gcmax -= gden; gcmin -= gden; }
    }
  }
  gcmax += gd; gcmin -= gd;
  gcmax += gl * 0.5f; gcmin += gl * 0.5f;
  float wa, wb, wg, wbb;
  tie_weights(r, inner_max, true, wa, wb);        // cmax = max(r, max(g, b))
  tie_weights(g, b, true, wg, wbb);
  gr += gcmax * wa; gg += gcmax * wb * wg; gb += gcmax * wb * wbb;
  tie_weights(r, inner_min, false, wa, wb);       // cmin = min(r, min(g, b))
  tie_weights(g, b, false, wg, wbb);
  gr += gcmin * wa; gg += gcmin * wb * wg; gb += gcmin * wb * wbb;
  grgb[0] += gr; grgb[1] += gg; grgb[2] += gb;
}

// One replayed bounce's shading (shade_bounce of the plain version) at
// the winner's surface s, with the bounce's draws(0..2) (csrc/threefry.cuh's
// KeyDraws hashes each where it is read: the scatter's two only where the
// ray scatters, the roulette only where the material can refract).
// g == nullptr: forward; c becomes the carry after the bounce.
// g != nullptr: reverse; c is the carry before the bounce, *g holds the
// cotangent of the carry after it. On return g->rc, inc, alb and nrm hold
// the cotangents before it, gs the cotangent of the surface, and go / gd
// the cotangent of the origin and direction by every route but the
// surface's own dependence on them (g->o and g->d are left to the caller).
// Both return the bounce's emissive-return and accumulation masks.
template <class Draws>
__device__ __forceinline__ Masks shade(int i, Carry& c, const Surf& s,
                                      const Draws& draws, float aof,
                                      const Knobs& k, Cot* g, SurfCot* gs,
                                      float* go, float* gd) {
  const float* d = c.d;
  const float* n = s.n;
  const float* df = s.df;
  const float* em = s.em;
  const float estr = s.estr, refl = s.refl, alpha = s.alpha, ior = s.ior;
  const bool did_hit = s.did_hit;

  // ---- masks -------------------------------------------------------------
  const bool active = c.active;
  const bool at_depth = c.depth == i;
  const bool aov_alpha = i > 0 && active && at_depth && c.is_alpha;
  const bool emissive_ret = active && did_hit && at_depth && estr > 0.0f;
  const bool live = active && !emissive_ret && did_hit;

  const float vdn = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];

  // ---- refraction ---------------------------------------------------------
  const bool refr_case = live && alpha <= k.alpha_hi && alpha >= k.alpha_lo;
  const bool exiting = vdn > 0.0f;
  const bool do_refract = refr_case && draws(2) > alpha;   // the roulette
  const float sgn = exiting ? -1.0f : 1.0f;
  const float ne[3] = {sgn * n[0], sgn * n[1], sgn * n[2]};
  const float n1 = exiting ? ior : c.med;
  const float n2 = exiting ? c.med : ior;
  const float n1s = n1 * n1, n2s_ = n2 * n2;
  const float n2s_safe = n2s_ > 1e-20f ? n2s_ : 1.0f;
  const float q = n1s / n2s_safe;
  const float ratio = clampf(q, 0.0f, 1e6f);
  const float ndotv = ne[0] * d[0] + ne[1] * d[1] + ne[2] * d[2];
  const float radical = 1.0f - (ratio * ratio) * (1.0f - ndotv * ndotv);
  const bool tir = radical <= 0.0f;
  const float sqr = sqrtf(fmaxf(radical, 1e-20f));
  float wv[3];
  for (int j = 0; j < 3; ++j) wv[j] = d[j] - ne[j] * ndotv;

  const bool cutout = live && alpha < k.alpha_lo;
  const bool opaque = live && alpha > k.alpha_hi;
  const bool accum = live && !do_refract && !cutout;

  // ---- scatter, for a ray that scatters -------------------------------------
  float ddr[3] = {0, 0, 0}, dd[3] = {0, 0, 0}, rf[3], tdr[3];
  float dn2 = 0.0f, dinv = 0.0f;
  if (accum) {
    const float theta = kTwoPi * draws(0);
    const float cph = clampf(2.0f * draws(1) - 1.0f, -1.0f, 1.0f);
    const float sph_ = sqrtf(fmaxf(1.0f - cph * cph, 0.0f));
    ddr[0] = n[0] + cosf(theta) * sph_;
    ddr[1] = n[1] + sinf(theta) * sph_;
    ddr[2] = n[2] + cph;
    dn2 = ddr[0] * ddr[0] + ddr[1] * ddr[1] + ddr[2] * ddr[2];
    dinv = dn2 > 0.0f ? 1.0f / sqrtf(fmaxf(dn2, 1e-38f)) : 0.0f;
    for (int j = 0; j < 3; ++j) dd[j] = ddr[j] * dinv;
  }
  for (int j = 0; j < 3; ++j) {
    rf[j] = d[j] - 2.0f * vdn * n[j];
    tdr[j] = rf[j] - dd[j];
  }
  const float th = k.bright_threshold, bb = k.bright_boost;
  const bool bright = c.rc[0] > th || c.rc[1] > th || c.rc[2] > th;
  const float e_scale = estr * k.e_scale_mult;

  if (g == nullptr) {
    // ---- forward: the next carry ---------------------------------------
    float nd[3];
    for (int j = 0; j < 3; ++j) {
      if (do_refract) {
        nd[j] = tir ? d[j] - 2.0f * ndotv * ne[j] : wv[j] * ratio - ne[j] * sqr;
      } else {
        nd[j] = accum ? dd[j] + tdr[j] * refl : d[j];
      }
    }
    for (int j = 0; j < 3; ++j) {
      if (live) c.o[j] = s.p[j];
      c.d[j] = nd[j];
      if (accum) {
        float nb = bright ? df[j] * (df[j] * (c.rc[j] * bb)) : df[j] * c.rc[j];
        if (k.use_ao) nb *= aof;
        c.rc[j] = nb;
      }
    }
    if (refr_case && !exiting) c.med = ior;
    c.is_alpha = ((c.is_alpha && !aov_alpha) && !opaque) || cutout;
    if (cutout) c.depth += 1;
    c.active = active && !emissive_ret && did_hit;
    return {emissive_ret, accum};
  }

  // ---- reverse -------------------------------------------------------------
  Cot& G = *g;
  float gn[3] = {0, 0, 0}, gp[3] = {0, 0, 0}, gdf[3] = {0, 0, 0};
  float gem[3] = {0, 0, 0}, gb3[3] = {0, 0, 0};
  float gestr = 0.0f, grefl = 0.0f, gior = 0.0f;

  // radiance: emissive overwrite, or accumulation, or pass-through
  float ge_scale = 0.0f;
  for (int j = 0; j < 3; ++j) {
    if (emissive_ret) {
      gb3[j] += G.inc[j];
      G.inc[j] = 0.0f;
    } else if (accum) {                      // inc + (em * e_scale) * rc
      const float gt = G.inc[j] * c.rc[j];
      gem[j] += gt * e_scale;
      ge_scale += gt * em[j];
    }
  }
  gestr += ge_scale * k.e_scale_mult;

  // throughput: accum ? nb : rc
  float grc[3];
  for (int j = 0; j < 3; ++j) {
    if (!accum) { grc[j] = G.rc[j]; continue; }
    grc[j] = G.inc[j] * (em[j] * e_scale);
    const float gnb = k.use_ao ? G.rc[j] * aof : G.rc[j];
    if (bright) {                            // df * (df * (rc * bb))
      const float s_ = c.rc[j] * bb, qv = df[j] * s_;
      gdf[j] += gnb * qv;
      const float gq = gnb * df[j];
      gdf[j] += gq * s_;
      grc[j] += gq * df[j] * bb;
    } else {                                 // df * rc
      gdf[j] += gnb * c.rc[j];
      grc[j] += gnb * df[j];
    }
  }

  // direction: refract ? ref : (accum ? dr : d); origin: live ? p : o
  float gref[3] = {0, 0, 0}, gdr[3] = {0, 0, 0};
  for (int j = 0; j < 3; ++j) {
    if (do_refract) gref[j] = G.d[j];
    else if (accum) gdr[j] = G.d[j];
    else gd[j] += G.d[j];
    if (live) gp[j] += G.o[j];
    else go[j] += G.o[j];
  }

  // dr = dd + (rf - dd) * refl;  rf = d - (2 vdn) n;  vdn = d . n
  float gdd[3] = {0, 0, 0}, grf[3] = {0, 0, 0};
  if (accum) {
    for (int j = 0; j < 3; ++j) {
      gdd[j] += gdr[j];
      const float gt = gdr[j] * refl;
      grefl += gdr[j] * tdr[j];
      grf[j] += gt;
      gdd[j] -= gt;
    }
    float g2v = 0.0f;
    for (int j = 0; j < 3; ++j) {
      gd[j] += grf[j];
      g2v -= grf[j] * n[j];
      gn[j] -= grf[j] * (2.0f * vdn);
    }
    const float gvdn = 2.0f * g2v;
    for (int j = 0; j < 3; ++j) {
      gd[j] += gvdn * n[j];
      gn[j] += gvdn * d[j];
    }
    // dd = ddr * dinv; dinv = 1/sqrt(max(dn2, 1e-38)) where dn2 > 0
    float gdinv = 0.0f, gddr[3];
    for (int j = 0; j < 3; ++j) {
      gddr[j] = gdd[j] * dinv;
      gdinv += gdd[j] * ddr[j];
    }
    if (dn2 >= 1e-38f) {
      const float sm = sqrtf(dn2);
      const float gdn2 = (-gdinv * dinv * dinv) / (2.0f * sm);
      for (int j = 0; j < 3; ++j) gddr[j] += 2.0f * ddr[j] * gdn2;
    }
    for (int j = 0; j < 3; ++j) gn[j] += gddr[j];   // ddr = n + ru
  }

  // refraction: ref = tir ? d - (2 vdne) ne : (d - ne ct) ratio - ne sqr
  if (do_refract) {
    float gne[3] = {0, 0, 0};
    if (tir) {
      float g2v = 0.0f;
      for (int j = 0; j < 3; ++j) {
        gd[j] += gref[j];
        g2v -= gref[j] * ne[j];
        gne[j] -= gref[j] * (2.0f * ndotv);
      }
      const float gv = 2.0f * g2v;
      for (int j = 0; j < 3; ++j) {
        gd[j] += gv * ne[j];
        gne[j] += gv * d[j];
      }
    } else {
      float gsqr = 0.0f, gratio = 0.0f, gct = 0.0f;
      for (int j = 0; j < 3; ++j) {
        gne[j] -= gref[j] * sqr;
        gsqr -= gref[j] * ne[j];
        const float gw = gref[j] * ratio;
        gratio += gref[j] * wv[j];
        gd[j] += gw;
        gne[j] -= gw * ndotv;
        gct -= gw * ne[j];
      }
      float gndotv = gct;              // ct = d . ne is ndotv's value
      if (radical >= 1e-20f) {
        const float grad = gsqr / (2.0f * sqr);
        const float h = 1.0f - ndotv * ndotv;
        gratio += 2.0f * ratio * (-grad * h);
        gndotv += -2.0f * ndotv * (-grad * (ratio * ratio));
      }
      for (int j = 0; j < 3; ++j) {
        gne[j] += gndotv * d[j];
        gd[j] += gndotv * ne[j];
      }
      if (q >= 0.0f && q <= 1e6f) {
        const float gn1s = gratio / n2s_safe;
        const float gn2s = n2s_ > 1e-20f ? -gratio * q / n2s_safe : 0.0f;
        // n1 = exiting ? ior : med, n2 = exiting ? med : ior; the carried
        // medium IOR is a constant
        gior += exiting ? 2.0f * n1 * gn1s : 2.0f * n2 * gn2s;
      }
    }
    for (int j = 0; j < 3; ++j) gn[j] += sgn * gne[j];
  }

  // albedo and normal AOVs: the last writer takes the cotangent
  for (int j = 0; j < 3; ++j) {
    if (emissive_ret) {
      gb3[j] += G.alb[j];
    } else if (i == 0) {
      gdf[j] += G.alb[j];
    } else if (aov_alpha) {
      if (estr > 0.0f) gem[j] += G.alb[j];
      else gdf[j] += G.alb[j];
    }
    if (emissive_ret || i == 0 || aov_alpha) {
      gn[j] += G.nrm[j];
      G.alb[j] = 0.0f;
      G.nrm[j] = 0.0f;
    }
  }
  if (emissive_ret && k.hsl_on) {
    hsl_boost_bwd(em[0], em[1], em[2], k.hsl_l, k.hsl_s, gb3, gem);
  } else if (emissive_ret) {
    for (int j = 0; j < 3; ++j) gem[j] += gb3[j];
  }

  for (int j = 0; j < 3; ++j) {
    G.rc[j] = grc[j];
    gs->p[j] = gp[j]; gs->n[j] = gn[j]; gs->df[j] = gdf[j]; gs->em[j] = gem[j];
  }
  gs->estr = gestr; gs->refl = grefl; gs->ior = gior;
  return {emissive_ret, accum};
}

// Reverse of the hit point p = o + d * safe_t: adds to go and gd, returns
// the cotangent of safe_t.
__device__ __forceinline__ float hit_point_bwd(const float* gp, const float* d,
                                               float safe_t, float* go,
                                               float* gd) {
  float gsafe = 0.0f;
  for (int j = 0; j < 3; ++j) {
    go[j] += gp[j];
    gd[j] += gp[j] * safe_t;
    gsafe += gp[j] * d[j];
  }
  return gsafe;
}

// A sphere winner's surface (or a miss's: hit0 false, w all zero), with
// the recomputed distance (sphere_distance_one's floors) and the knife-
// edge guard. With gs: the reverse, which adds the cotangent of (o, d)
// to go / gd and writes the winner's 14-channel cotangent to gw.
__device__ __forceinline__ void surface_sphere(const Carry& c, const float* w,
                                               bool hit0, const Knobs& k,
                                               Surf& s, const SurfCot* gs,
                                               float* go, float* gd,
                                               float* gw) {
  const float* o = c.o;
  const float* d = c.d;
  const float cx = w[0], cy = w[1], cz = w[2], r = w[3];
  const float oc[3] = {o[0] - cx, o[1] - cy, o[2] - cz};
  const float a_q = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const float b_q = 2.0f * (oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2]);
  const float c_q = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - r * r;
  const float disc = b_q * b_q - 4.0f * a_q * c_q;
  const float sq = sqrtf(fmaxf(disc, 1e-30f));
  const float a_sel = a_q > 1e-20f ? a_q : 1e-20f;
  const float inv_2a = 0.5f / a_sel;
  const float t1 = (-b_q - sq) * inv_2a;
  const float t2 = (-b_q + sq) * inv_2a;
  const bool s_hit = disc > 0.0f;
  const int root = (s_hit && t1 >= k.sphere_eps) ? 1
                 : ((s_hit && t2 >= k.sphere_eps) ? 2 : 0);
  const float s_t = root == 1 ? t1 : (root == 2 ? t2 : kBig);
  // knife-edge guard: a recorded hit that recomputes as invalid is a miss
  s.did_hit = hit0 && s_t < kBig;
  s.safe_t = s.did_hit ? s_t : 0.0f;
  for (int j = 0; j < 3; ++j) s.p[j] = o[j] + d[j] * s.safe_t;
  const float v[3] = {s.p[0] - cx, s.p[1] - cy, s.p[2] - cz};
  const float n2s = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const bool ncond = n2s > 0.0f && s.did_hit;
  const float s_inv = ncond ? 1.0f / sqrtf(n2s) : 0.0f;
  for (int j = 0; j < 3; ++j) {
    s.n[j] = v[j] * s_inv;
    s.df[j] = w[4 + j];
    s.em[j] = w[7 + j];
  }
  s.estr = w[10]; s.refl = w[11]; s.alpha = w[12]; s.ior = w[13];
  if (gs == nullptr) return;

  // normal: n = v / |v| where (n2s > 0 and did_hit), else 0
  float gp[3], gv[3] = {0, 0, 0};
  if (ncond) {
    float gs_inv = 0.0f;
    for (int j = 0; j < 3; ++j) {
      gv[j] = gs->n[j] * s_inv;
      gs_inv += gs->n[j] * v[j];
    }
    const float gn2s = (-gs_inv * s_inv * s_inv) / (2.0f * sqrtf(n2s));
    for (int j = 0; j < 3; ++j) gv[j] += 2.0f * v[j] * gn2s;
  }
  float gc[3], gr = 0.0f;
  for (int j = 0; j < 3; ++j) {
    gp[j] = gs->p[j] + gv[j];
    gc[j] = -gv[j];
  }
  const float gsafe = hit_point_bwd(gp, d, s.safe_t, go, gd);
  if (s.did_hit && root != 0) {
    const float gt1 = root == 1 ? gsafe : 0.0f;
    const float gt2 = root == 2 ? gsafe : 0.0f;
    const float gb = -(gt1 + gt2) * inv_2a;
    const float gsq = (gt2 - gt1) * inv_2a;
    const float ginv = gt1 * (-b_q - sq) + gt2 * (-b_q + sq);
    float ga = a_q > 1e-20f ? -(ginv * 0.5f) * (1.0f / a_sel) * (1.0f / a_sel)
                            : 0.0f;
    const float gdisc = disc >= 1e-30f ? gsq / (2.0f * sq) : 0.0f;
    const float gbq = gb + 2.0f * b_q * gdisc;
    ga += -4.0f * c_q * gdisc;
    const float gcq = -4.0f * a_q * gdisc;
    for (int j = 0; j < 3; ++j) {
      const float goc = 2.0f * oc[j] * gcq + 2.0f * gbq * d[j];
      gd[j] += 2.0f * gbq * oc[j] + 2.0f * d[j] * ga;
      go[j] += goc;
      gc[j] -= goc;
    }
    gr -= 2.0f * r * gcq;
  }
  gw[0] = gc[0]; gw[1] = gc[1]; gw[2] = gc[2]; gw[3] = gr;
  for (int j = 0; j < 3; ++j) {
    gw[4 + j] = gs->df[j];
    gw[7 + j] = gs->em[j];
  }
  gw[10] = gs->estr; gw[11] = gs->refl;
  gw[12] = 0.0f;        // alpha enters only comparisons
  gw[13] = gs->ior;
}

// Where a triangle winner's cotangents go: the triangle's rows 0-2 and
// 9-11, its material's rows 0-5 and its texel's rows 0-2 (the others get
// none, see the header); -1 marks a material or texel that was not read.
struct TriCot {
  float a[3], nraw[3], mat[6], tex[3];
  int mat_id, texel;
};

// A triangle winner's surface (row w, 25 channels): the recomputed
// Moller-Trumbore distance and the knife-edge guard, the unit normal, the
// barycentric UVs and nearest texel (only for a ray in its loop, as
// raytpu's fetch), and the material row, raytpu's _replay_bounce op for
// op. With gs: the reverse, which adds the cotangent of (o, d) to go / gd
// and fills gt.
__device__ __forceinline__ void surface_triangle(
    const Carry& c, const float* w, const float* mats, const float* atlas,
    const Knobs& k, Surf& s, const SurfCot* gs, float* go, float* gd,
    TriCot* gt) {
  const float* o = c.o;
  const float* d = c.d;
  const float ao[3] = {o[0] - w[0], o[1] - w[1], o[2] - w[2]};
  const float daox = ao[1] * d[2] - ao[2] * d[1];
  const float daoy = ao[2] * d[0] - ao[0] * d[2];
  const float daoz = ao[0] * d[1] - ao[1] * d[0];
  const float det = -(d[0] * w[9] + d[1] * w[10] + d[2] * w[11]);
  const float inv_det = 1.0f / (det >= k.det_eps ? det : 1.0f);
  const float num = ao[0] * w[9] + ao[1] * w[10] + ao[2] * w[11];
  const float t_dst = num * inv_det;
  const float t_u = (w[6] * daox + w[7] * daoy + w[8] * daoz) * inv_det;
  const float t_v = -(w[3] * daox + w[4] * daoy + w[5] * daoz) * inv_det;
  const float t_w = 1.0f - t_u - t_v;
  const bool valid = det >= k.det_eps && t_dst >= k.tri_eps &&
                     t_u >= k.tri_eps && t_v >= k.tri_eps && t_w >= k.tri_eps;
  const float dst = valid ? t_dst : kBig;
  s.did_hit = dst < kBig;
  s.safe_t = s.did_hit ? dst : 0.0f;
  for (int j = 0; j < 3; ++j) s.p[j] = o[j] + d[j] * s.safe_t;

  // unit normal, select-floored: a zero-area triangle has a zero normal
  const float tn2 = w[9] * w[9] + w[10] * w[10] + w[11] * w[11];
  const float t_inv = tn2 > 0.0f ? 1.0f / sqrtf(tn2) : 0.0f;
  for (int j = 0; j < 3; ++j) s.n[j] = w[9 + j] * t_inv;

  // area-ratio barycentrics (texture.h:16-27) with the raw vertices
  const float* n = s.n;
  auto area = [&](float p1x, float p1y, float p1z, float qx, float qy,
                  float qz) {
    const float cxx = p1y * qz - p1z * qy;
    const float cyy = p1z * qx - p1x * qz;
    const float czz = p1x * qy - p1y * qx;
    return n[0] * cxx + n[1] * cyy + n[2] * czz;
  };
  const float* p = s.p;
  const float area_abc = area(w[12] - w[0], w[13] - w[1], w[14] - w[2],
                              w[15] - w[0], w[16] - w[1], w[17] - w[2]);
  const float area_pbc = area(w[12] - p[0], w[13] - p[1], w[14] - p[2],
                              w[15] - p[0], w[16] - p[1], w[17] - p[2]);
  const float area_pca = area(w[15] - p[0], w[16] - p[1], w[17] - p[2],
                              w[0] - p[0], w[1] - p[1], w[2] - p[2]);
  const float inv_area = 1.0f / (fabsf(area_abc) > 1e-20f ? area_abc : 1.0f);
  const float w_a = area_pbc * inv_area;
  const float w_b = area_pca * inv_area;
  const float w_c = 1.0f - w_a - w_b;
  float uu = w_a * w[18] + w_b * w[20] + w_c * w[22];
  float vv = w_a * w[19] + w_b * w[21] + w_c * w[23];
  uu = uu - truncf(uu);
  uu = uu < 0.0f ? uu + 1.0f : uu;
  vv = vv - truncf(vv);
  vv = vv < 0.0f ? vv + 1.0f : vv;
  const int mat = (int)w[24];

  // nearest texel of a ray in its loop; outside the atlas reads zeros
  float tex[4];
  long long texel = -1;
  if (k.n_tex > 0) {
    const int aw = k.atlas_w, ah = k.atlas_h;
    const int tx = min(max((int)floorf(uu * (float)aw), 0), aw - 1);
    const int ty = min(max((int)floorf(vv * (float)ah), 0), ah - 1);
    const long long tid = ((long long)ty + (long long)ah * mat) * aw + tx;
    if (c.active && tid >= 0 && tid < (long long)k.n_tex) texel = tid;
    const size_t nt = (size_t)k.n_tex;
    for (int j = 0; j < 4; ++j) tex[j] = texel >= 0 ? atlas[j * nt + texel] : 0.0f;
  } else {            // untextured mesh: mesh.h:207's default material
    tex[0] = 0.784f; tex[1] = 0.965f; tex[2] = 1.0f; tex[3] = 1.0f;
  }
  // material table (texture.h:71-88 as data); outside it reads zeros
  const bool m_ok = mat >= 0 && mat < k.n_mats;
  float mt[kMatRows];
  for (int r = 0; r < kMatRows; ++r) mt[r] = m_ok ? mats[r * k.n_mats + mat] : 0.0f;
  const bool eft = mt[8] > 0.0f;
  for (int j = 0; j < 3; ++j) {
    s.df[j] = tex[j];
    s.em[j] = eft ? mt[j] * tex[j] : mt[j];
  }
  s.estr = mt[3]; s.refl = mt[4]; s.ior = mt[5];
  s.alpha = mt[7] > 0.0f ? mt[6] : tex[3];
  if (gs == nullptr) return;

  // ---- reverse: material and texel ---------------------------------------
  gt->mat_id = m_ok ? mat : -1;
  gt->texel = (int)texel;
  for (int j = 0; j < 3; ++j) {
    gt->tex[j] = gs->df[j] + (eft ? gs->em[j] * mt[j] : 0.0f);
    gt->mat[j] = eft ? gs->em[j] * tex[j] : gs->em[j];
  }
  gt->mat[3] = gs->estr; gt->mat[4] = gs->refl; gt->mat[5] = gs->ior;

  // normal: n = nraw / |nraw| where tn2 > 0 (the barycentrics' use of n
  // reaches only the texel index)
  float gn2 = 0.0f;
  for (int j = 0; j < 3; ++j) gt->nraw[j] = 0.0f;
  if (tn2 > 0.0f) {
    float gtinv = 0.0f;
    for (int j = 0; j < 3; ++j) {
      gt->nraw[j] = gs->n[j] * t_inv;
      gtinv += gs->n[j] * w[9 + j];
    }
    gn2 = (-gtinv * t_inv * t_inv) / (2.0f * sqrtf(tn2));
    for (int j = 0; j < 3; ++j) gt->nraw[j] += 2.0f * w[9 + j] * gn2;
  }

  // hit point, then t_dst = (ao . nraw) * (1 / det)
  const float gsafe = hit_point_bwd(gs->p, d, s.safe_t, go, gd);
  for (int j = 0; j < 3; ++j) gt->a[j] = 0.0f;
  if (s.did_hit) {
    const float gnum = gsafe * inv_det;
    const float ginv = gsafe * num;
    const float gdet = -ginv * inv_det * inv_det;
    for (int j = 0; j < 3; ++j) {
      const float gao = gnum * w[9 + j];
      gt->nraw[j] += gnum * ao[j];
      gd[j] -= gdet * w[9 + j];
      gt->nraw[j] -= gdet * d[j];
      go[j] += gao;
      gt->a[j] -= gao;
    }
  }
}

// A recorded index in [0, ns) is a sphere; -1 (a miss, or a ray whose
// loop is over) and, in sphere mode, any other value read the zero
// winner.
__device__ __forceinline__ bool is_hit(int bidx, int ns) {
  return (unsigned)bidx < (unsigned)ns;
}

__device__ __forceinline__ void load_winner(const float* tab, int ns, int bidx,
                                            float* w) {
  const bool hit = is_hit(bidx, ns);
#pragma unroll
  for (int r = 0; r < kRows; ++r) w[r] = hit ? tab[r * ns + bidx] : 0.0f;
}

// Mesh mode: an index >= ns is triangle bidx - ns (raytpu's tri_wins); one
// past the table reads the zero row, whose distance recomputes as invalid.
__device__ __forceinline__ void load_triangle(const float* tri, int nt,
                                              int t, float* w) {
  const bool in = (unsigned)t < (unsigned)nt;
#pragma unroll
  for (int r = 0; r < kTriRows; ++r) w[r] = in ? tri[(size_t)r * nt + t] : 0.0f;
}

__device__ __forceinline__ void init_carry(Carry& c, int ray,
                                           const float* ox, const float* oy,
                                           const float* oz, const float* dx,
                                           const float* dy, const float* dz) {
  c.o[0] = ox[ray]; c.o[1] = oy[ray]; c.o[2] = oz[ray];
  c.d[0] = dx[ray]; c.d[1] = dy[ray]; c.d[2] = dz[ray];
  c.rc[0] = c.rc[1] = c.rc[2] = 1.0f;
  c.med = 1.0f;
  c.active = true; c.is_alpha = false; c.slot = false; c.depth = 0;
}

// The cotangent of the replay's outputs: radiance, albedo and normal, and
// in the sky modes (kSky) the sky slot's scale.
template <bool kSky>
__device__ __forceinline__ void init_cot(Cot& g, int ray, size_t B,
                                         const float* gin) {
  for (int j = 0; j < 3; ++j) {
    g.o[j] = g.d[j] = g.rc[j] = 0.0f;
    g.inc[j] = gin[j * B + ray];
    g.alb[j] = gin[(3 + j) * B + ray];
    g.nrm[j] = gin[(6 + j) * B + ray];
    g.skl[j] = kSky ? gin[(9 + j) * B + ray] : 0.0f;
  }
}

// One replayed bounce from the recorded winner (kMesh: mesh mode, where an
// index >= n_spheres is a triangle; kSky: with the sky slot) with the
// bounce's draws(0..2). Forward (g == nullptr):
// c becomes the next carry. Reverse: c is the bounce's saved carry, *g the
// cotangent after it becomes the one before it, gw receives the sphere
// winner's cotangent (when the winner is a sphere) and gt a triangle
// winner's (when it is a triangle). Returns whether the winner was a
// triangle.
template <bool kMesh, bool kSky, class Draws>
__device__ __forceinline__ bool replay_bounce(
    int i, Carry& c, int bidx, const float* tab, const float* tri,
    const float* mats, const float* atlas, const Draws& draws, float aof,
    const Knobs& k, Cot* g, float* gw, TriCot* gt) {
  const int ns = k.n_spheres;
  const bool tri_wins = kMesh && bidx >= ns;
  Surf s;
  float go[3] = {0, 0, 0}, gd[3] = {0, 0, 0};
  float w[kTriRows];
  if (tri_wins) {
    load_triangle(tri, k.n_tris, bidx - ns, w);
    surface_triangle(c, w, mats, atlas, k, s, nullptr, nullptr, nullptr,
                     nullptr);
  } else {
    load_winner(tab, ns, bidx, w);
    surface_sphere(c, w, is_hit(bidx, ns), k, s, nullptr, nullptr, nullptr,
                   nullptr);
  }
  // the sky sphere's emission is its texel, added outside K1 / K3
  const bool sky_win = kSky && s.did_hit && bidx == k.sky_idx;
  if (sky_win) s.em[0] = s.em[1] = s.em[2] = 0.0f;
  if (g == nullptr) {
    const Masks m = shade(i, c, s, draws, aof, k, nullptr, nullptr, nullptr,
                          nullptr);
    if (sky_win && (m.emissive_ret || m.accum)) c.slot = true;
    return tri_wins;
  }
  SurfCot gs;
  const Masks m = shade(i, c, s, draws, aof, k, g, &gs, go, gd);
  if (sky_win) {
    gs.em[0] = gs.em[1] = gs.em[2] = 0.0f;   // a constant zero, not the table's
    if (!c.slot && (m.emissive_ret || m.accum)) {
      if (m.accum) {                          // skl = (estr * mult) * rc
        const float e_scale = s.estr * k.e_scale_mult;
        float ge_scale = 0.0f;
        for (int j = 0; j < 3; ++j) {
          g->rc[j] += g->skl[j] * e_scale;
          ge_scale += g->skl[j] * c.rc[j];
        }
        gs.estr += ge_scale * k.e_scale_mult;
      }
      g->skl[0] = g->skl[1] = g->skl[2] = 0.0f;
    }
  }
  if (tri_wins) {
    surface_triangle(c, w, mats, atlas, k, s, &gs, go, gd, gt);
  } else {
    surface_sphere(c, w, is_hit(bidx, ns), k, s, &gs, go, gd, gw);
  }
  for (int j = 0; j < 3; ++j) {
    g->o[j] = go[j];
    g->d[j] = gd[j];
  }
  return tri_wins;
}

// ---- sphere mode (K2's, and K5's): the table sums ------------------------

// The sphere kernels' dynamic shared memory: geo (cx cy cz r a sphere,
// K5's search), tab (the 14 x S table, row-major), then each warp's table
// sum wsum (S x 14, sphere-major) and staging (kWarpStage: 14 x
// kStagePitch, then its group table).
struct SphereSmem {
  float4* geo;
  float *tab, *wsum, *stage;
};

__host__ __device__ inline size_t sphere_shared_floats(int ns, int nt) {
  const int nw = nt / 32;
  return (size_t)4 * ns + (size_t)kRows * ns + (size_t)nw * kRows * ns +
         (size_t)nw * kWarpStage;
}

__device__ __forceinline__ SphereSmem sphere_smem(float* smem, int ns, int nt) {
  const int nw = nt / 32;
  SphereSmem m;
  m.geo = reinterpret_cast<float4*>(smem);
  m.tab = smem + 4 * ns;
  m.wsum = m.tab + kRows * ns;
  m.stage = m.wsum + nw * kRows * ns;
  return m;
}

// Adds each hit lane's 14-entry sphere cotangent gw into its warp's table
// sum wsum (S x 14, sphere-major), without per-thread columns and without
// atomics. The hit lanes are grouped by winner (__match_any_sync), the
// groups taken in the order of their lowest lanes; each lane stages its
// rows in the column of its rank in that order (its group's first column,
// an exclusive scan of the groups' sizes over their lowest lanes, plus its
// rank in the group), so that a group is a run of adjacent columns in lane
// order, and the group's lowest lane writes (winner, first column, lanes)
// to the warp's group table, after its staged rows. Then the (group, row)
// pairs are spread over the lanes: each sums its row over the group's run
// and adds the sum to the winner's entry (distinct pairs, distinct
// entries). The additions are a walk over each group's lanes in lane
// order, added to the entry once a bounce, so two launches give the same
// bits, and K2's sphere mode and K5 the same bits on the same winners. All
// 32 lanes of the warp call it together.
__device__ __forceinline__ void warp_table_sum(float* wsum, float* stage,
                                               int lane, bool hit, int bidx,
                                               const float* gw) {
  const unsigned hits = __ballot_sync(0xffffffffu, hit);
  if (hits == 0u) return;
  const unsigned peers = __match_any_sync(0xffffffffu, hit ? bidx : -1);
  const int lowest = __ffs(peers) - 1, size = __popc(peers);
  const bool leads = hit && lowest == lane;
  const unsigned below = (1u << lane) - 1u;
  const unsigned leaders = __ballot_sync(0xffffffffu, leads);
  int scan = leads ? size : 0;   // inclusive scan of the leaders' sizes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, scan, off);
    if (lane >= off) scan += up;
  }
  const int first = __shfl_sync(0xffffffffu, scan - (leads ? size : 0),
                                lowest);
  int* groups = reinterpret_cast<int*>(stage + kRows * kStagePitch);
  if (hit) {
    const int col = first + __popc(peers & below);
#pragma unroll
    for (int r = 0; r < kRows; ++r) stage[r * kStagePitch + col] = gw[r];
  }
  if (leads) {
    int* e = groups + 3 * __popc(leaders & below);
    e[0] = bidx;
    e[1] = first;
    e[2] = size;
  }
  __syncwarp();
  const int pairs = __popc(leaders) * kRows;
  for (int p = lane; p < pairs; p += 32) {
    const int gi = p / kRows, r = p - gi * kRows;
    const int* e = groups + 3 * gi;
    const float* run = stage + r * kStagePitch + e[1];
    const int n = e[2];
    float acc = 0.0f;
#pragma unroll 4
    for (int t = 0; t < n; ++t) acc += run[t];
    wsum[e[0] * kRows + r] += acc;
  }
  __syncwarp();
}

// This block's sphere-table sum, partial_row[e] for e = r * S + s (the
// layout sum_blocks_kernel reads), over its warps' sums in warp order.
// Called by every thread after a __syncthreads.
__device__ __forceinline__ void block_table_sum(const float* wsum, int ns,
                                                int nt, int tid,
                                                float* partial_row) {
  const int n_e = kRows * ns, nw = nt / 32;
  for (int e = tid; e < n_e; e += nt) {
    const int r = e / ns, s = e - r * ns;
    float acc = 0.0f;
    for (int w = 0; w < nw; ++w) acc += wsum[w * n_e + s * kRows + r];
    partial_row[e] = acc;
  }
}

// The sum over blocks of partial[b][e], in a fixed tree order, into
// d_sph[e].
__global__ void __launch_bounds__(kReduceThreads)
sum_blocks_kernel(const float* __restrict__ partial, int blocks, int n_e,
                  float* __restrict__ d_sph) {
  __shared__ float red[kReduceThreads];
  const int e = blockIdx.x, tid = threadIdx.x;
  float s = 0.0f;
  for (int b = tid; b < blocks; b += kReduceThreads) s += partial[(size_t)b * n_e + e];
  red[tid] = s;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) d_sph[e] = red[0];
}

}  // namespace
