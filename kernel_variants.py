"""Variant builds of the port's kernels, timed on the card.

    python3 kernel_variants.py [--only REGEX] [--tree DIR ...]   # from the repo's root

Each variant is a copy of ``raytpu_torch/csrc`` with text substitutions
(``VARIANTS``), built with the port's nvcc flags and ``-Xptxas -v`` (all
variants at once, one nvcc each), loaded in place of the shipped library
and timed with CUDA events on its library's workloads (``workloads``),
beside the shipped build in the same process; its ptxas registers and
spill stores are printed. ``--only REGEX`` picks the variants (none without it).
A text that does not occur exactly once in its library's sources stops
the script before anything is built. Some variants compute wrong results
on purpose, to measure what a part of a kernel costs (``*_no_hash``: draws
from the key bits without threefry; ``k3m_fixed_winner``: the shading of
triangle 0; each says what it does). A variant that changes K2's draws
(``k2_no_hash``, ``k2m0_no_draw_loads``) sends the replay off the recorded
winners (a recorded hit recomputes as a miss and the ray's loop ends), so
it times less work, not the draws alone. A variant built for another cull
box size (``CHUNK_OF``: K4's ``kChunk``, the walk's ``kWalkChunk``) is
timed on its workloads rebuilt with tables of that size.

The workloads, at the main paths' shapes: the start of a sample
(``_sample_start``, library ``rng``: the keys, camera rays and route rows
as the checkout's ``render`` makes them, the eager camera rays alone, the
RNG kernel's draws-only mode; their device time behind a spin kernel and
by torch.profiler, with its kernels a call; where the checkout has the
sample-start kernel, its words that differ from its plain version); K1,
K1's recording, K2's sphere mode and K5 at the Cornell sample (1200x900
rays, 6 bounces, the RNG kernel's keys); K4 on the camera rays and on the bounce-2 rays (through
the scan path) of the 600- and 4096-triangle block worlds at 1200x900; K3's
merged and per-triangle modes (forward, recording, sky, sky recording) at
1200x900, 6 bounces on the 600-triangle world and its sky twin; K2's mesh
mode on K3's recording of both; the gathers' segment sum and its plan
on three calls at their backward's shapes (``_segment_calls``), with
their readings (``_READINGS``: the sums' error, the plan's mismatches;
``seg_drop_heavy_tile``, ``seg_no_carry`` and ``sort_unstable_rank``
plant faults), the parent's PyTorch pieces for Step 0, and their device
time by kernel (``_device_ms``). ``--libs`` keeps the workloads of the
libraries it matches. ``k5s0_*`` are Step 0's variants of the parent of
K5's redesign (``--tree <parent> --tree-only '^k5s0_'``, or ``--only``
on that checkout); ``k5_run_unroll_*`` / ``k2_run_unroll_*`` unroll the
sphere modes' table sum (its runs of a group's columns) otherwise.

``--tree DIR`` first times every workload in another checkout (for
example the parent commit, unpacked by ``git archive``): this script runs
there in a subprocess with ``--here`` and imports that tree's
``raytpu_torch`` and ``chip_smoke``, so two versions compare in one call;
``--tree-only REGEX`` times the variants of that tree's sources whose
names match there too (``k2m0_*``: the K2 mesh mode of this change's
parent).
With ``--frames`` it first times, in turns (the tree, this checkout twice,
the tree), the frames (``_frames``): Cornell forward at 32 spp and
forward+backward at 8 spp (also under ``RAYTPU_SPH_BWD=ad``), the sky
showcase forward at 16 spp, the 600-triangle block world (merged, its
sky twin, and per-triangle) forward at 16 spp and forward+backward at 4
spp, and the scan path's 4096-triangle world forward at 4 spp and
bilinear forward+backward at 2 spp (1200x900, 6 bounces unless noted;
wall seconds of 3 runs, then one profiled run's kernels a sample and
idle share; this script's frames, run on each tree's package). Needs a
CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

# the draws of a key without threefry (wrong values, the same data flow)
_NO_HASH = ("    return uniform_draw(k0, k1, base + (uint32_t)j);",
            "    return __uint_as_float((((k0 ^ k1) + base + (uint32_t)j) >> 9)"
            " | 0x3F800000u) - 1.0f;")
_K2_BOUNDS = ("__launch_bounds__(kSphereThreads, kSphereMinBlocks)\n"
              "sphere_backward_kernel(")
_K5_BOUNDS = ("__launch_bounds__(kSphereThreads, kSphereMinBlocks)\n"
              "spheres_ad_kernel(")
_K2_SUM = ("    warp_table_sum(wsum, stage, lane, i < last && is_hit(bidx, ns), "
           "bidx, gw);\n  }\n  if (ray < n_rays) {\n    for (int j = 0; j < 3; "
           "++j) {\n      d_rays[j * B + ray] = g.o[j];")
# K3's merged search, called where the forward and recording modes call
# it, in this tree and in the parent commit
_K3M_CALL = ("      merged_search(aa, aa3, quad, qbox, left, lbox, aa_box, "
             "aa3_box, gmin,\n                    q, k, rox, roy, roz, rdx, "
             "rdy, rdz, best, bidx);")


def _search_twice(call):
    """The merged search run twice, the first result kept opaque to the
    compiler: the paths stay the same, so the difference is one search."""
    twice = call.replace("rox, roy,", "o2[0], o2[1],").replace(
        "roz, rdx, rdy, rdz, best, bidx", "o2[2], o2[3], o2[4], o2[5], b2, i2")
    twice = twice.replace("rox, roy, roz, rdx, rdy, rdz, best, bidx",
                          "o2[0], o2[1], o2[2], o2[3], o2[4], o2[5], b2, i2")
    return (call, (
        "      {\n        float o2[6] = {rox, roy, roz, rdx, rdy, rdz}, b2 = best;\n"
        "        int i2 = bidx;\n"
        "        asm volatile(\"\" : \"+f\"(o2[0]), \"+f\"(o2[1]), \"+f\"(o2[2]),"
        " \"+f\"(o2[3]), \"+f\"(o2[4]), \"+f\"(o2[5]), \"+f\"(b2), \"+r\"(i2));\n"
        + twice + "\n        asm volatile(\"\" :: \"f\"(b2), \"r\"(i2));\n      }\n"
        + call))
# K4's block size, its triangles a cull box and its warp's cull
_K4_THREADS = "constexpr int kThreads = 1024;"
_K4_CHUNK = "constexpr int kChunk = 32;"
_K4_CULL = ("inv_y, inv_z, tmin) && tmin < best;\n"
            "      if (!__any_sync(0xffffffffu, in)) continue;")
# the walk's chunk-box test in K3's merged search (negated)
_K3_MEETS = ("!meets_box(box, nb, box0 + (cs - lo) / kWalkChunk, rox, roy, roz,\n"
             "                       inv_x, inv_y, inv_z, tmin)")
# its columns per chunk box
_K3_WALK_CHUNK = "constexpr int kWalkChunk = 8;"
# the merged search's loop over the six groups
_K3_GROUPS = ("#pragma unroll 1\n  for (int g = 0; g < kGroups; ++g) {\n"
              "    const int kx = g >> 1;")
# the merged modes' launch bound
_K3M_BLOCKS = "constexpr int kMergedMinBlocks = 4;"
# K3's draws: hashed where read, the roulette and the scatter's two
_K3_DRAWS = ("    const CalledDraws draws = called_draws(k0, k1, i, "
             "k.n_draws);\n")
# K2 mesh mode's three draws of a bounce, hashed by the called copy
_K2M_CALLED = "  const CalledDraws d = called_draws(k0, k1, i, n_draws);"
_K3_ROULETTE = "refr_case && draws(2) > alpha;"
_K3_SCATTER = ("      const float theta = kTwoPi * draws(0);\n"
               "      const float cph = clampf(2.0f * draws(1) - 1.0f, -1.0f, "
               "1.0f);")
# the triangle winner's index in K3's shading
_K3_WINNER = "      const int t = bidx - ns;\n      const size_t T = (size_t)nt;"

# The parent commit's K2 mesh mode (before its redesign: a replay of every
# bounce, float atomics into d_tri and d_atlas, per-thread columns for
# d_sph and d_mat, the draws read from K3's buffer), for Step 0's
# variants, built in a checkout of that commit (``--tree DIR --tree-only
# '^k2m0_'``): the loops cut at the ray's last bounce (exact: the entries
# past it are the identity); the atomics and the column adds replaced by
# no-op uses of their values (wrong sums on purpose); the draws a
# constant in place of the buffer's loads (wrong paths on purpose)
_K2M0_FWD = ("    Carry saved[kMaxBounces];\n    Carry c;\n    init_carry(c, ray, "
             "ox, oy, oz, dx, dy, dz);")
_K2M0_LOOP = "    for (int i = 0; i < k.bounces; ++i) {\n      saved[i] = c;"
_K2M0_REV = ("    for (int i = k.bounces - 1; i >= 0; --i) {\n      const int bidx "
             "= idx[(size_t)i * B + ray];")
_K2M0_TRI = ("            atomicAdd(&d_tri[j * k.n_tris + t], gt.a[j]);\n"
             "            atomicAdd(&d_tri[(9 + j) * k.n_tris + t], gt.nraw[j]);")
_K2M0_TEX = ("          for (int j = 0; j < 3; ++j) atomicAdd(&d_atlas[j * n_tex "
             "+ gt.texel], gt.tex[j]);")
_K2M0_MAT = ("            col[(n_sph + r * nm + gt.mat_id) * stride + tid] += "
             "gt.mat[r];")
_K2M0_SPH = ("        for (int r = 0; r < kRows; ++r) col[(r * ns + bidx) * stride "
             "+ tid] += gw[r];")
_K2M0_DRAWS = ("  const float* p = draws + (size_t)i * n_draws * B + ray;\n"
               "  return LoadedDraws{{p[0], p[B], p[2 * B]}};")
_K2M0_CUT = [(_K2M0_FWD, _K2M0_FWD.replace("Carry c;", "Carry c;\n    int last = 0;")),
             (_K2M0_LOOP, _K2M0_LOOP.replace("k.bounces;", "k.bounces && c.active;")
              + "\n      last = i + 1;"),
             (_K2M0_REV, _K2M0_REV.replace("k.bounces - 1", "last - 1"))]
_K2M0_NO_ATOMICS = [
    (_K2M0_TRI, '            asm volatile("" :: "f"(gt.a[j]), "f"(gt.nraw[j]));'),
    (_K2M0_TEX, '          for (int j = 0; j < 3; ++j) asm volatile("" :: '
                '"f"(gt.tex[j]));')]
_K2M0_NO_COLUMNS = [
    (_K2M0_MAT, '            asm volatile("" :: "f"(gt.mat[r]));'),
    (_K2M0_SPH, '        for (int r = 0; r < kRows; ++r) asm volatile("" :: '
                '"f"(gw[r]));')]
_K2M0_NO_DRAWS = [(_K2M0_DRAWS, "  return LoadedDraws{{0.31f, 0.57f, 0.9f}};")]

# K2's mesh mode: the call of its table sums (the warp's grouping and the
# warps' turns), the turns' loop and barrier, its block size and the
# blocks an SM its launch bound asks for
_K2M_SUM = ("      __syncwarp();\n"
            "      mesh_table_sum(stage, gmask, lane, warp, key, table);")
_K2M_TURNS = ("  for (int w = 0; w < kMeshWarps; ++w) {\n    if (w == warp) {")
_K2M_TURN_SYNC = ("        }\n      }\n    }\n    __syncthreads();\n  }\n}")
_K2M_THREADS = "constexpr int kMeshThreads = 256;"
_K2M_SYNC = ("      if (!__syncthreads_or(i < last)) continue;   // past every "
             "ray's loop")
_K2M_INIT = ("    if (ray < n_rays) {\n      uint32_t k0, k1;\n"
             "      load_key(keys, B, ray, k0, k1);\n"
             "      init_carry(c, ray, ox, oy, oz, dx, dy, dz);")
_K2M_FWD = ("      for (int i = 0; i < k.bounces && c.active; ++i) {\n"
            "        saved[i] = c;")
_K2M_MATCH = "    const unsigned peers = __match_any_sync(0xffffffffu, key[q]);"
_K2M_PAIRS = ("    const int pairs = shared[q] ? __popc(lead[q]) * rows : 0;")
_K2M_BLOCKS = "constexpr int kMeshMinBlocks = 2;"

# K3's per-triangle modes. The lanes of a warp entering a chunk from
# which each scans it alone, in place of what the launch passes (1:
# always, the union of the lanes' chunks as before the warp search; 33:
# never).
_K3T_COOP = "hsl_s, sky_idx, coop_min};"
# The warps' 32-ray groups grid-stride over the card's warps, in place of
# the counter's next.
_K3T_GRID_STRIDE = ("""    auto next_group = [&]() {
      unsigned v = 0u;
      if (lane == 0) v = atomicAdd(&g_next, 1u);
      return (int)__shfl_sync(0xffffffffu, v, 0);
    };
    for (int g = next_group(); g < n_groups; g = next_group()) {
""", """    auto next_group = [&](int g) {
      const int first = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
      return g < 0 ? first : g + (int)((gridDim.x * blockDim.x) >> 5);
    };
    for (int g = next_group(-1); g < n_groups; g = next_group(g)) {
""")
# One block per 256 rays, each staging its tables (with grid-stride each
# warp then takes one group: the parent's schedule), in place of as many
# blocks as fit.
_K3T_NOT_PERSISTENT = (
    "    blocks = blocks < sms * per_sm ? blocks : sms * per_sm;\n", "")
# Each lane takes the counter's next ray when its own ends, in place of
# the warp's 32-ray groups.
_K3T_REFILL = (_K3T_GRID_STRIDE[0] + """      const int r = g * 32 + lane;
      const bool has = r < n_rays;
      if (has) start(r); else active = false;
      for (;;) {
        const bool go = has && i < k.bounces && active;
        if (!__any_sync(0xffffffffu, go)) break;
        bounce(go);
      }
      if (has) finish();
    }
""", """    bool has = false, done = false;
    for (;;) {
      const bool ended = has && !(i < k.bounces && active);
      if (ended) finish();
      const bool need = !done && (!has || ended);
      const unsigned want = __ballot_sync(0xffffffffu, need);
      if (want != 0u) {
        const int lead = __ffs(want) - 1;
        unsigned base = 0u;
        if (lane == lead) base = atomicAdd(&g_next, (unsigned)__popc(want));
        base = __shfl_sync(0xffffffffu, base, lead);
        if (need) {
          const unsigned r = base + __popc(want & ((1u << lane) - 1u));
          has = r < (unsigned)n_rays;
          done = !has;
          if (has) start((int)r);
        }
      }
      const bool go = has && i < k.bounces && active;
      if (!__any_sync(0xffffffffu, go)) {
        if (!__any_sync(0xffffffffu, has && !done)) break;
        continue;
      }
      bounce(go);
    }
""")
# The search table staged as the parent staged it, a channel a row (12 x
# T), and read word by word, in place of three float4s a triangle.
_K3T_WORDS = [
    ("struct Staged {\n  const float4* p;\n",
     "struct Staged {\n  const float4* p;\n  int nt;\n"),
    ("""    const float4 a = p[3 * t], b = p[3 * t + 1], c = p[3 * t + 2];
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
    s[8] = c.x; s[9] = c.y; s[10] = c.z; s[11] = c.w;
""", """    const float* w = reinterpret_cast<const float*>(p);
#pragma unroll
    for (int r = 0; r < kSearch; ++r) s[r] = w[r * nt + t];
"""),
    ("tri_s = Staged{reinterpret_cast<const float4*>(smem)};",
     "tri_s = Staged{reinterpret_cast<const float4*>(smem), nt};"),
    ("e += blockDim.x) smem[e] = search_g[e];",
     "e += blockDim.x) smem[(e % kSearch) * nt + e / kSearch] = search_g[e];"),
]
_K3T_BOUNDS = "__launch_bounds__(kThreads)\ntrace_scene_kernel(TRACE_SCENE_PARAMS)"
# The segment sum and its plan with a planted fault (wrong on purpose, to
# read what chip_smoke's checks of them see): a row summed by the warp
# drops its first level-1 partial (its first 256 tiles), a run that
# crosses warps in a tile drops the warps below, or the sort ranks equal
# digits of a round in reverse lane order (unstable: a permutation that
# still sorts the keys)
_SEG_DROP_TILE = ("      for (int u = u0 + lane; u <= u1; u += 32) {",
                  "      for (int u = u0 + lane + (lane == 0 ? 32 : 0); "
                  "u <= u1; u += 32) {")
_SEG_NO_CARRY = ("        v[k] = carry + v[k];",
                 "        v[k] = v[k] + 0.0f * carry;")
_SORT_UNSTABLE = ("rank[i] = valid ? run[warp][d] + __popc(peers & lower) : 0;",
                  "rank[i] = valid ? run[warp][d] + __popc(peers & ~lower & "
                  "~(1u << lane)) : 0;")
# the segment sum's channel group and launch bounds
_SEG_GROUP = "constexpr int kGroup = 4; "
_SEG_TILES_BOUNDS = "__launch_bounds__(kTile)\ntile_sums("
_SEG_ROWS_BOUNDS = "__launch_bounds__(kRowThreads)\nrow_sums("
# the sort's entries a thread in a pass
_SORT_ITEMS = "constexpr int kItems = 16;"
# Step 0 of the segment sum's redesign, built in a checkout of its parent
# (``--tree DIR --tree-only '^seg0_'``): tile_sums alone, row_sums alone
# (on an unwritten scratch plane: its sums are garbage, its time is its
# own), no row summed by the warp (every row a thread's), and the warp's
# rows left unsummed (wrong sums on purpose: the branch's cost)
_SEG0_ROWS = ("  row_sums<<<(n_rows + kRowThreads - 1) / kRowThreads, "
              "kRowThreads, 0, st>>>(")
_SEG0_TILES = "    tile_sums<<<(n + kTile - 1) / kTile, kTile, 0, st>>>("

# Step 0 of K5's redesign (``--only '^k5s0_'`` on the parent of the
# redesign): its reverse loop and carries, its table sum's call, and the
# grouping loop of that table sum (replay.cuh, shared with K2's sphere
# mode; only K5's library is rebuilt)
_K5_REV = ("  for (int i = k.bounces - 1; i >= 0; --i) {\n"
           "    const int bidx = i < last ? win[i] : -1;")
_K5_SAVED = ("  Carry saved[kMaxBounces];\n  int win[kMaxBounces];\n"
             "  float aofs[kMaxBounces];")
_K5_SUM = ("    warp_table_sum(wsum, stage, lane, i < last && is_hit(bidx, ns),"
           " bidx, gw);\n  }\n  if (ray < n_rays) {")
_K5_GROUPS = """  unsigned todo = hits;
  while (todo != 0u) {
    const int win = __shfl_sync(0xffffffffu, bidx, __ffs(todo) - 1);
    const unsigned grp = __ballot_sync(0xffffffffu, hit && bidx == win);
    todo &= ~grp;
    if (lane < kRows) {
      float acc = 0.0f;
      for (unsigned m = grp; m != 0u; m &= m - 1u) {
        acc += stage[lane * kStagePitch + __ffs(m) - 1];
      }
      wsum[win * kRows + lane] += acc;
    }
  }
"""
# the sphere modes' table sum (replay.cuh): the unrolling of a group's
# run of columns
_RUN_UNROLL = "#pragma unroll 4\n    for (int t = 0; t < n; ++t) acc += run[t];"
# the table sum's grouping, and a path for a warp whose hit lanes share
# one winner
_ONE_GROUP = ("  const unsigned peers = __match_any_sync(0xffffffffu, hit ? bidx : "
              "-1);\n")
_ONE_GROUP_PATH = """  if (__all_sync(0xffffffffu, !hit || peers == hits)) {
    const int win = __shfl_sync(0xffffffffu, bidx, __ffs(hits) - 1);
    if (hit) {
      const int col = __popc(hits & ((1u << lane) - 1u));
#pragma unroll
      for (int r = 0; r < kRows; ++r) stage[r * kStagePitch + col] = gw[r];
    }
    __syncwarp();
    if (lane < kRows) {
      const float* run = stage + lane * kStagePitch;
      const int n = __popc(hits);
      float acc = 0.0f;
#pragma unroll 4
      for (int t = 0; t < n; ++t) acc += run[t];
      wsum[win * kRows + lane] += acc;
    }
    __syncwarp();
    return;
  }
"""
# the groups by __match_any_sync, their (group, row) pairs spread over the
# lanes, each pair's members summed in lane order (the same bits)
_K5_MATCH = """  const unsigned peers = __match_any_sync(0xffffffffu, hit ? bidx : -1);
  const unsigned lead = __ballot_sync(0xffffffffu,
                                      hit && __ffs(peers) - 1 == lane);
  const int pairs = __popc(lead) * kRows;
  for (int p0 = 0; p0 < pairs; p0 += 32) {
    const int p = p0 + lane, grp = p / kRows, r = p - grp * kRows;
    unsigned lm = lead;
    for (int t = 0; t < grp && lm != 0u; ++t) lm &= lm - 1u;
    const int src = (p < pairs && lm != 0u) ? __ffs(lm) - 1 : 0;
    const unsigned m = __shfl_sync(0xffffffffu, peers, src);
    const int win = __shfl_sync(0xffffffffu, bidx, src);
    if (p < pairs) {
      float acc = 0.0f;
      for (unsigned mm = m; mm != 0u; mm &= mm - 1u) {
        acc += stage[r * kStagePitch + __ffs(mm) - 1];
      }
      wsum[win * kRows + r] += acc;
    }
  }
"""
# every saved carry field read where the (never taken) branch reads it,
# so the forward sweep alone still stores them
_K5_KEEP_SAVED = """  if (k.bounces < 0) {   // never: keeps the forward's stores
    for (int i = 0; i < last; ++i) {
      const Carry& s = saved[i];
      g.o[0] += s.o[0] + s.o[1] + s.o[2] + s.d[0] + s.d[1] + s.d[2] + s.rc[0]
          + s.rc[1] + s.rc[2] + s.med + (float)s.depth + (s.active ? 1.f : 0.f)
          + (s.is_alpha ? 1.f : 0.f) + (s.slot ? 1.f : 0.f) + aofs[i]
          + (float)win[i];
    }
  }
"""

# name -> (library, [(text, replacement), ...]); each text occurs once in
# the library's sources
VARIANTS = {
    "k1_no_hash": ("trace_spheres", [_NO_HASH]),
    "k1_no_early_exit": ("trace_spheres", [("if (!active && may_leave) {",
                                            "if (false) {")]),
    "k2_unbounded": ("trace_scene_bwd", [(_K2_BOUNDS, _K2_BOUNDS.replace(
        ", kSphereMinBlocks", ""))]),
    "k2_min_blocks_6": ("trace_scene_bwd", [(_K2_BOUNDS, _K2_BOUNDS.replace(
        "kSphereMinBlocks", "6"))]),
    "k2_no_hash": ("trace_scene_bwd", [_NO_HASH]),
    "k2_sums_in_registers": ("trace_scene_bwd", [(_K2_SUM, (
        "    if (i < last && is_hit(bidx, ns)) {\n      for (int r = 0; r < "
        "kRows; ++r) racc[r] += gw[r];\n    }\n  }\n  {\n    float t = 0.0f;\n"
        "    for (int r = 0; r < kRows; ++r) t += racc[r];\n    atomicAdd("
        "&sm.wsum[tid], t);\n  }\n  if (ray < n_rays) {\n    for (int j = 0; "
        "j < 3; ++j) {\n      d_rays[j * B + ray] = g.o[j];")), (
        "  float gw[kRows];\n  TriCot gt;\n  for (int i = k.bounces - 1;",
        "  float gw[kRows], racc[kRows] = {};\n  TriCot gt;\n  for (int i = "
        "k.bounces - 1;")]),
    "k5_unbounded": ("trace_spheres_bwd", [(_K5_BOUNDS, _K5_BOUNDS.replace(
        ", kSphereMinBlocks", ""))]),
    # Step 0 of K5's redesign, on its parent: the forward sweep alone
    # (search, AO, replay, the carries stored; the ray cotangents from the
    # initial g: wrong on purpose); the reverse sweep without its table
    # sums (wrong d_sph on purpose); the carries sized for 8 bounces (the
    # 6-bounce workload only); the reverse loop from the warp's largest
    # ray loop; 4 and 6 blocks an SM; the table sum grouped by
    # __match_any_sync
    "k5s0_forward_only": ("trace_spheres_bwd", [(
        _K5_REV, _K5_KEEP_SAVED + _K5_REV.replace(
            "i >= 0;", "i >= 0 && k.bounces < 0;"))]),
    "k5s0_no_table_sum": ("trace_spheres_bwd", [(_K5_SUM, (
        "    if (i < last && is_hit(bidx, ns)) {   // kept live, not summed\n"
        "      float acc = 0.0f;\n"
        "      for (int r = 0; r < kRows; ++r) acc += gw[r];\n"
        "      asm volatile(\"\" :: \"f\"(acc));\n    }\n  }\n"
        "  if (ray < n_rays) {"))]),
    "k5s0_carries_8": ("trace_spheres_bwd", [(
        _K5_SAVED, _K5_SAVED.replace("kMaxBounces", "8"))]),
    "k5s0_warp_last": ("trace_spheres_bwd", [(_K5_REV, _K5_REV.replace(
        "  for (int i = k.bounces - 1;",
        "  const int wlast = __reduce_max_sync(0xffffffffu, last);\n"
        "  for (int i = wlast - 1;"))]),
    **{f"k5s0_min_blocks_{m}": ("trace_spheres_bwd", [(
        _K5_BOUNDS, _K5_BOUNDS.replace("kSphereMinBlocks", str(m)))])
       for m in (4, 6)},
    "k5s0_match_any": ("trace_spheres_bwd", [(_K5_GROUPS, _K5_MATCH)]),
    # K5's table sum cut to its parts (wrong d_sph on purpose; gw kept
    # live): only the ballot of the hit lanes; the grouping, the scan and
    # the staging without the pairs' sums; the pairs with runs of one
    "k5_sum_ballot_only": ("trace_spheres_bwd", [(_K5_SUM, (
        "    {\n      const bool h = i < last && is_hit(bidx, ns);\n"
        "      float acc = 0.0f;\n"
        "      for (int r = 0; r < kRows; ++r) acc += h ? gw[r] : 0.0f;\n"
        "      asm volatile(\"\" :: \"f\"(acc), "
        "\"r\"(__ballot_sync(0xffffffffu, h)));\n    }\n  }\n"
        "  if (ray < n_rays) {"))]),
    "k5_sum_stage_only": ("trace_spheres_bwd", [(
        "  const int pairs = __popc(leaders) * kRows;",
        "  const int pairs = 0 * __popc(leaders);")]),
    "k5_sum_no_runs": ("trace_spheres_bwd", [(
        _RUN_UNROLL, "    for (int t = 0; t < 1; ++t) acc += run[t];")]),
    # one winner in the warp summed without the scan and the group table,
    # in K5 and K2's sphere mode
    **{f"{k}_one_group_path": (lib, [(_ONE_GROUP, _ONE_GROUP + _ONE_GROUP_PATH)])
       for k, lib in (("k5", "trace_spheres_bwd"), ("k2", "trace_scene_bwd"))},
    # the table sum's runs unrolled 1 or 8 times in place of 4, in K5 and
    # K2's sphere mode
    **{f"{k}_run_unroll_{u}": (lib, [(_RUN_UNROLL, _RUN_UNROLL.replace(
        "unroll 4", f"unroll {u}"))])
       for k, lib in (("k5", "trace_spheres_bwd"), ("k2", "trace_scene_bwd"))
       for u in (1, 8)},
    # K4: blocks of 512 or 256 threads in place of 1024; 16, 64 or 128
    # triangles a cull box in place of 32; the warp's cull on the box
    # alone, without the running best
    "k4_threads_512": ("intersect", [(_K4_THREADS, _K4_THREADS.replace(
        "1024", "512"))]),
    "k4_threads_256": ("intersect", [(_K4_THREADS, _K4_THREADS.replace(
        "1024", "256"))]),
    **{f"k4_chunk_{c}": ("intersect", [(_K4_CHUNK, _K4_CHUNK.replace(
        "32", str(c)))]) for c in (16, 64, 128)},
    "k4_no_best_cull": ("intersect", [(_K4_CULL, _K4_CULL.replace(
        " && tmin < best", ""))]),
    # K3's merged walk without its chunk boxes (every chunk from the ray's
    # first plane on is scanned); the six groups' loop unrolled
    "k3m_no_walk_boxes": ("trace_scene", [(_K3_MEETS, "false")]),
    "k3m_unrolled": ("trace_scene", [(_K3_GROUPS, _K3_GROUPS.replace(
        "unroll 1", "unroll"))]),
    # the merged modes held to 3 blocks an SM, or unbounded
    "k3m_min_blocks_3": ("trace_scene", [(_K3M_BLOCKS, _K3M_BLOCKS.replace(
        "4", "3"))]),
    "k3m_unbounded": ("trace_scene", [(
        "__launch_bounds__(kThreads, kMergedMinBlocks)",
        "__launch_bounds__(kThreads)")]),
    # chunks of 4 or 16 columns in place of 8
    **{f"k3m_walk_chunk_{c}": ("trace_scene", [(
        _K3_WALK_CHUNK, _K3_WALK_CHUNK.replace("8", str(c)))])
       for c in (4, 16)},
    # the shading reads triangle 0 for every triangle winner (its loads
    # cached and uniform; the hit distance kept, the paths changed)
    "k3m_fixed_winner": ("trace_scene", [(_K3_WINNER, _K3_WINNER.replace(
        "bidx - ns", "0"))]),
    # K3's three draws hashed together (three independent chains) where
    # the bounce is live, ahead of the shading that reads them
    "k3_eager_draws": ("trace_scene", [
        (_K3_DRAWS, _K3_DRAWS + (
            "    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;\n"
            "    if (live) { d0 = draws(0); d1 = draws(1); d2 = draws(2); }\n")),
        (_K3_ROULETTE, "refr_case && d2 > alpha;"),
        (_K3_SCATTER, _K3_SCATTER.replace("draws(0)", "d0").replace(
            "draws(1)", "d1"))]),
    # the draw's hash inlined at every read, in place of one called copy
    # (K3; K2's mesh mode)
    "k3_hash_inlined": ("trace_scene", [(_K3_DRAWS, (
        "    const KeyDraws draws = key_draws(k0, k1, i, k.n_draws);\n"))]),
    "k2m_hash_inlined": ("trace_scene_bwd", [(_K2M_CALLED, (
        "  const KeyDraws d = key_draws(k0, k1, i, n_draws);"))]),
    # the search run twice (paths unchanged: the difference is one search)
    "k3m_search_twice": ("trace_scene", [_search_twice(_K3M_CALL)]),
    # K2's mesh mode without its table sums (the staged cotangents kept:
    # wrong tables on purpose); with the warps' turns unordered and
    # without their barriers (racy sums, wrong on purpose); blocks of 128
    # threads (4 warps, 3 blocks an SM); 3 blocks an SM of 256 threads
    "k2m_no_table_sums": ("trace_scene_bwd", [(_K2M_SUM, (
        "      __syncwarp();\n      for (int r = 0; r < kStageRows; ++r) "
        "asm volatile(\"\" :: \"f\"(stage[r * kStagePitch + lane]), "
        "\"r\"(key[r & 3]));"))]),
    "k2m_unordered_turns": ("trace_scene_bwd", [
        (_K2M_TURNS, "  for (int w = 0; w < 1; ++w) {\n    if (true) {"),
        (_K2M_TURN_SYNC, "        }\n      }\n    }\n  }\n}")]),
    # the above and no block barrier in the reverse loop (each warp runs
    # its own bounces); the warp's grouping without __match_any_sync (every
    # lane its own group) or without its pair sums (wrong sums on purpose)
    "k2m_no_sums_no_barrier": ("trace_scene_bwd", [(_K2M_SUM, (
        "      for (int r = 0; r < kStageRows; ++r) "
        "asm volatile(\"\" :: \"f\"(stage[r * kStagePitch + lane]), "
        "\"r\"(key[r & 3]));")), (_K2M_SYNC, "      if (i >= last) continue;")]),
    "k2m_no_match": ("trace_scene_bwd", [(_K2M_MATCH, (
        "    const unsigned neg = __ballot_sync(0xffffffffu, key[q] < 0);\n"
        "    const unsigned peers = key[q] >= 0 ? 1u << lane : neg;"))]),
    "k2m_no_pair_sums": ("trace_scene_bwd", [(_K2M_PAIRS, (
        "    const int pairs = 0;"))]),
    # the replay's forward loop in step across the block too (a barrier a
    # bounce); blocks of 512 threads, one an SM
    "k2m_forward_in_step": ("trace_scene_bwd", [(_K2M_INIT, (
        "    c.active = false;\n    {\n      uint32_t k0 = 0u, k1 = 0u;\n"
        "      if (ray < n_rays) {\n        load_key(keys, B, ray, k0, k1);\n"
        "        init_carry(c, ray, ox, oy, oz, dx, dy, dz);\n      }")),
        (_K2M_FWD, (
        "      for (int i = 0; i < k.bounces; ++i) {\n"
        "        if (!__syncthreads_or(c.active)) break;\n"
        "        if (!c.active) continue;\n"
        "        saved[i] = c;"))]),
    "k2m_threads_512": ("trace_scene_bwd", [
        (_K2M_THREADS, _K2M_THREADS.replace("256", "512")),
        (_K2M_BLOCKS, _K2M_BLOCKS.replace("2", "1"))]),
    # the draws hashed where the shading reads them, in the replay and
    # again in the reverse step (sphere mode's way), not once ahead
    "k2m_hash_where_read": ("trace_scene_bwd", [
        (_K2M_INIT, _K2M_INIT.replace(
            "    if (ray < n_rays) {\n      uint32_t k0, k1;\n",
            "    uint32_t k0 = 0u, k1 = 0u;\n    if (ray < n_rays) {\n")),
        ("        saved_draws[i] = hash_draws(k0, k1, i, k.n_draws);\n", ""),
        ("                                   saved_draws[i], aof, k, nullptr,",
         "                                   key_draws(k0, k1, i, k.n_draws), "
         "aof, k, nullptr,"),
        ("                                       saved_draws[i], aof, k, &g, "
         "gw, &gt)) {", "                                       key_draws(k0, "
         "k1, i, k.n_draws), aof, k, &g, gw, &gt)) {")]),
    "k2m_threads_128": ("trace_scene_bwd", [
        (_K2M_THREADS, _K2M_THREADS.replace("256", "128")),
        (_K2M_BLOCKS, _K2M_BLOCKS.replace("2", "4"))]),
    "k2m_min_blocks_3": ("trace_scene_bwd", [
        (_K2M_BLOCKS, _K2M_BLOCKS.replace("2", "3"))]),
    "k2m_unbounded": ("trace_scene_bwd", [(
        "__launch_bounds__(kMeshThreads, kMeshMinBlocks)",
        "__launch_bounds__(kMeshThreads)")]),
    # K3 per-triangle: the warp search's threshold, refill, the parent's
    # staged layout, and Step 0: the persistent staging alone (coop_min 1)
    # and the warp search alone (one block per 256 rays), each against the
    # shipped build (both)
    **{f"k3t_coop_min_{m}": ("trace_scene", [(_K3T_COOP, _K3T_COOP.replace(
        "coop_min", str(m)))]) for m in (8, 12, 20, 24, 28, 33)},
    "k3t_refill": ("trace_scene", [_K3T_REFILL]),
    "k3t_refill_coop_min_33": ("trace_scene", [
        _K3T_REFILL, (_K3T_COOP, _K3T_COOP.replace("coop_min", "33"))]),
    "k3t_grid_stride": ("trace_scene", [_K3T_GRID_STRIDE]),
    "k3t_words_soa": ("trace_scene", _K3T_WORDS),
    "k3t_min_blocks_4": ("trace_scene", [(_K3T_BOUNDS, _K3T_BOUNDS.replace(
        "(kThreads)", "(kThreads, 4)"))]),
    "k3t_step0_staging_only": ("trace_scene", [(_K3T_COOP, _K3T_COOP.replace(
        "coop_min", "1"))]),
    "k3t_step0_search_only": ("trace_scene", [_K3T_NOT_PERSISTENT,
                                               _K3T_GRID_STRIDE]),
    "k3t_step0_neither": ("trace_scene", [
        _K3T_NOT_PERSISTENT, _K3T_GRID_STRIDE,
        (_K3T_COOP, _K3T_COOP.replace("coop_min", "1"))]),
    # the segment sum with a planted fault (wrong on purpose)
    "seg_drop_heavy_tile": ("segment_sum", [_SEG_DROP_TILE]),
    "seg_no_carry": ("segment_sum", [_SEG_NO_CARRY]),
    "sort_unstable_rank": ("index_sort", [_SORT_UNSTABLE]),
    # the segment sum's channels loaded together, and its kernels held to
    # 8 blocks an SM (32 registers)
    "seg_group_2": ("segment_sum", [(_SEG_GROUP, _SEG_GROUP.replace("4", "2"))]),
    "seg_group_8": ("segment_sum", [(_SEG_GROUP, _SEG_GROUP.replace("4", "8"))]),
    "seg_group_16": ("segment_sum", [(_SEG_GROUP, _SEG_GROUP.replace("4",
                                                                     "16"))]),
    "seg_tiles_8_blocks": ("segment_sum", [(_SEG_TILES_BOUNDS,
                                            _SEG_TILES_BOUNDS.replace(
                                                "(kTile)", "(kTile, 8)"))]),
    "seg_rows_8_blocks": ("segment_sum", [(_SEG_ROWS_BOUNDS,
                                           _SEG_ROWS_BOUNDS.replace(
                                               "(kRowThreads)",
                                               "(kRowThreads, 8)"))]),
    # the sort's entries a thread in a pass (tiles of 2,048 and 1,024)
    "sort_items_8": ("index_sort", [(_SORT_ITEMS, _SORT_ITEMS.replace(
        "16", "8"))]),
    "sort_items_4": ("index_sort", [(_SORT_ITEMS, _SORT_ITEMS.replace(
        "16", "4"))]),
    # Step 0 of the segment sum's redesign (--tree-only '^seg0_')
    "seg0_tiles_only": ("segment_sum", [(_SEG0_ROWS, "  if (false) "
                                          + _SEG0_ROWS.lstrip())]),
    "seg0_rows_only": ("segment_sum", [(_SEG0_TILES, "    if (false) "
                                         + _SEG0_TILES.lstrip())]),
    "seg0_no_warp_rows": ("segment_sum", [("constexpr int kHeavy = 8;",
                                           "constexpr int kHeavy = 1 << 30;")]),
    "seg0_skip_warp_rows": ("segment_sum", [(
        "unsigned todo = __ballot_sync(0xffffffffu, has && heavy);",
        "unsigned todo = 0u & __ballot_sync(0xffffffffu, has && heavy);")]),
    # Step 0: the parent's K2 mesh mode (--tree-only '^k2m0_')
    "k2m0_cut_at_last": ("trace_scene_bwd", _K2M0_CUT),
    "k2m0_no_atomics": ("trace_scene_bwd", _K2M0_NO_ATOMICS),
    "k2m0_no_columns": ("trace_scene_bwd", _K2M0_NO_COLUMNS),
    "k2m0_no_draw_loads": ("trace_scene_bwd", _K2M0_NO_DRAWS),
    "k2m0_all_four": ("trace_scene_bwd", _K2M0_CUT + _K2M0_NO_ATOMICS
                      + _K2M0_NO_COLUMNS + _K2M0_NO_DRAWS),
}

# the cull box size each chunk variant was built for: its workloads take
# tables of that size
CHUNK_OF = {**{f"k4_chunk_{c}": c for c in (16, 64, 128)},
            **{f"k3m_walk_chunk_{c}": c for c in (4, 16)}}

_CORNELL = ("trace_spheres", "trace_scene_bwd", "trace_spheres_bwd")
# the gathers' workloads: the sums, the plan, the parent's PyTorch pieces
_SEGMENT = {"segment_sum", "index_sort", "segment_pieces"}
# the workloads whose device time is read by kernel: the gathers' and the
# sample start's (library "rng")
_PROFILED = _SEGMENT | {"rng"}


def _time_ms(fn, iters=30):
    import torch

    fn(), fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=10):
    """(device ms per call, {kernel: device ms per call}, kernels per
    call) of ``fn``: torch.profiler's CUDA time after two warm-up calls,
    so the wrapper's host time, which CUDA events around a loop include
    when it is the longer, is not in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(), fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by, count = {}, 0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and us:
            name = ev.key.replace("(anonymous namespace)::", "")[:60]
            by[name] = by.get(name, 0.0) + us / 1e3 / iters
            count += ev.count
    return (round(sum(by.values()), 4), {k: round(v, 4) for k, v in by.items()},
            count / iters)


def _cornell(dev):
    """K1, K1 recording, K2 and K5 at the Cornell sample."""
    import numpy as np
    import torch

    from raytpu_torch import scenes
    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import (blocked_pixel_order,
                                                n_bounce_draws, sample_rays)
    from raytpu_torch.kernels import trace_scene_bwd as tb
    from raytpu_torch.kernels import trace_spheres as ts

    scene, cam, cfg = scenes.cornell_box(dev)
    cfg = cfg.replace(width=1200, height=900, max_bounces=6)
    pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
    keys, cam_d = rng.sample_stream(rng.prng_key(0, device=dev), pids, 0, 4)
    o, d = sample_rays(cam, cfg, pids, cam_d)
    rays = tuple(t.contiguous() for t in (*o, *d))
    sph = ts.pack_spheres(scene)
    k = ts.Knobs.create(cfg, scene.spheres.count, n_bounce_draws(cfg))
    _, idx, aof = ts._launch(sph, rays, keys, k, record=True)
    g = torch.tensor(np.random.default_rng(7).uniform(
        -1, 1, (9, cfg.n_pixels)).astype(np.float32), device=dev)
    return {
        "k1": ("trace_spheres", lambda: ts._launch(sph, rays, keys, k)),
        "k1_rec": ("trace_spheres",
                   lambda: ts._launch(sph, rays, keys, k, record=True)),
        "k2": ("trace_scene_bwd",
               lambda: tb.sphere_backward(sph, rays, keys, idx, aof, g, k)),
        "k5": ("trace_spheres_bwd",
               lambda: ts._launch_ad(sph, rays, keys, g, k)),
    }


def _at(module, attr, value, fn):
    """``fn`` run with ``module.attr`` set to ``value``: the cull box size
    a chunk variant was built for, which ``_launch`` checks the tables
    against."""
    def run():
        old = getattr(module, attr)
        setattr(module, attr, value)
        try:
            return fn()
        finally:
            setattr(module, attr, old)
    return run


def _k4(dev, chunk=None):
    """K4 on the camera rays and the bounce-2 rays of the 600- and
    4096-triangle worlds at 1200x900 (``chip_smoke``'s ray sets), with
    the checkout's tables, or with ``chunk`` triangles a cull box."""
    import chip_smoke as cs
    from raytpu_torch.geometry.triangle import precompute
    from raytpu_torch.kernels import intersect

    tables = getattr(intersect, "kernel_tables", intersect.pack_tables)
    out = {}
    for n in (cs.MESH_WORLD, cs.SCAN_WORLD):
        scene, cam, cfg = cs._per_triangle(cs._block_world(n), dev)
        cfg = cfg.replace(width=cs.FRAME[0], height=cs.FRAME[1],
                          use_pallas=True)
        geom = precompute(scene.triangles)
        eps = (cfg.sphere_eps, cfg.tri_det_eps, cfg.tri_eps)
        for what, o, d in cs._k4_ray_sets(scene, cam, cfg, 0, dev):
            if what in ("bounce 0", "bounce 2"):
                rays = tuple(c.contiguous() for c in (*o, *d))
                name = f"k4_{n}_{'camera' if what == 'bounce 0' else 'bounce2'}"
                t = (tables(scene, geom) if chunk is None
                     else intersect.pack_tables(scene, geom, chunk))
                run = lambda t=t, r=rays: intersect._launch(*t, r, *eps)
                out[name] = ("intersect", run if chunk is None else
                             _at(intersect, "KERNEL_CHUNK", chunk, run))
            if what == "bounce 2":
                break
    return out


def _mesh_batch(dev, scene, cam, cfg):
    """K3's tables, the camera rays, the draw source and the knobs of one
    sample at 1200x900, 6 bounces under key 0 (the RNG kernel's keys). A
    checkout whose K3 and K2 mesh mode take the draw buffer
    (``_launch(..., draws, ...)``: the parent of their keyed versions)
    gets the keys' draws."""
    import inspect

    import torch

    import chip_smoke as cs
    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import (blocked_pixel_order,
                                                n_bounce_draws, sample_rays)
    from raytpu_torch.kernels import trace_scene as tsc

    cfg = cfg.replace(width=cs.FRAME[0], height=cs.FRAME[1], max_bounces=6)
    pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
    keys, cam_d = rng.sample_stream(rng.prng_key(0, device=dev), pids, 0, 4)
    origin, direction = sample_rays(cam, cfg, pids, cam_d)
    nd = n_bounce_draws(cfg)
    keyed = "keys" in inspect.signature(tsc._launch).parameters
    src = keys if keyed else rng.bounce_draws(keys, nd, cfg.max_bounces)
    k = tsc.MeshKnobs.for_scene(cfg, scene, nd)
    rays = tuple(t.contiguous() for t in (*origin, *direction))
    return tsc.pack_scene(scene, k), rays, src, k


def _k3_merged(dev, chunk=None):
    """K3's merged forward and recording on the 600-triangle world and
    its sky twin at 1200x900, 6 bounces (the default load), with the
    checkout's walk tables, or with ``chunk`` columns a chunk box of the
    walk; without ``chunk`` also the per-triangle forward and recording
    (merge_quads off)."""
    import chip_smoke as cs
    from raytpu_torch.config import load_scene_file
    from raytpu_torch.kernels import trace_scene as tsc

    out = {}
    for key, path in (("", cs._block_world(cs.MESH_WORLD)),
                      ("_sky", cs._sky_files()[cs.MESH_WORLD])):
        scene, cam, cfg = load_scene_file(path, dev)
        mt, rays, src, k = _mesh_batch(dev, scene, cam, cfg)
        if chunk is not None:
            mt = mt._replace(**dict(zip(
                ("aa_walk", "aa3_walk", "aa_box", "aa3_box"),
                tsc.walk_tables(mt.tri, mt.aa, mt.aa3, k.plan, chunk))))
        for rec in (False, True):
            run = lambda a=(mt, rays, src, k), r=rec: tsc._launch(*a, record=r)
            out[f"k3m{key}{'_rec' if rec else ''}"] = (
                "trace_scene", run if chunk is None else
                _at(tsc, "WALK_CHUNK", chunk, run))
        if chunk is None:
            tri = _mesh_batch(dev, scene, cam, cfg.replace(merge_quads=False))
            for rec in (False, True):
                out[f"k3t{key}{'_rec' if rec else ''}"] = (
                    "trace_scene",
                    lambda a=tri, r=rec: tsc._launch(*a, record=r))
    return out


def _k2_mesh(dev):
    """K2's mesh mode on K3's recording of the 600-triangle world
    (per-triangle, as ``chip_smoke.phase_mesh_bwd_timing``) and of its sky
    twin (``chip_smoke._sky_scene``) at 1200x900, 6 bounces, one sample of
    the RNG kernel's keys (or their draws, ``_mesh_batch``), a random
    cotangent."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.kernels import trace_scene_bwd as tb

    out = {}
    for key, (scene, cam, cfg) in (
            ("", cs._per_triangle(cs._block_world(cs.MESH_WORLD), dev)),
            ("_sky", cs._sky_scene(cs.MESH_WORLD, dev))):
        mt, rays, src, k = _mesh_batch(dev, scene, cam, cfg)
        _, idx, aof = tsc._launch(mt, rays, src, k, record=True)
        tabs = tb.Tables(mt.sph, mt.tri, mt.mats, mt.atlas)
        g = torch.tensor(np.random.default_rng(8).uniform(
            -1, 1, (tb.g_planes(k), rays[0].shape[0])).astype(np.float32),
            device=dev)
        out[f"k2m{key}"] = ("trace_scene_bwd", lambda a=(
            tabs, rays, src, idx, aof, g, k): tb.mesh_backward(*a))
    return out


# name -> a reading of a workload's result (the segment sum's error, the
# plan's mismatches)
_READINGS = {}


def _segment_calls(dev):
    """The gathers' three calls at the shapes of their backward, made
    from a seed: (name, channels, index, rows). ``largest``: 18 channels
    of 1.08 M cotangents over 4,096 rows (the bilinear scan's triangle
    rows; 97% of the entries on row 0, where rays whose winner is no
    triangle go, the rest skewed); ``longest_row``: 4 channels over 11
    rows (one ~90% of the entries, as a material under most rays);
    ``sky``: 3 channels over a 4096x2048 sky's 8,388,608 texels (60% on
    one texel, the rays without a sky event reading direction 0's, the
    rest over the upper half). Half the channels in [-1, 1), half in
    [0, 1)."""
    import numpy as np
    import torch

    gen = np.random.default_rng(9)
    b = 1_080_000
    p11 = np.array([0.9] + [0.01] * 10)
    skewed = (4096 * gen.uniform(size=b) ** 2).astype(np.int64)
    cases = (("largest", 18, 4096, np.where(gen.uniform(size=b) < 0.97, 0,
                                            skewed)),
             ("longest_row", 4, 11, gen.choice(11, size=b, p=p11 / p11.sum())),
             ("sky", 3, 4096 * 2048, np.where(
                 gen.uniform(size=b) < 0.6, 4096 * 1024 + 2048,
                 gen.integers(0, 4096 * 1024, b))))
    out = []
    for name, c, rows, idx in cases:
        g = gen.uniform(-1.0, 1.0, (c, b)).astype(np.float32)
        g[c // 2:] = np.abs(g[c // 2:])
        out.append((name, torch.as_tensor(g, device=dev),
                    torch.as_tensor(idx, device=dev), rows))
    return out


def _segment_sum(dev):
    """The segment sum and its plan on ``_segment_calls``: ``seg_<call>``
    the sums with the plan made (its reading: the worst |sum - exact|
    over the row's sum of |g|, the exact sums in float64 on the CPU,
    chip_smoke's SEG_REL check); ``seg_<call>_plan`` the plan of a fresh
    index (its reading: the entries of (perm, seg, off) that differ from
    ``torch.sort(stable=True)`` + ``searchsorted``); and, for Step 0 of
    the redesign, the PyTorch pieces of the parent's plan and backward
    (``seg0_<call>_sort``, ``_searchsorted``, ``_casts``: its
    ``torch.sort``, ``searchsorted`` over ``arange(rows + 1)`` and three
    int32 copies; ``_stack``: the (C, B) copy of the channels that
    ``_Gather.backward`` stacked)."""
    import torch

    from raytpu_torch.kernels import gather

    out = {}
    for name, g, idx, rows in _segment_calls(dev):
        index = gather.GatherIndex(idx, rows)
        index.sorted_plan()
        cpu = gather.GatherIndex(idx.cpu(), rows)
        exact = gather.segment_sum_reference(g.cpu().double(), cpu)
        scale = gather.segment_sum_reference(g.cpu().double().abs(), cpu)
        seg, perm = torch.sort(idx, stable=True)
        ar = torch.arange(rows + 1, device=dev)
        off = torch.searchsorted(seg, ar)
        want = (perm.int(), seg.int(), off.int())
        chans = [x.clone() for x in g]
        out[f"seg_{name}"] = ("segment_sum",
                              lambda a=(g, index): gather._launch(*a))
        _READINGS[f"seg_{name}"] = lambda got, e=exact, sc=scale: float(
            ((got.cpu().double() - e).abs() / (sc + 1e-30)).max())
        out[f"seg_{name}_plan"] = (
            "index_sort",
            lambda a=(idx, rows): gather.GatherIndex(*a).sorted_plan())
        _READINGS[f"seg_{name}_plan"] = lambda got, w=want: int(sum(
            (x.long() != y.long()).sum().item() for x, y in zip(got, w)))
        out[f"seg0_{name}_sort"] = (
            "segment_pieces", lambda i=idx: torch.sort(i, stable=True))
        out[f"seg0_{name}_searchsorted"] = (
            "segment_pieces", lambda s=seg, r=rows: torch.searchsorted(
                s, torch.arange(r + 1, device=s.device, dtype=s.dtype)))
        out[f"seg0_{name}_casts"] = (
            "segment_pieces", lambda a=(perm, seg, off): tuple(
                x.to(torch.int32) for x in a))
        out[f"seg0_{name}_stack"] = ("segment_pieces",
                                     lambda c=chans: torch.stack(c))
    return out


def _start(cam, cfg, key, pids, rows):
    """A sample's start as the checkout's ``render`` makes it: the ray
    keys, the camera rays and the draw rows ``rows`` of the route
    (``render.sample_start`` on its packed camera; before it, the RNG
    kernel's keys and rows, then ``render.sample_rays``)."""
    from raytpu_torch.core import rng
    from raytpu_torch.integrator import render as rd

    if hasattr(rd, "sample_start"):
        return lambda p=rd.pack_camera(cam): rd.sample_start(
            p, cfg, key, pids, 0, rows)

    def run():
        keys, draws = rng.sample_stream(key, pids, 0, rows)
        return keys, *rd.sample_rays(cam, cfg, pids, draws[:4]), draws[4:]
    return run


def _sample_start(dev):
    """The start of one sample at 1200x900, 6 bounces, under key 0
    (library "rng"): ``start_<scene>_<rows>`` (``_start``) with the 4 rows
    of the megakernel routes and the scan path's 4 + 6 x n_bounce_draws,
    on Cornell, ``cornell_box_dof_ao`` (aperture on) and the MESH_WORLD
    block world; ``sample_rays_<scene>`` the eager camera rays alone on
    the RNG kernel's draws; ``rng_<rows>`` the RNG kernel's draws-only
    launch (``rng._launch``). Where the checkout has the sample-start
    kernel, each ``start_`` workload's reading is the count of words
    (keys, rays, rows) that differ from its plain version's."""
    import torch

    import chip_smoke as cs
    from raytpu_torch import scenes
    from raytpu_torch.config import load_scene_file
    from raytpu_torch.core import rng
    from raytpu_torch.integrator import render as rd

    key = rng.prng_key(0, device=dev)
    out = {}
    for name, (scene, cam, cfg) in (
            ("cornell", scenes.cornell_box(dev)),
            ("dof", scenes.cornell_box_dof_ao(dev)),
            ("block", load_scene_file(cs._block_world(cs.MESH_WORLD), dev))):
        cfg = cfg.replace(width=cs.FRAME[0], height=cs.FRAME[1],
                          max_bounces=6)
        pids = torch.as_tensor(rd.blocked_pixel_order(cfg), device=dev).long()
        for rows in (4, 4 + cfg.max_bounces * rd.n_bounce_draws(cfg)):
            run = _start(cam, cfg, key, pids, rows)
            out[f"start_{name}_{rows}"] = ("rng", run)
            if hasattr(rd, "sample_start_reference"):
                _READINGS[f"start_{name}_{rows}"] = (
                    lambda got, a=(rd.pack_camera(cam), cfg, key, pids, 0,
                                   rows): int((cs._start_words(got)
                                               != cs._start_words(
                                                   rd.sample_start_reference(
                                                       *a))).sum()))
        draws = rng.sample_stream(key, pids, 0, 4)[1]
        out[f"sample_rays_{name}"] = (
            "rng", lambda a=(cam, cfg, pids, draws): rd.sample_rays(*a))
    pids = torch.arange(cs.FRAME[0] * cs.FRAME[1], device=dev)
    for rows in (4, 22):
        out[f"rng_{rows}"] = (
            "rng", lambda r=rows, p=pids: rng._launch(key, p, 0, r))
    return out


def _frames(dev):
    """The frames, at 1200x900, 6 bounces unless noted, over all
    block-ordered pixel ids, ended by a synchronize: name -> (run, spp).
    Cornell (``scenes.cornell_box``) forward at 32 spp and
    forward+backward of every sphere leaf at 8 spp, also with
    ``RAYTPU_SPH_BWD=ad`` (K5); the sky showcase (1000x750, 4 bounces,
    K1) forward at 16 spp; the merged 600-triangle block world forward
    at 16 spp and forward+backward of every float leaf at 4 spp, its sky
    twin likewise (the sky texels too), the same world with the
    per-triangle search likewise, and the scan path's 4096-triangle world
    forward at 4 spp and, with bilinear textures, forward+backward at 2
    spp."""
    import torch

    import chip_smoke as cs
    from raytpu_torch import scenes
    from raytpu_torch.config import load_scene_file
    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import blocked_pixel_order, render
    from raytpu_torch.train import (combine_scene, partition_scene,
                                    photometric_loss)

    def frame(scene, cam, cfg, grads, env=None):
        pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev)
        params, static = partition_scene(scene)
        params = {n: p.detach().clone().requires_grad_(grads)
                  for n, p in params.items()}
        target = torch.zeros((cfg.n_pixels, 3), device=dev)

        def run():
            for p in params.values():
                p.grad = None
            old = os.environ.get("RAYTPU_SPH_BWD")
            if env:
                os.environ["RAYTPU_SPH_BWD"] = env
            try:
                s = render(combine_scene(params, static), cam, cfg, pids,
                           rng.prng_key(0))
                if grads:
                    photometric_loss(s.radiance * (1.0 / cfg.spp),
                                     target).backward()
                torch.cuda.synchronize()
            finally:
                if env:
                    os.environ.pop("RAYTPU_SPH_BWD")
                    if old is not None:
                        os.environ["RAYTPU_SPH_BWD"] = old
        return run, cfg.spp

    out = {}
    scene, cam, cfg = scenes.cornell_box(dev)
    cfg = cfg.replace(width=cs.FRAME[0], height=cs.FRAME[1], max_bounces=6,
                      use_megakernel=True)
    out["cornell_fwd_32spp"] = frame(scene, cam, cfg.replace(spp=32), False)
    out["cornell_fwd_bwd_8spp"] = frame(scene, cam, cfg.replace(spp=8), True)
    out["cornell_fwd_bwd_8spp_ad"] = frame(scene, cam, cfg.replace(spp=8),
                                           True, "ad")
    scene, cam, cfg = cs._sky_scene("show", dev)
    out["sky_show_fwd_16spp"] = frame(scene, cam, cfg.replace(
        spp=16, use_megakernel=True), False)
    for key, path in (("block", cs._block_world(cs.MESH_WORLD)),
                      ("sky", cs._sky_files()[cs.MESH_WORLD])):
        scene, cam, cfg = load_scene_file(path, dev)
        cfg = cfg.replace(width=cs.FRAME[0], height=cs.FRAME[1],
                          max_bounces=6, use_megakernel=True,
                          sky_texture_grads=key == "sky")
        out[f"{key}_fwd_16spp"] = frame(scene, cam, cfg.replace(spp=16), False)
        out[f"{key}_fwd_bwd_4spp"] = frame(scene, cam, cfg.replace(spp=4),
                                           True)
    scene, cam, cfg = cs._per_triangle(cs._block_world(cs.MESH_WORLD), dev)
    cfg = cfg.replace(width=cs.FRAME[0], height=cs.FRAME[1], max_bounces=6,
                      use_megakernel=True)
    out["block_tri_fwd_16spp"] = frame(scene, cam, cfg.replace(spp=16), False)
    out["block_tri_fwd_bwd_4spp"] = frame(scene, cam, cfg.replace(spp=4),
                                          True)
    scene, cam, cfg = cs._per_triangle(cs._block_world(cs.SCAN_WORLD), dev)
    cfg = cfg.replace(width=cs.FRAME[0], height=cs.FRAME[1], max_bounces=6)
    out["scan4096_fwd_4spp"] = frame(scene, cam, cfg.replace(spp=4), False)
    out["scan4096_bilinear_fwd_bwd_2spp"] = frame(scene, cam, cfg.replace(
        spp=2, bilinear_textures=True), True)
    return out


def time_frames(dev, reps=3) -> dict:
    """Per frame of ``_frames``: the wall seconds of ``reps`` runs after
    one warm-up run (``s``: their mean; ``runs``), then one run under
    torch.profiler: its kernels a sample and the device's idle share
    against the unprofiled mean (1 - busy / ``s``)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, (run, spp) in _frames(dev).items():
        run()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            runs.append(round(time.perf_counter() - t0, 4))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        busy_us, count = 0.0, 0
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            if ev.device_type == torch.autograd.DeviceType.CUDA and us:
                busy_us += us
                count += ev.count
        mean = sum(runs) / reps
        out[name] = {"s": round(mean, 4), "runs": runs,
                     "idle": round(max(0.0, 1 - busy_us / 1e6 / mean), 4),
                     "kernels_a_sample": round(count / spp, 1)}
    return out


def workloads(dev, libs, chunk=None):
    """name -> (library, callable) for the libraries in ``libs``; with
    ``chunk``, K4's and the walk's at that cull box size."""
    out = {}
    if set(libs) & set(_CORNELL):
        out.update(_cornell(dev))
    if "intersect" in libs:
        out.update(_k4(dev, chunk))
    if "trace_scene" in libs:
        out.update(_k3_merged(dev, chunk))
    if "trace_scene_bwd" in libs:
        out.update(_k2_mesh(dev))
    if _SEGMENT & set(libs) and importlib.util.find_spec(
            "raytpu_torch.kernels.gather"):
        out.update(_segment_sum(dev))
    if "rng" in libs:
        out.update(_sample_start(dev))
    return {n: w for n, w in out.items() if w[0] in libs}


def check_variants(names) -> None:
    """Each text a variant replaces occurs exactly once in its library's
    sources, so every variant builds what it says."""
    from raytpu_torch.kernels import _build

    for name in names:
        lib, subs = VARIANTS[name]
        text = "".join(p.read_text() for p in _build.sources(lib))
        for old, _ in subs:
            if text.count(old) != 1:
                raise SystemExit(f"kernel_variants: {name}: {old[:60]!r} "
                                 f"occurs {text.count(old)} times in {lib}")


def variant_source(root: str, lib: str, subs) -> None:
    """Apply the substitutions to the library's sources in the csrc copy
    under ``root``."""
    from raytpu_torch.kernels import _build

    for name in (p.name for p in _build.sources(lib)):
        path = os.path.join(root, name)
        text = open(path).read()
        for old, new in subs:
            text = text.replace(old, new)
        open(path, "w").write(text)


def _time_all(fns) -> dict:
    """ms per call of each workload."""
    return {n: round(_time_ms(f), 4) for n, (_, f) in fns.items()}


def _device_all(fns) -> str:
    """The device time of the gathers' and the sample start's workloads,
    by kernel (``_device_ms``: [ms, {kernel: ms}, kernels a call]); the
    sample start's also queued behind a spin kernel (``spin``,
    ``chip_smoke._device_ms``)."""
    import chip_smoke as cs

    got = {}
    for n, (lib, f) in fns.items():
        if lib in _PROFILED:
            got[n] = _device_ms(f)
            if lib == "rng":
                got[n] = {"spin": round(cs._device_ms(f), 4),
                          "profiler": got[n]}
    return f"device ms {json.dumps(got)}" if got else ""


def _read_all(fns) -> str:
    """The readings of the workloads that have one (``_READINGS``)."""
    got = {n: f"{_READINGS[n](f()):.3e}" for n, (_, f) in fns.items()
           if n in _READINGS}
    return f"; readings {json.dumps(got)}" if got else ""


def time_variants(dev, names, fns) -> None:
    """Build the variants ``names`` of the checkout whose ``raytpu_torch``
    is imported, then time each beside that checkout's build on its
    library's workloads in ``fns`` (rebuilt at a chunk variant's size)."""
    from raytpu_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        for name, (so, regs, spills) in build_variants(tmp, names).items():
            lib = VARIANTS[name][0]
            shipped = {n: w for n, w in fns.items() if w[0] == lib}
            mine = (workloads(dev, {lib}, CHUNK_OF[name])
                    if name in CHUNK_OF else shipped)
            shipped_lib = _build._loaded.get(lib)
            _build._loaded[lib] = ctypes.CDLL(so)
            ms, read, device = _time_all(mine), _read_all(mine), _device_all(mine)
            _build._loaded[lib] = shipped_lib
            again = _time_all(shipped)
            print(f"{name}: ms {json.dumps(ms)} (shipped {json.dumps(again)} "
                  f"after it); ptxas registers {regs}, spill stores "
                  f"{spills}{read}" + (f"; {device}" if device else ""),
                  flush=True)


_ALL = {*_CORNELL, "intersect", "trace_scene", *_SEGMENT, "rng"}


def here(frames: bool, only: str, libs: str = "") -> int:
    """Time every workload of the libraries matching ``libs`` (or, with
    ``frames``, every frame) with the checkout in the working directory,
    then its variants matching ``only`` (none if empty)."""
    import torch

    from raytpu_torch.kernels import _build

    names = [n for n in VARIANTS if only and re.search(only, n)]
    check_variants(names)
    _build.build_all()
    dev = torch.device("cuda", 0)
    if frames:
        print(json.dumps(time_frames(dev)))
        return 0
    fns = workloads(dev, {x for x in _ALL if re.search(libs, x)})
    print(json.dumps(_time_all(fns)) + _read_all(fns), flush=True)
    device = _device_all(fns)
    if device:
        print(device, flush=True)
    time_variants(dev, names, fns)
    return 0


def _run_here(tree: str, frames: bool, only: str = "", libs: str = "") -> str:
    """This script's ``--here`` in ``tree``: what it prints (the timings
    of the tree's build on the first line, then its variants')."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--here",
                          *(["--frames"] if frames else []),
                          *(["--only", only] if only else []),
                          *(["--libs", libs] if libs else [])], cwd=tree,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"kernel_variants: {tree}:\n{out.stderr}")
    return out.stdout.strip()


def build_variants(tmp, names):
    """Build every variant's library at once; (name -> (.so path, ptxas
    registers, spill stores))."""
    from raytpu_torch.kernels import _build

    jobs = {}
    for name in names:
        lib, subs = VARIANTS[name]
        src = os.path.join(tmp, name)
        shutil.copytree(_build.CSRC, src)
        variant_source(src, lib, subs)
        so = os.path.join(src, f"lib{lib}.so")
        jobs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(src, f"{lib}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_variants: {name} failed:\n{err}")
        out[name] = (so, re.findall(r"Used (\d+) registers", err),
                     re.findall(r"(\d+) bytes spill stores", err))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout whose kernels to time first")
    ap.add_argument("--only", default="",
                    help="time the variants whose names match (default: "
                         "none; some apply only to a parent's sources)")
    ap.add_argument("--tree-only", default="",
                    help="with --tree: time the variants whose names match "
                         "built from the tree's sources, in its run")
    ap.add_argument("--frames", action="store_true",
                    help="with --tree: time the K3 and K4 frames of the tree "
                         "and this checkout in turns (tree, this, this, "
                         "tree) before the kernels")
    ap.add_argument("--libs", default="",
                    help="time the workloads of the libraries whose names "
                         "match (with --tree, default: all)")
    ap.add_argument("--here", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.here:
        sys.path.insert(0, os.getcwd())
        return here(args.frames, args.only, args.libs)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from raytpu_torch.kernels import _build

    names = [n for n in VARIANTS if args.only and re.search(args.only, n)
             and not (args.tree_only and re.search(args.tree_only, n))]
    check_variants(names)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 1
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    for tree in args.tree:
        if args.frames:
            for who in (tree, root, root, tree):
                print(f"frames of {who}: s {_run_here(who, True)}",
                      flush=True)
        first, *rest = _run_here(tree, False, args.tree_only,
                                 args.libs).splitlines()
        print(f"tree {tree}: ms {first}", flush=True)
        for line in rest:
            print(f"tree {tree}: {line}", flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    libs = {VARIANTS[n][0] for n in names} | {
        x for x in (_ALL if args.tree or args.libs else ())
        if re.search(args.libs, x)}
    fns = workloads(dev, libs)
    print("shipped build: ms " + json.dumps(_time_all(fns)) + _read_all(fns),
          flush=True)
    device = _device_all(fns)
    if device:
        print("shipped build: " + device, flush=True)
    time_variants(dev, names, fns)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
