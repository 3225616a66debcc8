#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``raytpu_torch``) on one CUDA card.

    python3 chip_smoke.py          (from the repository root)

Phases, each of which raises on failure (exit code non-zero):
  1. environment: torch, nvcc and the card (nvidia-smi name, power limit);
  2. build every CUDA source of the port from this checkout, printing
     each kernel's ptxas registers, stack, spills and static shared
     memory from the report kept beside its library (the dynamic shared
     memory of K3's merged modes and K4, as the driver holds it after
     their launches, follows in phases 17 and 30);
  3. RNG parity: the eager threefry stream and the RNG kernel's
     draws-only mode (``csrc/rng.cu``: each ray's key and its draw rows)
     on the card reproduce a table of ``jax.random`` values (computed
     with JAX 0.9.0, pasted below); the kernel bit-equal to the eager
     stream (its plain version) over the full frame's keys for every row
     layout (RNG_ROWS); then the sample start (the same kernel's other
     mode: keys, camera rays and the route's draw rows in one launch a
     sample, what ``render`` runs first every sample) bit-equal to its
     plain version (the eager stream, then ``render.sample_rays``) over
     the full frame for every row layout, on Cornell and the DoF scene
     (aperture on), also with rows 0-3 for the camera's backward; both
     modes timed behind a spin kernel, with the CUDA-events figure;
  4. the sphere megakernel (K1), which takes each ray's key and hashes its
     draws, bit-equal to its plain PyTorch version (on the keys' draws)
     on the card, on five scenes at 64x48 rays, then at the main path's
     shape (1200x900 rays, 6 bounces), timed;
  5. the forward path: a 1200x900, 6-bounce Cornell frame through
     ``render`` over all block-ordered pixel ids, checked finite and lit,
     with one K1 and one sample-start launch per sample, no eager
     threefry and no eager camera-ray kernel in the profile; a small
     frame on the card against the same frame on the CPU, and its camera
     rays against the CPU's word for word (ROADMAP P-F1); the PPM through
     ``render_image``/``write_ppm``;
  6. K1 in recording mode bit-equal to its plain version (planes, winner
     indices, AO factors) and its planes to its own launch without
     recording, on the five scenes of phase 4 at 64x48 rays;
  7. the index-replay backward (K2, sphere mode on the keys) against its
     plain version (the replay under autograd) on those five scenes plus
     the 19-bounce nested refraction stack, at 64x48 rays; two launches
     give the same bits; then K1 recording, K2 and K2's plain version
     timed at the main path's shape;
  8. the training path: value and gradient of the photometric loss
     through ``render`` at 1200x900, 8 spp, 6 bounces with every sphere
     leaf requiring grad (K2 launches == spp), where its time goes
     (``torch.profiler``: sample starts == 2 x spp, no eager threefry),
     then 3 Adam steps of ``train.make_train_step`` towards a
     target the port renders with perturbed colours;
  9. the mesh megakernel (K3), which takes each ray's key and hashes its
     draws, bit-equal to its plain PyTorch version (on the keys' draws)
     at 64x48 rays on six scenes: block worlds written by
     ``scenes.write_block_world`` (60 triangles with water, the same with
     AO, the same untextured; 600 triangles; 2048, K3's limit) and the
     4-triangle cutout / window / emissive scene;
  10. K3 bit-equal to its plain version at the main path's shape (the
     600-triangle world, 1200x900 rays, 6 bounces, the RNG kernel's keys),
     both timed, the plain version counting the search work and the
     hashed draws for the bound, and its warps' issue: the lane slots of
     triangle tests that the union of a warp's lanes' chunks issues over
     those the rays need, and the warp search's split (chunks scanned
     lane by lane, (ray, chunk) entries searched together); the kernel's
     registers and dynamic shared memory;
  11. the mesh forward path: the 600-triangle world at 1200x900, 16 spp,
     6 bounces through ``render`` over all block-ordered pixel ids,
     checked finite and lit, with one K3 launch and one sample start
     (no draw rows) per sample and no K1 or K2 launch; where its time goes (``torch.profiler``); a small frame on
     the card against the CPU; the PPM;
  12. K3 in recording mode against its plain version on the six mesh
     scenes of phase 9 (planes, winners and, where a hit is recorded, AO
     factors bit-equal; planes unchanged by recording);
  13. K2's mesh mode (on the keys) against its plain version on those
     scenes, with the winners K3 recorded: ray cotangents and every row of
     the four table cotangents (the rows that get no cotangent,
     ``QUIET_ROWS``, at rounding level on both sides), and two launches
     bit-identical in all four tables and the ray cotangents; again with
     the texels' table in global memory (``MESH_SMEM_BUDGET`` 0);
  14. K3 recording and K2 mesh mode at the main path's shape (the
     600-triangle world, 1200x900 rays, 6 bounces), compared and timed
     beside their plain versions and bounds;
  15. the mesh training path: value and gradient of the photometric loss
     through ``render`` on that world at 1200x900, 4 spp, 6 bounces with
     every float leaf requiring grad (K3 recording launches == 2 x spp,
     K2 mesh launches == spp, sample starts of no draw rows), where its
     time goes, then 3 Adam steps
     towards a target with perturbed atlas and material colours, whose
     losses must fall;
  16. the scan path's closest-hit kernel (K4) against its plain version,
     winners and distances bit-equal, at 64x48 rays (random rays with
     axis-aligned directions, camera rays and each bounce's rays through
     the scan path) on Cornell, the six mesh scenes of phase 9 and a
     4096-triangle world (K4's limit, twice K3's);
  17. K4 on the 1200x900 camera rays and bounce-2 rays of the 600- and
     4096-triangle worlds, bit-equal to its plain version, timed beside
     it and its bound (the plain version's count of the chunks each ray
     enters before its running best), the bound's share of box tests and
     the bound with ``raytpu``'s 128-triangle boxes;
  18. the scan path against the megakernels on the card (the 600-triangle
     world against K3, Cornell against K1, 64x48x2spp) and against the
     CPU (the 4096-triangle world, 40x30x2spp);
  19. the scan-path forward frame: the 4096-triangle world at 1200x900, 4
     spp, 6 bounces through ``render`` (``use_megakernel`` off), finite
     and lit, K4 launches == spp x bounces x (1 + AO probes) and no K1,
     K2 or K3; where its time goes; the PPM; the same frame on the
     600-triangle world beside phase 11's K3 frame;
  20. the scan-path training path: value and gradient of the photometric
     loss on the 4096-triangle world at 1200x900, 2 spp, 6 bounces with
     bilinear textures and every float leaf requiring grad (K4 launches
     == 2 x spp x bounces: the forward and the checkpoint's recompute;
     the triangle vertices' gradients non-zero), where its time goes,
     then bilinear Adam steps towards a target with perturbed atlas and
     material colours: 2 of every float leaf, printed, and 3 of all but
     those that place a surface or turn a ray (``SCAN_STEP_FROZEN``),
     whose losses must fall; a second fwd+bwd must give the same bits on
     every leaf (ROADMAP P-F8: the winner gathers' backward sums in a
     fixed order, through the index-sort and segment-sum kernels), and
     the profile must hold no ``index_add_`` /
     ``index_put_(accumulate=True)`` and no ``torch.sort`` kernel;
  21. the gathers' plan (the radix sort ``csrc/index_sort.cu``) and
     segment sum (``csrc/segment_sum.cu``) on three calls: the largest and
     the longest-row call of phase 20's backward and the sky texels' call
     of the sky world's fwd+bwd (``compose_sky``): the plan bit-equal to
     ``torch.sort(stable=True)`` + ``searchsorted``, the sums against the
     exact row sums (their plain version, ``index_add_``, in float64 on
     the CPU; SEG_REL), the longest rows summed by the warp (its heavy
     branch), two launches bit-identical; both timed beside their plain
     versions and library calls, with their bounds;
  22. the equirect sky's kernel modes against their plain versions at
     64x48 rays: a generated SKY_SIZE sky (``scenes.write_sky_showcase``,
     the read timed) and block worlds with ``sky=``; K1's sky slot (16
     planes) and its recording on the showcase (also with AO and the HSL
     boost, and with a cutout sphere), K3's on the 60-triangle sky world
     (also with AO and with every texel a cutout) and the MESH_WORLD one,
     rays that leave K3's loop early among them, K3 bit-equal to its
     plain version, its recording too; K2's sky cotangent in sphere and
     mesh modes, two launches bit-identical;
  23. the texel index on the card: the 0-dim tensor divisor's quotient
     correctly rounded, and texel indices of the same directions on the
     card and the CPU;
  24. the sky modes timed at the sky frames' shapes beside their plain
     versions and bounds;
  25. the sky frames at full size under the SKY_SIZE sky: the showcase
     (1000x750, 4 bounces) through K1 at 16 spp; the MESH_WORLD sky world
     through K3 at 16 spp, its fwd+bwd on every float leaf and the sky
     texels at 4 spp, 3 Adam steps at 2 spp whose losses must fall; the
     SCAN_WORLD sky world through the scan path at 4 spp; each with its
     launches, rate and idle share;
  26. the scan path against K1 and K3 on the sky scenes at 64x48x2spp;
  27. ROADMAP P-F12: the scan path's gradients of every float leaf against
     K1/K2 and K3/K2 (Cornell, the showcase, the MESH_WORLD world with and
     without the sky) and against the CPU's scan path, per row;
  28. ROADMAP P-F1 on the sky scenes: card vs CPU radiance, slot texel
     indices and slot directions;
  29. K3's merged-quad search (the default for every mesh TOML) against
     its plain version at 64x48 rays, forward, recording and the sky
     modes, planes bit-equal, on ``scenes.write_quad_fixture`` (also with
     AO), the 60-triangle world (also with AO), the MESH_WORLD and
     2048-triangle worlds and the MESH_WORLD sky world; and against the
     per-triangle kernel on the same rays (winners at bounce 0 and over
     all bounces, outlier rays: tests/test_quad_merge.py's bars);
  30. the merged modes timed at 1200x900, 6 bounces on the MESH_WORLD
     world and its sky twin beside their plain versions and bounds (and
     the bounds' share of box tests);
  31. the mesh frames of phases 11, 15 and 25 through the default
     (merged) load: forward, fwd+bwd of every float leaf, 3 Adam steps
     whose losses must fall;
  32. the AD sphere backward K5 against its plain version (autograd
     through K1's plain version) and bit-equal to K2 on K1's recording, on
     phase 7's six scenes and the sky showcase at 64x48 rays; two
     launches bit-identical;
  33. K5 timed at the Cornell 1200x900, 6-bounce shape beside its plain
     version, K2 and its bound, with K5's and K2's sphere-mode ptxas
     summaries (their shared table sum), and the Cornell fwd+bwd frame
     with ``RAYTPU_SPH_BWD=ad`` (K5 launches == spp, no K2);
  34. the camera's gradient through the sample start (the kernel writes
     rows 0-3; ``render.camera_rays_vjp``) against autograd through the
     plain ``sample_rays`` on the card (CAM_RTOL), on the Cornell and DoF
     frames, and 3 Adam steps of ``make_train_step(train_camera=True)``
     whose losses must fall;
  35. the render command's output path: the 1200x900, 6-bounce Cornell
     frame through ``io/checkpoint.render_image_checkpointed`` (K1, the
     CLI's one tile a frame), OUT_SPP samples in flushes of OUT_FLUSH,
     its sidecar re-labelled as the MAIN_SPP run and resumed, the sums
     bit-equal to ``render_image``'s, one K1 launch and one sample start a
     sample; the same on the merged MESH_WORLD block world (K3); one flush
     timed (the sums' host copy, ``save_checkpoint``); the bilateral and
     the KPCN (``denoise``) on the Cornell frame on the card against the
     same call on the CPU (DN_TOL, KPCN_ATOL; the KPCN's drift with
     cuDNN's TF32 printed beside), timed (wall a call by CUDA events, with
     and without a spin kernel ahead, which their launches outrun; the
     KPCN on weights loaded once, the load timed apart, and as the default
     call that loads them) with their kernels a call and device busy time
     (profiler); their PSNR on
     a QUALITY_SPP Cornell pair against tests/test_denoise_quality.py's
     bars; ``python -m raytpu_torch.cli render cornell`` with every output
     flag as a subprocess: every file written, every stderr progress line
     a JSON object;
  36. the mesh importers: the MESH_WORLD world's mesh as binary PLY with
     UVs, GLB and binary STL, each with an OBJ twin of the arrays it
     parses to (``scenes.write_mesh_twins``), loaded through TOMLs and
     rendered at 1200x900, FMT_SPP spp through merged K3 (a launch a
     sample), each frame bit-equal to its twin's; the native loaders
     (``raytpu_torch/native``, g++) must have built; parse times of each
     format and of the SCAN_WORLD OBJ, native against Python;
  37. ``sharding.render_image_sharded`` of the 1200x900 Cornell frame
     (SHARD_SPP spp, K1) on the grids SHARD_GRIDS of ``cuda:0`` against
     ``render_image``: radiance within SHARD_REL, canvases within 1 on
     every pixel and equal on CANVAS_EQUAL of them, one K1 launch a sample
     in every cell, each grid's wall;
  38. ``cli render cornell --sharded`` as two processes sharing ``cuda:0``
     (gloo on a free localhost port, ``RAYTPU_*`` variables): rank 0's PPM
     against phase 37's frame by the same rule, SHARD_SPP / 2 K1 launches
     a rank, each process's wall with its start apart, its all-reduce;
     a gloo all-reduce of one frame's 38.9 MB of sums between two CPU
     processes, timed;
  39. ROADMAP P-F14: one Adam step at DEEP_BOUNCES bounces, 1200x900,
     DEEP_SPP spp, on Cornell and the MESH_WORLD world with
     ``use_megakernel`` on: routed to the scan path (said once on
     stderr), K4 on the world, no K1-K3; loss, gradients and stepped
     leaves finite and bit-equal to the same step with it off.
Phases 9-28 load their mesh worlds with ``merge_quads`` off (the
per-triangle search), so they compare K3 bit for bit with the scan path
and with the per-triangle times in PERF.md; phases 29-31 take the default.
Each path's launch counts (K1-K5, the RNG kernel, the index sort and the
segment sum; per cell and per process in phases 37 and 38) are set to 0 just
before it and read just after; every render starts each sample with the
sample-start kernel (the scan path reads its bounce rows, K1, K2, K3 and
K5 hash theirs from its keys, so the megakernel routes' launches write
no draw rows). The last lines are the card, a JSON line
per kernel and mode, and the result line. Imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "smoke_out")

# K1 vs its plain version (and card vs CPU): nvcc contracts FMAs where the
# plain path rounds twice, so grazing hits on the radius-500 walls can
# flip. A ray is an outlier if any channel differs by more than
# ATOL + RTOL*|x|; at most OUTLIER_FRAC of the rays may be outliers
# (the tolerance of tests/test_megakernel._compare).
ATOL, RTOL, OUTLIER_FRAC = 1e-4, 1e-5, 0.02
FRAME = (1200, 900)   # the flagship frame (bench.py), width x height
MAIN_SPP = 32
TRAIN_SPP = 8
MESH_SPP = 16         # cut from bench.py's 50: per-sample work is the same
MESH_WORLD = 600      # triangles of the mesh path's block world
MESH_TRAIN_SPP = 4    # the mesh fwd+bwd frame (cut like TRAIN_SPP)
MESH_STEP_SPP = 2     # the mesh Adam steps
SCAN_WORLD = 4096     # triangles of the scan path's world: K4's limit, K3's x2
SCAN_SPP = 4          # the scan-path forward frame (cut like MESH_SPP)
SCAN_TRAIN_SPP = 2    # the scan-path fwd+bwd frame
SCAN_STEP_SPP = 1     # its Adam steps
SCAN_STEP_LR = 1e-2
SKY_SIZE = (4096, 2048)   # the reference's MinecraftSkyDay, width x height
SKY_SHOW_SPP = 16         # the sky showcase (1000x750, 4 bounces) through K1
SKY_MESH_SPP = 16         # the sky world's K3 frame (cut like MESH_SPP)
SKY_TRAIN_SPP = 4         # its fwd+bwd
SKY_STEP_SPP = 2          # its Adam steps
SKY_SCAN_SPP = 4          # the SCAN_WORLD sky world through the scan path
# Leaves the scan-path Adam steps keep fixed. Under bilinear fetch every
# leaf that places a surface or turns a ray gets gradient through later
# bounces' texel lookups, but Adam moves each leaf by about lr whatever
# its gradient, and a 1e-2 move of these crosses the knife edges (a
# bounce ray meeting its own surface again or not, cracks between
# faces), and the loss rises: phase 20 prints two steps of every leaf
# beside the three that must fall. tests/test_torch_scan_grad.py shows
# the vertex gradient to be a descent direction where no knife edge lies
# in the way.
SCAN_STEP_FROZEN = ("spheres.center.", "spheres.radius", "spheres.mat.ior",
                    "spheres.mat.reflection", "triangles.a.", "triangles.b.",
                    "triangles.c.", "mat_table.ior", "mat_table.reflection")
# K1 recording vs its plain version: the recorded winner of a (ray,
# bounce) may flip for the same FMA reason, and a flipped winner sends
# the ray elsewhere for the rest of its bounces; at least IDX_AGREE of
# the (ray, bounce) entries must agree. Where they agree the AO factors
# must agree too, up to the same OUTLIER_FRAC of entries (a grazing AO
# probe can flip as well).
IDX_AGREE = 0.98
# K2 vs its plain version on the same recorded indices: the two sum the
# same terms in another order and contract FMAs differently, and the
# replay's knife-edge guard can turn a recorded hit into a miss on one
# side only. A ray is an outlier if any of its six cotangents differs by
# more than G_ATOL + G_RTOL*|x|; at most OUTLIER_FRAC of rays may be. The
# sphere table's cotangent is a sum over all rays: each row may differ by
# at most DSPH_REL times that row's largest |entry|.
G_ATOL, G_RTOL, DSPH_REL = 1e-4, 1e-4, 1e-3
# the segment sum against the exact row sums (float64): each row within
# SEG_REL of its sum of |cotangents|. Its f32 tree errs by under 2e-7 of
# it on rows of up to 1e6 entries (PERF.md); a 256-entry tile or a
# cross-warp carry left out errs by 2e-2 and more (kernel_variants.py's
# seg_* variants); a serial f32 sum, index_add_ on the CPU, by up to
# 2.5e-5 on one-signed rows of 1e6.
SEG_REL = 1e-5
# K2 sums every table cotangent in a fixed order, without float atomics:
# two launches on the same inputs must give the same bits in all four
# tables and the ray cotangents. QUIET_ROWS get no cotangent: the rows that enter only
# comparisons, indices and floor() (csrc/trace_scene_bwd.cu's header), and
# d_tri's rows 0-2, the vertex a, which is zero in exact arithmetic: a
# triangle's hit distance reaches the output only as the next ray's
# origin, whose cotangent is zero or (after a cutout, which keeps the
# direction) orthogonal to the direction. Both sides must hold them under
# ZERO_ROW of their table's largest |entry|; every other row is measured
# against its largest |entry|, floored at ZERO_ROW of the table's.
ZERO_ROW = 1e-6
QUIET_ROWS = {"d_sph": [12], "d_tri": [*range(9), *range(12, 25)],
              "d_mat": [6, 7, 8], "d_atlas": [3]}
# K3's FP32 operations (arithmetic and compares, as counted in
# csrc/trace_scene.cu) per sphere test and Moller-Trumbore triangle test,
# and per live (ray, bounce) for the winner's texel, material and shading
K3_OPS_SPHERE, K3_OPS_TRI, K3_OPS_SHADE = 33, 46, 210
# a slab test of a cull box, the least it needs, one count for every
# kernel that runs one (K3's slab, box.cuh's meets_box in K4 and in the
# merged walk): per axis 2 subtracts, 2 multiplies, a min and a max (18),
# 2 max and 2 min across the axes (4), 2 compares and their and (3). The
# kernels' NaN guards (~11 more) are their own cost, not the bound's.
OPS_SLAB = 25
# K3's merged search (csrc/trace_scene.cu: merged_search): FP32 operations
# per axis-aligned rect and triangle the walk tests (its numerator and
# its two stop compares, then the test), per chunk it visits (its first
# and last numerators, the stop and reach compares; a chunk box it tests
# costs OPS_SLAB), per general parallelogram test and general leftover
# test, and per live (ray, bounce) for the six group tests and the set-up
# of the groups it enters
K3M_OPS_RECT, K3M_OPS_AATRI, K3M_OPS_HEAD = 22, 26, 7
K3M_OPS_QUAD, K3M_OPS_LEFT, K3M_OPS_GROUPS = 49, 47, 30
# merged against per-triangle (tests/test_quad_merge.py's bars): winners
# equal at bounce 0 and over all bounces
AGREE0, AGREE_ALL = 0.99, 0.95
# K2's FP32 operations per live (ray, bounce): sphere mode's ~510 (the
# replayed bounce, again in the reverse step, and its adjoint) for a
# sphere winner or a miss, ~1,000 for a triangle winner (its distance,
# normal, barycentrics, texel and material replayed twice, plus the
# adjoint of the distance, the normal and the material)
K2_OPS_SPHERE, K2_OPS_TRI = 510, 1000
# The equirect sky: the slot's 7 planes out of K1 / K3 (scale 3, unit
# direction 3, early flag) and the scale's 3 cotangent planes into K2
SKY_SLOT_BYTES, SKY_G_BYTES = 7 * 4, 3 * 4
# phase 35, the render command's output path: the checkpointed Cornell
# frame (OUT_SPP samples in flushes of OUT_FLUSH, re-labelled as the
# MAIN_SPP run and resumed) and block world (OUT_MESH of MESH_OUT_SPP, in
# flushes of OUT_MESH_FLUSH); the denoisers on the card against the same
# call on the CPU: the bilateral within DN_TOL + DN_TOL|x|, the KPCN (TF32
# off) within KPCN_ATOL (the card's expf and convolution order differ
# from the CPU's); tests/test_denoise_quality.py's bars on a QUALITY_SPP
# Cornell pair at QUALITY_SIZE, 4 bounces: KPCN over the bilateral by
# KPCN_MARGIN_DB, the bilateral over the noisy image by BILATERAL_GAIN_DB
OUT_SPP, OUT_FLUSH = 16, 8
OUT_MESH, MESH_OUT_SPP, OUT_MESH_FLUSH = 2, 4, 2
DN_TOL, KPCN_ATOL = 1e-5, 1e-4
QUALITY_SPP, QUALITY_SIZE = (4, 160), (48, 36)
KPCN_MARGIN_DB, BILATERAL_GAIN_DB = 0.5, 1.0
# phases 36-39: the mesh formats (FMT_SPP through merged K3), the sharded
# Cornell frame (SHARD_SPP, the grids SHARD_GRIDS of cuda:0: radiance
# within SHARD_REL of render_image's, canvases within 1 everywhere and
# equal on CANVAS_EQUAL of pixels), the two-process run, and ROADMAP
# P-F14's gradients at DEEP_BOUNCES (DEEP_SPP, in tiles of DEEP_TILE
# pixels: the scan path's backward keeps a sample's 50 bounces, ~37 KB a
# ray on Cornell and ~50 KB on the block world on the card, whose tiles
# of 270,000 pixels peaked at 9.92 and 13.37 GB); each sharded frame and
# its straight twin timed SHARD_RUNS times (host-bound frames spread)
FMT_SPP = 4
SHARD_SPP, SHARD_GRIDS = 16, ((1, 1), (1, 2), (2, 1), (2, 2))
SHARD_REL, CANVAS_EQUAL = 1e-5, 0.999
SHARD_RUNS = 3
DEEP_BOUNCES, DEEP_SPP, DEEP_TILE = 50, 2, 270000
# H100 SXM HBM bytes/s (NVIDIA data sheet), for the bound_ms column.
HBM_BYTES_PER_S = 3.35e12
# FP32 (non-tensor) operations: the SM's issue limit, 4 schedulers x 32
# lanes a clock, x 132 SMs at 1.98 GHz. The data sheet's 67 TFLOP/s is
# that rate x 2, an FMA counted as two operations; every kernel here is
# built with -fmad=false and the K*_OPS constants count single adds,
# multiplies and compares, so each counted operation is one issued
# instruction.
FP32_OPS_PER_S = 128 * 132 * 1.98e9
# INT32 instructions: the same issue limit. The SM has 64 INT32 lanes, but
# nvcc also issues integer adds and shifts as IMAD on the FMA pipe: the RNG
# kernel's 22-row launch beat 64 lanes' time on the card (PERF.md). For the
# threefry hashing of the RNG kernel, K1, K2's sphere mode and K5.
INT32_OPS_PER_S = 128 * 132 * 1.98e9
# csrc/threefry.cuh: INT32 instructions of one fold_in (a hash) and of one
# draw (a hash and its conversion to U[0, 1)), three-input LOP3 / IADD3
# counted once
FOLD_OPS, DRAW_OPS = 73, 76
# The sample start's FP32 operations a ray for its camera ray (csrc/rng.cu:
# u and v 3 each, the jitter 4, 9 an axis for get_rays, the normalisation
# 12; divisions and the square root counted once)
CAM_OPS = 49
# the camera's cotangent through the sample-start kernel against autograd
# through the plain sample_rays, both reduced in float64
CAM_RTOL = 1e-5
# The RNG kernel's row layouts checked against the eager stream at the
# full frame: K1 / K2 / K5's camera rows, then K3's and the scan path's
# 4 + bounces x n_bounce_draws (without AO, one and two AO probes, and the
# 19-bounce stack)
RNG_ROWS = {"camera (K1, K2, K5)": 4, "6b x 3": 22, "6b x 5 (AO 1)": 34,
            "6b x 7 (AO 2)": 46, "19b x 3": 61}
# [seed, pixel, sample, fold_in(PRNGKey(seed), pixel),
#  fold_in(that, sample), bits of uniform(that key, (22,)) as uint32]
RNG_TABLE = [
    [0, 0, 0, [1797259609, 2579123966], [4165894930, 804218099], [1049673900, 1061798078, 1053528080, 1064071826, 1050260700, 1025890848, 1044724104, 1058359588, 1048250688, 1046052600, 1058733790, 1059780606, 1043794264, 1063962254, 1059249112, 1065044316, 1055066396, 1063626636, 1064672592, 1056596272, 1059551074, 1048483128]],
    [0, 1, 999, [928981903, 3453687069], [3928887806, 3004987596], [1043992896, 1061831198, 1060294770, 1054352512, 1063213902, 1064588136, 1048361136, 1027536384, 1051678888, 1041513664, 1055249624, 1036043872, 1059276698, 1052501464, 1053784884, 1061404174, 1063269374, 1062123202, 1057669568, 1024381440, 1057637820, 1064330264]],
    [0, 540599, 31, [786321683, 1693347054], [3110285788, 155785014], [1060379896, 1012388096, 1062035042, 1055950036, 1048444560, 1058206510, 1062212958, 1050395284, 1060938566, 1057772090, 1041812640, 1057829536, 1055368476, 1041322712, 1059176900, 1037815968, 1053696800, 1044932232, 1029289728, 1047308032, 1045718456, 1041664608]],
    [0, 1079999, 999, [4228442464, 1192574233], [2150462513, 2829808071], [1053553096, 1062811332, 1062249040, 1064036688, 1015264832, 1052916864, 1036224736, 1059167050, 1059753140, 1052793640, 1015950400, 1061221984, 1064925536, 1063537164, 1056653520, 1039343888, 1064285372, 1056930092, 1038976048, 1045708616, 1019089408, 1046362728]],
    [0, 1079999, 0, [4228442464, 1192574233], [2991150274, 762749889], [1054866592, 1057896544, 1060069206, 1034478096, 1028723456, 1061344960, 1027789088, 1060693068, 1050015852, 1053561720, 1038074208, 1057652190, 1061510078, 1061157462, 1062465192, 1060471270, 1053629728, 1031296672, 1024987904, 1061370856, 1060142496, 1055146340]],
    [42, 0, 0, [1832780943, 270669613], [1012194634, 3152801799], [1047624728, 1064341390, 1044956952, 1058754586, 1058194066, 1062587402, 1052474516, 1037287840, 1053991040, 1053513024, 1052074284, 1057685600, 1059441438, 1036222736, 1051960216, 1062179578, 1045239904, 1058495868, 1059865450, 1042662112, 1042060080, 1043877160]],
    [42, 1, 999, [64467757, 2916123636], [2102076120, 2054111053], [1045576216, 1060926190, 1063959678, 1058653062, 1059655556, 1057386430, 1061669884, 1044911368, 1043365320, 1048313320, 1050656696, 1056214288, 1059758526, 1058555036, 1057691004, 1064147978, 1055798688, 1059646414, 1047107984, 1053869852, 1047806600, 1060769518]],
    [42, 540599, 31, [86199957, 3704249531], [1532771041, 1800653709], [1049233940, 1061255458, 1059212478, 1035484352, 1062732164, 1054635860, 1029000448, 1042326864, 1059110530, 1058112986, 1057370398, 1063442594, 1026341888, 1048687460, 1053965988, 1050515628, 1057040884, 1057793098, 1044142256, 1059573538, 1035652752, 1050294256]],
    [42, 1079999, 999, [2825038166, 1354660484], [2271441039, 1922877605], [1063518392, 1063911220, 1059135646, 1059721824, 1036204048, 1050283752, 1019035520, 1029112288, 1064648432, 1018002176, 1061733466, 1064840048, 1063100826, 1043392984, 1046790264, 1050940288, 1063934432, 1062814292, 1041620328, 1050754264, 1054227188, 1060728114]],
    [42, 1079999, 0, [2825038166, 1354660484], [665299244, 1123881839], [1046532936, 1037213136, 1064472666, 1054613420, 1059793904, 1064894374, 1062959194, 1031821808, 1053003256, 1031546688, 1060949630, 1055991680, 1040441376, 1033804528, 1057365450, 1033211920, 1064810876, 1058303460, 1064253638, 1062363836, 1061029528, 1044157920]],
]


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def _card() -> str:
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]


def _ptxas_summary(reports):
    """{kernel: {registers, stack, spill_stores, static_smem}} from
    ``{library: _build.ptxas_report(library)}`` (nvcc -Xptxas -v of each
    library, kept beside it), the entry names demangled by c++filt where
    the machine has it. Raises if a library's report names no kernel."""
    import re
    import shutil

    out = {}
    for lib, text in reports.items():
        if "Compiling entry function '" not in text:
            raise AssertionError(f"ptxas: no kernel in {lib}'s report")
        for part in text.split("Compiling entry function '")[1:]:
            name = part.split("'")[0]
            num = lambda pat: int((re.search(pat, part) or [0, 0])[1])
            out[(lib, name)] = dict(
                registers=num(r"Used (\d+) registers"),
                stack=num(r"(\d+) bytes stack frame"),
                spill_stores=num(r"(\d+) bytes spill stores"),
                static_smem=num(r"(\d+) bytes smem"))
    if shutil.which("c++filt") and out:
        names = _run(["c++filt", *(n for _, n in out)]).splitlines()
        out = {(lib, pretty.replace("(anonymous namespace)::", "")
                .split("(")[0]): v
               for ((lib, _), v), pretty in zip(out.items(), names)}
    return {f"{lib}: {name}": v for (lib, name), v in out.items()}


def _ptxas_of(ptxas, *needles):
    """The ``_ptxas_summary`` entry whose name holds one of ``needles``;
    raises if there is none."""
    found = next((v for name, v in ptxas.items()
                  if any(n in name for n in needles)), None)
    if found is None:
        raise AssertionError(f"ptxas: no kernel named like {needles}")
    return found


def _outliers(x, y):
    """(outlier fraction over rays, [max |x - y| per plane]) for (3, B)."""
    diff = (x - y).abs()
    bad = (diff > ATOL + RTOL * x.abs()).any(dim=0)
    return bad.float().mean().item(), diff.max(dim=1).values.tolist()


PLANES = (("radiance", slice(0, 3)), ("albedo", slice(3, 6)),
          ("normal", slice(6, 9)), ("sky scale", slice(9, 12)),
          ("sky dir", slice(12, 15)), ("sky early", slice(15, 16)))


def _compare(name, ref, out):
    """ref/out: (9, B), or (16, B) with the sky slot's planes. Raises on
    NaN or more than OUTLIER_FRAC outliers in a group of planes."""
    if not (out.isfinite().all() and ref.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    worst = 0.0
    for p, sl in PLANES[:6 if ref.shape[0] == 16 else 3]:
        frac, mx = _outliers(ref[sl], out[sl])
        worst = max(worst, *mx)
        print(f"  {name:24s} {p:8s} outliers {frac:.5f}  max|diff| xyz "
              + " ".join(f"{m:.3e}" for m in mx))
        if frac > OUTLIER_FRAC:
            raise AssertionError(f"{name} {p}: {frac:.2%} rays differ")
    return worst


def _time_ms(fn, iters):
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=10):
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin kernel (``torch.cuda._sleep``) that outlasts
    the host's launches, so the events time the device's work back to
    back. Events around a loop alone time the host's launches where those
    take longer (the gathers' wrappers launch 3 to 11 kernels a call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(4e9 * loop_s) + 2_000_000)   # ~2x the loop at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_rng(dev):
    """RNG parity: the eager stream (the RNG kernel's plain version) and the
    RNG kernel on the card against RNG_TABLE (JAX's bits), then the kernel
    against the eager stream over the full frame's keys for every row
    layout of RNG_ROWS, then both timed at the Cornell sample's shape
    (the camera rows K1 takes, and the 22 rows K3 and the scan path
    read)."""
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.integrator.render import blocked_pixel_order

    mask = 0xFFFFFFFF
    for seed, pix, smp, kp_want, ks_want, bits_want in RNG_TABLE:
        key = rng.prng_key(seed, device=dev)
        pids = torch.tensor([pix], device=dev)
        kp = rng.pixel_keys(key, pids)
        ks = rng.sample_keys(kp, smp)
        cam, bounce = rng.ray_uniforms(ks, 4, 3, 6)
        draws = torch.cat([cam.reshape(-1), bounce.reshape(-1)])
        uni = rng.uniform(ks[0], (22,))
        k_keys, k_draws = rng._launch(key, pids, smp, 22)
        got = {
            "pixel_keys": kp[0].tolist(), "sample_keys": ks[0].tolist(),
            "ray_uniforms": (draws.view(torch.int32).long() & mask).tolist(),
            "uniform": (uni.view(torch.int32).long() & mask).tolist(),
            "kernel keys": (k_keys[:, 0].long() & mask).tolist(),
            "kernel draws": (k_draws[:, 0].view(torch.int32).long()
                             & mask).tolist(),
        }
        want = {"pixel_keys": kp_want, "sample_keys": ks_want,
                "ray_uniforms": bits_want, "uniform": bits_want,
                "kernel keys": ks_want, "kernel draws": bits_want}
        for k in got:
            if got[k] != want[k]:
                raise AssertionError(
                    f"rng {k} seed={seed} pixel={pix} sample={smp}: "
                    f"{got[k]} != {want[k]}"
                )
    print(f"rng parity: {len(RNG_TABLE)}/{len(RNG_TABLE)} (seed, pixel, "
          "sample) rows bit-exact on the card (fold_in, uniform, "
          "pixel_keys, sample_keys, ray_uniforms; the RNG kernel's keys and "
          "22 draws)")

    frame = (FRAME[0], FRAME[1])
    pids = torch.as_tensor(blocked_pixel_order(
        RenderConfig(width=frame[0], height=frame[1])), device=dev).long()
    key = rng.prng_key(0, device=dev)
    for name, rows in RNG_ROWS.items():
        k_keys, k_draws = rng._launch(key, pids, 7, rows)
        p_keys, p_draws = rng.stream_reference(key, pids, 7, rows)
        if not (torch.equal(k_keys, p_keys) and torch.equal(k_draws, p_draws)):
            raise AssertionError(f"RNG kernel != eager stream, rows {name}")
    print(f"RNG kernel bit-equal to the eager stream over the {frame[0]}x"
          f"{frame[1]} frame's keys for every row layout: "
          + ", ".join(f"{n} ({r} rows)" for n, r in RNG_ROWS.items()))
    res = {}
    for rows in (4, 22):
        res[rows] = _time_start(
            f"RNG kernel (draws only), {rows} rows",
            lambda r=rows: rng._launch(key, pids, 0, r),
            lambda r=rows: rng.stream_reference(key, pids, 0, r),
            _rng_bound(pids.shape[0], rows))
    return res


def _time_start(what, kernel, plain, bound):
    """A sample-start or RNG kernel call timed at the frame's shape: its
    device time queued behind a spin kernel (``_device_ms``), CUDA events
    around 20 calls in turns with its plain version (3 calls), printed
    beside the bound."""
    import numpy as np

    kernel(), plain()
    t = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which].append(_time_ms(kernel if which == "kernel" else plain,
                                 20 if which == "kernel" else 3))
    ev, plain_ms = float(np.mean(t["kernel"])), float(np.mean(t["plain"]))
    dev_ms = _device_ms(kernel)
    print(f"  {what}: device {dev_ms:.4f} ms (behind a spin kernel), events "
          f"{ev:.4f} ms; plain {plain_ms:.4f} ms; bound {bound[0]:.4f} ms, "
          f"{bound[1]}; turns {t}")
    return dict(ms=dev_ms, events_ms=ev, plain_ms=plain_ms, bound=bound)


def _start_words(start):
    """A sample start (keys, origin, direction, rows) as one int32 tensor of
    its words on the CPU."""
    import torch

    keys, o, d, rows = start
    return torch.cat([t.reshape(-1).cpu() for t in (
        keys, torch.stack([*o, *d]).view(torch.int32),
        rows.contiguous().view(torch.int32))])


def phase_sample_start(dev):
    """The sample-start kernel (``csrc/rng.cu``: each ray's key, camera ray
    and the route's draw rows, one launch a sample) bit-equal to its plain
    version (``render.sample_start_reference``: the eager stream, then
    ``sample_rays``) over the full frame's block-ordered pixel ids, for
    every row layout of RNG_ROWS, on Cornell (no aperture) and
    ``cornell_box_dof_ao`` (aperture); the camera-gradient layout (rows
    0-3 written too) the same planes; then timed at the frame's shape for
    the megakernel routes (keys and rays) and the scan path's 22 rows."""
    import torch

    from raytpu_torch import scenes
    from raytpu_torch.core import rng
    from raytpu_torch.integrator import render as rd

    key = rng.prng_key(0, device=dev)
    for name, (_, cam, cfg) in (("cornell", scenes.cornell_box(dev)),
                                ("dof+ao", scenes.cornell_box_dof_ao(dev))):
        cfg = cfg.replace(width=FRAME[0], height=FRAME[1])
        pids = torch.as_tensor(rd.blocked_pixel_order(cfg), device=dev).long()
        pack = rd.pack_camera(cam)
        for rname, rows in RNG_ROWS.items():
            got = _start_words(rd.kernel_start(pack, cfg, key, pids, 7, rows))
            want = _start_words(rd.sample_start_reference(pack, cfg, key,
                                                          pids, 7, rows))
            bad = int((got != want).sum())
            if bad:
                raise AssertionError(f"sample start, {name}, rows {rname}: "
                                     f"{bad} of {got.numel()} words differ "
                                     "from the plain version")
        ap = (cfg.aperture_x, cfg.aperture_y)
        full = rng.launch_start(key, pids, pack, 7, cfg.width, cfg.height, ap,
                                cfg.focus_distance, 0, 22)
        draws = rng.stream_reference(key, pids, 7, 22)[1]
        part = rng.launch_start(key, pids, pack, 7, cfg.width, cfg.height, ap,
                                cfg.focus_distance, 4, 22)
        if not (torch.equal(full[8:].view(torch.int32),
                            draws.view(torch.int32))
                and torch.equal(full[:8].view(torch.int32),
                                part[:8].view(torch.int32))):
            raise AssertionError(f"sample start, {name}: the camera-gradient "
                                 "layout (rows 0-3 written) differs")
        print(f"sample start bit-equal to its plain version over the "
              f"{cfg.width}x{cfg.height} frame on {name} (aperture "
              f"{cfg.aperture_x}, {cfg.aperture_y}): keys, origin, direction "
              "and rows for every row layout ("
              + ", ".join(f"{r}" for r in RNG_ROWS.values())
              + "), and with rows 0-3 for the camera's backward")

    _, cam, cfg = scenes.cornell_box(dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], max_bounces=6)
    pids = torch.as_tensor(rd.blocked_pixel_order(cfg), device=dev).long()
    pack = rd.pack_camera(cam)
    res = {}
    for what, rows in (("megakernel routes (keys + rays)", 4),
                       ("scan path (+ 18 bounce rows)", 22)):
        res[rows] = _time_start(
            f"sample start, {what}",
            lambda r=rows: rd.kernel_start(pack, cfg, key, pids, 0, r),
            lambda r=rows: rd.sample_start_reference(pack, cfg, key, pids, 0,
                                                     r),
            _start_bound(pids.shape[0], rows))
    return res


def _start_bound(b, n_rows, row0=4):
    """Least sample-start time: 8 B of pixel id in, 8 B of key, 24 B of ray
    and 4 B a written row (row0 .. n_rows-1) out per ray, the camera's 48
    B once; two fold_ins and n_rows draws per ray at the INT32 issue rate,
    CAM_OPS per ray at the FP32 rate."""
    return _bound(b * (8 + 8 + 24 + 4 * (n_rows - row0)) + 16 + 48,
                  b * CAM_OPS, b * (2 * FOLD_OPS + n_rows * DRAW_OPS))


def phase_camera_grad(dev, card):
    """The camera's gradient through the sample-start kernel (the forward
    writes rows 0-3 too; the backward ``render.camera_rays_vjp``) against
    autograd through the plain ``sample_rays`` on the same draws, both on
    the card and reduced in float64, within CAM_RTOL, on the Cornell and
    DoF frames' rays with random cotangents; then 3 Adam steps of
    ``make_train_step(train_camera=True)`` at the flagship frame, whose
    losses must fall, every camera leaf given a finite gradient."""
    import numpy as np
    import torch

    from raytpu_torch import scenes
    from raytpu_torch.core import rng
    from raytpu_torch.integrator import render as rd
    from raytpu_torch.train import combine_scene, make_train_step, partition_scene

    key = rng.prng_key(0, device=dev)
    worst = 0.0
    for i, (name, (_, cam, cfg)) in enumerate((
            ("cornell", scenes.cornell_box(dev)),
            ("dof+ao", scenes.cornell_box_dof_ao(dev)))):
        cfg = cfg.replace(width=FRAME[0], height=FRAME[1])
        pids = torch.as_tensor(rd.blocked_pixel_order(cfg), device=dev).long()
        pack = rd.pack_camera(cam).detach().requires_grad_()
        gen = np.random.default_rng(40 + i)
        g_o, g_d = (torch.tensor(gen.uniform(-1, 1, (3, cfg.n_pixels)).astype(
            np.float32), device=dev) for _ in range(2))
        _reset_launches()
        _, o, d, _ = rd.sample_start(pack, cfg, key, pids, 3, 4)
        if rng.start_launches != 1 or rng.rows_written != 4:
            raise AssertionError(f"camera grad, {name}: {rng.start_launches} "
                                 f"sample starts writing {rng.rows_written} "
                                 "rows, want 1 writing rows 0-3")
        loss = sum((g * x).sum() for g, x in zip(g_o, o)) + sum(
            (g * x).sum() for g, x in zip(g_d, d))
        got = torch.autograd.grad(loss, pack)[0]
        c = pack.detach().double().requires_grad_()
        draws = rng.stream_reference(key, pids, 3, 4)[1]
        po, pd = rd.sample_rays(rd.unpack_camera(c), cfg, pids, draws.double())
        ploss = sum((g.double() * x).sum() for g, x in zip(g_o, po)) + sum(
            (g.double() * x).sum() for g, x in zip(g_d, pd))
        want = torch.autograd.grad(ploss, c)[0].float()
        rel = ((got - want).abs() / want.abs().clamp(min=1e-30)).max().item()
        worst = max(worst, rel)
        print(f"  camera grad, {name}: the kernel route's (camera_rays_vjp) "
              f"against autograd through the plain sample_rays: max rel "
              f"{rel:.3e} (limit {CAM_RTOL}); |grad| "
              f"{want.abs().max().item():.4e}")
        if not rel <= CAM_RTOL:
            raise AssertionError(f"camera grad, {name}: rel {rel:.3e}")

    scene, cam, cfg = scenes.cornell_box(dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=TRAIN_SPP,
                      max_bounces=6, use_megakernel=True)
    pids = torch.arange(cfg.n_pixels, device=dev)
    tparams, static = partition_scene(scene)
    tparams = {n: p.detach().clone() for n, p in tparams.items()}
    for c in "xyz":
        tparams[f"spheres.mat.diffuse.{c}"] = (
            tparams[f"spheres.mat.diffuse.{c}"] * 0.8).clamp(0.0, 1.0)
    with torch.no_grad():
        tsums = rd.render(combine_scene(tparams, static), cam, cfg, pids, key)
        tgt = (tsums.radiance * (1.0 / cfg.spp)).to_array()
    init_fn, step_fn = make_train_step(cfg, 1e-2, train_camera=True)
    state, static = init_fn(scene, cam)
    losses = []
    _reset_launches()
    for _ in range(3):
        state, loss = step_fn(state, static, cam, pids, tgt, key)
        losses.append(loss.item())
    _check_rng("train_camera steps", 3 * 2 * cfg.spp, rows=4)
    grads = [p.grad for p in state.cam_params.values()]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and all(g is not None and g.isfinite().all() for g in grads)):
        raise AssertionError(f"train_camera: losses {losses}, camera grads "
                             f"{grads}")
    print(f"train_camera: 3 Adam steps (lr 1e-2, every sphere and camera "
          f"leaf) at {cfg.width}x{cfg.height} spp={cfg.spp} on {card}: "
          "losses " + " ".join(f"{x:.6e}" for x in losses)
          + "; sample starts write rows 0-3 for the camera's backward")
    return dict(max_rel=worst, losses=losses)


def _rng_bound(b, rows):
    """Least RNG kernel time: 8 B of pixel id in, 8 B of key and 4 B a row
    out per ray, against two fold_ins and a draw a row per ray at the
    INT32 issue rate."""
    return _bound(b * (8 + 8 + 4 * rows) + 16, 0,
                  b * (2 * FOLD_OPS + rows * DRAW_OPS))


def _refractive_scene(dev):
    from raytpu_torch.camera import make_camera
    from raytpu_torch.core.types import RenderConfig, Scene
    from raytpu_torch.scenes import BLACK, WHITE, spheres_from_rows

    rows = [
        ((0, -501, 0), 500.0, WHITE, BLACK, 0.0, 0.0, 1.0, 1.0),
        ((0, 1.5, -3), 0.8, BLACK, (1.0, 0.9, 0.7), 5.0, 0.0, 1.0, 1.0),
        ((0, 0, -3), 0.7, WHITE, BLACK, 0.0, 0.2, 0.1, 1.5),    # glass
        ((0.9, 0, -2.2), 0.4, WHITE, BLACK, 0.0, 0.0, 0.0, 1.0),  # cutout
    ]
    cam = make_camera((0, 0, 1), (0, 0, -3), (0, 1, 0), 50.0, 1.5, device=dev)
    return Scene(spheres_from_rows(rows, dev)), cam, RenderConfig(max_bounces=6)


def _kernel_inputs(scene, cam, cfg, seed, dev):
    """(camera rays origin, direction, bounce draws (max_bounces, n_draws,
    B), ray keys (2, B) int32) on the card: random keys from a numpy seed,
    the camera rays from their draws 0-3 and the bounce draws theirs
    (the eager stream), so the keyed kernels (K1, K2, K3, K5) take the
    keys and their plain versions the draws."""
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import n_bounce_draws, sample_rays

    rs = np.random.default_rng(seed)
    b = cfg.n_pixels
    pids = torch.arange(b, device=dev)
    keys = torch.tensor(rs.integers(-2**31, 2**31, (2, b)).astype(np.int32),
                        device=dev)
    origin, direction = sample_rays(cam, cfg, pids, rng.draws_at(keys, range(4)))
    draws = rng.bounce_draws(keys, n_bounce_draws(cfg), cfg.max_bounces)
    return origin, direction, draws.view(cfg.max_bounces, -1, b), keys


def _frame_sample(cam, cfg, dev, rows=None):
    """Sample 0 of the frame's block-ordered pixel ids under key 0 through
    the sample-start kernel: (origin, direction, ray keys (2, B), bounce
    draws (max_bounces, n_draws, B), a callable that redoes the sample's
    start for timing, the row count it makes). ``rows``: the rows a
    route's start makes (default: every row, the scan path's; 4 for K1's
    and K3's, which hash their bounce draws from the keys)."""
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import (
        blocked_pixel_order, n_bounce_draws, pack_camera, sample_start)

    pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
    key = rng.prng_key(0, device=dev)
    nd = n_bounce_draws(cfg)
    all_rows = 4 + cfg.max_bounces * nd
    pack = pack_camera(cam)
    keys, origin, direction, draws = sample_start(pack, cfg, key, pids, 0,
                                                  all_rows)
    rows = all_rows if rows is None else rows

    def redo():
        return sample_start(pack, cfg, key, pids, 0, rows)

    return (origin, direction, keys, draws.view(cfg.max_bounces, nd, -1),
            redo)


def _both(scene, cfg, origin, direction, draws, keys, counts=None):
    """(plain, kernel) outputs as (9, B) on the same card tensors: the
    plain version on the keys' draws, the kernel (through the wrapper) on
    the keys. ``counts`` receives the plain version's work counts."""
    import torch

    from raytpu_torch.kernels import trace_spheres as ts

    sph = ts.pack_spheres(scene)
    k = ts.Knobs.create(cfg, scene.spheres.count, draws.shape[1])
    ref = ts.trace_spheres_reference(sph, *origin, *direction,
                                     draws.reshape(-1, draws.shape[-1]), k,
                                     counts=counts)
    out = torch.cat([v.to_array().T for v in
                     ts.trace_megakernel(scene, cfg, origin, direction, keys)])
    return ref, out


def _bit_equal(name, ref, out):
    """Raises unless the keyed kernel's output equals its plain version's
    bit for bit (tensors, or tuples of tensors and None)."""
    import torch

    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    for a, b in zip(ref, out):
        if (a is None) != (b is None) or (
                a is not None and not torch.equal(a, b)):
            raise AssertionError(f"{name}: the kernel is not bit-equal to "
                                 "its plain version")


def phase_k1(dev):
    from raytpu_torch import scenes

    cases = [
        ("cornell 6b", scenes.cornell_box(dev), dict(max_bounces=6)),
        ("refractive+cutout 6b", _refractive_scene(dev), {}),
        ("dof+ao ao_samples=1", scenes.cornell_box_dof_ao(dev),
         dict(max_bounces=4, ao_samples=1)),
        ("dof+ao ao_samples=2", scenes.cornell_box_dof_ao(dev),
         dict(max_bounces=4, ao_samples=2)),
        ("cornell_cuda hsl+ao", scenes.cornell_box_cuda(dev), {}),
    ]
    print(f"K1 (keyed) vs plain at 64x48 rays: bit-equal required (the "
          f"differences printed, outlier: any channel > {ATOL} + {RTOL}|x|)")
    for i, (name, (scene, cam, cfg), over) in enumerate(cases):
        cfg = cfg.replace(width=64, height=48, **over)
        origin, direction, draws, keys = _kernel_inputs(scene, cam, cfg,
                                                        100 + i, dev)
        ref, out = _both(scene, cfg, origin, direction, draws, keys)
        _compare(name, ref, out)
        _bit_equal(name, ref, out)
    print("  K1 bit-equal to its plain version on every scene")


def phase_k1_timing(dev):
    """K1 and its plain version at the main path's shapes (one sample of
    the 1200x900, 6-bounce Cornell frame, the RNG kernel's keys), bit-equal,
    then timed with CUDA events in turns, with the RNG work of one sample
    (the RNG kernel's camera rows and the camera rays)."""
    import numpy as np

    from raytpu_torch.kernels import trace_spheres as ts
    from raytpu_torch.scenes import cornell_box

    scene, cam, cfg = cornell_box(dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], max_bounces=6)
    origin, direction, keys, draws, rng_sample = _frame_sample(cam, cfg, dev, 4)
    counts = {}
    ref, out = _both(scene, cfg, origin, direction, draws, keys, counts)
    print(f"K1 vs plain at the main path's shape ({cfg.width}x{cfg.height} "
          f"rays, 6 bounces):")
    max_err = _compare(f"cornell {cfg.width}x{cfg.height} 6b", ref, out)
    _bit_equal("K1 at the main path's shape", ref, out)
    frac = max(_outliers(ref[s], out[s])[0]
               for s in (slice(0, 3), slice(3, 6), slice(6, 9)))

    sph = ts.pack_spheres(scene)
    k = ts.Knobs.create(cfg, scene.spheres.count, draws.shape[1])
    flat = draws.reshape(-1, draws.shape[-1])
    rays = (*origin, *direction)
    kernel = lambda: ts._launch(sph, rays, keys, k)
    plain = lambda: ts.trace_spheres_reference(sph, *rays, flat, k)
    kernel(), plain()                                  # warm up
    t = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which].append(_time_ms(kernel if which == "kernel" else plain,
                                 20 if which == "kernel" else 3))
    rng_ms = np.mean([_time_ms(rng_sample, 5) for _ in range(2)])
    ms, plain_ms = float(np.mean(t["kernel"])), float(np.mean(t["plain"]))
    print(f"  K1 kernel {ms:.4f} ms  plain {plain_ms:.4f} ms per call "
          f"(turns: kernel {t['kernel']}, plain {t['plain']}); bit-equal; "
          f"sample start (RNG kernel: keys + camera rays) {rng_ms:.4f} ms "
          f"per sample (events); draws "
          f"hashed {counts['draws']} (+{counts.get('probe_draws', 0)} AO) "
          f"over {counts['live']} live (ray, bounce) entries")
    return dict(ms=ms, plain_ms=plain_ms, rng_ms=float(rng_ms),
                max_abs_err=max_err, outlier_frac=frac, counts=counts)


def phase_main(dev, card, timing):
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import (
        blocked_pixel_order, render, render_image)
    from raytpu_torch.io.ppm import write_ppm
    from raytpu_torch.scenes import cornell_box

    scene, cam, cfg = cornell_box(dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=MAIN_SPP, max_bounces=6,
                      use_megakernel=True)
    pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev)
    key = rng.prng_key(0)

    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = render(scene, cam, cfg, pids, key)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches, k2_launches, k3_launches, k4_launches, _ = _launches()
    rng_launches = _rng_launches()
    _check_rng("main path", cfg.spp, rows=0)

    rad = sums.radiance.to_array()
    mean = rad.double().mean().item() / cfg.spp
    if not (rad.isfinite().all() and sums.albedo.to_array().isfinite().all()
            and sums.normal.to_array().isfinite().all()):
        raise AssertionError("main path: non-finite sums")
    if not mean > 0.0:
        raise AssertionError(f"main path: mean radiance {mean} is not > 0")
    if (launches, k2_launches, k3_launches, k4_launches) != (cfg.spp, 0, 0, 0):
        raise AssertionError(f"main path: {launches} K1, {k2_launches} K2, "
                             f"{k3_launches} K3 and {k4_launches} K4 launches, "
                             f"want {cfg.spp}, 0, 0, 0")
    rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
    print(f"main path: cornell {cfg.width}x{cfg.height} spp={cfg.spp} "
          f"bounces={cfg.max_bounces}: {elapsed:.4f} s, "
          f"{rays / elapsed:.1f} rays/s end to end on {card}; "
          f"K1 launches {launches}, RNG kernel launches {rng_launches}; "
          f"mean radiance {mean:.6f}")
    print(f"  per sample (CUDA events, same shapes): sample start (keys + "
          f"camera rays) "
          f"{timing['rng_ms']:.4f} ms, K1 {timing['ms']:.4f} ms -> "
          f"RNG {cfg.spp * timing['rng_ms'] / 1e3:.4f} s, "
          f"K1 {cfg.spp * timing['ms'] / 1e3:.4f} s of the frame; "
          f"K1 alone {cfg.n_pixels * cfg.max_bounces / timing['ms'] * 1e3:.1f} rays/s")
    frame = _profile(lambda: render(scene, cam, cfg.replace(spp=2), pids, key))
    _print_profile("the Cornell frame at spp=2", *frame)
    _no_eager_threefry("the Cornell frame", frame[3])
    _unprofiled_idle("the Cornell frame", frame[1] / 2,
                     elapsed * 1e3 / cfg.spp)

    # the same small frame on the card (K1) and on the CPU (plain path)
    small = cfg.replace(width=40, height=30, spp=2)
    cpu_scene, cpu_cam, _ = cornell_box("cpu")
    small_ids = np.arange(small.n_pixels)
    a = render(cpu_scene, cpu_cam, small, small_ids, rng.prng_key(3))
    b = render(scene, cam, small, small_ids, rng.prng_key(3))
    _compare("40x30x2spp card vs cpu",
             torch.cat([v.to_array().T for v in a[:3]]),
             torch.cat([v.to_array().T.cpu() for v in b[:3]]))
    # ROADMAP P-F1: the card's camera rays against the CPU's on the same
    # keys, the kernel's and the plain version's on the card: from the same
    # camera values (the card's, copied), and from each device's own camera
    # (make_camera's tan and normalisations run on each)
    from raytpu_torch.integrator.render import (
        pack_camera, sample_start, sample_start_reference)

    ids, pack = torch.as_tensor(small_ids), pack_camera(cam)
    on_card = (small, rng.prng_key(3, device=dev), ids.to(dev), 1, 4)
    kern = _start_words(sample_start(pack, *on_card))
    plain = _start_words(sample_start_reference(pack, *on_card))
    pf1 = {"words": kern.numel(),
           "cameras_differ": int((pack.cpu().view(torch.int32)
                                  != pack_camera(cpu_cam).view(torch.int32))
                                 .sum())}
    for what, cpu_pack in (("same_camera", pack.cpu()),
                           ("own_camera", pack_camera(cpu_cam))):
        cpu = _start_words(sample_start(cpu_pack, small, rng.prng_key(3),
                                        ids, 1, 4))
        pf1[what] = {"kernel": int((kern != cpu).sum()),
                     "plain_on_card": int((plain != cpu).sum())}
    print(f"  P-F1, camera rays at {small.width}x{small.height} (keys, "
          f"origin, direction: {pf1['words']} words): words that differ from "
          f"the CPU's, from the card's camera values: the sample-start kernel "
          f"{pf1['same_camera']['kernel']}, the plain version on the card "
          f"{pf1['same_camera']['plain_on_card']}; from each device's own "
          f"camera ({pf1['cameras_differ']} of its 12 values differ): "
          f"{pf1['own_camera']['kernel']} and "
          f"{pf1['own_camera']['plain_on_card']}")

    img = render_image(scene, cam, cfg.replace(pixel_tile=cfg.n_pixels), key)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "chip_smoke_cornell.ppm")
    write_ppm(path, img.canvas)
    means = img.canvas.reshape(-1, 3).mean(axis=0)
    print(f"wrote {os.path.relpath(path, ROOT)}: canvas channel means "
          f"r={means[0]:.3f} g={means[1]:.3f} b={means[2]:.3f}")
    return (launches, k2_launches, k3_launches, k4_launches, rng_launches,
            frame, pf1)


def _stack_scene(dev):
    """scenes/refraction_stack.toml as sphere rows: glass > water > dense
    core, nested, under two lights; 19 bounces."""
    from raytpu_torch.camera import make_camera
    from raytpu_torch.core.types import RenderConfig, Scene
    from raytpu_torch.scenes import BLACK, spheres_from_rows

    rows = [
        # center,        radius, diffuse, emission, e_str, refl, alpha, ior
        ((0, -501, 0), 500.0, (0.9, 0.9, 0.9), BLACK, 0.0, 0.0, 1.0, 1.0),
        ((0, 0, -504), 500.0, (0.85, 0.88, 0.95), BLACK, 0.0, 0.0, 1.0, 1.0),
        ((0.0, 4.2, -1.0), 2.2, BLACK, (1.0, 0.97, 0.9), 3.0, 0.0, 1.0, 1.0),
        ((-2.6, 0.6, 0.4), 0.7, BLACK, (1.0, 0.55, 0.25), 4.0, 0.0, 1.0, 1.0),
        ((0.0, 0.0, -1.0), 1.0, (1.0, 1.0, 1.0), BLACK, 0.0, 0.3, 0.1, 1.5),
        ((0.0, 0.0, -1.0), 0.65, (0.7, 0.85, 1.0), BLACK, 0.0, 0.93, 0.5, 1.33),
        ((0.0, 0.0, -1.0), 0.35, (1.0, 0.95, 0.8), BLACK, 0.0, 0.1, 0.3, 2.4),
    ]
    cam = make_camera((0.0, 0.35, 2.4), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0),
                      55.0, 480 / 360, device=dev)
    cfg = RenderConfig(width=480, height=360, spp=200, max_bounces=19)
    return Scene(spheres_from_rows(rows, dev)), cam, cfg


def _record_cases(dev):
    """The five scenes of phase 4 (same configurations)."""
    from raytpu_torch import scenes

    return [
        ("cornell 6b", scenes.cornell_box(dev), dict(max_bounces=6)),
        ("refractive+cutout 6b", _refractive_scene(dev), {}),
        ("dof+ao ao_samples=1", scenes.cornell_box_dof_ao(dev),
         dict(max_bounces=4, ao_samples=1)),
        ("dof+ao ao_samples=2", scenes.cornell_box_dof_ao(dev),
         dict(max_bounces=4, ao_samples=2)),
        ("cornell_cuda hsl+ao", scenes.cornell_box_cuda(dev), {}),
    ]


def _record_both(scene, cfg, origin, direction, draws, keys, counts=None):
    """K1 recording launch (on the keys) and its plain version (on their
    draws): (sph, rays, flat draws, knobs, kernel (out, idx, aof), plain
    ...)."""
    from raytpu_torch.kernels import trace_spheres as ts

    sph = ts.pack_spheres(scene)
    k = ts.Knobs.create(cfg, scene.spheres.count, draws.shape[1],
                        scene.sky_index)
    flat = draws.reshape(-1, draws.shape[-1])
    rays = (*origin, *direction)
    kern = ts._launch(sph, rays, keys, k, record=True)
    plain = ts.trace_spheres_reference(sph, *rays, flat, k, record=True,
                                       counts=counts)
    return sph, rays, flat, k, kern, plain


def _check_record(name, kern, plain, forward, bit_equal=False):
    """Raises unless the recording launch's planes equal the plain
    launch's bit for bit, and its indices and AO factors agree with the
    plain version's (IDX_AGREE, OUTLIER_FRAC); with ``bit_equal`` (keyed
    K1) all of them must equal the plain version's."""
    import torch

    if bit_equal:
        _bit_equal(f"{name} recording", tuple(plain), tuple(kern))

    out, idx, aof = kern
    if not torch.equal(out, forward):
        raise AssertionError(f"{name}: recording changed the 9 planes")
    same = idx == plain[1]
    agree = same.float().mean().item()
    msg = (f"  {name:24s} idx agree {agree:.5f} "
           f"(live entries {(idx >= 0).float().mean().item():.3f})")
    if agree < IDX_AGREE:
        raise AssertionError(f"{name}: recorded indices agree on "
                             f"{agree:.2%} < {IDX_AGREE:.0%}")
    if aof is not None:
        bad = (aof != plain[2]) & same
        frac = bad.float().mean().item()
        msg += (f", AO factors differ on {frac:.5f} of entries where idx "
                f"agree (max {(aof - plain[2])[same].abs().max().item():.3e})")
        if frac > OUTLIER_FRAC:
            raise AssertionError(f"{name}: AO factors differ on {frac:.2%}")
    print(msg + "; planes bit-equal to the launch without recording")


def phase_k1_record(dev):
    from raytpu_torch.kernels import trace_spheres as ts

    print(f"K1 recording vs plain at 64x48 rays (idx agree >= "
          f"{IDX_AGREE:.0%}; AO factors where idx agree)")
    for i, (name, (scene, cam, cfg), over) in enumerate(_record_cases(dev)):
        cfg = cfg.replace(width=64, height=48, **over)
        origin, direction, draws, keys = _kernel_inputs(scene, cam, cfg,
                                                        100 + i, dev)
        sph, rays, flat, k, kern, plain = _record_both(
            scene, cfg, origin, direction, draws, keys)
        _check_record(name, kern, plain, ts._launch(sph, rays, keys, k),
                      bit_equal=True)
    print("  K1 recording bit-equal to its plain version (planes, winners, "
          "AO factors) on every scene")


def _compare_grads(name, ref, got):
    """ref/got: (d_sph (14, S), six ray cotangents). Raises on non-finite
    values or on a difference past the K2 tolerance; returns (max |diff|,
    outlier fraction of rays)."""
    import torch

    d_ref, r_ref = ref[0], torch.stack(ref[1])
    d_got, r_got = got[0], torch.stack(got[1])
    for t in (d_ref, r_ref, d_got, r_got):
        if not t.isfinite().all():
            raise AssertionError(f"{name}: non-finite cotangent")
    diff = (r_got - r_ref).abs()
    frac = (diff > G_ATOL + G_RTOL * r_ref.abs()).any(0).float().mean().item()
    scale = d_ref.abs().amax(1)
    row_err = (d_got - d_ref).abs().amax(1)
    rel = (row_err / scale.clamp(min=1e-30)).max().item()
    print(f"  {name:24s} ray outliers {frac:.5f}  max|d ray| diff "
          f"{diff.max().item():.3e}  d_sph worst row err / row max "
          f"{rel:.3e}")
    if frac > OUTLIER_FRAC:
        raise AssertionError(f"{name}: {frac:.2%} rays' cotangents differ")
    if (row_err > DSPH_REL * scale).any():
        raise AssertionError(f"{name}: d_sph differs by {rel:.3e} of a row")
    return max(diff.max().item(), row_err.max().item()), frac


def _sphere_reference(sph, rays, flat, idx, aof, g, k):
    """K2's plain version in sphere mode: (d_sph, six ray cotangents)."""
    from raytpu_torch.kernels import trace_scene_bwd as tb

    d_sph, *_, d_rays = tb.replay_reference(tb.Tables.of_spheres(sph), rays,
                                            flat, idx, aof, g, k)
    return d_sph, d_rays


def _sphere_kernel(sph, rays, keys, idx, aof, g, k):
    """K2's kernel in sphere mode on the ray keys: (d_sph, six ray
    cotangents)."""
    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.kernels import trace_scene_bwd as tb

    d_sph, *_, d_rays = tb._launch(tb.Tables.of_spheres(sph), rays, keys, idx,
                                   aof, g, tsc.MeshKnobs.of_spheres(k))
    return d_sph, d_rays


def _same_grads(a, b):
    import torch

    return torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))


def phase_k2(dev):
    import numpy as np
    import torch

    from raytpu_torch.kernels import trace_scene_bwd as tb

    cases = _record_cases(dev) + [("refraction stack 19b", _stack_scene(dev), {})]
    print(f"K2 vs plain (replay under autograd) at 64x48 rays, same recorded "
          f"idx/aof and random g (ray outlier: any > {G_ATOL} + {G_RTOL}|x|, "
          f"limit {OUTLIER_FRAC:.0%}; d_sph rows within {DSPH_REL} x row max)")
    for i, (name, (scene, cam, cfg), over) in enumerate(cases):
        cfg = cfg.replace(width=64, height=48, **over)
        origin, direction, draws, keys = _kernel_inputs(scene, cam, cfg,
                                                        200 + i, dev)
        sph, rays, flat, k, (_, idx, aof), _ = _record_both(
            scene, cfg, origin, direction, draws, keys)
        g = torch.tensor(np.random.default_rng(300 + i).uniform(
            -1, 1, (9, cfg.n_pixels)).astype(np.float32), device=dev)
        got = _sphere_kernel(sph, rays, keys, idx, aof, g, k)
        again = _sphere_kernel(sph, rays, keys, idx, aof, g, k)
        if not _same_grads(got, again):
            raise AssertionError(f"{name}: two K2 launches differ")
        ref = _sphere_reference(sph, rays, flat, idx, aof, g, k)
        _compare_grads(f"{name} ({cfg.max_bounces}b)", ref, got)
    print("  two launches on the same inputs: bit-identical d_sph and ray "
          "cotangents on every scene")


def _k1_bound(b, bounces, counts, n_spheres, record, sky=False):
    """Least K1 time, the largest of: rays 24 B + key 8 B + 9 planes out
    (+ 4 B of index per bounce when recording; + the sky slot's 7 planes,
    28 B, with the sky) at HBM speed; (33 FLOP per sphere test + 130 for
    the shading) for every (ray, bounce) that hit (``counts["live"]``,
    the plain version's count on this run's data) at the FP32 issue rate; the
    draws it hashes (``counts``' "draws" and "probe_draws") at DRAW_OPS
    each at the INT32 issue rate."""
    nbytes = b * (24 + 8 + 36 + (4 * bounces if record else 0)
                  + (SKY_SLOT_BYTES if sky else 0))
    flops = counts["live"] * (33 * n_spheres + 130)
    n_draws = counts["draws"] + counts.get("probe_draws", 0)
    return _bound(nbytes, flops, n_draws * DRAW_OPS)


def _k2_bound(b, bounces, counts, n_spheres, sky=False):
    """Least K2 sphere-mode time, the largest of: rays 24 B, key 8 B,
    index (4 B) per bounce, g 36 B (48 B with the sky scale's cotangent)
    and the ray cotangents 24 B per ray, the table twice, at HBM speed;
    ~510 FLOP (replayed bounce ~165, its adjoint ~330, the 14 sums) per
    (ray, bounce) that hit at the FP32 issue rate; the scatter and roulette draws
    K1 hashes (``counts["draws"]``), hashed twice (the replay and the
    reverse step), at the INT32 issue rate."""
    nbytes = (b * (24 + 8 + 4 * bounces + 36 + 24
                   + (SKY_G_BYTES if sky else 0)) + 2 * 14 * 4 * n_spheres)
    return _bound(nbytes, counts["live"] * K2_OPS_SPHERE,
                  2 * counts["draws"] * DRAW_OPS)


def _bound(nbytes, flops, int_ops=0):
    """(least ms, "bytes" or "operations"): the largest of the bytes at
    HBM speed, the FP32 operations at the FP32 issue rate and the INT32
    operations at the INT32 issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_k2_timing(dev):
    """At the main path's shape (one sample of the 1200x900, 6-bounce
    Cornell frame, the RNG kernel's keys): K1's recording bit-equal to its
    plain version, K2 against its plain version, then K1 recording, K2
    and K2's plain version timed with CUDA events in turns."""
    import numpy as np
    import torch

    from raytpu_torch.kernels import trace_spheres as ts
    from raytpu_torch.scenes import cornell_box

    scene, cam, cfg = cornell_box(dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], max_bounces=6)
    origin, direction, keys, draws, _ = _frame_sample(cam, cfg, dev, 4)
    counts = {}
    sph, rays, flat, k, (out, idx, aof), plain = _record_both(
        scene, cfg, origin, direction, draws, keys, counts)
    name = f"cornell {cfg.width}x{cfg.height} 6b"
    print(f"K1 recording and K2 at the main path's shape ({cfg.width}x"
          f"{cfg.height} rays, 6 bounces):")
    _check_record(name, (out, idx, aof), plain,
                  ts._launch(sph, rays, keys, k), bit_equal=True)
    g = torch.tensor(np.random.default_rng(7).uniform(
        -1, 1, (9, cfg.n_pixels)).astype(np.float32), device=dev)
    got = _sphere_kernel(sph, rays, keys, idx, aof, g, k)
    if not _same_grads(got, _sphere_kernel(sph, rays, keys, idx, aof, g, k)):
        raise AssertionError(f"{name}: two K2 launches differ")
    ref = _sphere_reference(sph, rays, flat, idx, aof, g, k)
    max_err, frac = _compare_grads(name, ref, got)
    del ref, plain

    record = lambda: ts._launch(sph, rays, keys, k, record=True)
    kernel = lambda: _sphere_kernel(sph, rays, keys, idx, aof, g, k)
    plain_fn = lambda: _sphere_reference(sph, rays, flat, idx, aof, g, k)
    t = {"record": [], "kernel": [], "plain": []}
    for which in ("plain", "kernel", "record", "record", "kernel", "plain"):
        fn = {"record": record, "kernel": kernel, "plain": plain_fn}[which]
        t[which].append(_time_ms(fn, 3 if which == "plain" else 20))
    n_live = counts["live"]
    b, s = cfg.n_pixels, k.n_spheres
    rec_bound = _k1_bound(b, cfg.max_bounces, counts, s, record=True)
    k2_bound = _k2_bound(b, cfg.max_bounces, counts, s)
    res = {w: float(np.mean(v)) for w, v in t.items()}
    print(f"  K1 recording {res['record']:.4f} ms (bound {rec_bound[0]:.4f} "
          f"ms, {rec_bound[1]}); K2 {res['kernel']:.4f} ms (bound "
          f"{k2_bound[0]:.4f} ms, {k2_bound[1]}); K2 plain "
          f"{res['plain']:.4f} ms per call (turns {t}); live (ray, bounce) "
          f"entries {n_live} of {b * cfg.max_bounces}, draws hashed "
          f"{counts['draws']} by K1, twice by K2; two K2 launches "
          "bit-identical")
    return dict(record_ms=res["record"], ms=res["kernel"],
                plain_ms=res["plain"], max_abs_err=max_err,
                outlier_frac=frac, bound=k2_bound, record_bound=rec_bound,
                n_live=n_live, n_rays=b, bounces=cfg.max_bounces,
                n_spheres=s, counts=counts)


# ATen's kernels of index_add_ / index_put_(accumulate=True): float atomics
ATOMIC_SCATTERS = ("indexFuncSmallIndex", "indexFuncLargeIndex",
                   "indexing_backward_kernel")


def _profile(work, names=None):
    """Device time by kernel over one call of ``work``, and the idle
    share of the window: torch.profiler with CUDA activity. A first call
    of ``work`` is the schedule's warm-up step, whose events are dropped:
    a window of a few ms opened cold lost most of its kernels. ``names``,
    a set, receives the window's kernel names."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        work()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    buckets = {"RNG kernel": 0.0, "eager camera rays": 0.0,
               "K1 trace_spheres": 0.0,
               "K2 backward": 0.0, "K5 spheres_ad": 0.0,
               "K2/K5 sum_blocks": 0.0, "K3 trace_scene": 0.0,
               "K4 intersect": 0.0, "segment sum": 0.0,
               "index sort": 0.0, "torch.sort": 0.0,
               "index gather/scatter": 0.0,
               "eager threefry (int64 bitwise)": 0.0, "other": 0.0}
    n_kernels = 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if (ev.device_type != torch.autograd.DeviceType.CUDA or not dev_us
                or ev.key.startswith("ProfilerStep")):
            # (the schedule's step annotation spans the step's device work)
            continue
        n_kernels += ev.count
        name = ev.key
        if names is not None:
            names.add(name)
        low = name.lower()
        if "rng_sample_kernel" in name or "sample_start_kernel" in name:
            buckets["RNG kernel"] += dev_us
        elif "div_floor" in name:
            # render.sample_rays's pixel row (no other eager floor division
            # of the frames): the camera rays made eagerly
            buckets["eager camera rays"] += dev_us
        elif "trace_spheres_kernel" in name:
            buckets["K1 trace_spheres"] += dev_us
        elif "trace_scene_kernel" in name:
            buckets["K3 trace_scene"] += dev_us
        elif "intersect_kernel" in name:
            buckets["K4 intersect"] += dev_us
        elif "tile_sums" in name or "row_sums" in name:
            # the gathers' backward (csrc/segment_sum.cu)
            buckets["segment sum"] += dev_us
        elif "isort_" in name:
            # the gathers' plans: the radix sort csrc/index_sort.cu
            buckets["index sort"] += dev_us
        elif "sort" in low:
            # torch.sort's kernels (the merged K3's walk tables)
            buckets["torch.sort"] += dev_us
        elif any(w in name.lower() for w in ("index", "scatter", "gather")):
            # the scan path's winner gathers (index_select); their int64
            # indices are not threefry
            buckets["index gather/scatter"] += dev_us
        elif "::backward_kernel" in name or "sphere_backward_kernel" in name:
            buckets["K2 backward"] += dev_us
        elif "spheres_ad_kernel" in name:
            buckets["K5 spheres_ad"] += dev_us
        elif "sum_blocks_kernel" in name:
            buckets["K2/K5 sum_blocks"] += dev_us
        elif (("long" in low or "int64" in low)
              and any(w in low for w in ("bitwise", "shift", "xor"))):
            # the eager threefry's uint32 emulation: int64 xor / or /
            # and / shifts (core/rng.py), which no other path launches
            buckets["eager threefry (int64 bitwise)"] += dev_us
        else:
            buckets["other"] += dev_us
    busy_ms = sum(buckets.values()) / 1e3
    return wall_ms, busy_ms, n_kernels, {k: v / 1e3 for k, v in buckets.items()}


def _unprofiled_idle(what, busy_ms, wall_ms):
    """Prints the idle share of a frame without the profiler's host cost:
    1 - (the profiled device busy time a sample) / (the unprofiled wall
    time a sample)."""
    print(f"  {what}: device busy {busy_ms:.3f} ms a sample (profiled) "
          f"against {wall_ms:.3f} ms of wall a sample without the profiler: "
          f"idle {max(0.0, 1 - busy_ms / wall_ms):.1%}")


def _no_eager_threefry(what, buckets):
    """Raises if the profile shows the eager int64 threefry: the RNG
    kernel makes every draw of the K1 / K3 / scan routes."""
    if buckets["eager threefry (int64 bitwise)"] > 0.0:
        raise AssertionError(f"{what}: eager int64 threefry in the profile")
    if buckets["RNG kernel"] <= 0.0:
        raise AssertionError(f"{what}: no RNG kernel in the profile")


def _print_profile(what, wall_ms, busy_ms, n_k, buckets):
    """Prints where a profiled window's time went; raises if it shows the
    camera rays made eagerly (the sample-start kernel makes them)."""
    if buckets["eager camera rays"] > 0.0:
        raise AssertionError(f"{what}: eager camera-ray kernels in the "
                             "profile")
    print(f"  where the time goes (torch.profiler, {what}): wall "
          f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms (idle "
          f"{max(0.0, 1 - busy_ms / wall_ms):.1%}), {n_k} kernels; "
          + ", ".join(f"{k} {v:.3f} ms ({v / busy_ms:.1%})"
                      for k, v in buckets.items() if v > 0.0))


def phase_train(dev, card):
    """The training path: fwd+bwd of the photometric loss at the flagship
    frame, where its time goes, then 3 Adam steps."""
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render
    from raytpu_torch.scenes import cornell_box
    from raytpu_torch.train import (combine_scene, make_train_step,
                                    partition_scene, photometric_loss)

    scene, cam, cfg = cornell_box(dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=TRAIN_SPP, max_bounces=6,
                      use_megakernel=True)
    pids = torch.arange(cfg.n_pixels, device=dev)
    target = torch.zeros((cfg.n_pixels, 3), device=dev)
    key = rng.prng_key(0)
    params, static = partition_scene(scene)
    params = {n: p.detach().clone().requires_grad_() for n, p in params.items()}

    def loss_fn(c=cfg):
        sums = render(combine_scene(params, static), cam, c, pids, key)
        return photometric_loss(sums.radiance * (1.0 / c.spp), target)

    loss_fn(cfg.replace(spp=1)).backward()        # warm up
    for p in params.values():
        p.grad = None
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = loss_fn()
    loss.backward()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    (k1_launches, k2_launches, k3_launches, k4_launches,
     k5_launches) = _launches()
    rng_launches = _rng_launches()

    grads = {n: p.grad for n, p in params.items()}
    if not (loss.isfinite().item()
            and all(g is not None and g.isfinite().all() for g in grads.values())):
        raise AssertionError("fwd+bwd: non-finite loss or gradient")
    for leaf in ("spheres.mat.diffuse.x", "spheres.mat.emission.x"):
        if not grads[leaf].abs().max().item() > 0.0:
            raise AssertionError(f"fwd+bwd: d loss / d {leaf} is all zero")
    if k2_launches != cfg.spp:
        raise AssertionError(f"fwd+bwd: {k2_launches} K2 launches, want {cfg.spp}")
    if k1_launches != 2 * cfg.spp:
        raise AssertionError(f"fwd+bwd: {k1_launches} K1 launches, want "
                             f"{2 * cfg.spp} (forward + checkpoint recompute)")
    _check_rng("fwd+bwd", 2 * cfg.spp, rows=0)
    if k3_launches != 0 or k4_launches != 0 or k5_launches != 0:
        raise AssertionError(f"fwd+bwd: {k3_launches} K3, {k4_launches} K4 "
                             f"and {k5_launches} K5 launches on the "
                             "megakernel path")
    rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
    print(f"fwd+bwd: cornell {cfg.width}x{cfg.height} spp={cfg.spp} "
          f"bounces={cfg.max_bounces}, d loss / d every sphere leaf: "
          f"{elapsed:.4f} s, {rays / elapsed:.1f} rays/s on {card}; "
          f"loss {loss.item():.6f}; K1 launches {k1_launches}, K2 launches "
          f"{k2_launches}, RNG kernel launches {rng_launches}; max |d diffuse.x| "
          f"{grads['spheres.mat.diffuse.x'].abs().max().item():.4e}, "
          f"max |d emission.x| "
          f"{grads['spheres.mat.emission.x'].abs().max().item():.4e}")

    prof_cfg = cfg.replace(spp=2)
    frame = _profile(lambda: loss_fn(prof_cfg).backward())
    _print_profile("fwd+bwd at spp=2", *frame)
    _no_eager_threefry("the Cornell fwd+bwd frame", frame[3])
    _unprofiled_idle("the Cornell fwd+bwd frame", frame[1] / 2,
                     elapsed * 1e3 / cfg.spp)

    # 3 Adam steps towards a target with perturbed diffuse colours, with
    # the target's key, so the loss measures the parameters and not noise
    tparams = {n: p.detach().clone() for n, p in partition_scene(scene)[0].items()}
    for c in "xyz":
        tparams[f"spheres.mat.diffuse.{c}"] = (
            tparams[f"spheres.mat.diffuse.{c}"] * 0.8).clamp(0.0, 1.0)
    with torch.no_grad():
        tsums = render(combine_scene(tparams, static), cam, cfg, pids, key)
        tgt = (tsums.radiance * (1.0 / cfg.spp)).to_array()
    init_fn, step_fn = make_train_step(cfg, 1e-2)
    state, static = init_fn(scene, cam)
    losses = []
    t0 = time.perf_counter()
    for step in range(3):
        state, loss = step_fn(state, static, cam, pids, tgt, key)
        losses.append(loss.item())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss {losses}")
    print(f"train: 3 Adam steps (lr 1e-2) at {cfg.width}x{cfg.height} "
          f"spp={cfg.spp} towards a perturbed-diffuse target: losses "
          + " ".join(f"{x:.6e}" for x in losses) + f"; {step_s:.4f} s per step")
    return dict(k1_launches=k1_launches, k2_launches=k2_launches,
                k5_launches=k5_launches, rng_launches=rng_launches,
                k3_launches=k3_launches, k4_launches=k4_launches,
                rays_per_s=rays / elapsed, elapsed=elapsed, profile=frame)


def _block_world(n: int, seed: int = 0) -> str:
    """The TOML of an n-triangle block world, written under OUT_DIR."""
    from raytpu_torch.scenes import write_block_world

    return write_block_world(os.path.join(OUT_DIR, f"block_world_{n}"),
                             n_triangles=n, seed=seed)


def _per_triangle(path, device):
    """``load_scene_file`` with the per-triangle search: merge_quads off
    after the load. The phases that hold K3 bit for bit against the scan
    path, or compare its times with those PERF.md records, load so;
    the default load takes the merged search (phases 29-31)."""
    from raytpu_torch.config import load_scene_file

    scene, cam, cfg = load_scene_file(path, device)
    return scene, cam, cfg.replace(merge_quads=False)


def _k3_cases(dev):
    """The four scenes of tests/test_torch_trace_scene.py (a 60-triangle
    block world with water; with AO; untextured; the 4-triangle branch
    scene), the main path's 600-triangle world and a 2048-triangle one."""
    import dataclasses

    from raytpu_torch.core.types import TextureAtlas
    from raytpu_torch.scenes import mesh_branch_scene

    small = _per_triangle(_block_world(60, seed=3), dev)
    bare = (dataclasses.replace(small[0], atlas=TextureAtlas.empty(dev)),
            *small[1:])
    return [
        ("block world 60 6b", small, dict(max_bounces=6)),
        ("block world 60 ao_samples=2", small,
         dict(max_bounces=4, use_ao=True, ao_samples=2)),
        ("untextured 60 6b", bare, dict(max_bounces=6)),
        ("branches 4 tris 5b", mesh_branch_scene(dev), dict(max_bounces=5)),
        (f"block world {MESH_WORLD} 6b",
         _per_triangle(_block_world(MESH_WORLD), dev), {}),
        ("block world 2048 6b", _per_triangle(_block_world(2048), dev), {}),
    ]


def _k3_both(scene, cfg, origin, direction, draws, keys, counts=None):
    """(plain, kernel) outputs of K3 as (9, B) on the same card tensors:
    the plain version on the keys' draws, the kernel (through its wrapper)
    on the keys. ``counts`` goes to the plain version."""
    import torch

    from raytpu_torch.kernels import trace_scene as tsc

    k = tsc.MeshKnobs.for_scene(cfg, scene, draws.shape[1])
    ref = tsc.trace_scene_reference(tsc.pack_scene(scene, k), *origin,
                                    *direction,
                                    draws.reshape(-1, draws.shape[-1]), k,
                                    counts)
    out = torch.cat([v.to_array().T for v in tsc.trace_mesh_megakernel(
        scene, cfg, origin, direction, keys)])
    return ref, out


def phase_k3(dev):
    print(f"K3 on the ray keys vs plain on their draws at 64x48 rays, bit "
          f"for bit (outliers: any channel > {ATOL} + {RTOL}|x|)")
    for i, (name, (scene, cam, cfg), over) in enumerate(_k3_cases(dev)):
        cfg = cfg.replace(width=64, height=48, **over)
        origin, direction, draws, keys = _kernel_inputs(scene, cam, cfg,
                                                        400 + i, dev)
        ref, out = _k3_both(scene, cfg, origin, direction, draws, keys)
        _compare(name, ref, out)
        _bit_equal(name, ref, out)


def _k3_bound(b, bounces, counts, table_bytes, sky=False):
    """Least K3 time: rays 24 B, the key 8 B and 9 planes out (16 with the
    sky slot) per ray plus the scene tables at HBM speed, against the
    operations of this run's search (K3_OPS_*: the plain version's counts
    of sphere, slab and entered-chunk triangle tests and live (ray,
    bounce) entries; K3M_OPS_* for the merged search: the walk's tests and
    binary-search steps, ``_aa_walk``'s counts, and the general
    candidates) at the FP32 issue rate, and the draws it hashes (the plain
    version's "draws" and "probe_draws") at DRAW_OPS INT32 operations
    each."""
    nbytes = b * (24 + 8 + 36 + (SKY_SLOT_BYTES if sky else 0)) + table_bytes
    n_draws = counts.get("draws", 0) + counts.get("probe_draws", 0)
    return _bound(nbytes, _k3_ops(counts), n_draws * DRAW_OPS)


def _k3_ops(counts):
    """K3's counted FP32 operations for the plain version's ``counts``."""
    ops = (counts["sphere"] * K3_OPS_SPHERE + counts["slab"] * OPS_SLAB
           + counts["tri"] * K3_OPS_TRI + counts["live"] * K3_OPS_SHADE)
    if "aa_rect" in counts:       # the merged search's candidates
        ops += (counts["aa_rect"] * K3M_OPS_RECT
                + counts["aa_tri"] * K3M_OPS_AATRI
                + counts["aa_head"] * K3M_OPS_HEAD
                + counts["aa_slab"] * OPS_SLAB
                + counts["quad"] * K3M_OPS_QUAD + counts["left"] * K3M_OPS_LEFT
                + counts["live"] * K3M_OPS_GROUPS)
    return ops


def _box_share(counts, ops):
    """The share of ``ops`` that is slab tests of cull boxes."""
    return (counts["slab"] + counts.get("aa_slab", 0)) * OPS_SLAB / ops


def phase_k3_timing(dev):
    """K3 and its plain version at the main path's shape (one sample of
    the 1200x900, 6-bounce block-world frame, the RNG kernel's draws),
    compared, then timed with CUDA events in turns, with the RNG work of a
    sample (the RNG kernel's rows and the camera rays)."""
    import numpy as np

    from raytpu_torch.kernels import trace_scene as tsc

    scene, cam, cfg = _per_triangle(_block_world(MESH_WORLD), dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], max_bounces=6)
    origin, direction, keys, draws, rng_sample = _frame_sample(cam, cfg, dev,
                                                               4)
    counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
    ref, out = _k3_both(scene, cfg, origin, direction, draws, keys, counts)
    name = f"block world {MESH_WORLD} {cfg.width}x{cfg.height} 6b"
    print(f"K3 vs plain at the main path's shape ({cfg.width}x{cfg.height} "
          f"rays, 6 bounces, {scene.triangles.count} triangles):")
    max_err = _compare(name, ref, out)
    _bit_equal(name, ref, out)
    frac = max(_outliers(ref[s], out[s])[0]
               for s in (slice(0, 3), slice(3, 6), slice(6, 9)))
    del ref, out

    k = tsc.MeshKnobs.for_scene(cfg, scene, draws.shape[1])
    tb = tsc.pack_scene(scene, k)
    flat = draws.reshape(-1, draws.shape[-1])
    rays = (*origin, *direction)
    kernel = lambda: tsc._launch(tb, rays, keys, k)
    plain = lambda: tsc.trace_scene_reference(tb, *rays, flat, k)
    kernel(), plain()                                  # warm up
    t = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which].append(_time_ms(kernel if which == "kernel" else plain,
                                 20 if which == "kernel" else 2))
    rng_ms = float(np.mean([_time_ms(rng_sample, 5) for _ in range(2)]))
    ms, plain_ms = float(np.mean(t["kernel"])), float(np.mean(t["plain"]))
    table_bytes = tb.nbytes()
    bound = _k3_bound(cfg.n_pixels, cfg.max_bounces, counts, table_bytes)
    b = cfg.n_pixels
    print(f"  K3 kernel {ms:.4f} ms  plain {plain_ms:.4f} ms per call (turns: "
          f"kernel {t['kernel']}, plain {t['plain']}); bound {bound[0]:.4f} "
          f"ms ({bound[1]}); sample start {rng_ms:.4f} ms per "
          "sample")
    print(f"  search work (plain version's counts): {counts['live']} live "
          f"(ray, bounce) entries of {b * cfg.max_bounces}, draws hashed "
          f"{counts['draws']} (+{counts['probe_draws']} AO); per live entry "
          f"{counts['sphere'] / counts['live']:.2f} sphere, "
          f"{counts['slab'] / counts['live']:.2f} slab and "
          f"{counts['tri'] / counts['live']:.2f} triangle tests; "
          f"{scene.triangles.count} triangles in {k.n_chunks} chunks")
    ratio = counts["tri_issued"] / counts["tri"]
    attrs = tsc.func_attrs(False, False, merged=False)
    print(f"  warps of 32 rays (lane slots of triangle tests): the union of "
          f"the lanes' chunks issues {counts['tri_issued']} for "
          f"{counts['tri']} needed, issued / needed {ratio:.3f}; "
          f"the warp search scans {counts['tri_loop']} slots lane by lane "
          f"(chunks {tsc.COOP_MIN} or more lanes enter) and "
          f"{counts['coop']} (ray, chunk) entries together; registers "
          f"{attrs['registers']}, local {attrs['local_bytes']} B, dynamic "
          f"shared memory {attrs['dynamic_smem']} B a block")
    return dict(ms=ms, plain_ms=plain_ms, rng_ms=rng_ms, max_abs_err=max_err,
                outlier_frac=frac, bound=bound, counts=counts,
                issued_over_needed=ratio, smem=attrs["dynamic_smem"])


def phase_mesh(dev, card, timing):
    """The mesh forward path: the block world at the flagship frame
    through ``render``, K3 once per sample."""
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import (
        blocked_pixel_order, render, render_image)
    from raytpu_torch.io.ppm import write_ppm

    path = _block_world(MESH_WORLD)
    scene, cam, cfg = _per_triangle(path, dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=MESH_SPP,
                      max_bounces=6, use_megakernel=True)
    pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev)
    key = rng.prng_key(0)

    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = render(scene, cam, cfg, pids, key)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k1, k2, k3, k4, _ = _launches()
    _check_rng("mesh path", cfg.spp, rows=0)

    rad = sums.radiance.to_array()
    mean = rad.double().mean().item() / cfg.spp
    if not (rad.isfinite().all() and sums.albedo.to_array().isfinite().all()
            and sums.normal.to_array().isfinite().all()):
        raise AssertionError("mesh path: non-finite sums")
    if not mean > 0.0:
        raise AssertionError(f"mesh path: mean radiance {mean} is not > 0")
    if (k3, k1, k2, k4) != (cfg.spp, 0, 0, 0):
        raise AssertionError(f"mesh path: {k3} K3, {k1} K1, {k2} K2 and {k4} "
                             f"K4 launches, want {cfg.spp}, 0, 0 and 0")
    rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
    print(f"mesh path: block world ({scene.triangles.count} triangles, "
          f"{scene.mat_table.count} materials) {cfg.width}x{cfg.height} "
          f"spp={cfg.spp} bounces={cfg.max_bounces}: {elapsed:.4f} s, "
          f"{rays / elapsed:.1f} rays/s end to end on {card}; K3 launches "
          f"{k3}; mean radiance {mean:.6f}")
    print(f"  per sample (CUDA events, same shapes): sample start (keys + "
          f"camera rays) {timing['rng_ms']:.4f} ms, K3 {timing['ms']:.4f} ms -> "
          f"RNG {cfg.spp * timing['rng_ms'] / 1e3:.4f} s, "
          f"K3 {cfg.spp * timing['ms'] / 1e3:.4f} s of the frame")

    frame = _profile(lambda: render(scene, cam, cfg.replace(spp=2), pids, key))
    _print_profile("the mesh frame at spp=2", *frame)
    _no_eager_threefry("the mesh frame", frame[3])

    # the same small frame on the card (K3) and on the CPU (plain path)
    small = cfg.replace(width=40, height=30, spp=2)
    cpu_scene, cpu_cam, _ = _per_triangle(path, "cpu")
    small_ids = np.arange(small.n_pixels)
    a = render(cpu_scene, cpu_cam, small, small_ids, rng.prng_key(3))
    b = render(scene, cam, small, small_ids, rng.prng_key(3))
    _compare("block world 40x30x2spp card vs cpu",
             torch.cat([v.to_array().T for v in a[:3]]),
             torch.cat([v.to_array().T.cpu() for v in b[:3]]))

    img = render_image(scene, cam, cfg.replace(pixel_tile=cfg.n_pixels), key)
    out = os.path.join(OUT_DIR, "chip_smoke_block_world.ppm")
    write_ppm(out, img.canvas)
    means = img.canvas.reshape(-1, 3).mean(axis=0)
    print(f"wrote {os.path.relpath(out, ROOT)}: canvas channel means "
          f"r={means[0]:.3f} g={means[1]:.3f} b={means[2]:.3f}")
    return dict(k1=k1, k2=k2, k3=k3, k4=k4, rays_per_s=rays / elapsed,
                ms_per_sample=elapsed / cfg.spp * 1e3)


def _mesh_inputs(scene, cfg, origin, direction, keys):
    """K3's tables, rays, the ray keys (the kernels' draw source), their
    bounce draws (bounces * n_draws, B) (the plain versions') and knobs for
    one batch."""
    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import n_bounce_draws
    from raytpu_torch.kernels import trace_scene as tsc

    nd = n_bounce_draws(cfg)
    k = tsc.MeshKnobs.for_scene(cfg, scene, nd)
    return (tsc.pack_scene(scene, k), (*origin, *direction), keys,
            rng.bounce_draws(keys, nd, cfg.max_bounces), k)


def _check_mesh_record(name, kern, plain, forward, bit_equal=False):
    """K3's recording launch against its plain version and its own launch
    without recording: the nine planes bit-equal, at least IDX_AGREE of
    the winners equal, and the AO factors equal where they are used (a
    bounce that accumulates has a recorded hit, so this compares them on
    every entry where both record the same hit) up to OUTLIER_FRAC of
    those entries (a flipped winner earlier on the ray moves its later
    hit points). With ``bit_equal`` (the per-triangle search) the planes
    and every winner must equal the plain version's, and the AO factors
    too wherever a hit is recorded. Returns (winner agreement, max |diff|
    of the planes and the AO factors compared)."""
    import torch

    out, idx, aof = kern
    if not torch.equal(out, forward):
        raise AssertionError(f"{name}: recording changed the 9 planes")
    if bit_equal:
        _bit_equal(f"{name} recording", plain[0], out)
        if not torch.equal(idx, plain[1]):
            raise AssertionError(f"{name}: recorded winners differ from the "
                                 "plain version's")
        hit = idx >= 0
        if aof is not None and not torch.equal(aof[hit], plain[2][hit]):
            raise AssertionError(f"{name}: recorded AO factors differ from "
                                 "the plain version's")
    max_err = (out - plain[0]).abs().max().item()
    same = idx == plain[1]
    agree = same.float().mean().item()
    msg = (f"  {name:28s} idx agree {agree:.5f} (live entries "
           f"{(idx >= 0).float().mean().item():.3f})")
    if agree < IDX_AGREE:
        raise AssertionError(f"{name}: recorded winners agree on "
                             f"{agree:.2%} < {IDX_AGREE:.0%}")
    if aof is not None:
        live = same & (idx >= 0)
        bad = (aof != plain[2]) & live
        frac = bad.float().sum().item() / max(live.sum().item(), 1)
        aof_err = (aof - plain[2])[live].abs().max().item()
        max_err = max(max_err, aof_err)
        msg += (f", AO factors differ on {frac:.5f} of the live entries "
                f"(max {aof_err:.3e})")
        if frac > OUTLIER_FRAC:
            raise AssertionError(f"{name}: AO factors differ on {frac:.2%}")
    print(msg + f"; planes bit-equal to the launch without recording, max "
          f"|diff| vs plain {max_err:.3e}")
    return agree, max_err


def phase_k3_record(dev):
    """K3 in recording mode against its plain version on the six mesh
    scenes of phase 9 at 64x48 rays."""
    from raytpu_torch.kernels import trace_scene as tsc

    print(f"K3 recording vs plain at 64x48 rays (idx agree >= {IDX_AGREE:.0%};"
          f" AO factors where used)")
    for i, (name, (scene, cam, cfg), over) in enumerate(_k3_cases(dev)):
        cfg = cfg.replace(width=64, height=48, **over)
        o, d, _, keys = _kernel_inputs(scene, cam, cfg, 500 + i, dev)
        tb, rays, keys, flat, k = _mesh_inputs(scene, cfg, o, d, keys)
        forward = tsc._launch(tb, rays, keys, k)
        _bit_equal(name, tsc.trace_scene_reference(tb, *rays, flat, k),
                   forward)
        _check_mesh_record(
            name, tsc._launch(tb, rays, keys, k, record=True),
            tsc.trace_scene_reference(tb, *rays, flat, k, record=True),
            forward, bit_equal=True)


def _compare_mesh_grads(name, ref, got, again):
    """ref/got/again: (d_sph, d_tri, d_mat, d_atlas, six ray cotangents).
    Raises on non-finite values, on ray cotangents past the K2 tolerance,
    on a QUIET_ROWS row over ZERO_ROW of its table's largest |entry| on
    either side, on d_tri's normal rows (9-11) under it where there are
    triangle winners, on another row off by more than DSPH_REL of its
    largest |entry| (at least ZERO_ROW of the table's), and on two
    launches that differ in any bit of the four tables or the ray
    cotangents. Returns (max |diff|, outlier fraction of rays, largest
    quiet row / table max)."""
    import torch

    r_ref, r_got = torch.stack(ref[4]), torch.stack(got[4])
    for t in (*ref[:4], *got[:4], r_ref, r_got):
        if not t.isfinite().all():
            raise AssertionError(f"{name}: non-finite cotangent")
    diff = (r_got - r_ref).abs()
    frac = (diff > G_ATOL + G_RTOL * r_ref.abs()).any(0).float().mean().item()
    worst, quiet, max_err = {}, 0.0, diff.max().item()
    for tname, a, w in zip(("d_sph", "d_tri", "d_mat", "d_atlas"), got[:4],
                           ref[:4]):
        if w.numel() == 0:
            continue
        top = w.abs().max().item()
        floor = ZERO_ROW * top
        rows = QUIET_ROWS[tname]
        loud = [r for r in range(w.shape[0]) if r not in rows]
        q = max(a[rows].abs().max().item(), w[rows].abs().max().item())
        quiet = max(quiet, q / max(top, 1e-30))
        if q > floor:
            raise AssertionError(f"{name}: {tname} rows {rows} reach {q:.3e}, "
                                 f"over {ZERO_ROW} of the table's {top:.3e}")
        if tname == "d_tri" and top > 0 and not (
                w[9:12].abs().amax(1) > floor).all():
            raise AssertionError(f"{name}: d_tri's normal rows carry no "
                                 "cotangent")
        scale = w[loud].abs().amax(1).clamp(min=floor)
        row_err = (a[loud] - w[loud]).abs().amax(1)
        worst[tname] = (row_err / scale.clamp(min=1e-30)).max().item()
        max_err = max(max_err, row_err.max().item())
        if (row_err > DSPH_REL * scale).any():
            raise AssertionError(f"{name}: {tname} differs by "
                                 f"{worst[tname]:.3e} of a row")
    if not (all(torch.equal(x, y) for x, y in zip(got[:4], again[:4]))
            and all(torch.equal(x, y) for x, y in zip(got[4], again[4]))):
        raise AssertionError(f"{name}: two launches differ in d_sph, d_tri, "
                             "d_mat, d_atlas or the ray cotangents")
    print(f"  {name:28s} ray outliers {frac:.5f}  max|d ray| diff "
          f"{diff.max().item():.3e}  worst row err / row max "
          + " ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; quiet rows / table max {quiet:.3e}; two launches "
          "bit-identical")
    if frac > OUTLIER_FRAC:
        raise AssertionError(f"{name}: {frac:.2%} rays' cotangents differ")
    return max_err, frac, quiet


def phase_k2_mesh(dev):
    """K2's mesh mode against its plain version (the replay under
    autograd) on the six mesh scenes at 64x48 rays, with the winners and
    AO factors K3 recorded on the card; two launches compared."""
    import numpy as np
    import torch

    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.kernels import trace_scene_bwd as tb

    print(f"K2 mesh mode vs plain at 64x48 rays, K3's recorded idx/aof, random "
          f"g (ray outlier: any > {G_ATOL} + {G_RTOL}|x|, limit "
          f"{OUTLIER_FRAC:.0%}; every table row within {DSPH_REL} x row max; "
          f"two launches bit-identical; each scene also with the texels' "
          f"table in global memory)")
    for i, (name, (scene, cam, cfg), over) in enumerate(_k3_cases(dev)):
        cfg = cfg.replace(width=64, height=48, **over)
        o, d, _, keys = _kernel_inputs(scene, cam, cfg, 600 + i, dev)
        mt, rays, keys, flat, k = _mesh_inputs(scene, cfg, o, d, keys)
        _, idx, aof = tsc._launch(mt, rays, keys, k, record=True)
        tabs = tb.Tables(mt.sph, mt.tri, mt.mats, mt.atlas)
        g = torch.tensor(np.random.default_rng(700 + i).uniform(
            -1, 1, (9, cfg.n_pixels)).astype(np.float32), device=dev)
        got = tb._launch(tabs, rays, keys, idx, aof, g, k)
        again = tb._launch(tabs, rays, keys, idx, aof, g, k)
        ref = tb.replay_reference(tabs, rays, flat, idx, aof, g, k)
        _compare_mesh_grads(f"{name} ({cfg.max_bounces}b)", ref, got, again)
        # the texels' table in the blocks' rows of the scratch buffer
        budget, tb.MESH_SMEM_BUDGET = tb.MESH_SMEM_BUDGET, 0
        try:
            glob = tb._launch(tabs, rays, keys, idx, aof, g, k)
            _compare_mesh_grads(f"{name} (global texels)", ref, glob,
                                tb._launch(tabs, rays, keys, idx, aof, g, k))
        finally:
            tb.MESH_SMEM_BUDGET = budget


def _k2_mesh_bound(b, bounces, idx, n_spheres, table_bytes, counts,
                   scratch_bytes, sky=False):
    """Least K2 mesh-mode time: per ray its rays 24 B, key 8 B, index 4 B
    per bounce, g 36 B (48 B with the sky scale's cotangent) and the ray
    cotangents 24 B; the tables read once and their cotangents written
    once; the scratch buffer of the blocks' table sums written once and
    read once (``scratch_bytes``); against K2_OPS_TRI FLOP per live (ray,
    bounce) with a triangle winner and K2_OPS_SPHERE per other live entry
    (this run's recorded winners), and the three draws of each replayed
    bounce (K3's plain version's ``counts["live"]``: the bounces a ray
    starts in its loop), hashed once, at DRAW_OPS INT32 operations
    each."""
    n_tri = int((idx >= n_spheres).sum().item())
    n_sph = int(((idx >= 0) & (idx < n_spheres)).sum().item())
    nbytes = (b * (24 + 8 + 4 * bounces + 36 + 24
                   + (SKY_G_BYTES if sky else 0))
              + 2 * table_bytes + 2 * scratch_bytes)
    return _bound(nbytes, n_tri * K2_OPS_TRI + n_sph * K2_OPS_SPHERE,
                  3 * counts["live"] * DRAW_OPS)


def _k2_mesh_scratch(b, k):
    """Bytes of K2 mesh mode's scratch buffer for b rays on this card."""
    from raytpu_torch.kernels import trace_scene_bwd as tb

    blocks, entries = tb.scratch_shape(b, k)
    return 4 * blocks * entries


def phase_mesh_bwd_timing(dev):
    """At the main path's shape (one sample of the 600-triangle block world
    at 1200x900 rays, 6 bounces, real RNG draws): K3 recording and K2 mesh
    mode against their plain versions, then each timed with CUDA events
    in turns beside its plain version."""
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import blocked_pixel_order, sample_rays
    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.kernels import trace_scene_bwd as tb

    scene, cam, cfg = _per_triangle(_block_world(MESH_WORLD), dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], max_bounces=6)
    pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
    keys, cam_d = rng.sample_stream(rng.prng_key(0, device=dev), pids, 0, 4)
    origin, direction = sample_rays(cam, cfg, pids, cam_d)
    mt, rays, keys, flat, k = _mesh_inputs(scene, cfg, origin, direction,
                                           keys)
    name = f"block world {MESH_WORLD} {cfg.width}x{cfg.height} 6b"
    print(f"K3 recording and K2 mesh mode at the main path's shape "
          f"({cfg.width}x{cfg.height} rays, 6 bounces, "
          f"{scene.triangles.count} triangles):")
    counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
    kern = tsc._launch(mt, rays, keys, k, record=True)
    plain = tsc.trace_scene_reference(mt, *rays, flat, k, counts, record=True)
    rec_agree, rec_err = _check_mesh_record(name, kern, plain,
                                            tsc._launch(mt, rays, keys, k),
                                            bit_equal=True)
    del plain
    _, idx, aof = kern
    tabs = tb.Tables(mt.sph, mt.tri, mt.mats, mt.atlas)
    g = torch.tensor(np.random.default_rng(8).uniform(
        -1, 1, (9, cfg.n_pixels)).astype(np.float32), device=dev)
    got = tb._launch(tabs, rays, keys, idx, aof, g, k)
    again = tb._launch(tabs, rays, keys, idx, aof, g, k)
    ref = tb.replay_reference(tabs, rays, flat, idx, aof, g, k)
    max_err, frac, quiet = _compare_mesh_grads(name, ref, got, again)
    del ref, got, again

    fns = {
        "record": lambda: tsc._launch(mt, rays, keys, k, record=True),
        "record_plain": lambda: tsc.trace_scene_reference(
            mt, *rays, flat, k, record=True),
        "k2": lambda: tb._launch(tabs, rays, keys, idx, aof, g, k),
        "k2_plain": lambda: tb.replay_reference(tabs, rays, flat, idx, aof,
                                                g, k),
    }
    t = {w: [] for w in fns}
    for which in ("record_plain", "record", "record", "record_plain",
                  "k2_plain", "k2", "k2", "k2_plain"):
        t[which].append(_time_ms(fns[which],
                                 2 if which.endswith("plain") else 20))
    res = {w: float(np.mean(v)) for w, v in t.items()}
    table_bytes = 4 * sum(x.numel() for x in tabs)
    b = cfg.n_pixels
    # K3's bound with the recorded winners written: 4 B per ray and bounce
    rec_bound = _k3_bound(b, cfg.max_bounces, counts,
                          mt.nbytes() + 4 * b * cfg.max_bounces)
    k2_bound = _k2_mesh_bound(b, cfg.max_bounces, idx, k.n_spheres,
                              table_bytes, counts, _k2_mesh_scratch(b, k))
    smem = tb.mesh_func_attrs(False)["dynamic_smem"]
    n_tri = int((idx >= k.n_spheres).sum().item())
    print(f"  K3 recording {res['record']:.4f} ms (plain "
          f"{res['record_plain']:.4f} ms; bound {rec_bound[0]:.4f} ms, "
          f"{rec_bound[1]}); K2 mesh {res['k2']:.4f} ms (plain "
          f"{res['k2_plain']:.4f} ms; bound {k2_bound[0]:.4f} ms, "
          f"{k2_bound[1]}) per call (turns {t}); live (ray, bounce) entries "
          f"{int((idx >= 0).sum().item())} of {b * cfg.max_bounces}, "
          f"{n_tri} with a triangle winner; K2 scratch "
          f"{tb.scratch_shape(b, k)} (blocks, entries), {smem} B of dynamic "
          f"shared memory a block")
    return dict(record_ms=res["record"], record_plain_ms=res["record_plain"],
                record_bound=rec_bound, record_agree=rec_agree,
                record_err=rec_err,
                ms=res["k2"], plain_ms=res["k2_plain"], bound=k2_bound,
                max_abs_err=max_err, outlier_frac=frac, smem=smem)


def k5_bound(k2):
    """K5's bound (raytpu/kernels/trace_spheres.py:460, jax.vjp of K1's
    loop) at the flagship fwd+bwd shape, from this run's data: K1's
    forward operations three times per live entry of phase 7's Cornell
    recording (the loop, then its reverse at about twice the forward), the
    scatter and roulette draws hashed twice (the loop and the reverse
    step) and the AO probes' once, against rays 24 B, key 8 B, g 36 B and
    ray cotangents 24 B a ray and the table twice."""
    c = k2["counts"]
    k5_bytes = (k2["n_rays"] * (24 + 8 + 36 + 24)
                + 2 * 14 * 4 * k2["n_spheres"])
    k5 = _bound(k5_bytes, 3 * k2["n_live"] * (33 * k2["n_spheres"] + 130),
                (2 * c["draws"] + c.get("probe_draws", 0)) * DRAW_OPS)
    print(f"  K5's bound {k5[0]:.4f} ms ({k5[1]}; "
          f"{k2['n_live']} live entries at {k2['n_rays']} rays x "
          f"{k2['bounces']} bounces)")
    return k5


def phase_mesh_train(dev, card):
    """The mesh training path: fwd+bwd of the photometric loss through
    ``render`` on the block world at the flagship frame, every float leaf
    requiring grad, where its time goes, then 3 Adam steps."""
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render
    from raytpu_torch.train import (combine_scene, make_train_step,
                                    partition_scene, photometric_loss)

    scene, cam, cfg = _per_triangle(_block_world(MESH_WORLD), dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=MESH_TRAIN_SPP,
                      max_bounces=6, use_megakernel=True)
    pids = torch.arange(cfg.n_pixels, device=dev)
    target = torch.zeros((cfg.n_pixels, 3), device=dev)
    key = rng.prng_key(0)
    params, static = partition_scene(scene)
    params = {n: p.detach().clone().requires_grad_() for n, p in params.items()}

    def loss_fn(c=cfg):
        sums = render(combine_scene(params, static), cam, c, pids, key)
        return photometric_loss(sums.radiance * (1.0 / c.spp), target)

    loss_fn(cfg.replace(spp=1)).backward()        # warm up
    for p in params.values():
        p.grad = None
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = loss_fn()
    loss.backward()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k1, k2, k3, k4, _ = _launches()
    _check_rng("mesh fwd+bwd", 2 * cfg.spp, rows=0)

    grads = {n: p.grad for n, p in params.items()}
    if not (loss.isfinite().item() and all(
            g is not None and g.isfinite().all() for g in grads.values())):
        raise AssertionError("mesh fwd+bwd: non-finite loss or gradient")
    for leaf in ("atlas.rgb.x", "mat_table.emission_strength",
                 "spheres.mat.emission.x"):
        if not grads[leaf].abs().max().item() > 0.0:
            raise AssertionError(f"mesh fwd+bwd: d loss / d {leaf} is all zero")
    if (k3, k2, k1, k4) != (2 * cfg.spp, cfg.spp, 0, 0):
        raise AssertionError(
            f"mesh fwd+bwd: {k3} K3, {k2} K2, {k1} K1 and {k4} K4 launches, "
            f"want {2 * cfg.spp} (recording: forward + checkpoint recompute), "
            f"{cfg.spp}, 0 and 0")
    rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
    print(f"mesh fwd+bwd: block world {cfg.width}x{cfg.height} spp={cfg.spp} "
          f"bounces={cfg.max_bounces}, d loss / d every float leaf "
          f"({len(params)} leaves): {elapsed:.4f} s, {rays / elapsed:.1f} "
          f"rays/s on {card}; loss {loss.item():.6f}; K3 (recording) "
          f"launches {k3}, K2 (mesh mode) launches {k2}, K1 launches {k1}; "
          f"max |d atlas.rgb.x| {grads['atlas.rgb.x'].abs().max().item():.4e}"
          f", max |d mat_table.emission_strength| "
          f"{grads['mat_table.emission_strength'].abs().max().item():.4e}")
    _print_profile("mesh fwd+bwd at spp=2",
                   *_profile(lambda: loss_fn(cfg.replace(spp=2)).backward()))

    # 3 Adam steps towards a target with perturbed atlas and material
    # colours, with the target's key, so the loss measures the parameters
    tparams = {n: p.detach().clone()
               for n, p in partition_scene(scene)[0].items()}
    for c in "xyz":
        tparams[f"atlas.rgb.{c}"] = (tparams[f"atlas.rgb.{c}"] * 0.8).clamp(0, 1)
        tparams[f"mat_table.emission.{c}"] = tparams[f"mat_table.emission.{c}"] * 0.8
    tcfg = cfg.replace(spp=MESH_STEP_SPP)
    with torch.no_grad():
        tsums = render(combine_scene(tparams, static), cam, tcfg, pids, key)
        tgt = (tsums.radiance * (1.0 / tcfg.spp)).to_array()
    init_fn, step_fn = make_train_step(tcfg, 1e-2)
    state, static = init_fn(scene, cam)
    losses = []
    t0 = time.perf_counter()
    for step in range(3):
        state, loss = step_fn(state, static, cam, pids, tgt, key)
        losses.append(loss.item())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mesh train: non-finite loss {losses}")
    if not losses[0] > losses[1] > losses[2]:
        raise AssertionError(f"mesh train: losses do not fall: {losses}")
    print(f"mesh train: 3 Adam steps (lr 1e-2) at {tcfg.width}x{tcfg.height} "
          f"spp={tcfg.spp} towards a perturbed atlas/material target: losses "
          + " ".join(f"{x:.6e}" for x in losses) + f"; {step_s:.4f} s per step")
    return dict(k1=k1, k2=k2, k3=k3, k4=k4, rays_per_s=rays / elapsed)


def _k4_ray_sets(scene, cam, cfg, seed, dev):
    """(name, origin, direction) on the card: random rays (a quarter with
    d.x = 0, a quarter with d.z = 0), then the camera rays of a
    ``cfg``-sized frame and each later bounce's rays through the scan
    path."""
    import numpy as np
    import torch

    from raytpu_torch.core.vec3 import Vec3
    from raytpu_torch.geometry.triangle import precompute
    from raytpu_torch.integrator import path

    rs = np.random.default_rng(seed)
    b = cfg.n_pixels
    o = rs.uniform(-2.0, 2.0, (3, b)).astype(np.float32)
    o[1] = np.abs(o[1])
    d = rs.normal(size=(3, b)).astype(np.float32)
    d[0, : b // 4] = 0.0
    d[2, b // 4: b // 2] = 0.0
    d /= np.linalg.norm(d, axis=0)
    card = lambda a: Vec3(*(torch.tensor(c, device=dev) for c in a))
    yield "random", card(o), card(d)
    origin, direction, draws, _ = _kernel_inputs(scene, cam, cfg, seed, dev)
    geom = precompute(scene.triangles) if scene.n_triangles else None
    state = path.init_state(origin, direction)
    for i in range(cfg.max_bounces):
        yield f"bounce {i}", state.origin, state.direction
        state = path.bounce(scene, geom, cfg, i, state, draws[i])


def phase_k4(dev):
    """K4 against its plain version at 64x48 rays, bit for bit: Cornell
    (spheres only, use_pallas=True), the six mesh scenes of phase 9 and
    the 4096-triangle world."""
    import torch

    from raytpu_torch.geometry.triangle import precompute
    from raytpu_torch.kernels import intersect
    from raytpu_torch.scenes import cornell_box

    print("K4 vs plain at 64x48 rays (random, camera and bounce rays): "
          "winners and t bit-equal")
    cases = [("cornell 10 spheres", cornell_box(dev), {}), *_k3_cases(dev),
             (f"block world {SCAN_WORLD} 6b",
              _per_triangle(_block_world(SCAN_WORLD), dev), {})]
    for i, (name, (scene, cam, cfg), over) in enumerate(cases):
        cfg = cfg.replace(width=64, height=48, use_pallas=True, **over)
        geom = precompute(scene.triangles) if scene.n_triangles else None
        tabs = intersect.pack_tables(scene, geom)
        eps = (cfg.sphere_eps, cfg.tri_det_eps, cfg.tri_eps)
        hits = []
        for what, o, d in _k4_ray_sets(scene, cam, cfg, 500 + i, dev):
            kt, ki = intersect.pallas_select(scene, geom, o, d, *eps)
            pt, pi = intersect.intersect_reference(*tabs, *o, *d, *eps)
            if not (torch.equal(ki, pi) and torch.equal(kt, pt)):
                raise AssertionError(
                    f"K4 {name} {what}: {(ki != pi).sum().item()} winners and "
                    f"{(kt != pt).sum().item()} distances differ")
            hits.append((ki >= 0).float().mean().item())
        print(f"  {name:28s} {len(hits)} ray sets equal; hit fractions "
              + " ".join(f"{h:.3f}" for h in hits))


def _k4_bound(b, counts, table_bytes):
    """Least K4 time: rays 24 B in and (t, index) 8 B out per ray plus the
    tables at HBM speed, against this input's work at ray granularity (the
    plain version's counts: a sphere test per sphere, a slab test per
    chunk, a triangle test per triangle of every chunk the ray enters
    before its running best, at K3's operation counts for the same tests)
    at the FP32 issue rate."""
    return _bound(b * (24 + 8) + table_bytes, _k4_ops(counts))


def _k4_ops(counts):
    """K4's counted FP32 operations for the plain version's ``counts``."""
    return (counts["sphere"] * K3_OPS_SPHERE + counts["slab"] * OPS_SLAB
            + counts["tri"] * K3_OPS_TRI)


def phase_k4_timing(dev):
    """K4 and its plain version at 1200x900 on the 600- and 4096-triangle
    worlds: on the camera rays of the frame's first sample and on one
    bounce set (bounce 2 of ``_k4_ray_sets``: K4 takes 4 camera and 20
    bounce launches a 4-spp, 6-bounce frame), compared bit for bit, then
    timed with CUDA events in turns, beside the bound from this input's
    work, its share of box tests and the bound the same rays would have
    with ``raytpu``'s 128-triangle boxes; the kernel's dynamic shared
    memory as the driver holds it after the launches."""
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.geometry.triangle import precompute
    from raytpu_torch.integrator.render import blocked_pixel_order, sample_rays
    from raytpu_torch.kernels import intersect

    res = {}
    for n in (MESH_WORLD, SCAN_WORLD):
        scene, cam, cfg = _per_triangle(_block_world(n), dev)
        cfg = cfg.replace(width=FRAME[0], height=FRAME[1], use_pallas=True)
        pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
        ks = rng.sample_keys(rng.pixel_keys(rng.prng_key(0, device=dev), pids), 0)
        cam_d, _ = rng.ray_uniforms(ks, 4, 3, 1)
        sets = {"camera": sample_rays(cam, cfg, pids, cam_d)}
        for what, o, d in _k4_ray_sets(scene, cam, cfg, 17, dev):
            if what == "bounce 2":
                sets[what] = (o, d)
                break
        geom = precompute(scene.triangles)
        tabs = intersect.kernel_tables(scene, geom)
        tabs128 = intersect.pack_tables(scene, geom)
        eps = (cfg.sphere_eps, cfg.tri_det_eps, cfg.tri_eps)
        res[n] = {}
        for what, (o, d) in sets.items():
            rays = tuple(c.contiguous() for c in (*o, *d))
            counts = {"sphere": 0, "slab": 0, "tri": 0}
            pt, pi = intersect.intersect_reference(
                *tabs, *rays, *eps, counts, chunk=intersect.KERNEL_CHUNK)
            kt, ki = intersect._launch(*tabs, rays, *eps)
            if not (torch.equal(ki, pi) and torch.equal(kt, pt)):
                raise AssertionError(
                    f"K4 {n} triangles, {what} rays at {cfg.width}x"
                    f"{cfg.height}: {(ki != pi).sum().item()} winners and "
                    f"{(kt != pt).sum().item()} distances differ")
            max_err = (kt - pt).abs().max().item()
            smem = intersect.func_attrs()["dynamic_smem"]
            c128 = {"sphere": 0, "slab": 0, "tri": 0}
            intersect.intersect_reference(*tabs128, *rays, *eps, c128,
                                          chunk=intersect.CHUNK)
            kernel = lambda: intersect._launch(*tabs, rays, *eps)
            plain = lambda: intersect.intersect_reference(*tabs, *rays, *eps)
            t = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                t[which].append(_time_ms(kernel if which == "kernel" else plain,
                                         20 if which == "kernel" else 2))
            ms, plain_ms = float(np.mean(t["kernel"])), float(np.mean(t["plain"]))
            b = cfg.n_pixels
            bound = _k4_bound(b, counts, 4 * sum(x.numel() for x in tabs))
            bound128 = _k4_bound(b, c128, 4 * sum(x.numel() for x in tabs128))
            print(f"K4 on the {b} {what} rays of the {n}-triangle world: equal "
                  f"to its plain version; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (turns: kernel {t['kernel']}, plain "
                  f"{t['plain']}); bound {bound[0]:.4f} ms ({bound[1]}), box "
                  f"tests {_box_share(counts, _k4_ops(counts)):.1%} of its "
                  f"operations; per ray {counts['sphere'] / b:.2f} sphere, "
                  f"{counts['slab'] / b:.2f} slab and {counts['tri'] / b:.2f} "
                  f"triangle tests (chunks entered before the running best, "
                  f"{intersect.KERNEL_CHUNK} a chunk); with {intersect.CHUNK}"
                  f"-triangle boxes {c128['slab'] / b:.2f} slab and "
                  f"{c128['tri'] / b:.2f} triangle tests, bound "
                  f"{bound128[0]:.4f} ms ({bound128[1]}); {smem} B of dynamic "
                  f"shared memory a block (the driver's); hits "
                  f"{(ki >= 0).float().mean().item():.4f}")
            res[n][what] = dict(ms=ms, plain_ms=plain_ms, bound=bound,
                                max_abs_err=max_err, smem=smem)
    return res


def _sums(s):
    import torch

    return torch.cat([v.to_array().T for v in s[:3]])


def phase_scan_checks(dev):
    """The scan path (K4 where it serves) against the megakernels on the
    card at 64x48x2spp, on the 600-triangle world (K3) and Cornell (K1);
    then the scan path on the card against the CPU (distance matrices) on
    a 40x30x2spp frame of the 4096-triangle world."""
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render
    from raytpu_torch.scenes import cornell_box

    print(f"scan path vs megakernel (outlier: any channel > {ATOL} + "
          f"{RTOL}|x|; limit {OUTLIER_FRAC:.0%} of rays)")
    for name, (scene, cam, cfg) in (
            ("cornell", cornell_box(dev)),
            (f"block world {MESH_WORLD}",
             _per_triangle(_block_world(MESH_WORLD), dev))):
        cfg = cfg.replace(width=64, height=48, spp=2, max_bounces=6)
        ids = torch.arange(cfg.n_pixels, device=dev)
        mk = render(scene, cam, cfg.replace(use_megakernel=True), ids,
                    rng.prng_key(5))
        scan = render(scene, cam, cfg, ids, rng.prng_key(5))
        _compare(f"{name} scan vs megakernel", _sums(mk), _sums(scan))
    path = _block_world(SCAN_WORLD)
    scene, cam, cfg = _per_triangle(path, dev)
    cpu_scene, cpu_cam, _ = _per_triangle(path, "cpu")
    small = cfg.replace(width=40, height=30, spp=2, max_bounces=6)
    ids = torch.arange(small.n_pixels)
    a = render(cpu_scene, cpu_cam, small, ids, rng.prng_key(3))
    b = render(scene, cam, small, ids, rng.prng_key(3))
    _compare(f"block world {SCAN_WORLD} 40x30x2spp scan, card vs cpu",
             _sums(a), _sums(b).cpu())


def _reset_launches():
    from raytpu_torch.core import rng
    from raytpu_torch.kernels import intersect
    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.kernels import trace_scene_bwd as tb
    from raytpu_torch.kernels import trace_spheres as ts

    from raytpu_torch.kernels import gather

    ts.launches = tb.launches = tsc.launches = intersect.launches = 0
    ts.ad_launches = rng.launches = rng.rows_written = gather.launches = 0
    rng.start_launches = 0
    gather.sort_launches = 0


def _check_rng(what, want, rows=None):
    """Raises unless the path launched the RNG kernel ``want`` times (one a
    sample, twice under the checkpoint's recompute), each launch the
    sample start (keys and camera rays), and with ``rows`` unless each
    launch wrote that many draw rows (0 on the megakernel routes, whose
    kernels hash their draws from the keys)."""
    from raytpu_torch.core import rng

    if _rng_launches() != want or rng.start_launches != want:
        raise AssertionError(f"{what}: {_rng_launches()} RNG kernel "
                             f"launches, {rng.start_launches} of them "
                             f"sample starts, want {want}")
    if rows is not None and rng.rows_written != want * rows:
        raise AssertionError(f"{what}: the RNG kernel wrote "
                             f"{rng.rows_written} rows in {want} launches, "
                             f"want {rows} a launch")


def _rng_launches():
    """The RNG kernel's launch count, both modes (``rng.launches``)."""
    from raytpu_torch.core import rng

    return rng.launches


def _launches():
    """(K1, K2, K3, K4, K5) launch counts."""
    from raytpu_torch.kernels import intersect
    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.kernels import trace_scene_bwd as tb
    from raytpu_torch.kernels import trace_spheres as ts

    return (ts.launches, tb.launches, tsc.launches, intersect.launches,
            ts.ad_launches)


def phase_scan_frame(dev, card, mesh):
    """The scan-path forward frame: the 4096-triangle world at 1200x900,
    6 bounces, through ``render`` (``use_megakernel`` off) over all
    block-ordered pixel ids; checked finite and lit, K4 once per bounce
    and AO probe of every sample, no K1/K2/K3; where its time goes; the
    PPM; then the same frame on the 600-triangle world beside phase 11's
    K3 frame."""
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import (
        blocked_pixel_order, render, render_image)
    from raytpu_torch.io.ppm import write_ppm

    out = {}
    for n in (SCAN_WORLD, MESH_WORLD):
        scene, cam, cfg = _per_triangle(_block_world(n), dev)
        cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=SCAN_SPP,
                          max_bounces=6)
        if cfg.use_megakernel:
            raise AssertionError("scan frame: the config asks for a megakernel")
        pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev)
        key = rng.prng_key(0)
        render(scene, cam, cfg.replace(spp=1), pids, key)        # warm up
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sums = render(scene, cam, cfg, pids, key)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        k1, k2, k3, k4, _ = _launches()
        _check_rng("scan frame", cfg.spp)
        rad = sums.radiance.to_array()
        mean = rad.double().mean().item() / cfg.spp
        if not all(v.to_array().isfinite().all() for v in sums[:3]):
            raise AssertionError("scan frame: non-finite sums")
        if not mean > 0.0:
            raise AssertionError(f"scan frame: mean radiance {mean} is not > 0")
        want = cfg.spp * cfg.max_bounces * (1 + (cfg.ao_samples if cfg.use_ao
                                                 else 0))
        if (k4, k1, k2, k3) != (want, 0, 0, 0):
            raise AssertionError(f"scan frame: {k4} K4, {k1} K1, {k2} K2 and "
                                 f"{k3} K3 launches, want {want}, 0, 0, 0")
        rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
        ms = elapsed / cfg.spp * 1e3
        print(f"scan path: block world ({scene.triangles.count} triangles) "
              f"{cfg.width}x{cfg.height} spp={cfg.spp} bounces="
              f"{cfg.max_bounces}: {elapsed:.4f} s, {rays / elapsed:.1f} rays/s "
              f"end to end on {card}, {ms:.2f} ms per sample; K4 launches "
              f"{k4}; mean radiance {mean:.6f}")
        if n == MESH_WORLD:
            print(f"  the same world through K3 (phase 11): "
                  f"{mesh['ms_per_sample']:.2f} ms per sample")
        _print_profile(f"the scan frame at spp=1, {n} triangles", *_profile(
            lambda: render(scene, cam, cfg.replace(spp=1), pids, key)))
        out[n] = dict(k1=k1, k2=k2, k3=k3, k4=k4, rays_per_s=rays / elapsed,
                      ms_per_sample=ms)
        if n == SCAN_WORLD:
            img = render_image(scene, cam, cfg.replace(pixel_tile=cfg.n_pixels),
                               key)
            path = os.path.join(OUT_DIR, f"chip_smoke_scan_{n}.ppm")
            write_ppm(path, img.canvas)
            means = img.canvas.reshape(-1, 3).mean(axis=0)
            print(f"wrote {os.path.relpath(path, ROOT)}: canvas channel means "
                  f"r={means[0]:.3f} g={means[1]:.3f} b={means[2]:.3f}")
    return out


def phase_scan_train(dev, card):
    """The scan-path training frame: fwd+bwd of the photometric loss
    through ``render`` on the 4096-triangle world at 1200x900, 2 spp, 6
    bounces, bilinear textures, every float leaf requiring grad (K4 twice
    per bounce of every sample: the forward and the checkpoint's
    recompute); where its time goes; then 3 bilinear Adam steps at 1 spp
    towards a target with perturbed atlas and material colours, whose
    losses must fall."""
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render
    from raytpu_torch.train import (combine_scene, partition_scene,
                                    photometric_loss)
    from raytpu_torch.train.inverse import ADAM_BETAS, ADAM_EPS

    from raytpu_torch.kernels import gather

    scene, cam, cfg = _per_triangle(_block_world(SCAN_WORLD), dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=SCAN_TRAIN_SPP,
                      max_bounces=6, bilinear_textures=True)
    pids = torch.arange(cfg.n_pixels, device=dev)
    target = torch.zeros((cfg.n_pixels, 3), device=dev)
    key = rng.prng_key(0)
    params, static = partition_scene(scene)
    params = {n: p.detach().clone().requires_grad_() for n, p in params.items()}

    def loss_fn(c=cfg):
        sums = render(combine_scene(params, static), cam, c, pids, key)
        return photometric_loss(sums.radiance * (1.0 / c.spp), target)

    # the warm-up's backward keeps for phase 21 its largest segment sum
    # and the one with the longest row
    calls = _keep_segment_calls(lambda: loss_fn(cfg.replace(spp=1)).backward(),
                                ("largest", "longest row"))
    for p in params.values():
        p.grad = None
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = loss_fn()
    loss.backward()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k1, k2, k3, k4, _ = _launches()
    seg, isort = gather.launches, gather.sort_launches
    _check_rng("scan fwd+bwd", 2 * cfg.spp)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    grads = {n: p.grad for n, p in params.items()}
    # P-F8: the gathers' backward sums in a fixed order, so a second
    # fwd+bwd on the same inputs gives the same bits on every leaf
    for p in params.values():
        p.grad = None
    loss_fn().backward()
    differ = [n for n, p in params.items()
              if (p.grad is None) != (grads[n] is None) or (
                  p.grad is not None and not torch.equal(p.grad, grads[n]))]
    if differ:
        raise AssertionError(f"scan fwd+bwd: two runs' gradients differ on "
                             f"{len(differ)} leaves: {differ[:8]}")
    if seg == 0 or isort == 0:
        raise AssertionError(f"scan fwd+bwd: {seg} segment-sum and {isort} "
                             "index-sort launches")
    if not (loss.isfinite().item() and all(
            g is None or g.isfinite().all() for g in grads.values())):
        raise AssertionError("scan fwd+bwd: non-finite loss or gradient")
    for leaf in ("triangles.a.x", "triangles.a.y", "triangles.a.z",
                 "atlas.rgb.x", "spheres.mat.emission.x"):
        if grads[leaf] is None or not grads[leaf].abs().max().item() > 0.0:
            raise AssertionError(f"scan fwd+bwd: d loss / d {leaf} is zero")
    want = 2 * cfg.spp * cfg.max_bounces
    if (k4, k1, k2, k3) != (want, 0, 0, 0):
        raise AssertionError(f"scan fwd+bwd: {k4} K4, {k1} K1, {k2} K2 and "
                             f"{k3} K3 launches, want {want} (forward + "
                             "checkpoint recompute), 0, 0, 0")
    rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
    print(f"scan fwd+bwd: block world ({scene.triangles.count} triangles, "
          f"bilinear) {cfg.width}x{cfg.height} spp={cfg.spp} bounces="
          f"{cfg.max_bounces}, d loss / d every float leaf ({len(params)} "
          f"leaves): {elapsed:.4f} s, {rays / elapsed:.1f} rays/s on {card}, "
          f"{elapsed / cfg.spp * 1e3:.2f} ms per sample, peak "
          f"{peak_gb:.2f} GB; loss {loss.item():.6f}; K4 launches {k4}; "
          f"segment-sum launches {seg}, index-sort launches {isort}; a "
          f"second fwd+bwd bit-identical on "
          f"all {len(params)} leaves; max "
          + ", ".join(f"|d {leaf}| {grads[leaf].abs().max().item():.4e}"
                      for leaf in ("triangles.a.x", "triangles.a.y",
                                   "triangles.a.z", "atlas.rgb.x")))
    names = set()
    prof = _profile(lambda: loss_fn(cfg.replace(spp=1)).backward(), names)
    _print_profile("scan fwd+bwd at spp=1", *prof)
    atomic = sorted(n for n in names if any(a in n for a in ATOMIC_SCATTERS))
    if (atomic or prof[3]["torch.sort"] > 0.0
            or not prof[3]["segment sum"] > 0.0
            or not prof[3]["index sort"] > 0.0):
        raise AssertionError(f"scan fwd+bwd: index_add_ / index_put_ kernels "
                             f"{atomic[:4]}, torch.sort "
                             f"{prof[3]['torch.sort']} ms, segment sum "
                             f"{prof[3]['segment sum']} ms, index sort "
                             f"{prof[3]['index sort']} ms in the profile")

    tparams = {n: p.detach().clone()
               for n, p in partition_scene(scene)[0].items()}
    for c in "xyz":
        tparams[f"atlas.rgb.{c}"] = (tparams[f"atlas.rgb.{c}"] * 0.8).clamp(0, 1)
        tparams[f"mat_table.emission.{c}"] = tparams[f"mat_table.emission.{c}"] * 0.8
    tcfg = cfg.replace(spp=SCAN_STEP_SPP)
    with torch.no_grad():
        tsums = render(combine_scene(tparams, static), cam, tcfg, pids, key)
        tgt = (tsums.radiance * (1.0 / tcfg.spp)).to_array()

    def adam_losses(frozen, n_steps):
        """Losses of n_steps bilinear Adam steps of every float leaf but
        those whose names start with ``frozen``; the number moved."""
        params = {n: p.detach().clone().requires_grad_(not n.startswith(
            frozen)) for n, p in partition_scene(scene)[0].items()}
        trained = [p for p in params.values() if p.requires_grad]
        opt = torch.optim.Adam(trained, lr=SCAN_STEP_LR, betas=ADAM_BETAS,
                               eps=ADAM_EPS)
        losses = []
        for step in range(n_steps):
            opt.zero_grad(set_to_none=True)
            loss = photometric_loss(render(combine_scene(params, static), cam,
                                           tcfg, pids, key).radiance, tgt)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        return losses, len(trained)

    every, n_every = adam_losses((), 2)
    print(f"scan train: 2 Adam steps (lr {SCAN_STEP_LR}) of all {n_every} "
          f"float leaves, bilinear: losses {every[0]:.6e} {every[1]:.6e} "
          "(not required to fall: see SCAN_STEP_FROZEN)")
    t0 = time.perf_counter()
    losses, n_trained = adam_losses(SCAN_STEP_FROZEN, 3)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"scan train: non-finite loss {losses}")
    if not losses[0] > losses[1] > losses[2]:
        raise AssertionError(f"scan train: losses do not fall: {losses}")
    print(f"scan train: 3 Adam steps (lr {SCAN_STEP_LR}) of {n_trained} of "
          f"{n_every} float leaves (all but {', '.join(SCAN_STEP_FROZEN)}) "
          f"at {tcfg.width}x{tcfg.height} spp={tcfg.spp}, bilinear, towards "
          "a perturbed atlas/material target: losses "
          + " ".join(f"{x:.6e}" for x in losses)
          + f"; {step_s:.4f} s per step")
    return dict(k1=k1, k2=k2, k3=k3, k4=k4, rays_per_s=rays / elapsed,
                seconds=elapsed, segment_sum=seg, index_sort=isort,
                seg_calls=calls)


def _keep_segment_calls(work, whats):
    """Runs ``work`` with the segment-sum wrapper watched; for each of
    ``whats`` the call it names, as (channels copied, index): "largest"
    (the most cotangents), "longest row" (the most entries on one row),
    "sky" (the index over the most rows)."""
    from raytpu_torch.kernels import gather

    sizes, calls, seen = {}, {}, {}
    launch = gather._launch

    def keep(g, index):
        chans = gather._channels(g)
        size = {"largest": len(chans) * chans[0].numel(),
                "longest row": int(index.sorted_plan()[2].diff().max().item()),
                "sky": index.n_rows}
        shape = (len(chans), index.n_rows, size["longest row"])
        seen[shape] = seen.get(shape, 0) + 1
        for what in whats:
            if size[what] > sizes.get(what, 0):
                sizes[what] = size[what]
                calls[what] = ([x.detach().clone() for x in chans], index)
        return launch(g, index)

    gather._launch = keep
    try:
        work()
    finally:
        gather._launch = launch
    print("  segment-sum calls (channels, rows, longest row: count): "
          + ", ".join(f"{c}, {r}, {n}: {k}" for (c, r, n), k in
                      sorted(seen.items(), key=lambda x: -x[1])))
    return calls


def phase_segment_sum(dev, strain):
    """The gathers' plan (csrc/index_sort.cu) and segment sum
    (csrc/segment_sum.cu) on three calls: the largest and the longest-row
    call of the scan fwd+bwd's backward (phase 20), and the sky texels'
    call (``compose_sky``) of the MESH_WORLD sky world's fwd+bwd at 1 spp,
    run here. The plan must equal its plain version
    (``torch.sort(stable=True)`` + ``searchsorted``) on the same card
    tensors bit for bit; every row of the sums within SEG_REL of its sum
    of |cotangents| from the exact row sums (the plain version,
    ``index_add_``, in float64 on the CPU; ``index_add_`` on the card, f32
    atomics, printed beside it); on the longest-row call rows summed by
    the warp (more than the kernel's heavy tiles); two launches
    bit-identical. Each timed (device time; CUDA events too) beside its
    plain version and library call (the plan: ``torch.sort`` +
    ``searchsorted``; the sums: ``index_add_``), with its bound. Returns
    {call: numbers}."""
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render
    from raytpu_torch.kernels import gather
    from raytpu_torch.train import (combine_scene, partition_scene,
                                    photometric_loss)

    scene, cam, cfg = _sky_scene(MESH_WORLD, dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=1, max_bounces=6,
                      use_megakernel=True, sky_texture_grads=True)
    params, static = partition_scene(scene)
    params = {n: p.detach().clone().requires_grad_() for n, p in params.items()}
    pids = torch.arange(cfg.n_pixels, device=dev)
    target = torch.zeros((cfg.n_pixels, 3), device=dev)

    def sky_fwd_bwd():
        sums = render(combine_scene(params, static), cam, cfg, pids,
                      rng.prng_key(0))
        photometric_loss(sums.radiance, target).backward()

    calls = dict(strain["seg_calls"])
    calls.update(_keep_segment_calls(sky_fwd_bwd, ("sky",)))
    del params
    tile, heavy = gather.kernel_tiles()
    out = {}
    for what in ("largest", "longest row", "sky"):
        chans, index = calls[what]
        idx, rows = index.idx, index.n_rows
        c, b = len(chans), idx.shape[0]
        mine = gather.GatherIndex(idx, rows).sorted_plan()
        plain = gather.sorted_plan_reference(idx, rows)
        differ = [n for n, x, y in zip(("perm", "seg", "off"), mine, plain)
                  if not torch.equal(x, y)]
        if differ:
            raise AssertionError(f"index sort ({what}): {differ} differ from "
                                 "torch.sort(stable=True) + searchsorted")
        index = gather.GatherIndex(idx, rows)
        got = gather._launch(chans, index)
        if not torch.equal(got, gather._launch(chans, index)):
            raise AssertionError(f"segment sum ({what}): two launches differ")
        g = torch.stack(chans)
        cpu = gather.GatherIndex(idx.cpu(), rows)
        exact = gather.segment_sum_reference(g.cpu().double(), cpu)
        scale = gather.segment_sum_reference(g.cpu().double().abs(), cpu)
        err = {}
        for who, sums in (("kernel", got), ("index_add_ on the card",
                                            gather.segment_sum_reference(g, index))):
            diff = (sums.cpu().double() - exact).abs()
            err[who] = ((diff / (scale + 1e-30)).max().item(),
                        diff.max().item())
        off = plain[2].long()
        span = torch.where(off[1:] > off[:-1], (off[1:] - 1) // tile
                           - off[:-1] // tile + 1, 0)
        n_heavy = int((span > heavy).sum().item())
        print(f"  segment sum ({what}) vs the exact row sums: worst |diff| "
              f"over the row's sum of |g| {err['kernel'][0]:.3e} (limit "
              f"{SEG_REL}; index_add_ on the card "
              f"{err['index_add_ on the card'][0]:.3e}), max |diff| "
              f"{err['kernel'][1]:.3e}; longest row {int(span.max())} tiles "
              f"of {tile} ({-(-int(span.max()) // tile)} second-level "
              f"partials), {n_heavy} rows over {heavy} tiles (summed by the "
              "warp); the plan equals torch.sort + searchsorted")
        if not err["kernel"][0] <= SEG_REL:
            raise AssertionError(f"segment sum ({what}) vs the exact row "
                                 f"sums: {err['kernel'][0]:.3e} > {SEG_REL}")
        if what == "longest row" and n_heavy == 0:
            raise AssertionError("segment sum: no row of the longest-row "
                                 "call took the warp's branch")
        zeros = torch.zeros((c, rows), device=dev)
        ar = torch.arange(rows + 1, device=dev)
        fns = {"sums": lambda: gather._launch(chans, index),
               "sums plain": lambda: gather.segment_sum_reference(g, index),
               "index_add_": lambda: zeros.index_add_(1, idx, g),
               "plan": lambda: gather.GatherIndex(idx, rows).sorted_plan(),
               "plan plain": lambda: gather.sorted_plan_reference(idx, rows),
               "torch.sort + searchsorted": lambda: torch.searchsorted(
                   torch.sort(idx, stable=True)[0], ar)}
        t = {w: [] for w in fns}
        for which in ("sums plain", "sums", "index_add_", "index_add_",
                      "sums", "sums plain", "plan plain", "plan",
                      "torch.sort + searchsorted", "torch.sort + searchsorted",
                      "plan", "plan plain"):
            t[which].append(_time_ms(fns[which], 10))
        events = {w: float(np.mean(v)) for w, v in t.items()}
        ms = {w: _device_ms(f) for w, f in fns.items()}
        n_rows_hit = int((off.diff() > 0).sum().item())
        bound = _bound(4 * (c * b + 2 * b + rows + 1 + c * rows), c * b)
        plan_bound = _bound(idx.element_size() * b + 8 * b + 4 * (rows + 1), 0)
        passes = gather.sort_sizes(b, rows)[1]
        print(f"segment sum, {what} call ({c} channels, {b} entries, "
              f"{rows} rows, {n_rows_hit} of them gathered): sums "
              f"{ms['sums']:.4f} ms (plain {ms['sums plain']:.4f}, index_add_ "
              f"{ms['index_add_']:.4f}; bound {bound[0]:.4f} ms, "
              f"{bound[1]}); plan {ms['plan']:.4f} ms, {passes} radix "
              f"passes (plain {ms['plan plain']:.4f}, torch.sort + "
              f"searchsorted {ms['torch.sort + searchsorted']:.4f}; bound "
              f"{plan_bound[0]:.4f} ms, {plan_bound[1]}): device time "
              "(10 calls queued behind a spin kernel); CUDA events around "
              f"10 calls, the host's launches included: {events}, turns {t}")
        out[what] = dict(ms=ms["sums"], plain_ms=ms["sums plain"],
                         library_ms=ms["index_add_"], bound=bound,
                         max_abs_err=err["kernel"][1],
                         max_rel_err=err["kernel"][0], shape=(c, b, rows),
                         heavy_rows=n_heavy, plan_ms=ms["plan"],
                         plan_plain_ms=ms["plan plain"],
                         plan_library_ms=ms["torch.sort + searchsorted"],
                         plan_bound=plan_bound, passes=passes,
                         events_ms=events["sums"],
                         plan_events_ms=events["plan"])
        del fns, zeros, g, exact, scale
    return out


def _on(obj, dev):
    """A scene or camera with every tensor moved to ``dev``."""
    from raytpu_torch.sharding.mesh import to_device

    return to_device(obj, dev)


_SKY_FILES = {}


def _sky_files():
    """The TOMLs of the sky scenes, written once under OUT_DIR: the
    showcase (``write_sky_showcase``, 5 spheres) under a generated
    SKY_SIZE sky, and the 60-, MESH_WORLD- and SCAN_WORLD-triangle block
    worlds with ``sky=`` that sky file. Times the writer and the loader
    on the full-size PPM."""
    from raytpu_torch.io.obj import load_sky
    from raytpu_torch.scenes import write_block_world, write_sky_showcase

    if not _SKY_FILES:
        t0 = time.perf_counter()
        show = write_sky_showcase(os.path.join(OUT_DIR, "sky_showcase"),
                                  SKY_SIZE)
        t_write = time.perf_counter() - t0
        sky = os.path.join(os.path.dirname(show), "sky.ppm")
        t0 = time.perf_counter()
        tex = load_sky(sky, "cpu")
        t_load = time.perf_counter() - t0
        print(f"sky texture: {tex.width}x{tex.height} P3 PPM "
              f"({os.path.getsize(sky) / 1e6:.1f} MB) written in "
              f"{t_write:.2f} s, read by io.obj.load_sky in {t_load:.2f} s "
              "(host); every sky scene below loads it through its TOML")
        _SKY_FILES["show"] = show
        for n in (60, MESH_WORLD, SCAN_WORLD):
            _SKY_FILES[n] = write_block_world(
                os.path.join(OUT_DIR, f"block_world_{n}_sky"), n_triangles=n,
                seed=3 if n == 60 else 0, sky=sky)
    return _SKY_FILES


_LOADED = {}


def _sky_scene(key, dev):
    """(scene, camera, config) of a sky scene on the card, loaded once;
    on the CPU a copy of the card's."""

    if key not in _LOADED:
        _LOADED[key] = _per_triangle(_sky_files()[key], dev)
    scene, cam, cfg = _LOADED[key]
    if str(dev) == "cpu":
        return _on(scene, "cpu"), _on(cam, "cpu"), cfg
    return scene, cam, cfg


def _k1_sky_cases(dev):
    """Sphere sky scenes of the K1 checks: the showcase, with AO and the
    HSL boost, and with its marble a cutout (cutout then sky)."""
    import dataclasses

    import torch

    show = _sky_scene("show", dev)
    s = show[0].spheres
    alpha = s.mat.alpha.clone()
    alpha[3] = 0.0
    cut = dataclasses.replace(show[0], spheres=dataclasses.replace(
        s, mat=dataclasses.replace(s.mat, alpha=alpha)))
    assert bool((cut.spheres.mat.alpha == 0).any()) and torch.is_tensor(alpha)
    return [("showcase 4b", show, {}),
            ("showcase ao+hsl 4b", show, dict(use_ao=True, ao_samples=2,
                                               hsl_l_factor=1.2,
                                               hsl_s_factor=1.1)),
            ("showcase cutout 6b", (cut, *show[1:]), dict(max_bounces=6))]


def _k3_sky_cases(dev):
    """Mesh sky scenes of the K3 checks: the 60-triangle world with its
    dome the sky sphere, with AO, with every atlas texel a cutout, and the
    MESH_WORLD-triangle world."""
    import dataclasses

    import torch

    from raytpu_torch.core.types import TextureAtlas

    small = _sky_scene(60, dev)
    a = small[0].atlas
    cut = dataclasses.replace(small[0], atlas=TextureAtlas(
        a.rgb, torch.zeros_like(a.alpha), a.width, a.height))
    return [("sky world 60 6b", small, dict(max_bounces=6)),
            ("sky world 60 ao_samples=2", small,
             dict(max_bounces=4, use_ao=True, ao_samples=2)),
            ("sky world 60 cutout 4b", (cut, *small[1:]), dict(max_bounces=4)),
            (f"sky world {MESH_WORLD} 6b", _sky_scene(MESH_WORLD, dev), {})]


def phase_sky_kernels(dev):
    """The sky modes against their plain versions on the same card
    tensors at 64x48 rays: K1's 16 planes and recording, K3's 16 planes
    and recording (rays that leave K3's loop early among them), K2's sky
    cotangent in sphere and mesh modes, two launches compared. Returns
    the largest |diff| of each mode and whether the forward planes were
    bit-equal."""
    import numpy as np
    import torch

    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.kernels import trace_scene_bwd as tb
    from raytpu_torch.kernels import trace_spheres as ts

    res = {"k1": 0.0, "k3": 0.0, "k2_sphere": 0.0, "k2_mesh": 0.0,
           "bit_equal": True}

    def bits(name, ref, out):
        differ = (ref != out).any(0).float().mean().item()
        res["bit_equal"] &= differ == 0.0
        print(f"  {name:28s} rays not bit-equal to the plain version: "
              f"{differ:.5f}")

    print("sky slot (K1): kernel vs plain at 64x48 rays, 16 planes, then "
          "recording and K2's sky cotangent (sphere mode)")
    for i, (name, (scene, cam, cfg), over) in enumerate(_k1_sky_cases(dev)):
        cfg = cfg.replace(width=64, height=48, **over)
        origin, direction, draws, keys = _kernel_inputs(scene, cam, cfg,
                                                        800 + i, dev)
        sph = ts.pack_spheres(scene)
        k = ts.Knobs.create(cfg, scene.spheres.count, draws.shape[1],
                            scene.sky_index)
        flat = draws.reshape(-1, draws.shape[-1])
        rays = (*origin, *direction)
        ref = ts.trace_spheres_reference(sph, *rays, flat, k)
        out = ts._launch(sph, rays, keys, k)
        if out.shape[0] != 16:
            raise AssertionError(f"{name}: {out.shape[0]} planes, want 16")
        res["k1"] = max(res["k1"], _compare(name, ref, out))
        bits(name, ref, out)
        _bit_equal(name, ref, out)
        kern = ts._launch(sph, rays, keys, k, record=True)
        _check_record(name, kern, ts.trace_spheres_reference(
            sph, *rays, flat, k, record=True), out, bit_equal=True)
        _, idx, aof = kern
        g = torch.tensor(np.random.default_rng(900 + i).uniform(
            -1, 1, (12, cfg.n_pixels)).astype(np.float32), device=dev)
        got = _sphere_kernel(sph, rays, keys, idx, aof, g, k)
        again = _sphere_kernel(sph, rays, keys, idx, aof, g, k)
        if not _same_grads(got, again):
            raise AssertionError(f"{name}: two K2 sky launches differ")
        ref_g = _sphere_reference(sph, rays, flat, idx, aof, g, k)
        res["k2_sphere"] = max(res["k2_sphere"],
                               _compare_grads(f"{name} K2 sky", ref_g, got)[0])

    print("sky slot (K3): kernel vs plain at 64x48 rays, 16 planes, then "
          "recording and K2's sky cotangent (mesh mode)")
    for i, (name, (scene, cam, cfg), over) in enumerate(_k3_sky_cases(dev)):
        cfg = cfg.replace(width=64, height=48, **over)
        o, d, _, keys = _kernel_inputs(scene, cam, cfg, 820 + i, dev)
        mt, rays, keys, flat, k = _mesh_inputs(scene, cfg, o, d, keys)
        ref = tsc.trace_scene_reference(mt, *rays, flat, k)
        out = tsc._launch(mt, rays, keys, k)
        if out.shape[0] != 16:
            raise AssertionError(f"{name}: {out.shape[0]} planes, want 16")
        res["k3"] = max(res["k3"], _compare(name, ref, out))
        bits(name, ref, out)
        _bit_equal(name, ref, out)
        kern = tsc._launch(mt, rays, keys, k, record=True)
        _check_mesh_record(name, kern, tsc.trace_scene_reference(
            mt, *rays, flat, k, record=True), out, bit_equal=True)
        _, idx, aof = kern
        # rays that left the loop before its last bounce with the slot
        # taken: their slot planes are written after the loop
        exited = ((idx[-1] == -1) & (out[9:12] != 0).any(0)).sum().item()
        print(f"  {name:28s} rays that left the loop early with the slot "
              f"taken: {exited}")
        if exited == 0:
            raise AssertionError(f"{name}: no ray left K3's loop early with "
                                 "its sky slot taken")
        tabs = tb.Tables(mt.sph, mt.tri, mt.mats, mt.atlas)
        g = torch.tensor(np.random.default_rng(920 + i).uniform(
            -1, 1, (12, cfg.n_pixels)).astype(np.float32), device=dev)
        got = tb._launch(tabs, rays, keys, idx, aof, g, k)
        again = tb._launch(tabs, rays, keys, idx, aof, g, k)
        ref_g = tb.replay_reference(tabs, rays, flat, idx, aof, g, k)
        res["k2_mesh"] = max(res["k2_mesh"], _compare_mesh_grads(
            f"{name} K2 sky", ref_g, got, again)[0])
    print(f"  sky forward planes bit-equal to the plain versions on every "
          f"scene: {res['bit_equal']}")
    return res


def phase_sky_texels(dev):
    """The texel index on the card: a 0-dim tensor divisor gives the
    correctly rounded quotient (what ``sky_texel_index`` relies on), a
    Python-float divisor does not always; and the indices of the same
    directions on the card and on the CPU (acos / atan2 rounding)."""
    import numpy as np
    import torch

    from raytpu_torch.core.vec3 import Vec3
    from raytpu_torch.materials.texture import PI32, TWO_PI32, sky_texel_index

    rs = np.random.default_rng(11)
    d = rs.normal(size=(3, 1 << 20)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    dirs = Vec3(*(torch.tensor(c, device=dev) for c in d))
    phi = torch.atan2(-dirs.z, dirs.x) + PI32
    true = (phi.double() / TWO_PI32).float()
    by_tensor = phi / torch.full((), TWO_PI32, dtype=torch.float32, device=dev)
    by_float = phi / TWO_PI32
    if not torch.equal(by_tensor, true):
        raise AssertionError("division by a 0-dim card tensor is not the "
                             "correctly rounded quotient")
    w, h = SKY_SIZE
    floor_differs = (torch.floor(by_float * w) != torch.floor(by_tensor * w))
    card = sky_texel_index(dirs, w, h).cpu()
    cpu = sky_texel_index(Vec3(*(torch.tensor(c) for c in d)), w, h)
    flips = (card != cpu).float().mean().item()
    print(f"sky texels: u = phi / 2pi on the card: 0-dim tensor divisor "
          f"correctly rounded on all {d.shape[1]} directions, Python-float "
          f"divisor off by an ulp on {(by_float != true).float().mean().item():.5f}"
          f" of them, moving floor(u*{w}) on "
          f"{floor_differs.float().mean().item():.6f}; texel index card vs "
          f"CPU (acos/atan2) flips on {flips:.6f} of the directions")
    if flips > OUTLIER_FRAC:
        raise AssertionError(f"texel indices flip on {flips:.2%}")
    return dict(div_float_ulp=(by_float != true).float().mean().item(),
                direction_flips=flips)


def phase_sky_timing(dev):
    """The sky modes at the sky frames' shapes, real RNG draws, timed with
    CUDA events in turns beside their plain versions and bounds: K1 and
    its recording on the showcase (1000x750 rays, 4 bounces), K2's sky
    sphere mode there; K3 and its recording on the MESH_WORLD sky world
    (1200x900 rays, 6 bounces), K2's sky mesh mode there."""
    import numpy as np
    import torch

    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.kernels import trace_scene_bwd as tb
    from raytpu_torch.kernels import trace_spheres as ts

    def camera_batch(scene, cam, cfg):
        o, d, keys, draws, _ = _frame_sample(cam, cfg, dev)
        return o, d, draws, keys

    def turns(fns, order, iters):
        t = {w: [] for w in fns}
        for which in order:
            t[which].append(_time_ms(fns[which], iters[which]))
        return {w: float(np.mean(v)) for w, v in t.items()}, t

    res = {}
    scene, cam, cfg = _sky_scene("show", dev)
    o, d, draws, keys = camera_batch(scene, cam, cfg)
    sph = ts.pack_spheres(scene)
    k = ts.Knobs.create(cfg, scene.spheres.count, draws.shape[1],
                        scene.sky_index)
    flat = draws.reshape(-1, draws.shape[-1])
    rays = (*o, *d)
    name = f"showcase {cfg.width}x{cfg.height} {cfg.max_bounces}b"
    print(f"sky modes at the sky frames' shapes ({name}; sky world "
          f"{MESH_WORLD} {FRAME[0]}x{FRAME[1]} 6b):")
    counts, rec_counts = {}, {}
    ref = ts.trace_spheres_reference(sph, *rays, flat, k, counts=counts)
    out = ts._launch(sph, rays, keys, k)
    k1_err = _compare(name, ref, out)
    _bit_equal(name, ref, out)
    kern = ts._launch(sph, rays, keys, k, record=True)
    _, idx, aof = kern
    _check_record(name, kern, ts.trace_spheres_reference(
        sph, *rays, flat, k, record=True, counts=rec_counts), out,
        bit_equal=True)
    g = torch.tensor(np.random.default_rng(10).uniform(
        -1, 1, (12, cfg.n_pixels)).astype(np.float32), device=dev)
    got = _sphere_kernel(sph, rays, keys, idx, aof, g, k)
    if not _same_grads(got, _sphere_kernel(sph, rays, keys, idx, aof, g, k)):
        raise AssertionError(f"{name}: two K2 sky launches differ")
    k2_err = _compare_grads(f"{name} K2 sky", _sphere_reference(
        sph, rays, flat, idx, aof, g, k), got)[0]
    del ref
    fns = {"k1": lambda: ts._launch(sph, rays, keys, k),
           "k1_plain": lambda: ts.trace_spheres_reference(sph, *rays, flat, k),
           "k1_rec": lambda: ts._launch(sph, rays, keys, k, record=True),
           "k2": lambda: _sphere_kernel(sph, rays, keys, idx, aof, g, k),
           "k2_plain": lambda: _sphere_reference(sph, rays, flat, idx, aof,
                                                 g, k)}
    ms, t = turns(fns, ("k1_plain", "k1", "k1_rec", "k2_plain", "k2", "k2",
                        "k2_plain", "k1_rec", "k1", "k1_plain"),
                  {w: 3 if w.endswith("plain") else 20 for w in fns})
    n_live = counts["live"]
    b, s = cfg.n_pixels, k.n_spheres
    res["k1"] = dict(ms=ms["k1"], plain_ms=ms["k1_plain"],
                     bound=_k1_bound(b, cfg.max_bounces, counts, s, False, True),
                     max_abs_err=k1_err)
    res["k1_rec"] = dict(ms=ms["k1_rec"], plain_ms=ms["k1_plain"],
                         bound=_k1_bound(b, cfg.max_bounces, rec_counts, s,
                                         True, True), max_abs_err=k1_err)
    res["k2_sphere"] = dict(ms=ms["k2"], plain_ms=ms["k2_plain"],
                            bound=_k2_bound(b, cfg.max_bounces, counts, s, True),
                            max_abs_err=k2_err)
    for w in ("k1", "k1_rec", "k2_sphere"):
        r = res[w]
        print(f"  {w:9s} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms; "
              f"bound {r['bound'][0]:.4f} ms, {r['bound'][1]})")
    print(f"  turns {t}; live (ray, bounce) entries {n_live} of "
          f"{b * cfg.max_bounces}")

    scene, cam, cfg = _sky_scene(MESH_WORLD, dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], max_bounces=6)
    o, d, _, keys = camera_batch(scene, cam, cfg)
    mt, rays, keys, flat, k = _mesh_inputs(scene, cfg, o, d, keys)
    name = f"sky world {MESH_WORLD} {cfg.width}x{cfg.height} 6b"
    counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
    ref = tsc.trace_scene_reference(mt, *rays, flat, k, counts)
    out = tsc._launch(mt, rays, keys, k)
    k3_err = _compare(name, ref, out)
    _bit_equal(name, ref, out)
    del ref
    kern = tsc._launch(mt, rays, keys, k, record=True)
    _, rec_err = _check_mesh_record(name, kern, tsc.trace_scene_reference(
        mt, *rays, flat, k, record=True), out, bit_equal=True)
    _, idx, aof = kern
    tabs = tb.Tables(mt.sph, mt.tri, mt.mats, mt.atlas)
    g = torch.tensor(np.random.default_rng(12).uniform(
        -1, 1, (12, cfg.n_pixels)).astype(np.float32), device=dev)
    got = tb._launch(tabs, rays, keys, idx, aof, g, k)
    again = tb._launch(tabs, rays, keys, idx, aof, g, k)
    k2m_err = _compare_mesh_grads(f"{name} K2 sky", tb.replay_reference(
        tabs, rays, flat, idx, aof, g, k), got, again)[0]
    del got, again
    fns = {"k3": lambda: tsc._launch(mt, rays, keys, k),
           "k3_plain": lambda: tsc.trace_scene_reference(mt, *rays, flat, k),
           "k3_rec": lambda: tsc._launch(mt, rays, keys, k, record=True),
           "k3_rec_plain": lambda: tsc.trace_scene_reference(
               mt, *rays, flat, k, record=True),
           "k2": lambda: tb._launch(tabs, rays, keys, idx, aof, g, k),
           "k2_plain": lambda: tb.replay_reference(tabs, rays, flat, idx,
                                                   aof, g, k)}
    ms, t = turns(fns, ("k3_plain", "k3", "k3", "k3_plain", "k3_rec_plain",
                        "k3_rec", "k3_rec", "k3_rec_plain", "k2_plain", "k2",
                        "k2", "k2_plain"),
                  {w: 2 if w.endswith("plain") else 20 for w in fns})
    b = cfg.n_pixels
    table_bytes = mt.nbytes()
    res["k3"] = dict(ms=ms["k3"], plain_ms=ms["k3_plain"],
                     bound=_k3_bound(b, cfg.max_bounces, counts, table_bytes,
                                     True), max_abs_err=k3_err)
    res["k3_rec"] = dict(ms=ms["k3_rec"], plain_ms=ms["k3_rec_plain"],
                         bound=_k3_bound(b, cfg.max_bounces, counts,
                                         table_bytes + 4 * b * cfg.max_bounces,
                                         True), max_abs_err=rec_err)
    res["k2_mesh"] = dict(ms=ms["k2"], plain_ms=ms["k2_plain"],
                          bound=_k2_mesh_bound(b, cfg.max_bounces, idx,
                                               k.n_spheres,
                                               4 * sum(x.numel() for x in tabs),
                                               counts, _k2_mesh_scratch(b, k),
                                               True), max_abs_err=k2m_err,
                          smem=tb.mesh_func_attrs(True)["dynamic_smem"])
    for w in ("k3", "k3_rec", "k2_mesh"):
        r = res[w]
        print(f"  {w:9s} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms; "
              f"bound {r['bound'][0]:.4f} ms, {r['bound'][1]})")
    print(f"  turns {t}; live (ray, bounce) entries {counts['live']} of "
          f"{b * cfg.max_bounces}")
    return res


def _frame(what, dev, card, scene, cam, cfg, want, fwd_bwd=None):
    """One timed frame through ``render`` over all block-ordered pixel ids
    (forward, or with ``fwd_bwd`` = params the loss and its gradient),
    its launch counts against ``want`` (K1, K2, K3, K4, K5), finiteness, and
    where its time goes at 1 spp. Returns (elapsed s, rays/s, launches,
    idle share, result)."""
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import blocked_pixel_order, render

    pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev)
    key = rng.prng_key(0)
    work = fwd_bwd if fwd_bwd is not None else (
        lambda c: render(scene, cam, c, pids, key))
    work(cfg.replace(spp=1))                        # warm up
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = work(cfg)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    got = _launches()
    if got != want:
        raise AssertionError(f"{what}: (K1, K2, K3, K4, K5) launches {got}, "
                             f"want {want}")
    # the megakernel routes' sample starts write no draw rows
    _check_rng(what, cfg.spp * (1 if fwd_bwd is None else 2),
               rows=0 if want[0] or want[2] else None)
    rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
    wall, busy, n_k, buckets = _profile(lambda: work(cfg.replace(spp=1)))
    idle = max(0.0, 1 - busy / wall)
    print(f"{what}: {cfg.width}x{cfg.height} spp={cfg.spp} bounces="
          f"{cfg.max_bounces}: {elapsed:.4f} s, {rays / elapsed:.1f} rays/s "
          f"on {card}; launches (K1, K2, K3, K4, K5) {got}")
    _print_profile(f"{what} at spp=1", wall, busy, n_k, buckets)
    return elapsed, rays / elapsed, got, idle, out


def phase_sky_frames(dev, card):
    """The sky frames at full size under the SKY_SIZE sky: the showcase
    through K1 (forward); the MESH_WORLD sky world through K3 (forward,
    forward+backward of every float leaf and the sky texels, 3 Adam steps
    whose losses fall); the SCAN_WORLD sky world through the scan path
    (forward). Each checked finite and lit, with its launches, time, rate
    and idle share; PPMs of the two megakernel frames."""
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render, render_image
    from raytpu_torch.io.ppm import write_ppm
    from raytpu_torch.train import (combine_scene, make_train_step,
                                    partition_scene, photometric_loss)

    res = {}

    def lit(what, sums, spp):
        rad = sums.radiance.to_array()
        if not all(v.to_array().isfinite().all() for v in sums[:3]):
            raise AssertionError(f"{what}: non-finite sums")
        mean = rad.double().mean().item() / spp
        if not mean > 0.0:
            raise AssertionError(f"{what}: mean radiance {mean} is not > 0")
        print(f"  mean radiance {mean:.6f}")

    def ppm(name, scene, cam, cfg):
        img = render_image(scene, cam, cfg.replace(pixel_tile=cfg.n_pixels),
                           rng.prng_key(0))
        path = os.path.join(OUT_DIR, f"chip_smoke_{name}.ppm")
        write_ppm(path, img.canvas)
        means = img.canvas.reshape(-1, 3).mean(axis=0)
        print(f"wrote {os.path.relpath(path, ROOT)}: canvas channel means "
              f"r={means[0]:.3f} g={means[1]:.3f} b={means[2]:.3f}")

    scene, cam, cfg = _sky_scene("show", dev)
    cfg = cfg.replace(spp=SKY_SHOW_SPP, use_megakernel=True)
    el, rate, got, idle, sums = _frame(
        "sky showcase (K1)", dev, card, scene, cam, cfg, (cfg.spp, 0, 0, 0, 0))
    lit("sky showcase", sums, cfg.spp)
    res["show"] = dict(s=el, rate=rate, launches=got, idle=idle)
    ppm("sky_showcase", scene, cam, cfg)

    scene, cam, cfg = _sky_scene(MESH_WORLD, dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=SKY_MESH_SPP,
                      max_bounces=6, use_megakernel=True)
    el, rate, got, idle, sums = _frame(
        f"sky world {MESH_WORLD} (K3)", dev, card, scene, cam, cfg,
        (0, 0, cfg.spp, 0, 0))
    lit("sky world", sums, cfg.spp)
    res["mesh"] = dict(s=el, rate=rate, launches=got, idle=idle)
    ppm(f"sky_world_{MESH_WORLD}", scene, cam, cfg)

    tcfg = cfg.replace(spp=SKY_TRAIN_SPP, sky_texture_grads=True)
    pids = torch.arange(cfg.n_pixels, device=dev)
    params, static = partition_scene(scene)
    params = {n: p.detach().clone().requires_grad_() for n, p in params.items()}
    target = torch.zeros((cfg.n_pixels, 3), device=dev)

    def fwd_bwd(c):
        for p in params.values():
            p.grad = None
        sums = render(combine_scene(params, static), cam, c, pids,
                      rng.prng_key(0))
        loss = photometric_loss(sums.radiance * (1.0 / c.spp), target)
        loss.backward()
        return loss

    el, rate, got, idle, loss = _frame(
        f"sky world {MESH_WORLD} fwd+bwd (K3 recording, K2)", dev, card,
        scene, cam, tcfg, (0, tcfg.spp, 2 * tcfg.spp, 0, 0), fwd_bwd)
    grads = {n: p.grad for n, p in params.items()}
    if not (loss.isfinite().item() and all(
            g is not None and g.isfinite().all() for g in grads.values())):
        raise AssertionError("sky fwd+bwd: non-finite loss or gradient")
    for leaf in ("sky.rgb.x", "atlas.rgb.x", "spheres.mat.emission_strength"):
        if not grads[leaf].abs().max().item() > 0.0:
            raise AssertionError(f"sky fwd+bwd: d loss / d {leaf} is all zero")
    print(f"  d loss / d every float leaf ({len(params)} leaves, the "
          f"{static['sky'].width}x{static['sky'].height} sky texels among "
          f"them): loss {loss.item():.6f}; max |d sky.rgb.x| "
          f"{grads['sky.rgb.x'].abs().max().item():.4e}, texels with a "
          f"gradient {int((grads['sky.rgb.x'] != 0).sum().item())}")
    res["mesh_bwd"] = dict(s=el, rate=rate, launches=got, idle=idle)
    del grads, params

    # 3 Adam steps towards a target with perturbed atlas, material and sky
    # colours, with the target's key
    tparams = {n: p.detach().clone() for n, p in partition_scene(scene)[0].items()}
    for c in "xyz":
        tparams[f"atlas.rgb.{c}"] = (tparams[f"atlas.rgb.{c}"] * 0.8).clamp(0, 1)
        tparams[f"mat_table.emission.{c}"] = tparams[f"mat_table.emission.{c}"] * 0.8
        tparams[f"sky.rgb.{c}"] = tparams[f"sky.rgb.{c}"] * 0.8
    scfg = tcfg.replace(spp=SKY_STEP_SPP)
    with torch.no_grad():
        tsums = render(combine_scene(tparams, static), cam, scfg, pids,
                       rng.prng_key(0))
        tgt = (tsums.radiance * (1.0 / scfg.spp)).to_array()
    del tparams
    init_fn, step_fn = make_train_step(scfg, 1e-2)
    state, st = init_fn(scene, cam)
    losses = []
    t0 = time.perf_counter()
    for _ in range(3):
        state, loss = step_fn(state, st, cam, pids, tgt, rng.prng_key(0))
        losses.append(loss.item())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    if not (all(math.isfinite(x) for x in losses)
            and losses[0] > losses[1] > losses[2]):
        raise AssertionError(f"sky train: losses do not fall: {losses}")
    print(f"sky train: 3 Adam steps (lr 1e-2, every float leaf and the sky "
          f"texels) at {scfg.width}x{scfg.height} spp={scfg.spp} towards a "
          "perturbed atlas/material/sky target: losses "
          + " ".join(f"{x:.6e}" for x in losses) + f"; {step_s:.4f} s per step")
    res["losses"] = losses
    del state

    scene, cam, cfg = _sky_scene(SCAN_WORLD, dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=SKY_SCAN_SPP,
                      max_bounces=6)
    el, rate, got, idle, sums = _frame(
        f"sky world {SCAN_WORLD} (scan path, K4)", dev, card, scene, cam, cfg,
        (0, 0, 0, cfg.spp * cfg.max_bounces, 0))
    lit("sky scan world", sums, cfg.spp)
    res["scan"] = dict(s=el, rate=rate, launches=got, idle=idle)
    return res


def phase_sky_routes(dev):
    """The scan path against K1 (the showcase) and K3 (the MESH_WORLD sky
    world) on the card at 64x48x2spp."""
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render

    print(f"sky scenes: scan path vs megakernel at 64x48x2spp (outlier: any "
          f"channel > {ATOL} + {RTOL}|x|; limit {OUTLIER_FRAC:.0%} of rays)")
    equal = True
    for name, key, bounces in (("sky showcase", "show", 4),
                               (f"sky world {MESH_WORLD}", MESH_WORLD, 6)):
        scene, cam, cfg = _sky_scene(key, dev)
        cfg = cfg.replace(width=64, height=48, spp=2, max_bounces=bounces)
        ids = torch.arange(cfg.n_pixels, device=dev)
        mk = _sums(render(scene, cam, cfg.replace(use_megakernel=True), ids,
                          rng.prng_key(5)))
        scan = _sums(render(scene, cam, cfg, ids, rng.prng_key(5)))
        _compare(f"{name} scan vs megakernel", mk, scan)
        same = torch.equal(mk, scan)
        equal &= same
        print(f"  {name}: scan path and megakernel bit-equal: {same}")
    return equal


def _grad_rows(name, got, want):
    """PERF.md §2's per-row rule on leaf gradients (dicts path -> tensor):
    each leaf within DSPH_REL of its largest |entry|, floored at ZERO_ROW
    of its table's largest (the leaves sharing a first path part); a leaf
    under that floor on both sides passes. Returns the worst error over
    that scale."""
    top = {}
    for path, w in want.items():
        t = path.split(".")[0]
        top[t] = max(top.get(t, 0.0), w.abs().max().item())
    worst = 0.0
    for path, w in want.items():
        g = got[path]
        if not (g.isfinite().all() and w.isfinite().all()):
            raise AssertionError(f"{name} {path}: non-finite gradient")
        floor = ZERO_ROW * top[path.split(".")[0]]
        scale = max(w.abs().max().item(), floor)
        if max(g.abs().max().item(), w.abs().max().item()) <= floor:
            continue
        err = (g - w).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, err)
        if err > DSPH_REL:
            raise AssertionError(f"{name} {path}: off by {err:.3e} of its row")
    return worst


def phase_scan_grads(dev):
    """ROADMAP P-F12: gradients of every float leaf through the scan path
    on the card against K1/K2 (Cornell, the sky showcase) and K3/K2 (the
    MESH_WORLD world, with and without the sky), and against the scan
    path on the CPU, at 64x48x2spp, by the per-row rule. The loss weighs
    only the pixels whose forward radiance agrees on both sides (card vs
    CPU: P-F1's flips), and their count is printed."""
    import numpy as np
    import torch

    from raytpu_torch.convert import scene_from_leaves, scene_leaves
    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render
    from raytpu_torch.scenes import cornell_box

    cases = [("cornell", cornell_box(dev), 6),
             ("sky showcase", _sky_scene("show", dev), 4),
             (f"block world {MESH_WORLD}",
              _per_triangle(_block_world(MESH_WORLD), dev), 6),
             (f"sky world {MESH_WORLD}", _sky_scene(MESH_WORLD, dev), 6)]
    print("P-F12: scan-path gradients at 64x48x2spp vs K1/K2 or K3/K2 on "
          f"the card and vs the scan path on the CPU (each leaf within "
          f"{DSPH_REL} of its largest |entry|, floored at {ZERO_ROW} of its "
          "table's)")
    res = {"worst": {}}
    for name, (scene, cam, cfg), bounces in cases:
        cfg = cfg.replace(width=64, height=48, spp=2, max_bounces=bounces,
                          sky_texture_grads=True)
        ids = np.arange(cfg.n_pixels)

        def grads(sc, c, target, mask, dev_):
            leaves = {p: v.detach().clone().requires_grad_()
                      for p, v in scene_leaves(sc).items()}
            s2 = scene_from_leaves(leaves, sc.triangles, sc.atlas,
                                   sc.mat_table, sc.sky_sphere_index, sc.sky)
            sums = render(s2, cam if dev_ != "cpu" else _on(cam, "cpu"), c,
                          ids, rng.prng_key(7))
            d = sums.radiance.to_array() / c.spp - target.to(dev_)
            (mask.to(dev_)[:, None] * d * d).sum().backward()
            return {p: (v.grad if v.grad is not None else
                        torch.zeros_like(v)).cpu() for p, v in leaves.items()}

        with torch.no_grad():
            mk = _sums(render(scene, cam, cfg.replace(use_megakernel=True), ids,
                              rng.prng_key(7))).cpu()
            scan = _sums(render(scene, cam, cfg, ids, rng.prng_key(7))).cpu()
            cpu_scene = _on(scene, "cpu")
            cpu = _sums(render(cpu_scene, _on(cam, "cpu"), cfg, ids,
                               rng.prng_key(7)))
        agree = lambda a, b: ~((a[:3] - b[:3]).abs()
                               > ATOL + RTOL * a[:3].abs()).any(0)
        mask = (agree(mk, scan) & agree(scan, cpu)).float()
        target = torch.full((cfg.n_pixels, 3), 0.2)
        g_scan = grads(scene, cfg, target, mask, dev)
        _reset_launches()
        g_mk = grads(scene, cfg.replace(use_megakernel=True), target, mask, dev)
        torch.cuda.synchronize()
        k1, k2, k3, *_ = _launches()
        want = ((2 * cfg.spp, cfg.spp, 0) if not scene.n_triangles
                else (0, cfg.spp, 2 * cfg.spp))
        if (k1, k2, k3) != want:
            raise AssertionError(f"{name}: megakernel gradient launches "
                                 f"(K1, K2, K3) {(k1, k2, k3)}, want {want}")
        if name == "sky showcase":
            res["launches"] = (k1, k2)
        g_cpu = grads(cpu_scene, cfg, target, mask, "cpu")
        w_cpu = _grad_rows(f"{name} scan card vs cpu", g_scan, g_cpu)
        note = ""
        if scene.sky_index >= 0:
            # the sky sphere's (black) diffuse: the scan path gives it the
            # gradient of every later sky event of a ray (zero in value,
            # since the throughput is 0 after the first), the slot, as
            # raytpu's, only the first's, which does not read it; a ray
            # meets the sky twice where it leaves the 1e5 dome and hits it
            # again by rounding (ROADMAP F7)
            i = scene.sky_index
            paths = [f"spheres.mat.diffuse.{c}" for c in "xyz"]
            top = max(g_scan[p].abs().max().item() for p in paths)
            sky_df = max(g_scan[p][i].abs().item() for p in paths)
            if any(g_mk[p][i].item() != 0.0 for p in paths):
                raise AssertionError(f"{name}: the slot gave the sky sphere's "
                                     "diffuse a gradient")
            g_scan = {p: v.clone() for p, v in g_scan.items()}
            for p in paths:
                g_scan[p][i] = 0.0
            note = (f"; the sky sphere's diffuse left out: scan path "
                    f"{sky_df / max(top, 1e-30):.3e} of its row, slot 0")
        w_mk = _grad_rows(f"{name} scan vs megakernel", g_scan, g_mk)
        print(f"  {name:22s} pixels weighed {int(mask.sum().item())} of "
              f"{cfg.n_pixels}; worst leaf error / row scale: scan vs "
              f"megakernel {w_mk:.3e}, card vs CPU {w_cpu:.3e} "
              f"({len(g_scan)} leaves){note}")
        res["worst"][name] = (w_mk, w_cpu)
    return res


def phase_sky_residue(dev):
    """P-F1 on the sky scenes: a 40x30x2spp frame of each on the card and
    on the CPU (the same route: K1, K3 or the scan path against its plain
    version): the share of pixels whose radiance differs, and, on the
    same rays and draws, the share of sky-slot texel indices that flip
    between the two runs and of slot directions that differ at all (the
    scattered directions' sin/cos, ``core/vec3.random_unit_vector``, and
    acos/atan2 round apart on the two sides). Bounded by OUTLIER_FRAC."""
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render
    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.kernels import trace_spheres as ts
    from raytpu_torch.core.vec3 import Vec3
    from raytpu_torch.materials.texture import sky_texel_index

    res = {}
    print(f"P-F1 on the sky scenes: card vs CPU (limit {OUTLIER_FRAC:.0%})")
    for name, key, bounces, mega in (("sky showcase (K1)", "show", 4, True),
                                     (f"sky world {MESH_WORLD} (K3)",
                                      MESH_WORLD, 6, True),
                                     (f"sky world {SCAN_WORLD} (scan)",
                                      SCAN_WORLD, 6, False)):
        scene, cam, cfg = _sky_scene(key, dev)
        cfg = cfg.replace(width=40, height=30, spp=2, max_bounces=bounces,
                          use_megakernel=mega)
        ids = torch.arange(cfg.n_pixels)
        cscene, ccam = _on(scene, "cpu"), _on(cam, "cpu")
        a = _sums(render(cscene, ccam, cfg, ids, rng.prng_key(3)))
        b = _sums(render(scene, cam, cfg, ids, rng.prng_key(3))).cpu()
        rad_frac = _outliers(a[:3], b[:3])[0]
        flips = dirs = float("nan")
        if mega:
            # the slot on the same rays and keys, card and CPU
            o, d, draws, keys = _kernel_inputs(scene, cam, cfg, 950, dev)
            if scene.n_triangles:
                k = tsc.MeshKnobs.for_scene(cfg, scene, draws.shape[1])
                run = lambda sc, rays, ks: tsc._forward(
                    tsc.pack_scene(sc, k), rays, ks, k)
            else:
                k = ts.Knobs.create(cfg, scene.spheres.count, draws.shape[1],
                                    scene.sky_index)
                run = lambda sc, rays, ks: ts._forward(ts.pack_spheres(sc),
                                                       rays, ks, k)
            card = run(scene, (*o, *d), keys).cpu()
            host = run(cscene, tuple(c.cpu() for c in (*o, *d)), keys.cpu())
            both = (card[9:12] != 0).any(0) & (host[9:12] != 0).any(0)
            w, h = scene.sky.width, scene.sky.height
            ic = sky_texel_index(Vec3(*card[12:15]), w, h)
            ih = sky_texel_index(Vec3(*host[12:15]), w, h)
            flips = (ic != ih)[both].float().mean().item()
            dirs = (card[12:15] != host[12:15]).any(0)[both].float().mean().item()
        slot = (f"slot texel indices that flip {flips:.5f}, slot directions "
                f"not bit-equal {dirs:.5f}" if mega else "no slot (scan path)")
        print(f"  {name:26s} pixels whose radiance differs {rad_frac:.5f}; "
              + slot)
        if rad_frac > OUTLIER_FRAC or flips > OUTLIER_FRAC:
            raise AssertionError(f"{name}: card vs CPU past {OUTLIER_FRAC:.0%}")
        res[name] = (rad_frac, flips, dirs)
    return res


def _merged_cases(dev):
    """The merged search's scenes, each loaded by default (merge_quads on):
    ``write_quad_fixture`` (also with AO), the 60-triangle world (also
    with AO), the MESH_WORLD and 2048-triangle worlds and the MESH_WORLD
    sky world."""
    from raytpu_torch.config import load_scene_file
    from raytpu_torch.scenes import write_quad_fixture

    fixture = load_scene_file(write_quad_fixture(
        os.path.join(OUT_DIR, "quad_fixture")), dev)
    small = load_scene_file(_block_world(60, seed=3), dev)
    ao = dict(max_bounces=4, use_ao=True, ao_samples=2)
    return [
        ("quad fixture 6b", fixture, dict(max_bounces=6)),
        ("quad fixture ao_samples=2", fixture, ao),
        ("block world 60 6b", small, dict(max_bounces=6)),
        ("block world 60 ao_samples=2", small, ao),
        (f"block world {MESH_WORLD} 6b",
         load_scene_file(_block_world(MESH_WORLD), dev), {}),
        ("block world 2048 6b", load_scene_file(_block_world(2048), dev), {}),
        (f"sky world {MESH_WORLD} 6b",
         load_scene_file(_sky_files()[MESH_WORLD], dev), {}),
    ]


def phase_merged_kernels(dev):
    """Phase 29: K3's merged modes (forward, recording, and the sky modes
    on the sky world) against the plain merged version at 64x48 rays:
    planes bit-equal; recording by phase 12's rule. Then the merged search
    against the per-triangle one on the card, the same rays: winners at
    bounce 0 and over all bounces, and radiance/albedo/normal outliers
    (tests/test_quad_merge.py's bars)."""
    import torch

    from raytpu_torch.kernels import trace_scene as tsc

    print("K3 merged-quad search vs its plain version at 64x48 rays (planes "
          f"bit-equal; recording: idx agree >= {IDX_AGREE:.0%}, planes equal "
          "to the launch without recording, AO factors where used); then "
          f"vs the per-triangle kernel (bounce-0 winners >= {AGREE0:.0%}, "
          f"all >= {AGREE_ALL:.0%}, outlier rays <= {OUTLIER_FRAC:.0%})")
    res = {}
    for i, (name, (scene, cam, cfg), over) in enumerate(_merged_cases(dev)):
        cfg = cfg.replace(width=64, height=48, **over)
        o, d, _, keys = _kernel_inputs(scene, cam, cfg, 1000 + i, dev)
        mt, rays, keys, flat, k = _mesh_inputs(scene, cfg, o, d, keys)
        if k.plan is None:
            raise AssertionError(f"{name}: the default load has no quad plan")
        ref = tsc.trace_scene_reference(mt, *rays, flat, k)
        out = tsc._launch(mt, rays, keys, k)
        if not torch.equal(ref, out):
            _compare(name, ref, out)
            raise AssertionError(f"{name}: merged planes differ from the "
                                 "plain version's bits")
        kern = tsc._launch(mt, rays, keys, k, record=True)
        _check_mesh_record(name, kern, tsc.trace_scene_reference(
            mt, *rays, flat, k, record=True), out)
        tk = tsc.MeshKnobs.for_scene(cfg.replace(merge_quads=False), scene,
                                     k.n_draws)
        tri, tri_idx, _ = tsc._launch(tsc.pack_scene(scene, tk), rays, keys,
                                      tk, record=True)
        a0 = (kern[1][0] == tri_idx[0]).float().mean().item()
        a_all = (kern[1] == tri_idx).float().mean().item()
        frac = max(_outliers(tri[sl], out[sl])[0] for _, sl in PLANES[:3])
        print(f"  {name:28s} merged vs per-triangle: winners agree "
              f"{a0:.5f} at bounce 0, {a_all:.5f} over all; outlier rays "
              f"{frac:.5f}; plan: {sum(g[2] + g[3] for g in k.aa_layout)} "
              f"aa rects, {sum(g[4] for g in k.aa_layout)} aa triangles, "
              f"{k.n_quads} quads, {k.n_leftover} leftovers")
        if a0 < AGREE0 or a_all < AGREE_ALL or frac > OUTLIER_FRAC:
            raise AssertionError(f"{name}: merged vs per-triangle past the "
                                 "agreement bars")
        res[name] = dict(agree0=a0, agree=a_all, outliers=frac)
    print("  merged planes bit-equal to the plain version on every scene")
    return res


def phase_merged_timing(dev):
    """Phase 30: K3's merged modes at the frames' shape (one sample at 1200x900,
    6 bounces, real RNG draws): forward and recording on the MESH_WORLD
    world, the sky modes on its sky twin; each compared with its plain
    version, then both timed in turns beside the bound of this run's
    counted work."""
    import numpy as np
    import torch

    from raytpu_torch.config import load_scene_file
    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import blocked_pixel_order, sample_rays
    from raytpu_torch.kernels import trace_scene as tsc

    res = {}
    for key, path in (("world", _block_world(MESH_WORLD)),
                      ("sky", _sky_files()[MESH_WORLD])):
        scene, cam, cfg = load_scene_file(path, dev)
        cfg = cfg.replace(width=FRAME[0], height=FRAME[1], max_bounces=6)
        pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
        keys, cam_d = rng.sample_stream(rng.prng_key(0, device=dev), pids, 0,
                                        4)
        origin, direction = sample_rays(cam, cfg, pids, cam_d)
        mt, rays, keys, flat, k = _mesh_inputs(scene, cfg, origin, direction,
                                               keys)
        sky = key == "sky"
        counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
        ref = tsc.trace_scene_reference(mt, *rays, flat, k, counts)
        out = tsc._launch(mt, rays, keys, k)
        if not torch.equal(ref, out):
            raise AssertionError(f"merged {key} at {cfg.width}x{cfg.height}:"
                                 " planes differ from the plain version's")
        rec = tsc._launch(mt, rays, keys, k, record=True)
        # the dynamic shared memory each launch set, as the driver holds it
        smem = {r: tsc.func_attrs(r, sky)["dynamic_smem"]
                for r in (False, True)}
        print(f"  merged K3 {key}: {smem[False]} / {smem[True]} B of dynamic "
              "shared memory a block (forward / recording)")
        _, rec_err = _check_mesh_record(
            f"merged {key} {cfg.width}x{cfg.height}", rec,
            tsc.trace_scene_reference(mt, *rays, flat, k, record=True), out)
        del ref, out, rec
        fns = {"fwd": lambda: tsc._launch(mt, rays, keys, k),
               "fwd_plain": lambda: tsc.trace_scene_reference(mt, *rays, flat, k),
               "rec": lambda: tsc._launch(mt, rays, keys, k, record=True),
               "rec_plain": lambda: tsc.trace_scene_reference(
                   mt, *rays, flat, k, record=True)}
        t = {w: [] for w in fns}
        for w in ("fwd_plain", "fwd", "fwd", "fwd_plain", "rec_plain", "rec",
                  "rec", "rec_plain"):
            t[w].append(_time_ms(fns[w], 2 if w.endswith("plain") else 20))
        ms = {w: float(np.mean(v)) for w, v in t.items()}
        b = cfg.n_pixels
        bound = _k3_bound(b, cfg.max_bounces, counts, mt.nbytes(), sky)
        rec_bound = _k3_bound(b, cfg.max_bounces, counts,
                              mt.nbytes() + 4 * b * cfg.max_bounces, sky)
        live = counts["live"]
        print(f"  merged K3 {key}: forward {ms['fwd']:.4f} ms (plain "
              f"{ms['fwd_plain']:.4f}; bound {bound[0]:.4f} ms, {bound[1]}), "
              f"recording {ms['rec']:.4f} ms (plain {ms['rec_plain']:.4f}; "
              f"bound {rec_bound[0]:.4f} ms); turns {t}; per live (ray, "
              f"bounce) of {live}: "
              + ", ".join(f"{counts.get(c, 0) / live:.2f} {c}" for c in (
                  "sphere", "aa_rect", "aa_tri", "aa_head", "aa_slab",
                  "quad", "left", "slab"))
              + f" (aa: the walk's tests, of {k.n_tris} triangles); box "
              f"tests {_box_share(counts, _k3_ops(counts)):.1%} of the "
              "bound's operations")
        res[key] = dict(ms=ms["fwd"], plain_ms=ms["fwd_plain"], bound=bound,
                        rec_ms=ms["rec"], rec_plain_ms=ms["rec_plain"],
                        rec_bound=rec_bound, rec_err=rec_err, counts=counts,
                        smem=smem)
        del mt, rays, flat, keys
    return res


def phase_merged_frames(dev, card):
    """Phase 31: the mesh frames of phases 11, 15 and 25 through the default
    (merged) load: the MESH_WORLD world and its sky twin at 1200x900, 6
    bounces, forward at MESH_SPP, forward+backward of every float leaf
    (and the sky texels) at MESH_TRAIN_SPP, and 3 Adam steps at
    MESH_STEP_SPP towards perturbed atlas, material (and sky) colours,
    whose losses must fall."""
    import torch

    from raytpu_torch.config import load_scene_file
    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render
    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.train import (combine_scene, make_train_step,
                                    partition_scene, photometric_loss)

    res = {}
    for key, path in (("world", _block_world(MESH_WORLD)),
                      ("sky", _sky_files()[MESH_WORLD])):
        scene, cam, cfg = load_scene_file(path, dev)
        if tsc.quad_plan(cfg, scene.triangles.count) is None:
            raise AssertionError(f"merged {key}: no quad plan by default")
        sky = key == "sky"
        cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=MESH_SPP,
                          max_bounces=6, use_megakernel=True,
                          sky_texture_grads=sky)
        what = f"merged {'sky world' if sky else 'block world'} {MESH_WORLD}"
        el, rate, got, idle, sums = _frame(f"{what} (K3)", dev, card, scene,
                                           cam, cfg, (0, 0, cfg.spp, 0, 0))
        mean = sums.radiance.to_array().double().mean().item() / cfg.spp
        if not (all(v.to_array().isfinite().all() for v in sums[:3])
                and mean > 0.0):
            raise AssertionError(f"{what}: non-finite or unlit ({mean})")
        r = dict(fwd=dict(s=el, rate=rate, launches=got, idle=idle))

        tcfg = cfg.replace(spp=MESH_TRAIN_SPP)
        pids = torch.arange(cfg.n_pixels, device=dev)
        params, static = partition_scene(scene)
        params = {n: p.detach().clone().requires_grad_()
                  for n, p in params.items()}
        target = torch.zeros((cfg.n_pixels, 3), device=dev)

        def fwd_bwd(c):
            for p in params.values():
                p.grad = None
            s_ = render(combine_scene(params, static), cam, c, pids,
                        rng.prng_key(0))
            loss = photometric_loss(s_.radiance * (1.0 / c.spp), target)
            loss.backward()
            return loss

        el, rate, got, idle, loss = _frame(
            f"{what} fwd+bwd (K3 recording, K2)", dev, card, scene, cam, tcfg,
            (0, tcfg.spp, 2 * tcfg.spp, 0, 0), fwd_bwd)
        leaves = ["atlas.rgb.x", "mat_table.emission_strength"]
        leaves += ["sky.rgb.x"] if sky else ["spheres.mat.emission.x"]
        if not (loss.isfinite().item() and all(
                p.grad is not None and p.grad.isfinite().all()
                for p in params.values())):
            raise AssertionError(f"{what} fwd+bwd: non-finite loss or grad")
        for leaf in leaves:
            if not params[leaf].grad.abs().max().item() > 0.0:
                raise AssertionError(f"{what}: d loss / d {leaf} is all zero")
        r["bwd"] = dict(s=el, rate=rate, launches=got, idle=idle)
        del params

        tparams = {n: p.detach().clone()
                   for n, p in partition_scene(scene)[0].items()}
        for c in "xyz":
            for leaf in ("atlas.rgb", "mat_table.emission") + (
                    ("sky.rgb",) if sky else ()):
                tparams[f"{leaf}.{c}"] = tparams[f"{leaf}.{c}"] * 0.8
            tparams[f"atlas.rgb.{c}"] = tparams[f"atlas.rgb.{c}"].clamp(0, 1)
        scfg = cfg.replace(spp=MESH_STEP_SPP)
        with torch.no_grad():
            tsums = render(combine_scene(tparams, static), cam, scfg, pids,
                           rng.prng_key(0))
            tgt = (tsums.radiance * (1.0 / scfg.spp)).to_array()
        del tparams
        init_fn, step_fn = make_train_step(scfg, 1e-2)
        state, st = init_fn(scene, cam)
        losses = []
        t0 = time.perf_counter()
        for _ in range(3):
            state, loss = step_fn(state, st, cam, pids, tgt, rng.prng_key(0))
            losses.append(loss.item())
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 3
        if not (all(math.isfinite(x) for x in losses)
                and losses[0] > losses[1] > losses[2]):
            raise AssertionError(f"{what} train: losses do not fall: {losses}")
        print(f"{what} train: 3 Adam steps (lr 1e-2) at {scfg.width}x"
              f"{scfg.height} spp={scfg.spp}: losses "
              + " ".join(f"{x:.6e}" for x in losses)
              + f"; {step_s:.4f} s per step")
        r["losses"] = losses
        res[key] = r
        del state
    return res


def _k5_rays(sph, rays, flat, keys, k, g):
    """K1's recording and the plain version's on the same rays, and g with
    zero cotangent on the rays whose winners or used AO factors differ
    between the two: K5 and its plain version each run their own search,
    and a flipped grazing hit or probe (phase 6 allows up to OUTLIER_FRAC)
    sends a ray elsewhere. Returns (idx, aof, masked g, fraction kept)."""
    from raytpu_torch.kernels import trace_spheres as ts

    _, idx, aof = ts._launch(sph, rays, keys, k, record=True)
    _, p_idx, p_aof = ts.trace_spheres_reference(sph, *rays, flat, k,
                                                 record=True)
    same = (idx == p_idx).all(0)
    if aof is not None:
        same &= ((aof == p_aof) | (idx < 0)).all(0)
    kept = same.float().mean().item()
    if kept < IDX_AGREE:
        raise AssertionError(f"K5: K1's and the plain version's recordings "
                             f"agree on {kept:.2%} of the rays")
    return idx, aof, g * same, kept


def _k5_cases(dev):
    """Phase 7's six sphere scenes and the sky showcase."""
    return (_record_cases(dev)
            + [("refraction stack 19b", _stack_scene(dev), {}),
               ("sky showcase 4b", _sky_scene("show", dev), {})])


def phase_k5(dev):
    """Phase 32: K5 against its plain version (autograd through K1's plain
    version) and against K2 on K1's recording, at 64x48 rays with a random
    output cotangent, by K2's rule (_compare_grads); two K5 launches
    bit-identical, and K5 bit-equal to K2 (the same search, draws, reverse
    step and table sums)."""
    import numpy as np
    import torch

    from raytpu_torch.kernels import trace_scene_bwd as tb
    from raytpu_torch.kernels import trace_spheres as ts

    print(f"K5 (AD sphere backward) vs its plain version (autograd) and vs "
          f"K2 at 64x48 rays (ray outlier: any > {G_ATOL} + {G_RTOL}|x|, "
          f"limit {OUTLIER_FRAC:.0%}; d_sph rows within {DSPH_REL} x row max)")
    res = {"max_abs_err": 0.0, "outlier_frac": 0.0, "k2_bits": []}
    for i, (name, (scene, cam, cfg), over) in enumerate(_k5_cases(dev)):
        cfg = cfg.replace(width=64, height=48, **over)
        o, d, draws, keys = _kernel_inputs(scene, cam, cfg, 1100 + i, dev)
        sph = ts.pack_spheres(scene)
        k = ts.Knobs.create(cfg, scene.spheres.count, draws.shape[1],
                            scene.sky_index)
        flat = draws.reshape(-1, draws.shape[-1])
        rays = (*o, *d)
        g = torch.tensor(np.random.default_rng(1200 + i).uniform(
            -1, 1, (tb.g_planes(k), cfg.n_pixels)).astype(np.float32),
            device=dev)
        idx, aof, g, kept = _k5_rays(sph, rays, flat, keys, k, g)
        got = ts._launch_ad(sph, rays, keys, g, k)
        again = ts._launch_ad(sph, rays, keys, g, k)
        if not _same_grads(got, again):
            raise AssertionError(f"{name}: two K5 launches differ")
        print(f"  {name}: rays with the same recording on both sides "
              f"{kept:.5f}")
        err, frac = _compare_grads(f"{name} K5 vs plain", ts.ad_reference(
            sph, rays, flat, g, k), got)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["outlier_frac"] = max(res["outlier_frac"], frac)
        k2 = _sphere_kernel(sph, rays, keys, idx, aof, g, k)
        _compare_grads(f"{name} K5 vs K2", k2, got)
        if not _same_grads(k2, got):
            raise AssertionError(f"{name}: K5 is not bit-equal to K2 on K1's "
                                 "recording")
        res["k2_bits"].append(True)
    print(f"  two K5 launches bit-identical on every scene; K5 bit-equal to "
          f"K2 on K1's recording on all {len(res['k2_bits'])} scenes")
    return res


def phase_k5_timing(dev, card, k2, ptxas):
    """Phase 33: K5 at the main path's shape (the Cornell 1200x900, 6-bounce
    sample of phase 7's timing) beside its plain version, K2 and its
    bound, with K5's and K2's sphere-mode ptxas summaries (their shared
    table sum, replay.cuh); then the Cornell fwd+bwd frame with
    RAYTPU_SPH_BWD=ad (K5 launches == spp, no K2)."""
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render
    from raytpu_torch.kernels import trace_spheres as ts
    from raytpu_torch.scenes import cornell_box
    from raytpu_torch.train import (combine_scene, partition_scene,
                                    photometric_loss)

    scene, cam, cfg = cornell_box(dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], max_bounces=6)
    origin, direction, keys, draws, _ = _frame_sample(cam, cfg, dev, 4)
    sph = ts.pack_spheres(scene)
    k = ts.Knobs.create(cfg, scene.spheres.count, draws.shape[1])
    flat = draws.reshape(-1, draws.shape[-1])
    rays = (*origin, *direction)
    g = torch.tensor(np.random.default_rng(7).uniform(
        -1, 1, (9, cfg.n_pixels)).astype(np.float32), device=dev)
    name = f"cornell {cfg.width}x{cfg.height} 6b"
    print(f"K5 at the main path's shape ({cfg.width}x{cfg.height} rays, 6 "
          "bounces):")
    idx, aof, g, kept = _k5_rays(sph, rays, flat, keys, k, g)
    print(f"  rays with the same recording on both sides {kept:.5f}")
    got = ts._launch_ad(sph, rays, keys, g, k)
    max_err, frac = _compare_grads(f"{name} K5 vs plain", ts.ad_reference(
        sph, rays, flat, g, k), got)
    k2_got = _sphere_kernel(sph, rays, keys, idx, aof, g, k)
    _compare_grads(f"{name} K5 vs K2", k2_got, got)
    if not _same_grads(k2_got, got):
        raise AssertionError(f"{name}: K5 is not bit-equal to K2")
    del got, k2_got
    fns = {"k5": lambda: ts._launch_ad(sph, rays, keys, g, k),
           "plain": lambda: ts.ad_reference(sph, rays, flat, g, k),
           "k2": lambda: _sphere_kernel(sph, rays, keys, idx, aof, g, k)}
    t = {w: [] for w in fns}
    for w in ("plain", "k5", "k2", "k2", "k5", "plain"):
        t[w].append(_time_ms(fns[w], 2 if w == "plain" else 20))
    ms = {w: float(np.mean(v)) for w, v in t.items()}
    bound = k5_bound(k2)
    print(f"  K5 {ms['k5']:.4f} ms (plain {ms['plain']:.4f} ms; bound "
          f"{bound[0]:.4f} ms, {bound[1]}); K2 on K1's recording "
          f"{ms['k2']:.4f} ms; turns {t}; K5 bit-equal to K2")
    k5_ptxas = {sky: _ptxas_of(ptxas, f"spheres_ad_kernel<{sky}>",
                               f"17spheres_ad_kernelILb{int(sky == 'true')}E")
                for sky in ("false", "true")}
    k2_ptxas = {sky: _ptxas_of(ptxas, f"sphere_backward_kernel<{sky}>",
                               f"22sphere_backward_kernelILb"
                               f"{int(sky == 'true')}E")
                for sky in ("false", "true")}
    print(f"  ptxas (without / with the sky slot): K5 {k5_ptxas}; K2 sphere "
          f"mode {k2_ptxas}")
    del fns, idx, aof

    cfg = cfg.replace(spp=TRAIN_SPP, use_megakernel=True)
    pids = torch.arange(cfg.n_pixels, device=dev)
    params, static = partition_scene(scene)
    params = {n: p.detach().clone().requires_grad_() for n, p in params.items()}
    target = torch.zeros((cfg.n_pixels, 3), device=dev)

    def fwd_bwd(c):
        for p in params.values():
            p.grad = None
        sums = render(combine_scene(params, static), cam, c, pids,
                      rng.prng_key(0))
        loss = photometric_loss(sums.radiance * (1.0 / c.spp), target)
        loss.backward()
        return loss

    prev = os.environ.get("RAYTPU_SPH_BWD")
    os.environ["RAYTPU_SPH_BWD"] = "ad"
    try:
        el, rate, got, idle, loss = _frame(
            "cornell fwd+bwd with RAYTPU_SPH_BWD=ad (K1 recording, K5)", dev,
            card, scene, cam, cfg, (2 * cfg.spp, 0, 0, 0, cfg.spp), fwd_bwd)
    finally:
        if prev is None:
            del os.environ["RAYTPU_SPH_BWD"]
        else:
            os.environ["RAYTPU_SPH_BWD"] = prev
    if not (loss.isfinite().item() and all(
            p.grad.isfinite().all() for p in params.values())):
        raise AssertionError("cornell fwd+bwd (K5): non-finite")
    if not params["spheres.mat.diffuse.x"].grad.abs().max().item() > 0.0:
        raise AssertionError("cornell fwd+bwd (K5): d loss / d diffuse is 0")
    return dict(ms=ms["k5"], plain_ms=ms["plain"], k2_ms=ms["k2"],
                bound=bound, max_abs_err=max_err, outlier_frac=frac,
                ptxas=k5_ptxas, k2_ptxas=k2_ptxas,
                frame=dict(s=el, rate=rate, launches=got, idle=idle))


def _resume_check(what, scene, cam, cfg, first, flush):
    """A checkpointed render of ``first`` of ``cfg.spp`` samples in flushes
    of ``flush``, its sidecar rewritten as the ``cfg.spp`` run's (as
    tests/test_checkpoint.py does), resumed to ``cfg.spp``: its sums
    bit-equal to ``render_image``'s (spp a power of two, so means equal
    bit for bit only where sums do), its launches (K1, K2, K3, K4, K5) and
    sample starts one a sample in each run. Returns the walls (s) of both
    runs and of the straight frame, the launches and the sums."""
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render_image
    from raytpu_torch.io import checkpoint as ck

    path = os.path.join(OUT_DIR, f"ckpt_{what.replace(' ', '_')}.npz")
    for f in (path, path + ".json"):
        if os.path.exists(f):
            os.remove(f)
    key = rng.prng_key(0)
    walls, launches = [], []
    for run_cfg in (cfg.replace(spp=first), cfg):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.render_image_checkpointed(scene, cam, run_cfg, key, path,
                                     flush_every=flush)
        walls.append(time.perf_counter() - t0)
        launches.append(_launches())
        _check_rng(f"checkpointed {what}", first if run_cfg.spp == first
                   else cfg.spp - first, rows=0)
        if run_cfg.spp == first:
            rad, alb, nrm, done = ck.load_checkpoint(path, run_cfg, 0)
            if done != first:
                raise AssertionError(f"{what}: {done} samples checkpointed, "
                                     f"want {first}")
            ck.save_checkpoint(path, rad, alb, nrm, done, cfg, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    straight = render_image(scene, cam, cfg, key)
    walls.append(time.perf_counter() - t0)
    rad, alb, nrm, done = ck.load_checkpoint(path, cfg, 0)
    n_diff = sum(int((a != np.asarray(b)[::-1].reshape(-1, 3) * cfg.spp)
                     .sum()) for a, b in ((rad, straight.image),
                                          (alb, straight.albedo),
                                          (nrm, straight.normal)))
    if done != cfg.spp or n_diff:
        raise AssertionError(f"checkpointed {what}: {n_diff} sums differ "
                             f"from render_image's ({done} samples)")
    if not (np.isfinite(rad).all() and rad.mean() > 0):
        raise AssertionError(f"checkpointed {what}: non-finite or unlit")
    return walls, launches, (rad, alb, nrm), straight


def phase_outputs(dev, card):
    """Phase 35, the render command's output path on the card: the
    checkpointed Cornell frame (K1) and merged block world (K3), resumed
    bit-equal to ``render_image``, with the time of a flush (one host copy
    of the frame's sums, ``save_checkpoint``); both denoisers on the
    Cornell frame on the card against the same call on the CPU, timed,
    with the bilateral's kernel count; their quality on a rendered pair;
    ``cli render`` with every output flag as a subprocess."""
    import numpy as np
    import torch

    from raytpu_torch.config import load_scene_file
    from raytpu_torch.core import rng
    from raytpu_torch.denoise import denoise, learned
    from raytpu_torch.denoise.quality import render_pair, score_denoisers
    from raytpu_torch.io import checkpoint as ck
    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.scenes import cornell_box

    os.makedirs(OUT_DIR, exist_ok=True)
    res = {}
    scene, cam, cfg = cornell_box(dev)
    n_pix = FRAME[0] * FRAME[1]
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=MAIN_SPP,
                      max_bounces=6, use_megakernel=True, pixel_tile=n_pix)
    walls, launches, sums, frame = _resume_check(
        "cornell", scene, cam, cfg, OUT_SPP, OUT_FLUSH)
    if launches != [(OUT_SPP, 0, 0, 0, 0), (cfg.spp - OUT_SPP, 0, 0, 0, 0)]:
        raise AssertionError(f"checkpointed cornell: launches {launches}")
    # one flush: the frame's sums from the card in one copy, then the npz
    planes = torch.from_numpy(np.concatenate(sums, 1).T.copy()).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = planes.cpu().numpy()
    copy_s = time.perf_counter() - t0
    path = os.path.join(OUT_DIR, "ckpt_flush.npz")
    t0 = time.perf_counter()
    ck.save_checkpoint(path, host[0:3].T, host[3:6].T, host[6:9].T,
                       cfg.spp, cfg, 0)
    save_s = time.perf_counter() - t0
    res["flush"] = dict(copy_s=copy_s, save_s=save_s,
                        bytes=host.nbytes, npz_bytes=os.path.getsize(path))
    res["cornell"] = dict(walls=walls, launches=launches)
    print(f"outputs: checkpointed cornell {cfg.width}x{cfg.height} "
          f"{cfg.max_bounces}b (K1): {OUT_SPP} spp in flushes of {OUT_FLUSH} "
          f"{walls[0]:.4f} s, resumed to {cfg.spp} {walls[1]:.4f} s, "
          f"render_image at {cfg.spp} spp {walls[2]:.4f} s; sums bit-equal; "
          f"launches {launches} on {card}")
    print(f"  one flush: host copy of the sums ({host.nbytes} B) "
          f"{copy_s:.4f} s + save_checkpoint (npz {res['flush']['npz_bytes']}"
          f" B) {save_s:.4f} s = {copy_s + save_s:.4f} s")

    wscene, wcam, wcfg = load_scene_file(_block_world(MESH_WORLD), dev)
    if tsc.quad_plan(wcfg, wscene.triangles.count) is None:
        raise AssertionError("checkpointed block world: no quad plan")
    wcfg = wcfg.replace(width=FRAME[0], height=FRAME[1], spp=MESH_OUT_SPP,
                        max_bounces=6, use_megakernel=True, pixel_tile=n_pix)
    wwalls, wlaunches, _, _ = _resume_check(
        "block world", wscene, wcam, wcfg, OUT_MESH, OUT_MESH_FLUSH)
    if wlaunches != [(0, 0, OUT_MESH, 0, 0),
                     (0, 0, wcfg.spp - OUT_MESH, 0, 0)]:
        raise AssertionError(f"checkpointed block world: launches {wlaunches}")
    res["block_world"] = dict(walls=wwalls, launches=wlaunches)
    print(f"outputs: checkpointed merged block world {MESH_WORLD} (K3): "
          f"{OUT_MESH} spp in flushes of {OUT_MESH_FLUSH} {wwalls[0]:.4f} s, "
          f"resumed to {wcfg.spp} {wwalls[1]:.4f} s, render_image "
          f"{wwalls[2]:.4f} s; sums bit-equal; launches {wlaunches}")

    # the denoisers on the Cornell frame: the card against the CPU. The
    # KPCN runs on weights loaded once a device (the load timed apart);
    # "kpcn_load" is the default call, which loads the shipped weights
    # each time
    host_in = [torch.from_numpy(np.ascontiguousarray(a))
               for a in (frame.image, frame.albedo, frame.normal)]
    dev_in = [a.to(dev) for a in host_in]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kpcn = learned.load_params(device=dev)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    kpcn_host = learned.load_params(device="cpu")
    calls = {"bilateral": (denoise, denoise),
             "kpcn": (lambda *a: learned.denoise_learned(*a, params=kpcn),
                      lambda *a: learned.denoise_learned(*a,
                                                         params=kpcn_host)),
             "kpcn_load": (learned.denoise_learned, learned.denoise_learned)}
    with torch.no_grad():
        for name, (fn, host_fn) in calls.items():
            got = fn(*dev_in)
            if not (got.is_cuda and got.shape == dev_in[0].shape):
                raise AssertionError(f"{name}: output on {got.device}")
            want = host_fn(*host_in)    # the KPCN's stays for TF32's reading
            diff = (got.cpu() - want).abs()
            over = diff - (DN_TOL + DN_TOL * want.abs() if name == "bilateral"
                           else KPCN_ATOL)
            res[name] = dict(max_abs_err=diff.max().item(),
                             wall_ms=_device_ms(lambda: fn(*dev_in), 5),
                             events_ms=_time_ms(lambda: fn(*dev_in), 5))
            if not (got.isfinite().all() and over.max().item() <= 0.0):
                raise AssertionError(f"{name} on the card vs the CPU: max "
                                     f"|diff| {res[name]['max_abs_err']}")
        # the TF32 trap, measured: the KPCN with cuDNN's default TF32
        keep = learned.fp32_convs
        learned.fp32_convs = lambda _: torch.backends.cudnn.flags(
            enabled=True, allow_tf32=True)
        try:
            tf32 = learned.denoise_learned(*dev_in, params=kpcn)
        finally:
            learned.fp32_convs = keep
        res["kpcn"]["tf32_max_abs_err"] = (tf32.cpu() - want).abs().max().item()
        res["kpcn"]["load_ms"] = load_ms
        for name, (fn, _) in calls.items():
            wall, busy, n_k, _ = _profile(lambda: fn(*dev_in))
            res[name].update(kernels=n_k, profiled_busy_ms=busy,
                             profiled_wall_ms=wall)
    for name in calls:
        r = res[name]
        print(f"outputs: {name} denoise {FRAME[0]}x{FRAME[1]} on {card}: "
              f"wall {r['wall_ms']:.4f} ms a call (CUDA events behind a spin "
              f"kernel, which the launches outrun), {r['events_ms']:.4f} ms "
              f"(events alone), {r['kernels']} kernels a call (profiler: "
              f"device busy {r['profiled_busy_ms']:.3f} ms of "
              f"{r['profiled_wall_ms']:.3f} ms wall); card vs CPU max |diff| "
              f"{r['max_abs_err']:.3e}"
              + (f" (TF32 on: {r['tf32_max_abs_err']:.3e}); weights loaded "
                 f"once, the load {r['load_ms']:.4f} ms"
                 if name == "kpcn" else "")
              + ("; the shipped weights loaded in every call"
                 if name == "kpcn_load" else ""))

    qcfg = cfg.replace(width=QUALITY_SIZE[0], height=QUALITY_SIZE[1],
                       max_bounces=4, pixel_tile=QUALITY_SIZE[0] *
                       QUALITY_SIZE[1])
    lo, hi = render_pair(scene, cam, qcfg, rng.prng_key(3), *QUALITY_SPP)
    scores = score_denoisers(lo, hi, {"bilateral": denoise,
                                      "learned": calls["kpcn"][0]},
                             device=dev)
    res["quality"] = scores
    print(f"outputs: quality on a {QUALITY_SPP} spp Cornell pair at "
          f"{QUALITY_SIZE[0]}x{QUALITY_SIZE[1]}, 4 bounces (PSNR dB, SSIM): "
          + "; ".join(f"{k} {v['psnr']:.4f} {v['ssim']:.5f}"
                      for k, v in scores.items()))
    if not (scores["learned"]["psnr"] >= scores["bilateral"]["psnr"]
            + KPCN_MARGIN_DB and scores["bilateral"]["psnr"]
            >= scores["noisy"]["psnr"] + BILATERAL_GAIN_DB):
        raise AssertionError(f"denoiser quality bars missed: {scores}")

    res["cli"] = _cli_outputs()
    return res


def _cli_outputs():
    """``python -m raytpu_torch.cli render cornell`` at 320x240, 8 spp with
    every output flag: it must exit 0 and write the image, both AOVs, an
    8-sample checkpoint, the preview and a trace, with every progress line
    on stderr a JSON object. Returns its wall seconds."""
    import shutil

    import numpy as np

    from raytpu_torch.io.ppm import read_ppm

    d = os.path.join(OUT_DIR, "cli")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    p = lambda name: os.path.join(d, name)
    cmd = [sys.executable, "-m", "raytpu_torch.cli", "render", "cornell",
           "--width", "320", "--height", "240", "--spp", "8",
           "--denoise", "learned", "--aov", "--checkpoint", p("ck.npz"),
           "--flush-every", "4", "--log-json", "--preview", p("prev.ppm"),
           "--profile-dir", p("prof"), "--out", p("cornell.ppm")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"cli render: exit {res.returncode}\n"
                             f"{res.stderr[-4000:]}")
    for name in ("cornell.ppm", "cornell_albedo.ppm", "cornell_normal.ppm",
                 "prev.ppm"):
        img = read_ppm(p(name))
        if img.shape != (240, 320, 3):
            raise AssertionError(f"cli render: {name} is {img.shape}")
    if int(np.load(p("ck.npz"))["samples_done"]) != 8:
        raise AssertionError("cli render: the checkpoint is not at 8 samples")
    traces = os.listdir(p("prof"))
    if len(traces) != 1 or not json.load(open(os.path.join(
            p("prof"), traces[0])))["traceEvents"]:
        raise AssertionError(f"cli render: trace files {traces}")
    lines = res.stderr.splitlines()
    progress = [json.loads(ln) for ln in lines if ln.startswith("{")]
    if ([r["samples"] for r in progress] != [4, 8]
            or any(ln.startswith("[render]") for ln in lines)):
        raise AssertionError(f"cli render: progress lines {lines}")
    print(f"outputs: cli render cornell 320x240 8 spp --denoise learned --aov "
          f"--checkpoint --flush-every 4 --log-json --preview --profile-dir: "
          f"exit 0 in {wall:.2f} s (process start and the kernels' load "
          f"included); image, AOVs, 8-sample checkpoint, preview and trace "
          f"({os.path.getsize(os.path.join(p('prof'), traces[0]))} B) "
          f"written; {len(progress)} JSON progress lines")
    return wall


def phase_formats(dev, card):
    """Phase 36: the mesh importers. The MESH_WORLD block world's mesh
    written as binary PLY with UVs, GLB and binary STL, each with an OBJ
    twin of the arrays it parses to (``scenes.write_mesh_twins``); each
    scene loaded through its TOML on the card and rendered at 1200x900,
    FMT_SPP spp, 6 bounces through merged K3 (one launch a sample, no
    other kernel of K1-K5), its frame bit-equal to its twin's. The native
    loaders must have built here; the parse times of each format and of
    the SCAN_WORLD world's OBJ, native against Python (arrays equal)."""
    import numpy as np
    import torch

    from raytpu_torch import native
    from raytpu_torch.config import load_scene_file
    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render_image
    from raytpu_torch.io.mesh_formats import parse_mesh
    from raytpu_torch.io.obj import parse_obj
    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.scenes import write_mesh_twins

    if native.load() is None:
        raise AssertionError("formats: the native loaders did not build")
    big = os.path.join(os.path.dirname(_block_world(SCAN_WORLD)),
                       "block_world.obj")
    parse = {}
    for what, use in (("native", True), ("python", False)):
        t0 = time.perf_counter()
        mesh = parse_obj(big, use_native=use)
        parse[what] = (time.perf_counter() - t0, mesh)
    a, b = parse["native"][1], parse["python"][1]
    if not (a.mat_names == b.mat_names and all(
            np.array_equal(getattr(a, f), getattr(b, f))
            for f in a._fields if f != "mat_names")):
        raise AssertionError("formats: native and Python OBJ parses differ")
    res = {"obj_native_s": parse["native"][0],
           "obj_python_s": parse["python"][0], "formats": {}}
    print(f"formats: the native loaders built ({native._SO}); OBJ of the "
          f"{SCAN_WORLD}-triangle world parsed natively in "
          f"{res['obj_native_s'] * 1e3:.3f} ms, by the Python parser in "
          f"{res['obj_python_s'] * 1e3:.3f} ms; arrays equal")

    toml = _block_world(MESH_WORLD)
    twins = write_mesh_twins(toml)
    base = os.path.dirname(toml)
    n_pix = FRAME[0] * FRAME[1]
    for fmt, specs in twins.items():
        t0 = time.perf_counter()
        mesh = parse_mesh(os.path.join(base, f"block_world_{fmt}.{fmt}"))
        parse_s = time.perf_counter() - t0
        frames, launches = [], []
        for spec in specs:
            scene, cam, cfg = load_scene_file(spec, dev)
            cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=FMT_SPP,
                              max_bounces=6, use_megakernel=True,
                              pixel_tile=n_pix)
            if tsc.quad_plan(cfg, scene.triangles.count) is None:
                raise AssertionError(f"formats {spec}: no quad plan")
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames.append(render_image(scene, cam, cfg, rng.prng_key(0)))
            wall = time.perf_counter() - t0
            launches.append(_launches())
        if launches != [(0, 0, FMT_SPP, 0, 0)] * 2:
            raise AssertionError(f"formats {fmt}: launches {launches}")
        got, want = frames
        if not (all(np.array_equal(getattr(got, f), getattr(want, f))
                    for f in got._fields)
                and np.isfinite(got.image).all() and got.image.mean() > 0):
            raise AssertionError(f"formats {fmt}: the frame differs from "
                                 "its OBJ twin's, or is unlit")
        res["formats"][fmt] = dict(parse_s=parse_s, wall_s=wall,
                                   triangles=len(mesh.face_v),
                                   materials=len(mesh.mat_names))
        print(f"formats: {fmt} ({len(mesh.face_v)} triangles, "
              f"{len(mesh.mat_names)} materials) parsed in "
              f"{parse_s * 1e3:.3f} ms; {FRAME[0]}x{FRAME[1]} {FMT_SPP} spp "
              f"6b through merged K3 ({launches[0][2]} launches) "
              f"{wall:.4f} s on {card}, bit-equal to its OBJ twin's frame")
    return res


def _canvas_rule(what, got, want):
    """Canvases of one frame: within 1 on every pixel and equal on at
    least CANVAS_EQUAL of them. Returns (max diff, equal share)."""
    import numpy as np

    diff = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    same = (diff == 0).all(-1).mean()
    if diff.max() > 1 or same < CANVAS_EQUAL:
        raise AssertionError(f"{what}: canvas max diff {diff.max()}, equal "
                             f"on {same:.6f} of pixels")
    return int(diff.max()), float(same)


def phase_sharded(dev, card):
    """Phase 37: the Cornell frame (1200x900, SHARD_SPP spp, 6 bounces,
    K1) through ``sharding.render_image_sharded`` on the grids
    SHARD_GRIDS of ``cuda:0`` against ``render_image``: radiance within
    SHARD_REL (relative), the canvas rule, and in every cell one K1 launch
    a sample of its share (``render`` wrapped to count each cell's
    launches). Returns the straight frame and each grid's wall."""
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import render_image
    from raytpu_torch.kernels import trace_spheres as ts
    from raytpu_torch.scenes import cornell_box
    from raytpu_torch.sharding import make_mesh, mesh as smesh
    from raytpu_torch.sharding import render_image_sharded

    scene, cam, cfg = cornell_box(dev)
    n_pix = FRAME[0] * FRAME[1]
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=SHARD_SPP,
                      max_bounces=6, use_megakernel=True, pixel_tile=n_pix)
    key = rng.prng_key(0)
    render_image(scene, cam, cfg.replace(spp=1), key)      # warm up
    walls = []
    for _ in range(SHARD_RUNS):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        straight = render_image(scene, cam, cfg, key)
        walls.append(time.perf_counter() - t0)
        if _launches() != (cfg.spp, 0, 0, 0, 0):
            raise AssertionError(f"sharded: straight launches {_launches()}")
    res = {"straight_s": walls, "grids": {}}
    cells = []
    plain_render = smesh.render

    def counted(scene, cam, cfg, ids, key, **kw):
        before = ts.launches
        out = plain_render(scene, cam, cfg, ids, key, **kw)
        cells.append((scene.device, kw["sample_offset"], len(ids),
                      ts.launches - before))
        return out

    smesh.render = counted
    try:
        for grid in SHARD_GRIDS:
            mesh = make_mesh(*grid, devices=[dev] * (grid[0] * grid[1]))
            walls = []
            for _ in range(SHARD_RUNS):
                cells.clear()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = render_image_sharded(scene, cam, cfg, key, mesh)
                walls.append(time.perf_counter() - t0)
            spp_local = cfg.spp // grid[1]
            if (len(cells) != grid[0] * grid[1]
                    or any(c[3] != spp_local for c in cells)
                    or _launches() != (cfg.spp * grid[0], 0, 0, 0, 0)):
                raise AssertionError(f"sharded {grid}: cells {cells}, "
                                     f"launches {_launches()}")
            x, y = straight.image, out.image
            rel = float((np.abs(x - y) / np.maximum(np.abs(x), 1e-30)).max())
            if not (np.isfinite(y).all() and (np.abs(x - y)
                                              <= SHARD_REL * np.abs(x)).all()):
                raise AssertionError(f"sharded {grid}: radiance off by {rel} "
                                     "relative")
            canvas = _canvas_rule(f"sharded {grid}", out.canvas,
                                  straight.canvas)
            res["grids"][grid] = dict(wall_s=walls, max_rel=rel,
                                      canvas=canvas,
                                      cell_launches=[c[3] for c in cells])
            fmt = lambda w: ", ".join(f"{t:.4f}" for t in w)
            print(f"sharded: grid {grid} of {dev} {FRAME[0]}x{FRAME[1]} "
                  f"{cfg.spp} spp 6b: {fmt(walls)} s (render_image "
                  f"{fmt(res['straight_s'])} s) on {card}; K1 launches a "
                  f"cell {[c[3] for c in cells]}; radiance max rel. diff "
                  f"{rel:.3e}; canvas max diff {canvas[0]}, equal on "
                  f"{canvas[1]:.6f}")
    finally:
        smesh.render = plain_render
    res["straight"] = straight
    return res


# one rank of phase 38: the CLI's main with the all-reduces timed and the
# rank's K1 launches and wall printed as the last line of its stdout
_RANK = """
import json, sys, time
t0 = time.perf_counter()
import torch.distributed as dist
from raytpu_torch import cli
from raytpu_torch.kernels import trace_spheres as ts
reduces, plain = [], dist.all_reduce
def timed(t, *a, **k):
    t1 = time.perf_counter()
    out = plain(t, *a, **k)
    reduces.append((time.perf_counter() - t1, t.numel() * t.element_size()))
    return out
dist.all_reduce = timed
t1 = time.perf_counter()
rc = cli.main(sys.argv[1:])
print(json.dumps({"k1": ts.launches, "reduces": reduces,
                  "imports_s": t1 - t0, "main_s": time.perf_counter() - t1}))
raise SystemExit(rc)
"""

# a gloo all-reduce of one 1200x900 frame's sums between two CPU processes
_GLOO = """
import json, os, sys, time, torch, torch.distributed as dist
dist.init_process_group("gloo", init_method="tcp://" + sys.argv[1],
                        world_size=2, rank=int(sys.argv[2]))
x = torch.zeros((9, int(sys.argv[3])), dtype=torch.float32)
times = []
for _ in range(6):
    dist.barrier()
    t0 = time.perf_counter()
    dist.all_reduce(x)
    times.append(time.perf_counter() - t0)
dist.destroy_process_group()
print(json.dumps(times[1:]))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(argv_of, env_of, timeout):
    """Two processes (rank 0, 1), started together; (returncodes, stdout,
    stderr, walls). Both are killed if either outlives ``timeout``."""
    procs, t0 = [], time.perf_counter()
    for r in range(2):
        procs.append(subprocess.Popen(argv_of(r), cwd=ROOT, env=env_of(r),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs, walls = [], []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
            walls.append(time.perf_counter() - t0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ([p.returncode for p in procs], [o[0] for o in outs],
            [o[1] for o in outs], walls)


def phase_two_process(card, straight):
    """Phase 38: ``python -m raytpu_torch.cli render cornell --sharded``
    (the CLI's main, through a wrapper that reads its counts) as two
    processes sharing ``cuda:0``, ranks of a gloo group on a free
    localhost port: rank 0's PPM against phase 37's straight frame by the
    canvas rule, SHARD_SPP / 2 K1 launches a rank; the walls of each
    process, with the CLI's render apart; then a gloo all-reduce of one
    frame's sums (1,080,000 x 9 f32 = 38.9 MB) between two CPU processes,
    after a barrier, 5 times."""
    import numpy as np

    from raytpu_torch.io.ppm import read_ppm

    out = os.path.join(OUT_DIR, "chip_smoke_cornell_two_process.ppm")
    if os.path.exists(out):
        os.remove(out)
    port = _free_port()
    argv = [sys.executable, "-c", _RANK, "render", "cornell", "--sharded",
            "--width", str(FRAME[0]), "--height", str(FRAME[1]), "--spp",
            str(SHARD_SPP), "--bounces", "6", "--out", out]
    env = lambda r: dict(os.environ, PYTHONPATH=ROOT,
                         RAYTPU_COORDINATOR=f"127.0.0.1:{port}",
                         RAYTPU_NUM_PROCESSES="2", RAYTPU_PROCESS_ID=str(r))
    rcs, stdout, stderr, walls = _pair(lambda r: argv, env, 600)
    if rcs != [0, 0]:
        raise AssertionError(f"two processes: exit codes {rcs}\n"
                             + "\n----\n".join(e[-3000:] for e in stderr))
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in stdout]
    # rank 0's render, from the CLI's line (rank 1 prints none)
    line = [ln for ln in stderr[0].splitlines() if ln.startswith("rendered")]
    render_s = float(line[0].split(" in ")[1].split("s ")[0])
    if [r["k1"] for r in ranks] != [SHARD_SPP // 2] * 2:
        raise AssertionError(f"two processes: K1 launches "
                             f"{[r['k1'] for r in ranks]}, want "
                             f"{SHARD_SPP // 2} a rank")
    canvas = np.rint(read_ppm(out, bottom_up=False) * 255).astype(np.int64)
    rule = _canvas_rule("two processes", canvas, straight.canvas)
    n_pix = FRAME[0] * FRAME[1]
    gport = _free_port()
    grcs, gout, gerr, _ = _pair(
        lambda r: [sys.executable, "-c", _GLOO, f"127.0.0.1:{gport}", str(r),
                   str(n_pix)],
        lambda r: dict(os.environ, CUDA_VISIBLE_DEVICES=""), 300)
    if grcs != [0, 0]:
        raise AssertionError(f"gloo all-reduce: exit codes {grcs}\n"
                             + "\n----\n".join(e[-2000:] for e in gerr))
    gloo = [json.loads(o.strip().splitlines()[-1]) for o in gout]
    res = dict(walls=walls, imports_s=[r["imports_s"] for r in ranks],
               main_s=[r["main_s"] for r in ranks], render_s=render_s,
               canvas=rule, k1=[r["k1"] for r in ranks],
               in_render_reduces=[r["reduces"] for r in ranks],
               gloo_s=gloo, gloo_bytes=9 * 4 * n_pix)
    print(f"two processes: cli render cornell --sharded {FRAME[0]}x{FRAME[1]}"
          f" {SHARD_SPP} spp 6b, ranks 0 and 1 on cuda:0 ({card}): process "
          f"walls {walls[0]:.3f} / {walls[1]:.3f} s, of which the start "
          f"(interpreter and imports) {res['imports_s'][0]:.3f} / "
          f"{res['imports_s'][1]:.3f} s and the CLI's main "
          f"{res['main_s'][0]:.3f} / {res['main_s'][1]:.3f} s (group join, "
          f"scene, kernels' load, render, all-reduce, rank 0's write); rank "
          f"0's render {render_s:.3f} s; K1 launches {res['k1']}; in-render "
          f"all-reduce (s, B) {res['in_render_reduces']}; canvas max diff "
          f"{rule[0]}, equal on {rule[1]:.6f}")
    print(f"  gloo all-reduce of {res['gloo_bytes']} B between two CPU "
          f"processes, after a barrier (s): rank 0 "
          f"{[round(t, 4) for t in gloo[0]]}, rank 1 "
          f"{[round(t, 4) for t in gloo[1]]}")
    return res


def phase_deep_grad(dev, card):
    """Phase 39, ROADMAP P-F14: one Adam step (``make_train_step``'s, the
    frame's loss and gradient summed over tiles of DEEP_TILE pixels) at
    DEEP_BOUNCES bounces, 1200x900, DEEP_SPP spp on Cornell and the
    MESH_WORLD world (merged load), with ``use_megakernel`` on: the render
    goes through the scan path (the log says so once), launches no K1-K3
    and, on the world (>= 128 triangles), K4 twice a bounce of a sample;
    its loss, gradients and stepped parameters finite and bit-equal to the
    same step with ``use_megakernel`` off (``--no-megakernel``)."""
    import contextlib
    import io

    import torch

    from raytpu_torch.config import load_scene_file
    from raytpu_torch.core import rng
    from raytpu_torch.integrator import hit
    from raytpu_torch.integrator.render import render
    from raytpu_torch.scenes import cornell_box
    from raytpu_torch.train import (combine_scene, make_train_step,
                                    photometric_loss)

    res = {}
    for name, (scene, cam, cfg) in (
            ("cornell", cornell_box(dev)),
            ("block world", load_scene_file(_block_world(MESH_WORLD), dev))):
        cfg = cfg.replace(width=FRAME[0], height=FRAME[1], spp=DEEP_SPP,
                          max_bounces=DEEP_BOUNCES)
        n_pix = cfg.n_pixels
        target = torch.zeros((n_pix, 3), device=dev)
        runs = {}
        for mk in (True, False):
            run_cfg = cfg.replace(use_megakernel=mk)
            init_fn, _ = make_train_step(run_cfg, 1e-2)
            state, static = init_fn(scene, cam)
            hit._logged.clear()
            log = io.StringIO()
            _reset_launches()
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = torch.zeros((), device=dev)
            with contextlib.redirect_stderr(log):
                for lo in range(0, n_pix, DEEP_TILE):
                    ids = torch.arange(lo, min(lo + DEEP_TILE, n_pix),
                                       device=dev)
                    sums = render(combine_scene(state.params, static), cam,
                                  run_cfg, ids, rng.prng_key(0))
                    part = photometric_loss(sums.radiance * (1.0 / cfg.spp),
                                            target[ids]) * (len(ids) / n_pix)
                    part.backward()
                    loss = loss + part.detach()
            grads = {k: (torch.zeros_like(p) if p.grad is None
                         else p.grad.clone()) for k, p in state.params.items()}
            for p in state.params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            state.optimizer.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[mk] = dict(loss=loss, grads=grads, wall=wall,
                            params={k: p.detach().clone()
                                    for k, p in state.params.items()},
                            launches=_launches(), log=log.getvalue(),
                            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        on, off = runs[True], runs[False]
        n_tiles = -(-n_pix // DEEP_TILE)
        k4 = 2 * cfg.spp * cfg.max_bounces * n_tiles if name != "cornell" else 0
        if on["log"].count("scan path") != 1 or "scan path" in off["log"]:
            raise AssertionError(f"deep grad {name}: log {on['log']!r} / "
                                 f"{off['log']!r}")
        for r in (on, off):
            if r["launches"] != (0, 0, 0, k4, 0):
                raise AssertionError(f"deep grad {name}: launches "
                                     f"{r['launches']}, want K4 {k4} only")
        finite = on["loss"].isfinite().item() and all(
            g.isfinite().all().item() for g in on["grads"].values())
        same = (torch.equal(on["loss"], off["loss"]) and all(
            torch.equal(on[f][k], off[f][k]) for f in ("grads", "params")
            for k in on["grads"]))
        lit = sum(g.abs().max().item() > 0 for g in on["grads"].values()
                  if g.numel())
        if not (finite and same and lit >= 5):
            raise AssertionError(f"deep grad {name}: finite {finite}, "
                                 f"bit-equal to --no-megakernel {same}, "
                                 f"{lit} leaves with gradient")
        res[name] = dict(wall_s=[on["wall"], off["wall"]], k4=on["launches"][3],
                         peak_gb=on["peak_gb"], leaves=len(on["grads"]),
                         lit=lit, loss=on["loss"].item())
        print(f"deep grad (P-F14): {name} {FRAME[0]}x{FRAME[1]} {cfg.spp} spp "
              f"{cfg.max_bounces}b, one Adam step over {n_tiles} tiles, "
              f"use_megakernel on / off: {on['wall']:.3f} / {off['wall']:.3f} s "
              f"on {card}; routed to the scan path (logged once); K4 "
              f"launches {on['launches'][3]}; loss {on['loss'].item():.6f}; "
              f"{len(on['grads'])} leaves ({lit} with gradient), finite, "
              f"gradients and stepped leaves bit-equal to --no-megakernel; "
              f"peak memory {on['peak_gb']:.2f} GB")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from raytpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = _card()
    nvcc = _run([_build.nvcc_path(), "--version"]).splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {nvcc}")
    print(f"card: {card}")

    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    print(f"build: {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    ptxas = _ptxas_summary({p.stem: _build.ptxas_report(p.stem)
                            for p in sorted(_build.CSRC.glob("*.cu"))})
    print("ptxas (registers, stack B, spill stores B, static shared memory "
          "B; dynamic shared memory at the timed shapes in phases 17 and "
          "30):")
    for name, v in ptxas.items():
        print(f"  {name}: {v['registers']} registers, {v['stack']} B stack, "
              f"{v['spill_stores']} B spill stores, {v['static_smem']} B "
              "static shared memory")

    rng_t = phase_rng(dev)
    start_t = phase_sample_start(dev)
    phase_k1(dev)
    timing = phase_k1_timing(dev)
    (launches, render_k2, render_k3, render_k4, render_rng,
     main_prof, pf1) = phase_main(dev, card, timing)
    phase_k1_record(dev)
    phase_k2(dev)
    k2 = phase_k2_timing(dev)
    train = phase_train(dev, card)
    phase_k3(dev)
    k3 = phase_k3_timing(dev)
    mesh = phase_mesh(dev, card, k3)
    phase_k3_record(dev)
    phase_k2_mesh(dev)
    mbwd = phase_mesh_bwd_timing(dev)
    mtrain = phase_mesh_train(dev, card)
    phase_k4(dev)
    k4 = phase_k4_timing(dev)
    phase_scan_checks(dev)
    scan = phase_scan_frame(dev, card, mesh)
    strain = phase_scan_train(dev, card)
    seg = phase_segment_sum(dev, strain)
    sky_k = phase_sky_kernels(dev)
    sky_tex = phase_sky_texels(dev)
    sky_t = phase_sky_timing(dev)
    sky_f = phase_sky_frames(dev, card)
    sky_routes = phase_sky_routes(dev)
    sgrads = phase_scan_grads(dev)
    residue = phase_sky_residue(dev)
    merged_k = phase_merged_kernels(dev)
    merged_t = phase_merged_timing(dev)
    merged_f = phase_merged_frames(dev, card)
    k5_k = phase_k5(dev)
    k5 = phase_k5_timing(dev, card, k2, ptxas)
    cam_g = phase_camera_grad(dev, card)
    phase_outputs(dev, card)
    fmt = phase_formats(dev, card)
    shard = phase_sharded(dev, card)
    two = phase_two_process(card, shard["straight"])
    deep = phase_deep_grad(dev, card)

    k1_bound = _k1_bound(k2["n_rays"], k2["bounces"], timing["counts"],
                         k2["n_spheres"], record=False)
    print("Cornell frames without eager threefry (device busy ms by "
          "bucket): fwd " + json.dumps({k: round(v, 4) for k, v in
                                        main_prof[3].items() if v})
          + "; fwd+bwd " + json.dumps({k: round(v, 4) for k, v in
                                       train["profile"][3].items() if v}))
    print(f"sky: forward planes bit-equal to the plain versions "
          f"{sky_k['bit_equal']}, scan path = megakernel {sky_routes}; "
          f"texel flips card vs CPU {sky_tex['direction_flips']:.6f}; "
          f"P-F12 worst rows {sgrads['worst']}; P-F1 residue {residue}")
    print("merged K3 vs per-triangle (winners at bounce 0, all, outliers): "
          + "; ".join(f"{n} {r['agree0']:.5f} {r['agree']:.5f} "
                      f"{r['outliers']:.5f}" for n, r in merged_k.items()))
    print("merged frames (fwd, fwd+bwd rays/s; Adam losses): " + "; ".join(
        f"{key} {r['fwd']['rate']:.1f} {r['bwd']['rate']:.1f} {r['losses']}"
        for key, r in merged_f.items())
          + f"; K5 Cornell fwd+bwd {k5['frame']['rate']:.1f} rays/s")
    print("last modules: parse ms " + json.dumps(
        {f: round(r["parse_s"] * 1e3, 3) for f, r in fmt["formats"].items()})
          + f", OBJ {SCAN_WORLD} native / Python "
          f"{fmt['obj_native_s'] * 1e3:.3f} / {fmt['obj_python_s'] * 1e3:.3f}"
          f"; sharded (1, 2) / straight min wall "
          f"{min(shard['grids'][(1, 2)]['wall_s']):.4f} / "
          f"{min(shard['straight_s']):.4f} s; two processes' walls "
          f"{[round(w, 3) for w in two['walls']]} s; gloo all-reduce of "
          f"{two['gloo_bytes']} B min {min(min(g) for g in two['gloo_s']):.4f}"
          f" s; P-F14 steps (on, off) " + json.dumps(
              {n: [round(w, 3) for w in r["wall_s"]] for n, r in deep.items()}))
    print(card)
    print(json.dumps({"kernels": [{
        "name": "sample_start (RNG kernel)", "route": "cuda",
        "source": "raytpu_torch/csrc/rng.cu", "replaces": None,
        "launches": render_rng,
        "launches_by_path": {"render": render_rng,
                             "fwd_bwd": train["rng_launches"],
                             "train_camera_steps": 6 * TRAIN_SPP},
        "max_abs_err": 0.0, "ms": start_t[4]["ms"],
        "plain_ms": start_t[4]["plain_ms"], "bound_ms": start_t[4]["bound"][0],
        "bound_by": start_t[4]["bound"][1], "library_ms": None,
        "events_ms": start_t[4]["events_ms"],
        "ms_scan_22_rows": start_t[22]["ms"],
        "events_ms_scan_22_rows": start_t[22]["events_ms"],
        "plain_ms_scan_22_rows": start_t[22]["plain_ms"],
        "bound_ms_scan_22_rows": start_t[22]["bound"][0],
        "draws_only": {f"{r}_rows": {
            "ms": rng_t[r]["ms"], "events_ms": rng_t[r]["events_ms"],
            "plain_ms": rng_t[r]["plain_ms"], "bound_ms": rng_t[r]["bound"][0]}
            for r in (4, 22)},
        "camera_grad_max_rel": cam_g["max_rel"], "p_f1_words": pf1,
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("rng:")},
    }, {
        "name": "trace_spheres", "route": "cuda",
        "source": "raytpu_torch/csrc/trace_spheres.cu",
        "replaces": "raytpu/kernels/trace_spheres.py:421",
        "launches": train["k1_launches"],
        "launches_by_path": {"render": launches, "fwd_bwd": train["k1_launches"],
                             "mesh_render": mesh["k1"],
                             "mesh_fwd_bwd": mtrain["k1"],
                             "scan_render": scan[SCAN_WORLD]["k1"],
                             "scan_fwd_bwd": strain["k1"],
                             "sharded_render_cells": {
                                 "x".join(map(str, g)): r["cell_launches"]
                                 for g, r in shard["grids"].items()},
                             "two_process_ranks": two["k1"]},
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None,
        "ms_record": k2["record_ms"], "bound_ms_record": k2["record_bound"][0],
        "outlier_frac": timing["outlier_frac"],
    }, {
        "name": "trace_scene_bwd", "route": "cuda",
        "source": "raytpu_torch/csrc/trace_scene_bwd.cu",
        "replaces": "raytpu/kernels/trace_scene_bwd.py:641",
        "launches": train["k2_launches"],
        "launches_by_path": {"render": render_k2,
                             "fwd_bwd": train["k2_launches"],
                             "mesh_render": mesh["k2"],
                             "mesh_fwd_bwd": mtrain["k2"],
                             "scan_render": scan[SCAN_WORLD]["k2"],
                             "scan_fwd_bwd": strain["k2"]},
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound"][0], "bound_by": k2["bound"][1],
        "library_ms": None, "outlier_frac": k2["outlier_frac"],
        "ptxas": k5["k2_ptxas"]["false"],
    }, {
        "name": "trace_scene", "route": "cuda",
        "source": "raytpu_torch/csrc/trace_scene.cu",
        "replaces": "raytpu/kernels/trace_scene.py:431",
        "launches": mesh["k3"],
        "launches_by_path": {"render": render_k3,
                             "fwd_bwd": train["k3_launches"],
                             "mesh_render": mesh["k3"],
                             "mesh_fwd_bwd": mtrain["k3"],
                             "scan_render": scan[SCAN_WORLD]["k3"],
                             "scan_fwd_bwd": strain["k3"]},
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound"][0], "bound_by": k3["bound"][1],
        "library_ms": None, "outlier_frac": k3["outlier_frac"],
        "issued_over_needed": k3["issued_over_needed"],
        "ptxas": _ptxas_of(ptxas, "trace_scene_kernel<false, false>",
                           "18trace_scene_kernelILb0ELb0E"),
        "dynamic_smem_bytes": k3["smem"],
    }, {
        "name": "segment_sum", "route": "cuda",
        "source": "raytpu_torch/csrc/segment_sum.cu", "replaces": None,
        "launches": strain["segment_sum"],
        "max_abs_err": seg["largest"]["max_abs_err"],
        "ms": seg["largest"]["ms"], "plain_ms": seg["largest"]["plain_ms"],
        "bound_ms": seg["largest"]["bound"][0],
        "bound_by": seg["largest"]["bound"][1],
        "library_ms": seg["largest"]["library_ms"],
        "shape": seg["largest"]["shape"],
        "max_rel_err": seg["largest"]["max_rel_err"],
        "events_ms": seg["largest"]["events_ms"],
        **{f"{key}_{what.replace(' ', '_')}": (
            r[field][0] if field == "bound" else r[field])
           for what, r in seg.items() if what != "largest"
           for key, field in (("ms", "ms"), ("plain_ms", "plain_ms"),
                              ("library_ms", "library_ms"),
                              ("bound_ms", "bound"),
                              ("max_rel_err", "max_rel_err"),
                              ("shape", "shape"),
                              ("heavy_rows", "heavy_rows"))},
        "ptxas": {k: v for k, v in ptxas.items()
                  if k.startswith("segment_sum:")},
    }, {
        "name": "index_sort", "route": "cuda",
        "source": "raytpu_torch/csrc/index_sort.cu", "replaces": None,
        "launches": strain["index_sort"], "max_abs_err": 0.0,
        "ms": seg["largest"]["plan_ms"],
        "plain_ms": seg["largest"]["plan_plain_ms"],
        "bound_ms": seg["largest"]["plan_bound"][0],
        "bound_by": seg["largest"]["plan_bound"][1],
        "library_ms": seg["largest"]["plan_library_ms"],
        "passes": seg["largest"]["passes"],
        "events_ms": seg["largest"]["plan_events_ms"],
        **{f"{key}_{what.replace(' ', '_')}": (
            r[field][0] if field == "plan_bound" else r[field])
           for what, r in seg.items() if what != "largest"
           for key, field in (("ms", "plan_ms"), ("plain_ms", "plan_plain_ms"),
                              ("library_ms", "plan_library_ms"),
                              ("bound_ms", "plan_bound"),
                              ("passes", "passes"))},
        "ptxas": {k: v for k, v in ptxas.items()
                  if k.startswith("index_sort:")},
    }, {
        "name": "trace_scene (recording mode)", "route": "cuda",
        "source": "raytpu_torch/csrc/trace_scene.cu",
        "replaces": "raytpu/kernels/trace_scene.py:431",
        "launches": mtrain["k3"],
        "max_abs_err": mbwd["record_err"],
        "idx_agree": mbwd["record_agree"],
        "ms": mbwd["record_ms"], "plain_ms": mbwd["record_plain_ms"],
        "bound_ms": mbwd["record_bound"][0],
        "bound_by": mbwd["record_bound"][1], "library_ms": None,
    }, {
        "name": "trace_scene_bwd (mesh mode)", "route": "cuda",
        "source": "raytpu_torch/csrc/trace_scene_bwd.cu",
        "replaces": "raytpu/kernels/trace_scene_bwd.py:641",
        "launches": mtrain["k2"],
        "max_abs_err": mbwd["max_abs_err"],
        "ms": mbwd["ms"], "plain_ms": mbwd["plain_ms"],
        "bound_ms": mbwd["bound"][0], "bound_by": mbwd["bound"][1],
        "library_ms": None, "outlier_frac": mbwd["outlier_frac"],
        "two_launches_bit_identical": True,
        "ptxas": _ptxas_of(ptxas, " backward_kernel<false>",
                           "15backward_kernelILb0E"),
        "dynamic_smem_bytes": mbwd["smem"],
    }, {
        "name": "intersect", "route": "cuda",
        "source": "raytpu_torch/csrc/intersect.cu",
        "replaces": "raytpu/kernels/intersect.py:56",
        "launches": scan[SCAN_WORLD]["k4"],
        "launches_by_path": {"render": render_k4,
                             "fwd_bwd": train["k4_launches"],
                             "mesh_render": mesh["k4"],
                             "mesh_fwd_bwd": mtrain["k4"],
                             "scan_render": scan[SCAN_WORLD]["k4"],
                             "scan_render_600": scan[MESH_WORLD]["k4"],
                             "scan_fwd_bwd": strain["k4"],
                             "deep_grad_world": deep["block world"]["k4"],
                             "deep_grad_cornell": deep["cornell"]["k4"]},
        "max_abs_err": max(r["max_abs_err"] for w in k4.values()
                           for r in w.values()),
        "ms": k4[SCAN_WORLD]["camera"]["ms"],
        "plain_ms": k4[SCAN_WORLD]["camera"]["plain_ms"],
        "bound_ms": k4[SCAN_WORLD]["camera"]["bound"][0],
        "bound_by": k4[SCAN_WORLD]["camera"]["bound"][1], "library_ms": None,
        "ptxas": _ptxas_of(ptxas, "intersect_kernel"),
        "dynamic_smem_bytes": k4[SCAN_WORLD]["camera"]["smem"],
        **{f"{key}_{n}_{what.replace(' ', '')}": (
            r[field][0] if field == "bound" else r[field])
           for n, w in k4.items() for what, r in w.items()
           for key, field in (("ms", "ms"), ("plain_ms", "plain_ms"),
                              ("bound_ms", "bound"))},
    }, *({
        "name": name, "route": "cuda", "source": f"raytpu_torch/csrc/{src}.cu",
        "replaces": rep, "launches": launches,
        "max_abs_err": sky_t[key]["max_abs_err"], "ms": sky_t[key]["ms"],
        "plain_ms": sky_t[key]["plain_ms"], "bound_ms": sky_t[key]["bound"][0],
        "bound_by": sky_t[key]["bound"][1], "library_ms": None,
        **({"ptxas": _ptxas_of(ptxas, " backward_kernel<true>",
                               "15backward_kernelILb1E"),
            "dynamic_smem_bytes": sky_t[key]["smem"]} if key == "k2_mesh"
           else {}),
    } for name, src, rep, key, launches in (
        ("trace_spheres (sky)", "trace_spheres",
         "raytpu/kernels/trace_spheres.py:421", "k1",
         sky_f["show"]["launches"][0]),
        ("trace_spheres (sky, recording)", "trace_spheres",
         "raytpu/kernels/trace_spheres.py:421", "k1_rec",
         sgrads["launches"][0]),
        ("trace_scene_bwd (sky, sphere mode)", "trace_scene_bwd",
         "raytpu/kernels/trace_scene_bwd.py:641", "k2_sphere",
         sgrads["launches"][1]),
        ("trace_scene (sky)", "trace_scene",
         "raytpu/kernels/trace_scene.py:431", "k3",
         sky_f["mesh"]["launches"][2]),
        ("trace_scene (sky, recording)", "trace_scene",
         "raytpu/kernels/trace_scene.py:431", "k3_rec",
         sky_f["mesh_bwd"]["launches"][2]),
        ("trace_scene_bwd (sky, mesh mode)", "trace_scene_bwd",
         "raytpu/kernels/trace_scene_bwd.py:641", "k2_mesh",
         sky_f["mesh_bwd"]["launches"][1]))), *({
        "name": name, "route": "cuda",
        "source": "raytpu_torch/csrc/trace_scene.cu",
        "replaces": "raytpu/kernels/trace_scene.py:431", "launches": launches,
        "max_abs_err": err, "ms": r[ms], "plain_ms": r[plain],
        "bound_ms": r[bound][0], "bound_by": r[bound][1], "library_ms": None,
        "ptxas": _ptxas_of(
            ptxas, f"trace_scene_kernel_merged<{str(ms == 'rec_ms').lower()}, "
            f"{str(r is merged_t['sky']).lower()}>",
            f"trace_scene_kernel_mergedILb{int(ms == 'rec_ms')}"
            f"ELb{int(r is merged_t['sky'])}E"),
        "dynamic_smem_bytes": r["smem"][ms == "rec_ms"],
        **({"launches_by_path": {"formats_render": {
            f: FMT_SPP for f in fmt["formats"]}}}
           if name == "trace_scene (merged)" else {}),
    } for name, r, ms, plain, bound, err, launches in (
        ("trace_scene (merged)", merged_t["world"], "ms", "plain_ms", "bound",
         0.0, merged_f["world"]["fwd"]["launches"][2]),
        ("trace_scene (merged, recording)", merged_t["world"], "rec_ms",
         "rec_plain_ms", "rec_bound", merged_t["world"]["rec_err"],
         merged_f["world"]["bwd"]["launches"][2]),
        ("trace_scene (merged, sky)", merged_t["sky"], "ms", "plain_ms",
         "bound", 0.0, merged_f["sky"]["fwd"]["launches"][2]),
        ("trace_scene (merged, sky, recording)", merged_t["sky"], "rec_ms",
         "rec_plain_ms", "rec_bound", merged_t["sky"]["rec_err"],
         merged_f["sky"]["bwd"]["launches"][2]))), {
        "name": "trace_spheres_bwd (K5)", "route": "cuda",
        "source": "raytpu_torch/csrc/trace_spheres_bwd.cu",
        "replaces": "raytpu/kernels/trace_spheres.py:460",
        "launches": k5["frame"]["launches"][4],
        "launches_by_path": {"fwd_bwd": train["k5_launches"],
                             "fwd_bwd_sph_bwd_ad": k5["frame"]["launches"][4]},
        "max_abs_err": max(k5["max_abs_err"], k5_k["max_abs_err"]),
        "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound"][0], "bound_by": k5["bound"][1],
        "library_ms": None, "outlier_frac": max(k5["outlier_frac"],
                                                k5_k["outlier_frac"]),
        "k2_ms": k5["k2_ms"], "ptxas": k5["ptxas"]["false"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
