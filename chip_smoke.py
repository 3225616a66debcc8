#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``raytpu_torch``) on one CUDA card.

    python3 chip_smoke.py          (from the repository root)

Phases, each of which raises on failure (exit code non-zero):
  1. environment: torch, nvcc and the card (nvidia-smi name, power limit);
  2. build every CUDA source of the port from this checkout;
  3. RNG parity: the eager threefry stream and the RNG kernel
     (``csrc/rng.cu``: each ray's key and its draw rows, one launch a
     sample) on the card reproduce a table of ``jax.random`` values
     (computed with JAX 0.9.0, pasted below); the kernel bit-equal to the
     eager stream (its plain version) over the full frame's keys for
     every row layout (RNG_ROWS); both timed;
  4. the sphere megakernel (K1), which takes each ray's key and hashes its
     draws, bit-equal to its plain PyTorch version (on the keys' draws)
     on the card, on five scenes at 64x48 rays, then at the main path's
     shape (1200x900 rays, 6 bounces), timed;
  5. the forward path: a 1200x900, 6-bounce Cornell frame through
     ``render`` over all block-ordered pixel ids, checked finite and lit,
     with one K1 and one RNG kernel launch per sample and no eager
     threefry in the profile; a small frame on the card against the same
     frame on the CPU; the PPM through ``render_image``/``write_ppm``;
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
     (``torch.profiler``: RNG kernel launches == 2 x spp, no eager
     threefry), then 3 Adam steps of ``train.make_train_step`` towards a
     target the port renders with perturbed colours;
  9. the mesh megakernel (K3) against its plain PyTorch version at 64x48
     rays on six scenes: block worlds written by
     ``scenes.write_block_world`` (60 triangles with water, the same with
     AO, the same untextured; 600 triangles; 2048, K3's limit) and the
     4-triangle cutout / window / emissive scene;
  10. K3 against its plain version at the main path's shape (the
     600-triangle world, 1200x900 rays, 6 bounces, real RNG draws), both
     timed, the plain version counting the search work for the bound;
  11. the mesh forward path: the 600-triangle world at 1200x900, 16 spp,
     6 bounces through ``render`` over all block-ordered pixel ids,
     checked finite and lit, with one K3 launch per sample and no K1 or
     K2 launch; where its time goes (``torch.profiler``); a small frame on
     the card against the CPU; the PPM;
  12. K3 in recording mode against its plain version on the six mesh
     scenes of phase 9 (planes unchanged, winners, AO factors where used);
  13. K2's mesh mode against its plain version on those scenes, with the
     winners K3 recorded: ray cotangents and every row of the four table
     cotangents (the rows that get no cotangent, ``QUIET_ROWS``, at
     rounding level on both sides), and two launches against each other;
  14. K3 recording and K2 mesh mode at the main path's shape (the
     600-triangle world, 1200x900 rays, 6 bounces), compared and timed
     beside their plain versions and bounds;
  15. the mesh training path: value and gradient of the photometric loss
     through ``render`` on that world at 1200x900, 4 spp, 6 bounces with
     every float leaf requiring grad (K3 recording launches == 2 x spp,
     K2 mesh launches == spp), where its time goes, then 3 Adam steps
     towards a target with perturbed atlas and material colours, whose
     losses must fall;
  16. the scan path's closest-hit kernel (K4) against its plain version,
     winners and distances bit-equal, at 64x48 rays (random rays with
     axis-aligned directions, camera rays and each bounce's rays through
     the scan path) on Cornell, the six mesh scenes of phase 9 and a
     4096-triangle world (K4's limit, twice K3's);
  17. K4 on the 1200x900 camera rays of the 600- and 4096-triangle worlds,
     compared and timed beside its plain version and its bound;
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
     whose losses must fall;
  22. the equirect sky's kernel modes against their plain versions at
     64x48 rays: a generated SKY_SIZE sky (``scenes.write_sky_showcase``,
     the read timed) and block worlds with ``sky=``; K1's sky slot (16
     planes) and its recording on the showcase (also with AO and the HSL
     boost, and with a cutout sphere), K3's on the 60-triangle sky world
     (also with AO and with every texel a cutout) and the MESH_WORLD one,
     rays that leave K3's loop early among them; K2's sky cotangent in
     sphere and mesh modes, two launches compared;
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
     world and its sky twin beside their plain versions and bounds;
  31. the mesh frames of phases 11, 15 and 25 through the default
     (merged) load: forward, fwd+bwd of every float leaf, 3 Adam steps
     whose losses must fall;
  32. the AD sphere backward K5 against its plain version (autograd
     through K1's plain version) and bit-equal to K2 on K1's recording, on
     phase 7's six scenes and the sky showcase at 64x48 rays; two
     launches bit-identical;
  33. K5 timed at the Cornell 1200x900, 6-bounce shape beside its plain
     version, K2 and its bound, and the Cornell fwd+bwd frame with
     ``RAYTPU_SPH_BWD=ad`` (K5 launches == spp, no K2).
Phases 9-28 load their mesh worlds with ``merge_quads`` off (the
per-triangle search), so they compare K3 bit for bit with the scan path
and with the per-triangle times in PERF.md; phases 29-31 take the default.
Each path's launch counts (K1-K5 and the RNG kernel) are set to 0 just
before it and read just after; every render draws through the RNG
kernel (K3 and the scan path read its bounce rows, the sphere kernels
hash theirs from its keys). The last lines are the card, a JSON line
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
# K2's mesh mode sums d_tri and d_atlas with float atomics, whose order
# changes between launches: two launches may differ by at most ATOMIC_REL
# of each row's largest |entry| (d_sph, d_mat and the ray cotangents stay
# bit-identical). QUIET_ROWS get no cotangent: the rows that enter only
# comparisons, indices and floor() (csrc/trace_scene_bwd.cu's header), and
# d_tri's rows 0-2, the vertex a, which is zero in exact arithmetic: a
# triangle's hit distance reaches the output only as the next ray's
# origin, whose cotangent is zero or (after a cutout, which keeps the
# direction) orthogonal to the direction. Both sides must hold them under
# ZERO_ROW of their table's largest |entry|; every other row is measured
# against its largest |entry|, floored at ZERO_ROW of the table's.
ATOMIC_REL, ZERO_ROW = 1e-5, 1e-6
QUIET_ROWS = {"d_sph": [12], "d_tri": [*range(9), *range(12, 25)],
              "d_mat": [6, 7, 8], "d_atlas": [3]}
# K3's FP32 operations (arithmetic and compares, as counted in
# csrc/trace_scene.cu) per sphere test, slab test and Moller-Trumbore
# triangle test, and per live (ray, bounce) for the winner's texel,
# material and shading
K3_OPS_SPHERE, K3_OPS_SLAB, K3_OPS_TRI, K3_OPS_SHADE = 33, 25, 46, 210
# K3's merged search (csrc/trace_scene.cu: merged_search): FP32 operations
# per axis-aligned rect test, axis-aligned triangle test, general
# parallelogram test and general leftover test, and per live (ray,
# bounce) for the six group tests and the set-up of the groups it enters
K3M_OPS_RECT, K3M_OPS_AATRI, K3M_OPS_QUAD, K3M_OPS_LEFT = 18, 22, 49, 47
K3M_OPS_GROUPS = 30
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
# H100 SXM peaks (NVIDIA data sheet):
# HBM bytes/s and FP32 (non-tensor) FLOP/s, for the bound_ms column.
HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12
# INT32 instructions: the SM's issue limit, 4 schedulers x 32 lanes a
# clock, x 132 SMs at 1.98 GHz (the data sheet's 67 TFLOP/s FP32 is 128
# lanes x 132 SMs x 2 (FMA) x 1.98 GHz). The SM has 64 INT32 lanes, but
# nvcc also issues integer adds and shifts as IMAD on the FMA pipe: the RNG
# kernel's 22-row launch beat 64 lanes' time on the card (PERF.md). For the
# threefry hashing of the RNG kernel, K1, K2's sphere mode and K5.
INT32_OPS_PER_S = 128 * 132 * 1.98e9
# csrc/threefry.cuh: INT32 instructions of one fold_in (a hash) and of one
# draw (a hash and its conversion to U[0, 1)), three-input LOP3 / IADD3
# counted once
FOLD_OPS, DRAW_OPS = 73, 76
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
        fns = {"kernel": lambda: rng._launch(key, pids, 0, rows),
               "plain": lambda: rng.stream_reference(key, pids, 0, rows)}
        fns["kernel"](), fns["plain"]()
        t = {w: [] for w in fns}
        for which in ("plain", "kernel", "kernel", "plain"):
            t[which].append(_time_ms(fns[which], 20 if which == "kernel" else 3))
        ms = {w: float(np.mean(v)) for w, v in t.items()}
        bound = _rng_bound(pids.shape[0], rows)
        res[rows] = dict(ms=ms["kernel"], plain_ms=ms["plain"], bound=bound)
        print(f"  RNG kernel, {rows} rows at {pids.shape[0]} rays: "
              f"{ms['kernel']:.4f} ms (eager plain {ms['plain']:.4f} ms; "
              f"bound {bound[0]:.4f} ms, {bound[1]}; turns {t})")
    return res


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
    (the eager stream), so the keyed kernels (K1, K2's sphere mode, K5)
    take the keys and their plain versions and K3 the draws."""
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
    the RNG kernel: (origin, direction, ray keys (2, B), bounce draws
    (max_bounces, n_draws, B), a callable that redoes the sample's RNG
    kernel and camera rays for timing, the row count it makes). ``rows``:
    the rows a route's RNG launch makes (default: every row, K3's and the
    scan path's; 4 for K1's)."""
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import (
        blocked_pixel_order, n_bounce_draws, sample_rays)

    pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
    key = rng.prng_key(0, device=dev)
    nd = n_bounce_draws(cfg)
    all_rows = 4 + cfg.max_bounces * nd
    keys, draws = rng.sample_stream(key, pids, 0, all_rows)
    origin, direction = sample_rays(cam, cfg, pids, draws[:4])
    rows = all_rows if rows is None else rows

    def redo():
        return sample_rays(cam, cfg, pids,
                           rng.sample_stream(key, pids, 0, rows)[1][:4])

    return (origin, direction, keys,
            draws[4:].view(cfg.max_bounces, nd, -1), redo)


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
          f"RNG kernel + camera rays {rng_ms:.4f} ms per sample; draws "
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
    if rng_launches != cfg.spp:
        raise AssertionError(f"main path: {rng_launches} RNG kernel launches, "
                             f"want {cfg.spp}")

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
    print(f"  per sample (CUDA events, same shapes): RNG kernel + camera rays "
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

    img = render_image(scene, cam, cfg.replace(pixel_tile=cfg.n_pixels), key)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "chip_smoke_cornell.ppm")
    write_ppm(path, img.canvas)
    means = img.canvas.reshape(-1, 3).mean(axis=0)
    print(f"wrote {os.path.relpath(path, ROOT)}: canvas channel means "
          f"r={means[0]:.3f} g={means[1]:.3f} b={means[2]:.3f}")
    return (launches, k2_launches, k3_launches, k4_launches, rng_launches,
            frame)


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
    the plain version's count on this run's data) at the FP32 peak; the
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
    (ray, bounce) that hit at the FP32 peak; the scatter and roulette draws
    K1 hashes (``counts["draws"]``), hashed twice (the replay and the
    reverse step), at the INT32 issue rate."""
    nbytes = (b * (24 + 8 + 4 * bounces + 36 + 24
                   + (SKY_G_BYTES if sky else 0)) + 2 * 14 * 4 * n_spheres)
    return _bound(nbytes, counts["live"] * K2_OPS_SPHERE,
                  2 * counts["draws"] * DRAW_OPS)


def _bound(nbytes, flops, int_ops=0):
    """(least ms, "bytes" or "operations"): the largest of the bytes at
    HBM speed, the FP32 operations at the FP32 peak and the INT32
    operations at the INT32 issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOP_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
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


def _profile(work):
    """Device time by kernel over one call of ``work``, and the idle
    share of the window: torch.profiler with CUDA activity. A first call
    of ``work`` is the schedule's warm-up step, whose events are dropped:
    a window of a few ms opened cold lost most of its kernels."""
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
    buckets = {"RNG kernel": 0.0, "K1 trace_spheres": 0.0,
               "K2 backward": 0.0, "K5 spheres_ad": 0.0,
               "K2/K5 sum_blocks": 0.0, "K3 trace_scene": 0.0,
               "K4 intersect": 0.0, "index gather/scatter": 0.0,
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
        low = name.lower()
        if "rng_sample_kernel" in name:
            buckets["RNG kernel"] += dev_us
        elif "trace_spheres_kernel" in name:
            buckets["K1 trace_spheres"] += dev_us
        elif "trace_scene_kernel" in name:
            buckets["K3 trace_scene"] += dev_us
        elif "intersect_kernel" in name:
            buckets["K4 intersect"] += dev_us
        elif any(w in name.lower() for w in ("index", "scatter", "gather")):
            # the scan path's winner gathers (index_select) and their
            # backward (index_add); their int64 indices are not threefry
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
    if k1_launches != 2 * cfg.spp or rng_launches != 2 * cfg.spp:
        raise AssertionError(f"fwd+bwd: {k1_launches} K1 and {rng_launches} "
                             f"RNG kernel launches, want {2 * cfg.spp} each "
                             "(forward + checkpoint recompute)")
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


def _k3_both(scene, cfg, origin, direction, draws, counts=None):
    """(plain, kernel) outputs of K3 as (9, B) on the same card tensors;
    the kernel through its wrapper. ``counts`` goes to the plain version."""
    import torch

    from raytpu_torch.kernels import trace_scene as tsc

    k = tsc.MeshKnobs.for_scene(cfg, scene, draws.shape[1])
    ref = tsc.trace_scene_reference(tsc.pack_scene(scene, k), *origin,
                                    *direction,
                                    draws.reshape(-1, draws.shape[-1]), k,
                                    counts)
    out = torch.cat([v.to_array().T for v in tsc.trace_mesh_megakernel(
        scene, cfg, origin, direction, draws)])
    return ref, out


def phase_k3(dev):
    print(f"K3 vs plain at 64x48 rays (outlier: any channel > {ATOL} + "
          f"{RTOL}|x|; limit {OUTLIER_FRAC:.0%} of rays)")
    for i, (name, (scene, cam, cfg), over) in enumerate(_k3_cases(dev)):
        cfg = cfg.replace(width=64, height=48, **over)
        origin, direction, draws, _ = _kernel_inputs(scene, cam, cfg, 400 + i,
                                                     dev)
        _compare(name, *_k3_both(scene, cfg, origin, direction, draws))


def _k3_bound(b, bounces, counts, table_bytes, sky=False):
    """Least K3 time: rays 24 B, draws 3 x 4 B per bounce and 9 planes out
    (16 with the sky slot) per ray plus the scene tables at HBM speed,
    against the operations of this run's search (K3_OPS_*: the plain
    version's counts of sphere, slab and entered-chunk triangle tests and
    live (ray, bounce) entries; K3M_OPS_* for the merged search's
    candidates) at the FP32 peak."""
    nbytes = (b * (24 + 12 * bounces + 36 + (SKY_SLOT_BYTES if sky else 0))
              + table_bytes)
    ops = (counts["sphere"] * K3_OPS_SPHERE + counts["slab"] * K3_OPS_SLAB
           + counts["tri"] * K3_OPS_TRI + counts["live"] * K3_OPS_SHADE)
    if "aa_rect" in counts:       # the merged search's candidates
        ops += (counts["aa_rect"] * K3M_OPS_RECT
                + counts["aa_tri"] * K3M_OPS_AATRI
                + counts["quad"] * K3M_OPS_QUAD + counts["left"] * K3M_OPS_LEFT
                + counts["live"] * K3M_OPS_GROUPS)
    return _bound(nbytes, ops)


def phase_k3_timing(dev):
    """K3 and its plain version at the main path's shape (one sample of
    the 1200x900, 6-bounce block-world frame, the RNG kernel's draws),
    compared, then timed with CUDA events in turns, with the RNG work of a
    sample (the RNG kernel's rows and the camera rays)."""
    import numpy as np

    from raytpu_torch.kernels import trace_scene as tsc

    scene, cam, cfg = _per_triangle(_block_world(MESH_WORLD), dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], max_bounces=6)
    origin, direction, _, draws, rng_sample = _frame_sample(cam, cfg, dev)
    counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
    ref, out = _k3_both(scene, cfg, origin, direction, draws, counts)
    name = f"block world {MESH_WORLD} {cfg.width}x{cfg.height} 6b"
    print(f"K3 vs plain at the main path's shape ({cfg.width}x{cfg.height} "
          f"rays, 6 bounces, {scene.triangles.count} triangles):")
    max_err = _compare(name, ref, out)
    frac = max(_outliers(ref[s], out[s])[0]
               for s in (slice(0, 3), slice(3, 6), slice(6, 9)))
    del ref, out

    k = tsc.MeshKnobs.for_scene(cfg, scene, draws.shape[1])
    tb = tsc.pack_scene(scene, k)
    flat = draws.reshape(-1, draws.shape[-1])
    rays = (*origin, *direction)
    kernel = lambda: tsc._launch(tb, rays, flat, k)
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
          f"ms ({bound[1]}); RNG kernel + camera rays {rng_ms:.4f} ms per "
          "sample")
    print(f"  search work (plain version's counts): {counts['live']} live "
          f"(ray, bounce) entries of {b * cfg.max_bounces}; per live entry "
          f"{counts['sphere'] / counts['live']:.2f} sphere, "
          f"{counts['slab'] / counts['live']:.2f} slab and "
          f"{counts['tri'] / counts['live']:.2f} triangle tests; "
          f"{scene.triangles.count} triangles in {k.n_chunks} chunks")
    return dict(ms=ms, plain_ms=plain_ms, rng_ms=rng_ms, max_abs_err=max_err,
                outlier_frac=frac, bound=bound, counts=counts)


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
    _check_rng("mesh path", cfg.spp)

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
    print(f"  per sample (CUDA events, same shapes): RNG kernel + camera "
          f"rays {timing['rng_ms']:.4f} ms, K3 {timing['ms']:.4f} ms -> "
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


def _mesh_inputs(scene, cfg, origin, direction, draws):
    """K3's tables, rays, flat draws and knobs for one batch."""
    from raytpu_torch.kernels import trace_scene as tsc

    k = tsc.MeshKnobs.for_scene(cfg, scene, draws.shape[1])
    return (tsc.pack_scene(scene, k), (*origin, *direction),
            draws.reshape(-1, draws.shape[-1]), k)


def _check_mesh_record(name, kern, plain, forward):
    """K3's recording launch against its plain version and its own launch
    without recording: the nine planes bit-equal, at least IDX_AGREE of
    the winners equal, and the AO factors equal where they are used (a
    bounce that accumulates has a recorded hit, so this compares them on
    every entry where both record the same hit) up to OUTLIER_FRAC of
    those entries (a flipped winner earlier on the ray moves its later
    hit points). Returns (winner agreement, max |diff| of the planes and
    the AO factors compared)."""
    import torch

    out, idx, aof = kern
    if not torch.equal(out, forward):
        raise AssertionError(f"{name}: recording changed the 9 planes")
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
        o, d, draws, _ = _kernel_inputs(scene, cam, cfg, 500 + i, dev)
        tb, rays, flat, k = _mesh_inputs(scene, cfg, o, d, draws)
        _check_mesh_record(
            name, tsc._launch(tb, rays, flat, k, record=True),
            tsc.trace_scene_reference(tb, *rays, flat, k, record=True),
            tsc._launch(tb, rays, flat, k))


def _compare_mesh_grads(name, ref, got, again):
    """ref/got/again: (d_sph, d_tri, d_mat, d_atlas, six ray cotangents).
    Raises on non-finite values, on ray cotangents past the K2 tolerance,
    on a QUIET_ROWS row over ZERO_ROW of its table's largest |entry| on
    either side, on d_tri's normal rows (9-11) under it where there are
    triangle winners, on another row off by more than DSPH_REL of its
    largest |entry| (at least ZERO_ROW of the table's), and on two
    launches whose d_tri or d_atlas rows differ by more than ATOMIC_REL of
    that (the atomics' order) or whose d_sph, d_mat or ray cotangents
    differ at all. Returns (max |diff|, outlier fraction of rays, worst
    launch-to-launch difference / row scale, largest quiet row / table
    max)."""
    import torch

    r_ref, r_got = torch.stack(ref[4]), torch.stack(got[4])
    for t in (*ref[:4], *got[:4], r_ref, r_got):
        if not t.isfinite().all():
            raise AssertionError(f"{name}: non-finite cotangent")
    diff = (r_got - r_ref).abs()
    frac = (diff > G_ATOL + G_RTOL * r_ref.abs()).any(0).float().mean().item()
    worst, rerun, quiet, max_err = {}, 0.0, 0.0, diff.max().item()
    for tname, a, w, b in zip(("d_sph", "d_tri", "d_mat", "d_atlas"),
                              got[:4], ref[:4], again[:4]):
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
        run_err = (a[loud] - b[loud]).abs().amax(1)
        rerun = max(rerun, (run_err / scale.clamp(min=1e-30)).max().item())
        if (run_err > ATOMIC_REL * scale).any():
            raise AssertionError(f"{name}: two launches' {tname} differ by "
                                 f"more than {ATOMIC_REL} of a row")
    if not (torch.equal(got[0], again[0]) and torch.equal(got[2], again[2])
            and all(torch.equal(x, y) for x, y in zip(got[4], again[4]))):
        raise AssertionError(f"{name}: two launches' d_sph, d_mat or ray "
                             "cotangents differ")
    print(f"  {name:28s} ray outliers {frac:.5f}  max|d ray| diff "
          f"{diff.max().item():.3e}  worst row err / row max "
          + " ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; quiet rows / table max {quiet:.3e}; two launches {rerun:.3e}")
    if frac > OUTLIER_FRAC:
        raise AssertionError(f"{name}: {frac:.2%} rays' cotangents differ")
    return max_err, frac, rerun, quiet


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
          f"two launches within {ATOMIC_REL} x row max)")
    rerun = 0.0
    for i, (name, (scene, cam, cfg), over) in enumerate(_k3_cases(dev)):
        cfg = cfg.replace(width=64, height=48, **over)
        o, d, draws, _ = _kernel_inputs(scene, cam, cfg, 600 + i, dev)
        mt, rays, flat, k = _mesh_inputs(scene, cfg, o, d, draws)
        _, idx, aof = tsc._launch(mt, rays, flat, k, record=True)
        tabs = tb.Tables(mt.sph, mt.tri, mt.mats, mt.atlas)
        g = torch.tensor(np.random.default_rng(700 + i).uniform(
            -1, 1, (9, cfg.n_pixels)).astype(np.float32), device=dev)
        got = tb._launch(tabs, rays, flat, idx, aof, g, k)
        again = tb._launch(tabs, rays, flat, idx, aof, g, k)
        ref = tb.replay_reference(tabs, rays, flat, idx, aof, g, k)
        rerun = max(rerun, _compare_mesh_grads(
            f"{name} ({cfg.max_bounces}b)", ref, got, again)[2])
    return rerun


def _k2_mesh_bound(b, bounces, idx, n_spheres, table_bytes, sky=False):
    """Least K2 mesh-mode time: per ray its rays 24 B, draws 0..2 (12 B)
    and index (4 B) per bounce, g 36 B (48 B with the sky scale's
    cotangent) and the ray cotangents 24 B; the tables read once and their
    cotangents written once; against K2_OPS_TRI FLOP per live (ray,
    bounce) with a triangle winner and K2_OPS_SPHERE per other live entry
    (this run's recorded winners)."""
    n_tri = int((idx >= n_spheres).sum().item())
    n_sph = int(((idx >= 0) & (idx < n_spheres)).sum().item())
    nbytes = (b * (24 + 16 * bounces + 36 + 24 + (SKY_G_BYTES if sky else 0))
              + 2 * table_bytes)
    return _bound(nbytes, n_tri * K2_OPS_TRI + n_sph * K2_OPS_SPHERE)


def phase_mesh_bwd_timing(dev):
    """At the main path's shape (one sample of the 600-triangle block world
    at 1200x900 rays, 6 bounces, real RNG draws): K3 recording and K2 mesh
    mode against their plain versions, then each timed with CUDA events
    in turns beside its plain version."""
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import (
        blocked_pixel_order, n_bounce_draws, sample_rays)
    from raytpu_torch.kernels import trace_scene as tsc
    from raytpu_torch.kernels import trace_scene_bwd as tb

    scene, cam, cfg = _per_triangle(_block_world(MESH_WORLD), dev)
    cfg = cfg.replace(width=FRAME[0], height=FRAME[1], max_bounces=6)
    pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
    ks = rng.sample_keys(rng.pixel_keys(rng.prng_key(0, device=dev), pids), 0)
    cam_d, draws = rng.ray_uniforms(ks, 4, n_bounce_draws(cfg), cfg.max_bounces)
    origin, direction = sample_rays(cam, cfg, pids, cam_d)
    mt, rays, flat, k = _mesh_inputs(scene, cfg, origin, direction, draws)
    name = f"block world {MESH_WORLD} {cfg.width}x{cfg.height} 6b"
    print(f"K3 recording and K2 mesh mode at the main path's shape "
          f"({cfg.width}x{cfg.height} rays, 6 bounces, "
          f"{scene.triangles.count} triangles):")
    counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
    kern = tsc._launch(mt, rays, flat, k, record=True)
    plain = tsc.trace_scene_reference(mt, *rays, flat, k, counts, record=True)
    rec_agree, rec_err = _check_mesh_record(name, kern, plain,
                                            tsc._launch(mt, rays, flat, k))
    del plain
    _, idx, aof = kern
    tabs = tb.Tables(mt.sph, mt.tri, mt.mats, mt.atlas)
    g = torch.tensor(np.random.default_rng(8).uniform(
        -1, 1, (9, cfg.n_pixels)).astype(np.float32), device=dev)
    got = tb._launch(tabs, rays, flat, idx, aof, g, k)
    again = tb._launch(tabs, rays, flat, idx, aof, g, k)
    ref = tb.replay_reference(tabs, rays, flat, idx, aof, g, k)
    max_err, frac, rerun, quiet = _compare_mesh_grads(name, ref, got, again)
    del ref, got, again

    fns = {
        "record": lambda: tsc._launch(mt, rays, flat, k, record=True),
        "record_plain": lambda: tsc.trace_scene_reference(
            mt, *rays, flat, k, record=True),
        "k2": lambda: tb._launch(tabs, rays, flat, idx, aof, g, k),
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
                              table_bytes)
    n_tri = int((idx >= k.n_spheres).sum().item())
    print(f"  K3 recording {res['record']:.4f} ms (plain "
          f"{res['record_plain']:.4f} ms; bound {rec_bound[0]:.4f} ms, "
          f"{rec_bound[1]}); K2 mesh {res['k2']:.4f} ms (plain "
          f"{res['k2_plain']:.4f} ms; bound {k2_bound[0]:.4f} ms, "
          f"{k2_bound[1]}) per call (turns {t}); live (ray, bounce) entries "
          f"{int((idx >= 0).sum().item())} of {b * cfg.max_bounces}, "
          f"{n_tri} with a triangle winner")
    return dict(record_ms=res["record"], record_plain_ms=res["record_plain"],
                record_bound=rec_bound, record_agree=rec_agree,
                record_err=rec_err,
                ms=res["k2"], plain_ms=res["k2_plain"], bound=k2_bound,
                max_abs_err=max_err, outlier_frac=frac, rerun=rerun)


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
    _check_rng("mesh fwd+bwd", 2 * cfg.spp)

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
    chunk, a triangle test per triangle of every chunk the ray enters, at
    K3's operation counts for the same tests) at the FP32 peak."""
    ops = (counts["sphere"] * K3_OPS_SPHERE + counts["slab"] * K3_OPS_SLAB
           + counts["tri"] * K3_OPS_TRI)
    return _bound(b * (24 + 8) + table_bytes, ops)


def phase_k4_timing(dev):
    """K4 and its plain version on the 1200x900 camera rays of the 600- and
    4096-triangle worlds: compared bit for bit, then timed with CUDA
    events in turns, beside the bound from this input's work."""
    import numpy as np
    import torch

    from raytpu_torch.core import rng
    from raytpu_torch.geometry.triangle import precompute
    from raytpu_torch.integrator.render import blocked_pixel_order, sample_rays
    from raytpu_torch.kernels import intersect

    res = {}
    for n in (MESH_WORLD, SCAN_WORLD):
        scene, cam, cfg = _per_triangle(_block_world(n), dev)
        cfg = cfg.replace(width=FRAME[0], height=FRAME[1])
        pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
        ks = rng.sample_keys(rng.pixel_keys(rng.prng_key(0, device=dev), pids), 0)
        cam_d, _ = rng.ray_uniforms(ks, 4, 3, 1)
        o, d = sample_rays(cam, cfg, pids, cam_d)
        rays = tuple(c.contiguous() for c in (*o, *d))
        tabs = intersect.pack_tables(scene, precompute(scene.triangles))
        eps = (cfg.sphere_eps, cfg.tri_det_eps, cfg.tri_eps)
        counts = {"sphere": 0, "slab": 0, "tri": 0}
        pt, pi = intersect.intersect_reference(*tabs, *rays, *eps, counts)
        kt, ki = intersect._launch(*tabs, rays, *eps)
        if not (torch.equal(ki, pi) and torch.equal(kt, pt)):
            raise AssertionError(f"K4 {n} triangles at {cfg.width}x"
                                 f"{cfg.height}: {(ki != pi).sum().item()} "
                                 "winners differ")
        max_err = (kt - pt).abs().max().item()
        kernel = lambda: intersect._launch(*tabs, rays, *eps)
        plain = lambda: intersect.intersect_reference(*tabs, *rays, *eps)
        t = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            t[which].append(_time_ms(kernel if which == "kernel" else plain,
                                     20 if which == "kernel" else 2))
        ms, plain_ms = float(np.mean(t["kernel"])), float(np.mean(t["plain"]))
        b = cfg.n_pixels
        bound = _k4_bound(b, counts, 4 * sum(x.numel() for x in tabs))
        print(f"K4 on the {b} camera rays of the {n}-triangle world: equal to "
              f"its plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(turns: kernel {t['kernel']}, plain {t['plain']}); bound "
              f"{bound[0]:.4f} ms ({bound[1]}); per ray {counts['sphere'] / b:.2f} "
              f"sphere, {counts['slab'] / b:.2f} slab and "
              f"{counts['tri'] / b:.2f} triangle tests; hits "
              f"{(ki >= 0).float().mean().item():.4f}")
        res[n] = dict(ms=ms, plain_ms=plain_ms, bound=bound, max_abs_err=max_err)
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

    ts.launches = tb.launches = tsc.launches = intersect.launches = 0
    ts.ad_launches = rng.launches = 0


def _check_rng(what, want):
    """Raises unless the path launched the RNG kernel ``want`` times (one a
    sample, twice under the checkpoint's recompute)."""
    if _rng_launches() != want:
        raise AssertionError(f"{what}: {_rng_launches()} RNG kernel "
                             f"launches, want {want}")


def _rng_launches():
    """The RNG kernel's launch count (``rng.sample_stream``)."""
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

    loss_fn(cfg.replace(spp=1)).backward()        # warm up
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
    _check_rng("scan fwd+bwd", 2 * cfg.spp)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    grads = {n: p.grad for n, p in params.items()}
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
          f"{peak_gb:.2f} GB; loss {loss.item():.6f}; K4 launches {k4}; max "
          + ", ".join(f"|d {leaf}| {grads[leaf].abs().max().item():.4e}"
                      for leaf in ("triangles.a.x", "triangles.a.y",
                                   "triangles.a.z", "atlas.rgb.x")))
    _print_profile("scan fwd+bwd at spp=1",
                   *_profile(lambda: loss_fn(cfg.replace(spp=1)).backward()))

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
    return dict(k1=k1, k2=k2, k3=k3, k4=k4, rays_per_s=rays / elapsed)


def _on(obj, dev):
    """A scene or camera with every tensor moved to ``dev``."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _on(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    return obj


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
        o, d, draws, _ = _kernel_inputs(scene, cam, cfg, 820 + i, dev)
        mt, rays, flat, k = _mesh_inputs(scene, cfg, o, d, draws)
        ref = tsc.trace_scene_reference(mt, *rays, flat, k)
        out = tsc._launch(mt, rays, flat, k)
        if out.shape[0] != 16:
            raise AssertionError(f"{name}: {out.shape[0]} planes, want 16")
        res["k3"] = max(res["k3"], _compare(name, ref, out))
        bits(name, ref, out)
        kern = tsc._launch(mt, rays, flat, k, record=True)
        _check_mesh_record(name, kern, tsc.trace_scene_reference(
            mt, *rays, flat, k, record=True), out)
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
        got = tb._launch(tabs, rays, flat, idx, aof, g, k)
        again = tb._launch(tabs, rays, flat, idx, aof, g, k)
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
    o, d, draws, _ = camera_batch(scene, cam, cfg)
    mt, rays, flat, k = _mesh_inputs(scene, cfg, o, d, draws)
    name = f"sky world {MESH_WORLD} {cfg.width}x{cfg.height} 6b"
    counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
    ref = tsc.trace_scene_reference(mt, *rays, flat, k, counts)
    out = tsc._launch(mt, rays, flat, k)
    k3_err = _compare(name, ref, out)
    del ref
    kern = tsc._launch(mt, rays, flat, k, record=True)
    _, rec_err = _check_mesh_record(name, kern, tsc.trace_scene_reference(
        mt, *rays, flat, k, record=True), out)
    _, idx, aof = kern
    tabs = tb.Tables(mt.sph, mt.tri, mt.mats, mt.atlas)
    g = torch.tensor(np.random.default_rng(12).uniform(
        -1, 1, (12, cfg.n_pixels)).astype(np.float32), device=dev)
    got = tb._launch(tabs, rays, flat, idx, aof, g, k)
    again = tb._launch(tabs, rays, flat, idx, aof, g, k)
    k2m_err = _compare_mesh_grads(f"{name} K2 sky", tb.replay_reference(
        tabs, rays, flat, idx, aof, g, k), got, again)[0]
    del got, again
    fns = {"k3": lambda: tsc._launch(mt, rays, flat, k),
           "k3_plain": lambda: tsc.trace_scene_reference(mt, *rays, flat, k),
           "k3_rec": lambda: tsc._launch(mt, rays, flat, k, record=True),
           "k3_rec_plain": lambda: tsc.trace_scene_reference(
               mt, *rays, flat, k, record=True),
           "k2": lambda: tb._launch(tabs, rays, flat, idx, aof, g, k),
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
                                               True), max_abs_err=k2m_err)
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
    _check_rng(what, cfg.spp * (1 if fwd_bwd is None else 2))
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
            # the slot on the same rays and draws (K1: the same keys),
            # card and CPU
            o, d, draws, keys = _kernel_inputs(scene, cam, cfg, 950, dev)
            if scene.n_triangles:
                src = draws.reshape(-1, draws.shape[-1])
                k = tsc.MeshKnobs.for_scene(cfg, scene, draws.shape[1])
                run = lambda sc, rays, fl: tsc._forward(
                    tsc.pack_scene(sc, k), rays, fl, k)
            else:
                src = keys
                k = ts.Knobs.create(cfg, scene.spheres.count, draws.shape[1],
                                    scene.sky_index)
                run = lambda sc, rays, fl: ts._forward(ts.pack_spheres(sc),
                                                       rays, fl, k)
            card = run(scene, (*o, *d), src).cpu()
            host = run(cscene, tuple(c.cpu() for c in (*o, *d)), src.cpu())
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
        o, d, draws, _ = _kernel_inputs(scene, cam, cfg, 1000 + i, dev)
        mt, rays, flat, k = _mesh_inputs(scene, cfg, o, d, draws)
        if k.plan is None:
            raise AssertionError(f"{name}: the default load has no quad plan")
        ref = tsc.trace_scene_reference(mt, *rays, flat, k)
        out = tsc._launch(mt, rays, flat, k)
        if not torch.equal(ref, out):
            _compare(name, ref, out)
            raise AssertionError(f"{name}: merged planes differ from the "
                                 "plain version's bits")
        kern = tsc._launch(mt, rays, flat, k, record=True)
        _check_mesh_record(name, kern, tsc.trace_scene_reference(
            mt, *rays, flat, k, record=True), out)
        tk = tsc.MeshKnobs.for_scene(cfg.replace(merge_quads=False), scene,
                                     draws.shape[1])
        tri, tri_idx, _ = tsc._launch(tsc.pack_scene(scene, tk), rays, flat,
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
    from raytpu_torch.integrator.render import (
        blocked_pixel_order, n_bounce_draws, sample_rays)
    from raytpu_torch.kernels import trace_scene as tsc

    res = {}
    for key, path in (("world", _block_world(MESH_WORLD)),
                      ("sky", _sky_files()[MESH_WORLD])):
        scene, cam, cfg = load_scene_file(path, dev)
        cfg = cfg.replace(width=FRAME[0], height=FRAME[1], max_bounces=6)
        pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
        ks = rng.sample_keys(rng.pixel_keys(rng.prng_key(0, device=dev),
                                            pids), 0)
        cam_d, draws = rng.ray_uniforms(ks, 4, n_bounce_draws(cfg),
                                        cfg.max_bounces)
        origin, direction = sample_rays(cam, cfg, pids, cam_d)
        mt, rays, flat, k = _mesh_inputs(scene, cfg, origin, direction, draws)
        counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
        ref = tsc.trace_scene_reference(mt, *rays, flat, k, counts)
        out = tsc._launch(mt, rays, flat, k)
        if not torch.equal(ref, out):
            raise AssertionError(f"merged {key} at {cfg.width}x{cfg.height}:"
                                 " planes differ from the plain version's")
        rec = tsc._launch(mt, rays, flat, k, record=True)
        _, rec_err = _check_mesh_record(
            f"merged {key} {cfg.width}x{cfg.height}", rec,
            tsc.trace_scene_reference(mt, *rays, flat, k, record=True), out)
        del ref, out, rec
        fns = {"fwd": lambda: tsc._launch(mt, rays, flat, k),
               "fwd_plain": lambda: tsc.trace_scene_reference(mt, *rays, flat, k),
               "rec": lambda: tsc._launch(mt, rays, flat, k, record=True),
               "rec_plain": lambda: tsc.trace_scene_reference(
                   mt, *rays, flat, k, record=True)}
        t = {w: [] for w in fns}
        for w in ("fwd_plain", "fwd", "fwd", "fwd_plain", "rec_plain", "rec",
                  "rec", "rec_plain"):
            t[w].append(_time_ms(fns[w], 2 if w.endswith("plain") else 20))
        ms = {w: float(np.mean(v)) for w, v in t.items()}
        b, sky = cfg.n_pixels, key == "sky"
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
                  "sphere", "aa_rect", "aa_tri", "quad", "left", "slab")))
        res[key] = dict(ms=ms["fwd"], plain_ms=ms["fwd_plain"], bound=bound,
                        rec_ms=ms["rec"], rec_plain_ms=ms["rec_plain"],
                        rec_bound=rec_bound, rec_err=rec_err, counts=counts)
        del mt, rays, flat, draws
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


def phase_k5_timing(dev, card, k2):
    """Phase 33: K5 at the main path's shape (the Cornell 1200x900, 6-bounce
    sample of phase 7's timing) beside its plain version, K2 and its
    bound; then the Cornell fwd+bwd frame with RAYTPU_SPH_BWD=ad (K5
    launches == spp, no K2)."""
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
                frame=dict(s=el, rate=rate, launches=got, idle=idle))


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

    rng_t = phase_rng(dev)
    phase_k1(dev)
    timing = phase_k1_timing(dev)
    (launches, render_k2, render_k3, render_k4, render_rng,
     main_prof) = phase_main(dev, card, timing)
    phase_k1_record(dev)
    phase_k2(dev)
    k2 = phase_k2_timing(dev)
    train = phase_train(dev, card)
    phase_k3(dev)
    k3 = phase_k3_timing(dev)
    mesh = phase_mesh(dev, card, k3)
    phase_k3_record(dev)
    rerun = phase_k2_mesh(dev)
    mbwd = phase_mesh_bwd_timing(dev)
    mtrain = phase_mesh_train(dev, card)
    phase_k4(dev)
    k4 = phase_k4_timing(dev)
    phase_scan_checks(dev)
    scan = phase_scan_frame(dev, card, mesh)
    strain = phase_scan_train(dev, card)
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
    k5 = phase_k5_timing(dev, card, k2)

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
    print(card)
    print(json.dumps({"kernels": [{
        "name": "rng_sample", "route": "cuda",
        "source": "raytpu_torch/csrc/rng.cu", "replaces": None,
        "launches": train["rng_launches"],
        "launches_by_path": {"render": render_rng,
                             "fwd_bwd": train["rng_launches"]},
        "max_abs_err": 0.0, "ms": rng_t[4]["ms"],
        "plain_ms": rng_t[4]["plain_ms"], "bound_ms": rng_t[4]["bound"][0],
        "bound_by": rng_t[4]["bound"][1], "library_ms": None,
        "ms_22_rows": rng_t[22]["ms"], "plain_ms_22_rows": rng_t[22]["plain_ms"],
        "bound_ms_22_rows": rng_t[22]["bound"][0],
    }, {
        "name": "trace_spheres", "route": "cuda",
        "source": "raytpu_torch/csrc/trace_spheres.cu",
        "replaces": "raytpu/kernels/trace_spheres.py:421",
        "launches": train["k1_launches"],
        "launches_by_path": {"render": launches, "fwd_bwd": train["k1_launches"],
                             "mesh_render": mesh["k1"],
                             "mesh_fwd_bwd": mtrain["k1"],
                             "scan_render": scan[SCAN_WORLD]["k1"],
                             "scan_fwd_bwd": strain["k1"]},
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
        "two_launches_rel": max(rerun, mbwd["rerun"]),
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
                             "scan_fwd_bwd": strain["k4"]},
        "max_abs_err": k4[SCAN_WORLD]["max_abs_err"],
        "ms": k4[SCAN_WORLD]["ms"], "plain_ms": k4[SCAN_WORLD]["plain_ms"],
        "bound_ms": k4[SCAN_WORLD]["bound"][0],
        "bound_by": k4[SCAN_WORLD]["bound"][1], "library_ms": None,
        "ms_600": k4[MESH_WORLD]["ms"], "plain_ms_600": k4[MESH_WORLD]["plain_ms"],
        "bound_ms_600": k4[MESH_WORLD]["bound"][0],
    }, *({
        "name": name, "route": "cuda", "source": f"raytpu_torch/csrc/{src}.cu",
        "replaces": rep, "launches": launches,
        "max_abs_err": sky_t[key]["max_abs_err"], "ms": sky_t[key]["ms"],
        "plain_ms": sky_t[key]["plain_ms"], "bound_ms": sky_t[key]["bound"][0],
        "bound_by": sky_t[key]["bound"][1], "library_ms": None,
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
        "k2_ms": k5["k2_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
