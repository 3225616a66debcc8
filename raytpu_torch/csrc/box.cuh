// The conservative slab test of a cull box, shared by K4 (intersect.cu)
// and K3's merged walk (trace_scene.cu); its plain version is
// raytpu_torch/kernels/trace_scene.py:entered_boxes.
#pragma once

#include <cuda_runtime.h>

// Whether the line o + t d meets box c (rows lo3 hi3 of `box`, n columns)
// ahead of its origin, and its entry t. An axis whose slab product is NaN
// (the origin on a box plane and the direction's component zero) is
// unconstrained: the line lies in that slab. So a cull by it skips no
// valid hit, where the boxes hold their primitives with a margin.
__device__ __forceinline__ bool meets_box(const float* box, int n, int c,
                                          float ox, float oy, float oz,
                                          float inv_x, float inv_y,
                                          float inv_z, float& tmin) {
  float t_near[3], t_far[3];
  const float o[3] = {ox, oy, oz}, inv[3] = {inv_x, inv_y, inv_z};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float t0 = (box[r * n + c] - o[r]) * inv[r];
    const float t1 = (box[(r + 3) * n + c] - o[r]) * inv[r];
    const bool nan = isnan(t0) || isnan(t1);
    t_near[r] = nan ? -INFINITY : fminf(t0, t1);
    t_far[r] = nan ? INFINITY : fmaxf(t0, t1);
  }
  tmin = fmaxf(fmaxf(t_near[0], t_near[1]), t_near[2]);
  const float tmax = fminf(fminf(t_far[0], t_far[1]), t_far[2]);
  return tmax >= tmin && tmax >= 0.0f;
}
