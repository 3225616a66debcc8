// The segment sum of the scan path's gather backward: the table
// cotangents of every winner gather (raytpu_torch/kernels/gather.py), in a
// fixed order and without float atomics.
//
// Replaces no TPU kernel. raytpu's scan path gathers each winner's scene
// rows by one-hot products (core/gather.py) whose transposes XLA sums in a
// fixed order; the port's gathers are indexed loads, whose transpose is a
// scatter-add. PyTorch's (index_add_) adds with float atomics, so two
// backward runs differ by rounding, and a few rows hit by a million rays
// serialise them. So each index is sorted once, stably
// (gather.GatherIndex: the permutation, the sorted rows and each row's
// segment [off[r], off[r + 1]) of the sorted order), and this kernel sums
// each row's segment of every channel in ray order by a fixed tree.
//
// What bounds it: C channels of B cotangents read once (through the
// permutation), the permutation, the sorted rows and n + 1 offsets, and
// C x n sums written; one add an entry. So bytes (PERF.md gives the card's
// time). Two kernels:
//   * tile_sums: a block of kTile threads takes kTile consecutive sorted
//     entries and, channel by channel, scans each segment's run inside the
//     tile: a segmented inclusive scan in each warp (five shuffles, each
//     lane adding the lane s below only inside its own segment), then the
//     runs that cross warps carried from the warps below in warp order. The
//     last entry of each run in the tile writes the run's sum to a scratch
//     plane at its own position;
//   * row_sums: a thread a row adds its runs' sums (one a tile the
//     segment touches) in tile order; rows that touch more than kHeavy
//     tiles (a sphere or a material that many rays hit) are summed by the
//     whole warp, lane l taking tiles l, l + 32, ... in order and a
//     butterfly of five shuffles joining the lanes, one heavy row at a time
//     in lane order.
// Every addition's operands and order depend only on the sorted index, so
// two launches on the same inputs give the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (raytpu_torch/kernels/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;          // sorted entries a block of tile_sums
constexpr int kWarps = kTile / 32;
constexpr int kRowThreads = 256;
constexpr int kHeavy = 8;           // tiles past which a row is the warp's

__global__ void __launch_bounds__(kTile)
tile_sums(const float* __restrict__ g, const int* __restrict__ perm,
          const int* __restrict__ seg, float* __restrict__ part, int n_ch,
          int n) {
  __shared__ float tail[2][kWarps];
  __shared__ int first[kWarps], last[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pos = blockIdx.x * kTile + threadIdx.x;
  const bool valid = pos < n;
  const int r = valid ? seg[pos] : -1 - (int)threadIdx.x;   // a pad: its own run
  const int src = valid ? perm[pos] : 0;
  // the lowest lane of this lane's run inside the warp
  const int up = __shfl_up_sync(0xffffffffu, r, 1);
  const bool head = lane == 0 || up != r;
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  const int run0 = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
  const int down = __shfl_down_sync(0xffffffffu, r, 1);
  const bool end = valid && (threadIdx.x == kTile - 1 || pos == n - 1 ||
                             (lane < 31 ? down : seg[pos + 1]) != r);
  if (lane == 0) first[warp] = r;
  if (lane == 31) last[warp] = r;
  __syncthreads();
  // the run of this lane continues from the warps below, over how many
  const bool from_below = run0 == 0 && warp > 0 && last[warp - 1] == r;
  int below = 0;
  if (from_below) {
    below = 1;
    while (warp - below > 0 && first[warp - below] == r &&
           last[warp - below - 1] == r) {
      ++below;
    }
  }
  for (int c = 0; c < n_ch; ++c) {
    float v = valid ? g[(size_t)c * n + src] : 0.0f;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float w = __shfl_up_sync(0xffffffffu, v, s);
      if (lane - s >= run0) v = v + w;
    }
    if (lane == 31) tail[c & 1][warp] = v;
    __syncthreads();
    if (from_below) {
      // the warps below in warp order: the lowest first
      float carry = tail[c & 1][warp - below];
      for (int w = warp - below + 1; w < warp; ++w) carry = carry + tail[c & 1][w];
      v = carry + v;
    }
    if (end) part[(size_t)c * n + pos] = v;
  }
}

// the sum of row r's runs of channel c, tiles t0 .. t1 (ascending)
__device__ __forceinline__ float runs(const float* part, size_t c_off, int t,
                                      int t1, int e) {
  float s = 0.0f;
  for (; t <= t1; ++t) s = s + part[c_off + min(e, (t + 1) * kTile) - 1];
  return s;
}

__global__ void __launch_bounds__(kRowThreads)
row_sums(const float* __restrict__ part, const int* __restrict__ off,
         float* __restrict__ out, int n_ch, int n, int n_rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowThreads + threadIdx.x;
  const bool has = row < n_rows;
  const int a = has ? off[row] : 0, e = has ? off[row + 1] : 0;
  const int t0 = a / kTile, t1 = e > a ? (e - 1) / kTile : t0 - 1;
  const bool heavy = t1 - t0 + 1 > kHeavy;
  if (has && !heavy) {
    for (int c = 0; c < n_ch; ++c) {
      out[(size_t)c * n_rows + row] = runs(part, (size_t)c * n, t0, t1, e);
    }
  }
  unsigned todo = __ballot_sync(0xffffffffu, has && heavy);
  while (todo) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    const int lt0 = __shfl_sync(0xffffffffu, t0, l);
    const int lt1 = __shfl_sync(0xffffffffu, t1, l);
    const int le = __shfl_sync(0xffffffffu, e, l);
    const int lrow = __shfl_sync(0xffffffffu, row, l);
    for (int c = 0; c < n_ch; ++c) {
      const size_t c_off = (size_t)c * n;
      float s = 0.0f;
      for (int t = lt0 + lane; t <= lt1; t += 32) {
        s = s + part[c_off + min(le, (t + 1) * kTile) - 1];
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, m);
      if (lane == 0) out[(size_t)c * n_rows + lrow] = s;
    }
  }
}

}  // namespace

// g (n_ch, n) f32 cotangents in ray order; perm (n,) i32, the stable
// sort's permutation of the index (sorted entry j is ray perm[j]); seg
// (n,) i32, the sorted index; off (n_rows + 1,) i32, each row's first
// sorted entry (off[n_rows] = n); part (n_ch, n) f32 scratch; out
// (n_ch, n_rows) f32, every entry written (0 for a row no ray took).
// Launches tile_sums then row_sums on `stream` without synchronising and
// returns the first failing launch's cudaError_t.
extern "C" int raytpu_segment_sum(const float* g, const int* perm,
                                  const int* seg, const int* off, float* part,
                                  float* out, int n_ch, int n, int n_rows,
                                  void* stream) {
  if (n_ch < 0 || n < 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_ch == 0 || n_rows == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    tile_sums<<<(n + kTile - 1) / kTile, kTile, 0, st>>>(g, perm, seg, part,
                                                         n_ch, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  row_sums<<<(n_rows + kRowThreads - 1) / kRowThreads, kRowThreads, 0, st>>>(
      part, off, out, n_ch, n, n_rows);
  return (int)cudaGetLastError();
}

// out[0] = kTile, the sorted entries a block of tile_sums takes; out[1] =
// kHeavy, the tiles past which row_sums sums a row by the warp.
extern "C" void raytpu_segment_sum_tiles(int* out) {
  out[0] = kTile;
  out[1] = kHeavy;
}
