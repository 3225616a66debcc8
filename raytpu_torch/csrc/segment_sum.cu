// The segment sum of the scan path's gather backward: the table
// cotangents of every winner gather (raytpu_torch/kernels/gather.py), in a
// fixed order and without float atomics.
//
// Replaces no TPU kernel. raytpu's scan path gathers each winner's scene
// rows by one-hot products (core/gather.py) whose transposes XLA sums in a
// fixed order; the port's gathers are indexed loads, whose transpose is a
// scatter-add. PyTorch's (index_add_) adds with float atomics, so two
// backward runs differ by rounding, and a few rows hit by a million rays
// serialise them. So each index is sorted once, stably (index_sort.cu:
// the permutation, the sorted rows and each row's segment
// [off[r], off[r + 1]) of the sorted order), and this kernel sums each
// row's segment of every channel in ray order by a fixed tree.
//
// What bounds it: bytes. C channels of B cotangents read once (through the
// permutation), the permutation, the sorted rows and n + 1 offsets, and
// C x n sums written; one add an entry. The channels are read where
// autograd left them: their pointers ride in the kernel's parameters, no
// stacked copy. Three launches:
//   * tile_sums, level 0: a block of kTile threads takes kTile consecutive
//     sorted entries and, kGroup channels at a time (their loads in flight
//     together, one __syncthreads a group), scans each row's run inside the
//     tile: a segmented inclusive scan in each warp (five shuffles, each
//     lane adding the lane s below only inside its own run), then the runs
//     that cross warps carried from the warps below in warp order. The last
//     entry of each run in the tile writes the run's sum to the scratch
//     plane `part` at its own position;
//   * tile_sums, level 1: the same scan over the tiles' last entries (each
//     tile's partial of the row that reaches its end, keyed by that row),
//     kTile tiles a block, into `part1`: a row that spans many tiles gets
//     one partial a kTile tiles;
//   * row_sums: a thread a row adds its level-0 partials (one a tile its
//     segment touches) in tile order; a row that touches more than kHeavy
//     tiles is the warp's: lane l adds its level-1 partials l, l + 32, ...
//     in order, a butterfly of five shuffles joins the lanes, and the
//     row's own partial in its last tile, if that tile's end is not the
//     row's, comes last. So a row of a million entries costs each lane a
//     few loads a channel, where one warp used to walk its 4,000 tiles.
// Every addition's operands and order depend only on the sorted index, so
// two launches on the same inputs give the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (raytpu_torch/kernels/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 256;          // entries a block of tile_sums
constexpr int kWarps = kTile / 32;
constexpr int kGroup = 4;           // channels whose loads are in flight together
constexpr int kMaxCh = 32;          // channels a launch
constexpr int kRowThreads = 256;
constexpr int kHeavy = 8;           // tiles past which a row is the warp's

struct Channels {
  const float* p[kMaxCh];
};

// level 0: sorted entry pos is ray perm[pos] of row seg[pos]
struct Entries {
  const int* perm;
  const int* seg;
  __device__ int key(int pos) const { return seg[pos]; }
  __device__ int at(int pos) const { return perm[pos]; }
  __device__ float value(const float* const* chan, int c, int at) const {
    return chan[c][at];
  }
};

// level 1: entry t is tile t's last entry, its level-0 partial
struct Tiles {
  const float* part;
  const int* seg;
  int n;
  __device__ int last(int t) const { return min((t + 1) * kTile, n) - 1; }
  __device__ int key(int t) const { return seg[last(t)]; }
  __device__ int at(int t) const { return last(t); }
  __device__ float value(const float* const*, int c, int at) const {
    return part[(size_t)c * n + at];
  }
};

template <class Src>
__global__ void __launch_bounds__(kTile)
tile_sums(Src src, Channels ch, float* __restrict__ out, int n_ch, int len) {
  __shared__ float tail[2][kGroup][kWarps];
  __shared__ int first[kWarps], last[kWarps];
  __shared__ const float* chan[kMaxCh];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) chan[c] = ch.p[c];
  }
  const int pos = blockIdx.x * kTile + threadIdx.x;
  const bool valid = pos < len;
  const int r = valid ? src.key(pos) : -1 - (int)threadIdx.x;   // a pad: its own run
  const int at = valid ? src.at(pos) : 0;
  // the lowest lane of this lane's run inside the warp
  const int up = __shfl_up_sync(kFull, r, 1);
  const bool head = lane == 0 || up != r;
  const unsigned heads = __ballot_sync(kFull, head);
  const int run0 = 31 - __clz(heads & (kFull >> (31 - lane)));
  const int down = __shfl_down_sync(kFull, r, 1);
  const bool end = valid && (threadIdx.x == kTile - 1 || pos == len - 1 ||
                             (lane < 31 ? down : src.key(pos + 1)) != r);
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
  for (int c0 = 0, buf = 0; c0 < n_ch; c0 += kGroup, buf ^= 1) {
    float v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      v[k] = valid && c0 + k < n_ch ? src.value(chan, c0 + k, at) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const float w = __shfl_up_sync(kFull, v[k], s);
        if (lane - s >= run0) v[k] = v[k] + w;
      }
      if (lane == 31) tail[buf][k][warp] = v[k];
    }
    __syncthreads();
    if (from_below) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        // the warps below in warp order: the lowest first
        float carry = tail[buf][k][warp - below];
        for (int w = warp - below + 1; w < warp; ++w) {
          carry = carry + tail[buf][k][w];
        }
        v[k] = carry + v[k];
      }
    }
    if (end) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (c0 + k < n_ch) out[(size_t)(c0 + k) * len + pos] = v[k];
      }
    }
  }
}

__global__ void __launch_bounds__(kRowThreads)
row_sums(const float* __restrict__ part, const float* __restrict__ part1,
         const int* __restrict__ off, float* __restrict__ out, int n_ch,
         int n, int n_rows) {
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n + kTile - 1) / kTile;
  const int row = blockIdx.x * kRowThreads + threadIdx.x;
  const bool has = row < n_rows;
  const int a = has ? off[row] : 0, e = has ? off[row + 1] : 0;
  const int t0 = a / kTile, t1 = e > a ? (e - 1) / kTile : t0 - 1;
  const bool heavy = t1 - t0 + 1 > kHeavy;
  if (has && !heavy) {
    for (int c0 = 0; c0 < n_ch; c0 += kGroup) {
      float s[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) s[k] = 0.0f;
#pragma unroll
      for (int j = 0; j < kHeavy; ++j) {
        if (t0 + j <= t1) {
          const int at = min(e, (t0 + j + 1) * kTile) - 1;
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            if (c0 + k < n_ch) s[k] = s[k] + part[(size_t)(c0 + k) * n + at];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (c0 + k < n_ch) out[(size_t)(c0 + k) * n_rows + row] = s[k];
      }
    }
  }
  unsigned todo = __ballot_sync(kFull, has && heavy);
  while (todo) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    const int le = __shfl_sync(kFull, e, l);
    const int lt0 = __shfl_sync(kFull, t0, l), lt1 = __shfl_sync(kFull, t1, l);
    const int lrow = __shfl_sync(kFull, row, l);
    // the row's tiles whose last entry is its own: t0 .. last_t; their
    // level-1 run ends at tile last_t, one partial a kTile tiles
    const bool ends_tile = le == min((lt1 + 1) * kTile, n);
    const int last_t = ends_tile ? lt1 : lt1 - 1;
    const int u0 = lt0 / kTile, u1 = last_t / kTile;
    for (int c0 = 0; c0 < n_ch; c0 += kGroup) {
      float s[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) s[k] = 0.0f;
      for (int u = u0 + lane; u <= u1; u += 32) {
        const int at = min(last_t + 1, (u + 1) * kTile) - 1;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (c0 + k < n_ch) s[k] = s[k] + part1[(size_t)(c0 + k) * n_tiles + at];
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
          s[k] = s[k] + __shfl_xor_sync(kFull, s[k], m);
        }
        if (c0 + k < n_ch) {
          if (!ends_tile) s[k] = s[k] + part[(size_t)(c0 + k) * n + le - 1];
          if (lane == 0) out[(size_t)(c0 + k) * n_rows + lrow] = s[k];
        }
      }
    }
  }
}

}  // namespace

// chans: n_ch (<= kMaxCh) pointers to (n,) f32 cotangents in ray order;
// perm (n,) i32, the stable sort's permutation of the index (sorted entry
// j is ray perm[j]); seg (n,) i32, the sorted index; off (n_rows + 1,)
// i32, each row's first sorted entry (off[n_rows] = n); part f32 scratch
// of n_ch x (n + ceil(n / kTile)); out (n_ch, n_rows) f32, every entry
// written (0 for a row no ray took). Launches both levels of tile_sums
// then row_sums on `stream` without synchronising and returns the first
// failing launch's cudaError_t.
extern "C" int raytpu_segment_sum(const float* const* chans, const int* perm,
                                  const int* seg, const int* off, float* part,
                                  float* out, int n_ch, int n, int n_rows,
                                  void* stream) {
  if (n_ch < 0 || n_ch > kMaxCh || n < 0 || n_rows < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_ch == 0 || n_rows == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (n + kTile - 1) / kTile;
  float* part1 = part + (size_t)n_ch * n;
  Channels ch = {};
  for (int c = 0; c < n_ch; ++c) ch.p[c] = chans[c];
  if (n > 0) {
    tile_sums<Entries><<<n_tiles, kTile, 0, st>>>(Entries{perm, seg}, ch,
                                                  part, n_ch, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tile_sums<Tiles><<<(n_tiles + kTile - 1) / kTile, kTile, 0, st>>>(
        Tiles{part, seg, n}, ch, part1, n_ch, n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  row_sums<<<(n_rows + kRowThreads - 1) / kRowThreads, kRowThreads, 0, st>>>(
      part, part1, off, out, n_ch, n, n_rows);
  return (int)cudaGetLastError();
}

// out[0] = kTile, the sorted entries a block of tile_sums takes; out[1] =
// kHeavy, the tiles past which row_sums sums a row by the warp from its
// level-1 partials; out[2] = kMaxCh, the channels a launch.
extern "C" void raytpu_segment_sum_tiles(int* out) {
  out[0] = kTile;
  out[1] = kHeavy;
  out[2] = kMaxCh;
}
