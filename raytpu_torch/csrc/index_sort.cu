// The plan of the gathers' segment sum (raytpu_torch/kernels/gather.py,
// GatherIndex.sorted_plan): the stable sort of an index of n entries, each
// a row in [0, n_rows): its permutation perm (sorted entry j is entry
// perm[j]), the sorted rows seg, and each row's first sorted entry off
// (n_rows + 1 of them, the last n). A stable sort has one answer, so the
// plan equals torch.sort(stable=True) + searchsorted bit for bit.
//
// Replaces no TPU kernel: raytpu's gathers are one-hot products whose
// transposes XLA sums (core/gather.py); the port's transposes sum each
// row's cotangents in sorted order (segment_sum.cu), which needs the sort.
//
// What bounds it: bytes. The index read once (8 bytes an entry), perm
// and seg written once, off written once (4 bytes a row). The design:
//   * an LSD radix sort of the int32 keys over only their ceil(log2 n_rows)
//     bits, in passes of at most kMaxBits bits (widths as even as
//     possible: one pass at 11 rows, two at 4,096, three at 8.4 M). The
//     first pass reads the index itself and takes its position as value;
//     the last writes seg and perm;
//   * each pass in three kernels: isort_count (a block's digit counts over
//     its kTile entries, by warp-aggregated integer atomics in shared
//     memory: exact) into counts[digit][block]; isort_scan (a block a
//     digit: the exclusive scan of its counts over blocks, and its total);
//     isort_scatter (a block's bases: the exclusive scan of the totals
//     over digits plus its scanned counts; each warp ranks its kWarpSpan
//     consecutive entries 32 at a time, in position order: a lane's rank
//     is the lanes below it with the same digit (ballots over the digit's
//     bits) plus the warp's running count of the digit; the warps below
//     are added in warp order). Where an entry lands depends only on the
//     keys, never on the order of the atomics;
//   * off by row chunks, not by boundaries alone: at 8.4 M rows (the sky's
//     texels) for 1.08 M entries most rows are empty, and the rows past the
//     last texel hit form one gap of millions that one boundary thread
//     would write alone. isort_chunks: a warp a chunk of kRowChunk rows
//     finds the chunk's first sorted entry by a 32-ary search of seg;
//     isort_offsets: a block a chunk stages the chunk's sorted entries in
//     shared memory (past kStage of them it reads them where they are) and
//     each row's first entry is a binary search there; off is written
//     once, in order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (raytpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // entries a thread in a pass
constexpr int kTile = kThreads * kItems;    // entries a block in a pass
constexpr int kWarpSpan = 32 * kItems;      // consecutive entries a warp
constexpr int kMaxBits = 8;                 // key bits a pass
constexpr int kDigits = 1 << kMaxBits;      // == kThreads: a thread a digit
constexpr int kRowChunk = 1024;             // rows a block of isort_offsets
constexpr int kStage = 4096;                // sorted entries it stages

static_assert(kDigits == kThreads, "a thread a digit in the scans");

__device__ __forceinline__ int digit_of(int key, int shift, int width) {
  return (int)(((uint32_t)key >> shift) & ((1u << width) - 1u));
}

// the lanes of `active` whose digit is this lane's (every lane calls it)
__device__ __forceinline__ unsigned peers_of(int d, int width,
                                             unsigned active) {
  unsigned m = active;
#pragma unroll
  for (int b = 0; b < kMaxBits; ++b) {
    if (b < width) {
      const unsigned set = __ballot_sync(kFull, (d >> b) & 1);
      m &= ((d >> b) & 1) ? set : ~set;
    }
  }
  return m;
}

// exclusive scan of one int a thread over the block, in thread order;
// `sum` is kWarps ints of shared memory. Ends with a __syncthreads.
__device__ __forceinline__ int block_exclusive(int v, int* sum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(kFull, x, s);
    if (lane >= s) x += y;
  }
  if (lane == 31) sum[warp] = x;
  __syncthreads();
  int below = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = sum[w];
    if (w < warp) below += s;
    total += s;
  }
  __syncthreads();
  return below + x - v;
}

template <typename Key>
__global__ void __launch_bounds__(kThreads)
isort_count(const Key* __restrict__ keys, int n, int shift, int width,
            int* __restrict__ counts, int n_blocks) {
  __shared__ int hist[kDigits];
  const int lane = threadIdx.x & 31;
  hist[threadIdx.x] = 0;
  const int base = blockIdx.x * kTile + threadIdx.x;
  int d[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = base + i * kThreads;
    d[i] = pos < n ? digit_of((int)keys[pos], shift, width) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = base + i * kThreads < n;
    const unsigned peers = peers_of(d[i], width, __ballot_sync(kFull, valid));
    if (valid && (peers & ((1u << lane) - 1u)) == 0u) {
      atomicAdd(&hist[d[i]], __popc(peers));   // the lowest lane of its digit
    }
  }
  __syncthreads();
  if (threadIdx.x < (1 << width)) {
    counts[(size_t)threadIdx.x * n_blocks + blockIdx.x] = hist[threadIdx.x];
  }
}

// a block a digit: its counts over the blocks, exclusive-scanned in block
// order in place; totals[digit] their sum
__global__ void __launch_bounds__(kThreads)
isort_scan(int* __restrict__ counts, int n_blocks, int* __restrict__ totals) {
  __shared__ int sum[kWarps];
  int* row = counts + (size_t)blockIdx.x * n_blocks;
  int carry = 0;
  for (int b0 = 0; b0 < n_blocks; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    int total;
    const int below = block_exclusive(b < n_blocks ? row[b] : 0, sum, total);
    if (b < n_blocks) row[b] = carry + below;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

template <typename Key>
__global__ void __launch_bounds__(kThreads)
isort_scatter(const Key* __restrict__ keys_in, const int* __restrict__ vals_in,
              int* __restrict__ keys_out, int* __restrict__ vals_out, int n,
              int shift, int width, const int* __restrict__ counts,
              const int* __restrict__ totals, int n_blocks) {
  // each warp's running counts of the digits, then its first positions
  __shared__ int run[kWarps][kDigits];
  __shared__ int sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_digits = 1 << width;
  const int first = blockIdx.x * kTile + warp * kWarpSpan + lane;
  int key[kItems], val[kItems], rank[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = first + i * 32;
    key[i] = pos < n ? (int)keys_in[pos] : 0;
    val[i] = pos < n ? (vals_in != nullptr ? vals_in[pos] : pos) : 0;
  }
#pragma unroll
  for (int e = lane; e < kDigits; e += 32) run[warp][e] = 0;
  // this block's first position of digit threadIdx.x: the digits below it
  // over all blocks, then its own count in the blocks below
  int total;
  const int d_own = threadIdx.x;
  int base = block_exclusive(d_own < n_digits ? totals[d_own] : 0, sum, total);
  if (d_own < n_digits) base += counts[(size_t)d_own * n_blocks + blockIdx.x];
  // ranks in position order: the round's lower lanes of the same digit
  // plus the warp's count of the digit in the rounds before
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = first + i * 32 < n;
    const int d = digit_of(key[i], shift, width);
    const unsigned peers = peers_of(d, width, __ballot_sync(kFull, valid));
    rank[i] = valid ? run[warp][d] + __popc(peers & lower) : 0;
    __syncwarp();
    if (valid && (peers >> lane) == 1u) {   // the highest lane of its digit
      run[warp][d] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  // the warps below in warp order
  if (d_own < n_digits) {
    int acc = base;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = run[w][d_own];
      run[w][d_own] = acc;
      acc += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + i * 32 < n) {
      const int dest = run[warp][digit_of(key[i], shift, width)] + rank[i];
      keys_out[dest] = key[i];
      vals_out[dest] = val[i];
    }
  }
}

// the first j in [lo, hi) with seg[j] >= key, hi if none (seg ascending);
// the whole warp calls it with the same arguments
__device__ int warp_lower_bound(const int* __restrict__ seg, int lo, int hi,
                                int key) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (int)(((unsigned)(hi - lo) + 31u) >> 5);
    const long long j = (long long)lo + (long long)lane * step;
    const int k = __popc(__ballot_sync(kFull, j < hi && seg[j] < key));
    if (k == 0) return lo;
    // samples 0 .. k - 1 lie below key, sample k (if any) does not
    const int next = lo + (k - 1) * step + 1;
    hi = (int)min((long long)hi, (long long)lo + (long long)k * step);
    lo = next;
  }
  const int j = lo + lane;
  return lo + __popc(__ballot_sync(kFull, j < hi && seg[j] < key));
}

// chunk_lo[c] = the first sorted entry of row c * kRowChunk, for c in
// [0, n_chunks] (n past the last key); a warp each
__global__ void __launch_bounds__(kThreads)
isort_chunks(const int* __restrict__ seg, int n, int n_chunks,
             int* __restrict__ chunk_lo) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (c > n_chunks) return;   // the whole warp
  const int at = warp_lower_bound(seg, 0, n, c * kRowChunk);
  if ((threadIdx.x & 31) == 0) chunk_lo[c] = at;
}

// the first of s[0, m) that is >= r, m if none (s ascending)
template <typename P>
__device__ __forceinline__ int lower_bound(P s, int m, int r) {
  int a = 0, b = m;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (s[mid] < r) a = mid + 1; else b = mid;
  }
  return a;
}

// a block a chunk of kRowChunk rows: off[r] for its rows r <= n_rows
__global__ void __launch_bounds__(kThreads)
isort_offsets(const int* __restrict__ seg, const int* __restrict__ chunk_lo,
              int n_rows, int* __restrict__ off) {
  __shared__ int stage[kStage];
  const int lo = chunk_lo[blockIdx.x], m = chunk_lo[blockIdx.x + 1] - lo;
  const int r0 = blockIdx.x * kRowChunk;
  const int rows = min(kRowChunk, n_rows + 1 - r0);
  if (m <= kStage) {
    for (int e = threadIdx.x; e < m; e += kThreads) stage[e] = seg[lo + e];
    __syncthreads();
    for (int k = threadIdx.x; k < rows; k += kThreads) {
      off[r0 + k] = lo + lower_bound(stage, m, r0 + k);
    }
  } else {
    for (int k = threadIdx.x; k < rows; k += kThreads) {
      off[r0 + k] = lo + lower_bound(seg + lo, m, r0 + k);
    }
  }
}

struct Passes {
  int count, width[4], shift[4];
};

Passes passes_for(int n_rows) {
  int bits = 0;
  while (bits < 31 && (1 << bits) < n_rows) ++bits;
  Passes p;
  p.count = bits == 0 ? 1 : (bits + kMaxBits - 1) / kMaxBits;
  for (int i = 0, shift = 0; i < p.count; ++i) {
    p.width[i] = bits / p.count + (i < bits % p.count ? 1 : 0);
    p.shift[i] = shift;
    shift += p.width[i];
  }
  return p;
}

int blocks_for(int n) { return (n + kTile - 1) / kTile; }
int chunks_for(int n_rows) { return (n_rows + 1 + kRowChunk - 1) / kRowChunk; }

}  // namespace

// out[0] = int32 scratch entries raytpu_index_sort needs for n entries and
// n_rows rows (two planes of n, the digit counts and totals, the chunk
// starts); out[1] = its radix passes; out[2] = kTile; out[3] = kRowChunk.
extern "C" void raytpu_index_sort_sizes(int n, int n_rows, long long* out) {
  const Passes p = passes_for(n_rows);
  out[0] = 2LL * n + (long long)kDigits * blocks_for(n) + kDigits +
           chunks_for(n_rows) + 1;
  out[1] = p.count;
  out[2] = kTile;
  out[3] = kRowChunk;
}

// idx (n,) int64, every entry in [0, n_rows); perm, seg (n,) int32; off
// (n_rows + 1,) int32; scratch int32 of raytpu_index_sort_sizes' count.
// Launches every pass, then the offsets, on `stream` without
// synchronising; returns the first failing launch's cudaError_t.
extern "C" int raytpu_index_sort(const long long* idx, int n, int n_rows,
                                 int* perm, int* seg, int* off, int* scratch,
                                 void* stream) {
  if (n < 0 || n_rows < 1 || n_rows > (1 << 30) || n > 0x7fffffff - kTile) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const Passes p = passes_for(n_rows);
  const int n_blocks = blocks_for(n), n_chunks = chunks_for(n_rows);
  int* k_tmp = scratch;
  int* v_tmp = scratch + n;
  int* counts = scratch + 2LL * n;
  int* totals = counts + (size_t)kDigits * n_blocks;
  int* chunk_lo = totals + kDigits;
  cudaError_t err = cudaSuccess;
  if (n > 0) {
    // the last pass writes seg and perm, the one before the scratch planes
    int* k_out[2] = {seg, k_tmp};
    int* v_out[2] = {perm, v_tmp};
    int to = (p.count - 1) & 1;
    for (int i = 0; i < p.count; ++i) {
      const int from = to;
      if (i > 0) to ^= 1;
      // the first pass reads the index and takes positions as values
      if (i == 0) {
        isort_count<long long><<<n_blocks, kThreads, 0, st>>>(
            idx, n, p.shift[0], p.width[0], counts, n_blocks);
      } else {
        isort_count<int><<<n_blocks, kThreads, 0, st>>>(
            k_out[from], n, p.shift[i], p.width[i], counts, n_blocks);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      isort_scan<<<1 << p.width[i], kThreads, 0, st>>>(counts, n_blocks,
                                                       totals);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      if (i == 0) {
        isort_scatter<long long><<<n_blocks, kThreads, 0, st>>>(
            idx, nullptr, k_out[to], v_out[to], n, p.shift[0], p.width[0],
            counts, totals, n_blocks);
      } else {
        isort_scatter<int><<<n_blocks, kThreads, 0, st>>>(
            k_out[from], v_out[from], k_out[to], v_out[to], n, p.shift[i],
            p.width[i], counts, totals, n_blocks);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  isort_chunks<<<(32 * (n_chunks + 1) + kThreads - 1) / kThreads, kThreads, 0,
                 st>>>(seg, n, n_chunks, chunk_lo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  isort_offsets<<<n_chunks, kThreads, 0, st>>>(seg, chunk_lo, n_rows, off);
  return (int)cudaGetLastError();
}
