// Pairwise merged-bottom-k statistics: one thread per (row, col) pair.
//
// Replaces the TPU kernel galah_tpu/ops/pallas_pairwise.py
// (tile_stats_pallas / _make_kernel; tile_intersect_pallas is its
// intersect form). For sorted, sentinel-padded rows a and b of width K
// it computes what ops/pairwise._pair_stats computes:
//   pos_b(i)  = #(b < a_i)            (searchsorted, left)
//   match(i)  = a_i valid and b[pos_b(i)] == a_i
//   cexcl(i)  = #(match before i)
//   urank(i)  = i + pos_b(i) - cexcl(i)   (rank of a_i in the union)
//   total     = min(sketch_size, na + nb - #match)
//   common    = #(match & urank < total)
// With `intersect` it reports common = #match (|a ∩ b|, the marker
// screen's count) and total = na. The TPU kernel compared whole blocks
// densely because Mosaic has no dynamic indexing; here each thread
// walks its column's b with a pointer that only moves forward, so a
// pair costs O(K) compares instead of O(K^2).
//
// Layout: block (x, y) takes row y and 128 consecutive columns. The
// row is staged through shared memory in tiles of kTile values, which
// every thread of the block then reads as a broadcast; each thread's
// b pointer persists across tiles. Hashes are biased int64 (u64 ^
// 2^63); INT64_MAX is the sentinel, so a row's valid values are its
// prefix before the first INT64_MAX.
//
// Bound: bytes moved are (Br + Bc) * K * 8 in and 8 per pair out; the
// walks do O(K) dependent compares per pair, so at the screen's shapes
// the kernel is bound by those compares, not by memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

__device__ int valid_prefix(const long long* v, int k) {
  int lo = 0, hi = k;  // first index holding the sentinel
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < INT64_MAX) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One forward walk of b against the row's valid prefix. With
// total < 0 it counts matches; otherwise it counts matches whose union
// rank is below total.
__device__ int walk(const long long* __restrict__ a,
                    const long long* __restrict__ b, int k, int na,
                    bool live, int total, long long* tile) {
  int j = 0, count = 0, cexcl = 0;
  for (int t0 = 0; t0 < na; t0 += kTile) {
    const int tn = min(kTile, na - t0);
    __syncthreads();
    for (int s = threadIdx.x; s < tn; s += blockDim.x) tile[s] = a[t0 + s];
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < tn; ++s) {
      const long long x = tile[s];
      while (j < k && b[j] < x) ++j;
      if (j < k && b[j] == x) {
        if (total < 0) {
          ++count;
        } else {
          const int urank = (t0 + s) + j - cexcl;
          if (urank < total) ++count;
          ++cexcl;
        }
      }
    }
  }
  return count;
}

__global__ void tile_stats_kernel(const long long* __restrict__ rows,
                                  const long long* __restrict__ cols,
                                  int br, int bc, int k, int sketch_size,
                                  int intersect, int* __restrict__ common,
                                  int* __restrict__ total) {
  __shared__ long long tile[kTile];
  __shared__ int na_s;
  const int row = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = col < bc;
  const long long* a = rows + static_cast<size_t>(row) * k;
  const long long* b = cols + static_cast<size_t>(live ? col : 0) * k;
  if (threadIdx.x == 0) na_s = valid_prefix(a, k);
  __syncthreads();
  const int na = na_s;
  const int n_match = walk(a, b, k, na, live, -1, tile);
  if (intersect) {
    if (live) {
      common[static_cast<size_t>(row) * bc + col] = n_match;
      total[static_cast<size_t>(row) * bc + col] = na;
    }
    return;
  }
  const int nb = live ? valid_prefix(b, k) : 0;
  const int tot = min(sketch_size, na + nb - n_match);
  const int c = walk(a, b, k, na, live, tot, tile);
  if (live) {
    common[static_cast<size_t>(row) * bc + col] = c;
    total[static_cast<size_t>(row) * bc + col] = tot;
  }
}

}  // namespace

extern "C" int tile_stats_launch(const void* rows, const void* cols,
                                 int br, int bc, int k, int sketch_size,
                                 int intersect, void* common, void* total,
                                 void* stream) {
  if (br <= 0 || bc <= 0) return 0;
  if (br > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((bc + kThreads - 1) / kThreads, br);
  tile_stats_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(rows),
      static_cast<const long long*>(cols), br, bc, k, sketch_size,
      intersect, static_cast<int*>(common), static_cast<int*>(total));
  return static_cast<int>(cudaGetLastError());
}
