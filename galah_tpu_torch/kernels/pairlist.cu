// Merged-bottom-k statistics for an explicit list of row pairs: one
// block per pair.
//
// Replaces the TPU kernel galah_tpu/ops/pallas_pairlist.py
// (_pair_stats_pairs_jit / _make_blocked_kernel). For a sorted,
// sentinel-padded (N, K) sketch matrix and index lists pi, pj it gives
// each pair (a = row pi[p], b = row pj[p]) the integers that
// ops/pairwise._pair_stats gives (and kernels/tile_stats.cu's full
// form):
//   pos_b(i) = #(b < a_i),  match(i) = a_i valid and in b,
//   cexcl(i) = #(match before i),  urank(i) = i + pos_b(i) - cexcl(i),
//   total    = min(sketch_size, na + nb - #match),
//   common   = #(match & urank < total).
// The TPU kernel pooled 8 pairs per program to spread Mosaic's
// per-program cost and compared every a value with every b value
// (O(K^2)); neither carries over. Here the block reads its two rows
// where they lie in the matrix (no gathered copies), stages b in
// shared memory, gives each thread a contiguous run of a's valid
// prefix to binary-search in b, and takes the union ranks' running
// match count from a block-wide exclusive scan.
//
// Hashes are biased int64 (u64 ^ 2^63); INT64_MAX is the sentinel, so
// a row's valid values are its prefix before the first INT64_MAX.
//
// Bound: each pair reads its two rows once (16 K bytes) and writes 8
// bytes; the work is ~na * log2(nb) dependent compares per pair plus
// the staging, so at K = 1000 the rows' bytes bound it when they come
// from device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ int valid_prefix(const long long* v, int k) {
  int lo = 0, hi = k;  // first index holding the sentinel
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < INT64_MAX) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ int lower_bound(const long long* s, int n, long long x) {
  int lo = 0, hi = n;  // first index with s[idx] >= x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Exclusive prefix sum of one int per thread over the block; *sum gets
// the block's total.
__device__ int block_exclusive_scan(int v, int* buf, int* sum) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int add = t >= off ? buf[t - off] : 0;
    __syncthreads();
    buf[t] += add;
    __syncthreads();
  }
  const int inclusive = buf[t];
  *sum = buf[kThreads - 1];
  __syncthreads();
  return inclusive - v;
}

__global__ void __launch_bounds__(kThreads)
pairlist_kernel(const long long* __restrict__ mat, int k,
                const long long* __restrict__ pi,
                const long long* __restrict__ pj, int sketch_size,
                int* __restrict__ common, int* __restrict__ total) {
  extern __shared__ long long sb[];  // the pair's b row
  __shared__ int buf[kThreads];
  __shared__ int na_s, nb_s;
  const int p = blockIdx.x;
  const long long* a = mat + static_cast<size_t>(pi[p]) * k;
  const long long* b = mat + static_cast<size_t>(pj[p]) * k;
  for (int s = threadIdx.x; s < k; s += kThreads) sb[s] = b[s];
  if (threadIdx.x == 0) na_s = valid_prefix(a, k);
  __syncthreads();
  if (threadIdx.x == 0) nb_s = valid_prefix(sb, k);
  __syncthreads();
  const int na = na_s, nb = nb_s;

  // thread t takes a's valid indices [lo, hi), in order
  const int per = (na + kThreads - 1) / kThreads;
  const int lo = min(na, static_cast<int>(threadIdx.x) * per);
  const int hi = min(na, lo + per);
  int n_match = 0;
  for (int i = lo; i < hi; ++i) {
    const long long x = a[i];
    const int pos = lower_bound(sb, nb, x);
    n_match += (pos < nb && sb[pos] == x);
  }
  int all_match;
  int cexcl = block_exclusive_scan(n_match, buf, &all_match);
  const int tot = min(sketch_size, na + nb - all_match);
  int c = 0;
  for (int i = lo; i < hi; ++i) {
    const long long x = a[i];
    const int pos = lower_bound(sb, nb, x);
    if (pos < nb && sb[pos] == x) {
      if (i + pos - cexcl < tot) ++c;
      ++cexcl;
    }
  }
  int all_common;
  block_exclusive_scan(c, buf, &all_common);
  if (threadIdx.x == 0) {
    common[p] = all_common;
    total[p] = tot;
  }
}

}  // namespace

extern "C" int pairlist_launch(const void* mat, int k, const void* pi,
                               const void* pj, int b, int sketch_size,
                               void* common, void* total, void* stream) {
  if (b <= 0) return 0;
  const size_t smem = static_cast<size_t>(k) * sizeof(long long);
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairlist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pairlist_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(mat), k,
      static_cast<const long long*>(pi), static_cast<const long long*>(pj),
      sketch_size, static_cast<int*>(common), static_cast<int*>(total));
  return static_cast<int>(cudaGetLastError());
}
