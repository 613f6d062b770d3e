// Window membership for fragment ANI: one thread per query element.
//
// Replaces the TPU kernel galah_tpu/ops/pallas_fragment.py
// (_window_hits_jit / _make_fragment_kernel). That kernel could not
// index dynamically, so the host planned which reference blocks each
// block of 1024 sorted queries might hit and the kernel compared them
// densely. Here every thread binary-searches its element's pair's
// sorted reference set directly; no host plan is needed and the flags
// are the same integers.
//
// Layout: a launch covers many (query, reference) pairs. Pair p has a
// device address and length for its sorted query hashes and for its
// sorted distinct reference set, and writes q_len[p] int32 flags at
// out_off[p]. Block b covers elements [blk_start[b], blk_start[b] +
// 256) of pair blk_pair[b]. Hashes are biased int64 (u64 ^ 2^63), so
// signed compares order them as u64; INT64_MAX is the sentinel and
// never hits.
//
// Bound: the searches are a chain of dependent loads (log2 |ref| per
// element) into a reference set that neighbouring threads share, since
// the queries are sorted; it is bound by load latency through L2, not
// by the bytes it must move (8 B in and 4 B out per element).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void window_hits_kernel(
    const unsigned long long* __restrict__ q_addr,
    const long long* __restrict__ q_len,
    const unsigned long long* __restrict__ r_addr,
    const long long* __restrict__ r_len,
    const long long* __restrict__ out_off,
    const int* __restrict__ blk_pair,
    const long long* __restrict__ blk_start,
    int* __restrict__ hits) {
  const int p = blk_pair[blockIdx.x];
  const long long i = blk_start[blockIdx.x] + threadIdx.x;
  if (i >= q_len[p]) return;
  const long long* q = reinterpret_cast<const long long*>(q_addr[p]);
  const long long* r = reinterpret_cast<const long long*>(r_addr[p]);
  const long long x = q[i];
  const long long n = r_len[p];
  int hit = 0;
  if (x != INT64_MAX && n > 0) {
    long long lo = 0, hi = n;  // lower bound of x in r[0, n)
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (r[mid] < x) lo = mid + 1; else hi = mid;
    }
    hit = (lo < n) && (r[lo] == x);
  }
  hits[out_off[p] + i] = hit;
}

}  // namespace

extern "C" int window_hits_launch(
    const void* q_addr, const void* q_len, const void* r_addr,
    const void* r_len, const void* out_off, const void* blk_pair,
    const void* blk_start, void* hits, long long n_blocks,
    void* stream) {
  if (n_blocks <= 0) return 0;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  window_hits_kernel<<<static_cast<unsigned int>(n_blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(q_addr),
      static_cast<const long long*>(q_len),
      static_cast<const unsigned long long*>(r_addr),
      static_cast<const long long*>(r_len),
      static_cast<const long long*>(out_off),
      static_cast<const int*>(blk_pair),
      static_cast<const long long*>(blk_start),
      static_cast<int*>(hits));
  return static_cast<int>(cudaGetLastError());
}
