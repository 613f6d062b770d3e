// Window membership for fragment ANI: a merge-path intersection of
// sorted runs.
//
// Replaces the TPU kernel galah_tpu/ops/pallas_fragment.py
// (_window_hits_jit / _make_fragment_kernel). That kernel could not
// index dynamically, so the host planned which reference blocks each
// block of 1024 sorted queries might hit and the kernel compared them
// densely. Both sides of a pair are sorted (the query with duplicates,
// one k-mer in several windows; the reference distinct), so membership
// is a merge.
//
// Partition ("Merge Path": Green, McColl & Bader 2012; Odeh et al.
// 2012). Pair p merges its query q (nq values) with its reference set r
// (nr values) and is cut along merge diagonals into segments of
// kSegment = 256 x 15 merged items, one block each, so the host plan is
// O(pairs): per pair its addresses, lengths, output offset and the
// running end of its blocks (ops/window_hits.py, plan_launch). A pair
// with nq = 0 has no block. Block b finds its pair by a 32-way warp
// search over the block ends, and the co-ranks (qi, ri) of both ends of
// its segment by a 32-way warp search along each diagonal in device
// memory (warp 0 the start, warp 1 the end; ~log32(nq) rounds of 32
// loads at once).
//
// Tie rule: on equal values the r element merges first. A query value
// then hits iff the last r element merged before it equals it. A block
// stages the one r element just before its segment as a halo, so a run
// of equal query values that crosses a segment boundary still hits.
// INT64_MAX, the sentinel, never hits; an empty r gives all zeros.
//
// Data movement. The block copies its q slice and its r slice (at most
// kSegment values together, 30 KB) into shared memory with cp.async, 16
// bytes a copy (stage.cuh). Each thread takes 15 consecutive merged
// items, finds its own co-rank by binary search in shared memory and
// merges them sequentially, loading one value a step (the side that
// moved) and keeping its hits as a bit mask. The flags then go through
// shared memory so that the block writes them to device memory
// coalesced. Every segment has the same size, so no tile can overflow
// shared memory whatever the ratio of nq to nr.
//
// Bound: each pair reads q and r once and writes 4 bytes a query value,
// 8 (nq + nr) + 4 nq bytes, ~2.7 GB at the exact-ANI stage's largest
// launch (67 pairs of ~2 M values a side): 0.8 ms at 3.35 TB/s. What
// keeps it above that is the shared-memory side: the per-thread co-rank
// search (~12 levels) and merge make ~35 instructions and two
// data-dependent 8-byte loads a merged item, whose lanes hit shared
// memory banks at random. Three other designs ran slower on the card:
// 32-bit high and low planes staged through registers, a binary search
// in the r slice per query value, and segments of 256 x 31 or 512 x 15
// items. nvcc -Xptxas -v (sm_90a): 40 registers, 30,768 bytes of static
// shared memory, no spills; 6 blocks of 256 threads an SM (registers).
//
// Hashes are biased int64 (u64 ^ 2^63), so signed compares order them
// as u64.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"


namespace {

constexpr int kThreads = 256;
constexpr int kItems = 15;  // odd, so threads' runs spread over banks
constexpr int kSegment = kThreads * kItems;
constexpr long long kSentinel = INT64_MAX;

// Rows of the (6, n_pairs) int64 plan.
enum PlanRow { kQAddr, kQLen, kRAddr, kRLen, kOutOff, kBlkEnd, kPlanRows };

// First m in [lo, hi) with pred(m) false, or hi; pred is true, then
// false, over [lo, hi). Called by a whole warp; 32 probes a round.
template <class Pred>
__device__ long long warp_partition_point(long long lo, long long hi,
                                          Pred pred) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long len = hi - lo;
    const unsigned t = __ballot_sync(~0u, pred(lo + len * lane / 32));
    const int c = __popc(t);  // probes 0 .. c-1 are true
    if (c == 0) return lo;
    const long long next_hi = c < 32 ? lo + len * c / 32 : hi;
    lo = lo + len * (c - 1) / 32 + 1;
    hi = next_hi;
  }
  const long long p = lo + lane;
  return lo + __popc(__ballot_sync(~0u, p < hi && pred(p)));
}

// Number of q values among the first d items of the merge of q and r
// (r first on ties).
__device__ long long co_rank(const long long* q, long long nq,
                             const long long* r, long long nr,
                             long long d) {
  const long long lo = d > nr ? d - nr : 0;
  const long long hi = d < nq ? d : nq;
  return warp_partition_point(
      lo, hi, [&](long long m) { return q[m] < r[d - m - 1]; });
}

__global__ void __launch_bounds__(kThreads)
window_hits_kernel(const long long* __restrict__ plan, int n_pairs,
                   int* __restrict__ hits) {
  __shared__ __align__(16) long long buf[kSegment + 4];
  __shared__ long long bounds[2];  // q co-ranks of the segment's ends
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x;
  const long long* blk_end = plan + kBlkEnd * n_pairs;
  const long long p = warp_partition_point(
      0, n_pairs, [&](long long m) { return blk_end[m] <= b; });
  const long long* q = reinterpret_cast<const long long*>(
      plan[kQAddr * n_pairs + p]);
  const long long* r = reinterpret_cast<const long long*>(
      plan[kRAddr * n_pairs + p]);
  const long long nq = plan[kQLen * n_pairs + p];
  const long long nr = plan[kRLen * n_pairs + p];
  const long long local = b - (p > 0 ? blk_end[p - 1] : 0);
  const long long d0 = local * kSegment;
  const long long d1 = min(d0 + kSegment, nq + nr);
  if (warp < 2) {
    const long long d = warp == 0 ? d0 : d1;
    const long long qi = co_rank(q, nq, r, nr, d);
    if ((threadIdx.x & 31) == 0) bounds[warp] = qi;
  }
  __syncthreads();
  const long long qi0 = bounds[0];
  const long long ri0 = d0 - qi0;
  const int nqb = static_cast<int>(bounds[1] - qi0);
  const int nrb = static_cast<int>((d1 - bounds[1]) - ri0);
  if (nqb == 0) return;  // the segment holds reference values only

  // the q slice, then the r slice behind its halo, each placed so that
  // its 16-byte alignment in shared memory matches device memory's
  const int halo = ri0 > 0 ? 1 : 0;
  const int q_off = static_cast<int>(
      (reinterpret_cast<uintptr_t>(q + qi0) >> 3) & 1);
  const int r_off = ((q_off + nqb + 1) & ~1) + static_cast<int>(
      (reinterpret_cast<uintptr_t>(r + ri0 - halo) >> 3) & 1);
  long long* q_s = buf + q_off;
  long long* r_s = buf + r_off + halo;  // r_s[-1] is the halo
  stage_async(q_s, q + qi0, nqb);
  stage_async(r_s - halo, r + ri0 - halo, nrb + halo);
  stage_wait();
  __syncthreads();

  // this thread's merged items [t0, t1) of the segment
  const int t0 = threadIdx.x * kItems;
  const int t1 = min(t0 + kItems, nqb + nrb);
  int i_first = 0, i = 0;
  unsigned mask = 0;  // bit e: query value i_first + e hits
  if (t0 < t1) {
    int lo = max(0, t0 - nrb), hi = min(t0, nqb);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (q_s[mid] < r_s[t0 - mid - 1]) lo = mid + 1; else hi = mid;
    }
    i_first = i = lo;
    int j = t0 - lo;
    bool have = j > 0 || halo;  // an r value merged before item t0
    long long last = have ? r_s[j - 1] : 0;
    long long x = i < nqb ? q_s[i] : 0;
    long long y = j < nrb ? r_s[j] : 0;
    for (int s = t0; s < t1; ++s) {
      const bool take_q = i < nqb && (j >= nrb || x < y);
      if (take_q) {
        if (have && last == x && x != kSentinel) mask |= 1u << (i - i_first);
        ++i;
      } else {
        last = y;
        have = true;
        ++j;
      }
      // one load a step, of the side that moved
      const int k = take_q ? i : j;
      const long long w = k < (take_q ? nqb : nrb) ? (take_q ? q_s : r_s)[k]
                                                   : 0;
      if (take_q) x = w; else y = w;
    }
  }
  __syncthreads();  // every thread is done reading q_s and r_s
  int* flags = reinterpret_cast<int*>(buf);
  for (int e = 0; e < i - i_first; ++e) flags[i_first + e] = (mask >> e) & 1;
  __syncthreads();
  const long long out = plan[kOutOff * n_pairs + p] + qi0;
  for (int e = threadIdx.x; e < nqb; e += kThreads) hits[out + e] = flags[e];
}

}  // namespace

extern "C" int window_hits_launch(const void* plan, int n_pairs,
                                  long long n_blocks, int segment,
                                  void* hits, void* stream) {
  if (segment != kSegment) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks <= 0) return 0;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  window_hits_kernel<<<static_cast<unsigned int>(n_blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(plan), n_pairs,
      static_cast<int*>(hits));
  return static_cast<int>(cudaGetLastError());
}
