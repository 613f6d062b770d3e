// Merged-bottom-k statistics for an explicit list of row pairs: a warp
// per pair, kWarps pairs a block.
//
// Replaces the TPU kernel galah_tpu/ops/pallas_pairlist.py
// (_pair_stats_pairs_jit / _make_blocked_kernel). For a sorted,
// sentinel-padded (N, K) sketch matrix, each row's valid length and
// index lists pi, pj it gives each pair (a = row pi[p], b = row pj[p])
// the integers that ops/pairwise._pair_stats gives (and
// kernels/tile_stats.cu's full form):
//   total  = min(sketch_size, na + nb - #match),
//   common = #(match & union rank < total).
// The TPU kernel pooled 8 pairs a program and compared every a value
// with every b chunk, because Mosaic has no dynamic indexing; neither
// carries over.
//
// Design. Warp w of block blk takes pair p = blk * kWarps + w and runs
// merge_walk.cuh's merge path over the two valid prefixes: the 32
// lanes split the na + nb merged items along merge diagonals and walk
// their segments, loading one value a step; the segment that straddles
// the union rank `total` is split across the warp again, and one lane
// walks the last piece. Valid lengths come from one pass over the
// matrix (the wrapper's `lens`), not from a search a pair.
// Rows: the collision screen emits pairs sorted by pi, then pj, so the
// warps of a block mostly share their a row. The block stages the a
// row of its first pair in shared memory (its valid prefix and a
// sentinel, cp.async, stage.cuh), and each warp that shares it stages
// its own b row beside it: the walk's loads are then ld.shared by
// 32-bit address. A warp whose pi differs reads both rows in place,
// so any order of the list is right. Lists shorter than
// kMinStagedPairs, and rows wider than kMaxStagedK, are read in place
// altogether (through L1 and L2).
//
// Bound: each pair reads its two valid prefixes (16 K bytes at most,
// from L2 when the matrix fits there) and writes 8 bytes. A walk step
// is ~16 instructions (a 64-bit compare, selects, one dependent load)
// for 32 lanes; its shared-memory load goes to 32 lanes at random
// offsets, ~6 bank-conflict wavefronts, so the shared-memory pipe, not
// device memory, bounds the staged kernel. On an H100 at a
// dense-similarity list (2,096,128 pairs of 2,048 rows, K = 1000) it
// takes 5.92 ms, the in-place plan 9.32 ms, 8 pairs a block 6.27 ms
// and one merge-path level 7.54 ms (kernels/rehearse_pairlist.py).
// nvcc -Xptxas -v (sm_90a): 40 registers, no spills, for both kernels.
//
// Hashes are biased int64 (u64 ^ 2^63); INT64_MAX is the sentinel.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_walk.cuh"
#include "stage.cuh"

namespace {

using merge_walk::DeviceRow;
using merge_walk::kSentinel;
using merge_walk::merge_stats;
using merge_walk::SharedRow;

constexpr int kWarps = 6;           // pairs a block, one warp each
constexpr int kMaxStagedK = 1536;   // widest K staged (two blocks an SM)
// shorter lists fill the card about a wave at a time, so each block's
// staging would show as latency; they read their rows in place
constexpr int kMinStagedPairs = 16384;

template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32)
pairlist_kernel(const long long* __restrict__ mat, int k,
                const int* __restrict__ lens,
                const long long* __restrict__ pi,
                const long long* __restrict__ pj, int b, int sketch_size,
                int* __restrict__ common, int* __restrict__ total) {
  extern __shared__ __align__(16) long long smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long p0 = static_cast<long long>(blockIdx.x) * kWarps;
  const long long p = p0 + warp;
  const bool live = p < b;
  const long long ia = live ? pi[p] : 0, ib = live ? pj[p] : 0;
  const int na = live ? lens[ia] : 0, nb = live ? lens[ib] : 0;
  // slot 0: the block's a row, the row of its first pair; slot 1 + w:
  // warp w's b row; each a valid prefix followed by the sentinel
  long long* sb = smem + static_cast<size_t>(1 + warp) * ((k + 2) & ~1);
  bool staged = false;
  if (kStaged) {
    const long long ra = pi[p0];
    const int la = lens[ra];
    stage_async(smem, mat + ra * k, la);
    if (threadIdx.x == 0) smem[la] = kSentinel;
    staged = live && ia == ra;
    if (staged) {
      stage_async(sb, mat + ib * k, nb, lane, 32);
      if (lane == 0) sb[nb] = kSentinel;
    }
    stage_wait();
    __syncthreads();
  }
  if (!live) return;
  const int2 r = staged
      ? merge_stats(SharedRow(smem), na, SharedRow(sb), nb, sketch_size,
                    false, lane)
      : merge_stats(DeviceRow(mat + ia * k), na, DeviceRow(mat + ib * k),
                    nb, sketch_size, false, lane);
  if (lane == 0) {
    common[p] = r.x;
    total[p] = r.y;
  }
}

// each device's opt-in dynamic shared memory a block, set with the
// kernel's attribute at the first launch on that device (the attribute
// is a function's on one device)
constexpr int kMaxDevices = 64;
int g_max_smem[kMaxDevices] = {};
bool g_smem_set[kMaxDevices] = {};

}  // namespace

extern "C" int pairlist_launch(const void* mat, int k, const void* lens,
                               const void* pi, const void* pj, int b,
                               int sketch_size, void* common, void* total,
                               void* stream) {
  if (b <= 0) return 0;
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!g_smem_set[dev]) {
    int optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaFuncGetAttributes(&attr, pairlist_kernel<true>);
    }
    if (err == cudaSuccess) {
      // dynamic and static shared memory together stay within opt-in
      const int limit = optin - static_cast<int>(attr.sharedSizeBytes);
      err = cudaFuncSetAttribute(pairlist_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limit);
      if (err == cudaSuccess) {
        g_max_smem[dev] = limit;
        g_smem_set[dev] = true;
      }
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int max_smem = g_max_smem[dev];
  const long long stride = (static_cast<long long>(k) + 2) & ~1LL;
  const long long smem = (1 + kWarps) * stride * 8;
  const bool staged =
      k <= kMaxStagedK && b >= kMinStagedPairs && smem <= max_smem;
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(b) + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const long long*>(mat);
  const auto* l = static_cast<const int*>(lens);
  const auto* i = static_cast<const long long*>(pi);
  const auto* j = static_cast<const long long*>(pj);
  if (staged) {
    pairlist_kernel<true><<<blocks, kWarps * 32, smem, s>>>(
        m, k, l, i, j, b, sketch_size, static_cast<int*>(common),
        static_cast<int*>(total));
  } else {
    pairlist_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        m, k, l, i, j, b, sketch_size, static_cast<int*>(common),
        static_cast<int*>(total));
  }
  return static_cast<int>(cudaGetLastError());
}
