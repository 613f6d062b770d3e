// Pairwise merged-bottom-k statistics: a warp per (row, col) pair, both
// operands in shared memory.
//
// Replaces the TPU kernel galah_tpu/ops/pallas_pairwise.py
// (tile_stats_pallas / _make_kernel; tile_intersect_pallas is its
// intersect form, and its range_skip variant computes the same
// function). For sorted, sentinel-padded rows a and b of width K it
// computes what ops/pairwise._pair_stats computes:
//   pos_b(i)  = #(b < a_i)            (searchsorted, left)
//   match(i)  = a_i valid and b[pos_b(i)] == a_i
//   cexcl(i)  = #(match before i)
//   urank(i)  = i + pos_b(i) - cexcl(i)   (rank of a_i in the union)
//   total     = min(sketch_size, na + nb - #match)
//   common    = #(match & urank < total)
// With `intersect` it reports common = #match (|a ∩ b|, the marker
// screen's count) and total = na. The TPU kernel compared whole blocks
// densely because Mosaic has no dynamic indexing.
//
// Tiles. A block takes a tile of 4 rows and 8 columns and gives each
// of its 32 pairs one warp. Where the tile's 12 sketches fit in shared
// memory (K <= 2419 on an H100) it stages them; past that it reads its
// operands in place from device memory, through L1 and L2. Smaller
// staged tiles for wider K were slower than reading in place (2.50 ms
// against 0.96 ms at K = 6080 and 7.39 against 2.09 at K = 10048 for
// 64 x 512 pairs, kernels/rehearse_tile_stats.py on an H100): they
// leave an SM one block of 2 or 1 warps. Blocks run along a row of
// tiles (a 1-D grid, no row limit), so a row tile is read from L2 by
// consecutive blocks.
// Staging: each sketch lands in shared memory once, followed by the
// sentinel at an even stride. Where K is even and the matrices 16-byte
// aligned, thread 0 has the bulk copy engine (TMA, cp.async.bulk) move
// the rows and the first half of the columns on one mbarrier and the
// other half on a second, so the first half's warps start while the
// rest is in flight; otherwise every thread copies with cp.async
// (stage.cuh). Each warp finds its two sketches' valid prefixes (the
// values before the first INT64_MAX) itself.
//
// Merge path within a pair: merge_walk.cuh, shared with pairlist.cu.
// The 32 lanes split the merge of the valid prefixes along merge
// diagonals; the intersect form sums the lanes' match counts, and the
// full form splits the segment that straddles the union rank `total`
// across the warp again before one lane walks what is left of it.
//
// Bound: bytes moved are (Br + Bc) K 8 in and 8 a pair out, and the
// walks na + nb compares a pair: at the screen's shapes (64 x 512
// pairs, K = 2176) both bounds are a few microseconds, below one
// launch. What the kernel takes there (rehearse_tile_stats.py,
// intersect form, on an H100): 0.1765 ms, of which 0.057 ms is the
// launch, the staging and the prefix searches (all-sentinel rows, no
// item to merge) and the rest the walks, ~800 merged items a ns; each
// step is a data-dependent shared load inside two-word 64-bit
// compares and selects. In place, 0.742 ms at K = 6080.
// nvcc -Xptxas -v (sm_90a): 32 registers and 16 bytes of static shared
// memory, no spills, for the staged kernel, one block of 1024 threads
// an SM with (12 x 2178 x 8 =) 209,088 bytes of dynamic shared memory
// at K = 2176; 43 registers, no spills, for the in-place one.
//
// The gathered-tile entry (tile_stats_gather_launch) serves the
// survivor strategy `gather` of ops/sparse_device.py
// (galah_tpu/ops/sparse_device._gather_dense_pair_stats, which gathers
// the survivors' rows into 64 x 128 tiles and runs the TPU kernel over
// every cell of each). Its rows are named by index: a segment s of the
// planner has 64 a rows (ua[s]) and 128 b rows (ub[s]), and each
// listed pair is one cell (ra, rb) of one segment. The grid covers
// every segment's 16 x 16 tiles of 4 x 8 cells in one launch; the
// pairs come sorted by tile, so tile t owns pairs
// [tile_off[t], tile_off[t + 1]), each named by its cell ra * 128 + rb.
// A tile with no pair returns at once. A tile with pairs stages only
// the rows its pairs name, each straight from the matrix by index
// (its valid prefix and the sentinel, cp.async), and warp w walks
// pairs w, w + 32, ... of the tile through the same merge_walk.cuh
// merge path as the full form and pairlist.cu, so the integers are
// theirs. Cells no pair names are neither walked nor written. Where 12
// staged rows do not fit in shared memory the rows are read in place.
// At K = 1000 over 128 segments (kernels/rehearse_gather.py on an H100)
// it takes 3.80 ms at fill 1.0 (1,048,576 pairs), where pairlist.cu
// takes 3.91 ms on the same list, and 1.31 against 1.09 at fill 0.12:
// a sparse tile stages up to 12 rows for a few pairs. nvcc -Xptxas -v
// (sm_90a): 32 registers, staged; 50 in place; no spills.
//
// Hashes are biased int64 (u64 ^ 2^63); INT64_MAX is the sentinel.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_walk.cuh"
#include "stage.cuh"

namespace {

using merge_walk::kSentinel;

// Staged tiles (tr, tc) in order of preference; the first whose
// sketches fit in shared memory is taken. Where none fits, a 4 x 8
// tile reads its operands in place.
constexpr int kTiles[][2] = {{4, 8}};
constexpr int kInPlace[2] = {4, 8};

// mbarrier and 1-D bulk copy (TMA) helpers
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.b32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(long long* dst,
                                          const long long* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <bool kStaged>
__global__ void __launch_bounds__(1024)
tile_stats_kernel(const long long* __restrict__ rows,
                  const long long* __restrict__ cols, int br, int bc,
                  int k, int sketch_size, int intersect, int tr, int tc,
                  int* __restrict__ common, int* __restrict__ total) {
  extern __shared__ __align__(16) long long smem[];
  __shared__ __align__(8) unsigned long long bars[2];
  const int col_tiles = (bc + tc - 1) / tc;
  const int r0 = static_cast<int>(blockIdx.x / col_tiles) * tr;
  const int c0 = static_cast<int>(blockIdx.x % col_tiles) * tc;
  const int nr = min(tr, br - r0), nc = min(tc, bc - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pr = warp / tc, pc = warp % tc;
  const long long* a = rows + static_cast<size_t>(r0 + pr) * k;
  const long long* b = cols + static_cast<size_t>(c0 + pc) * k;
  if (kStaged) {
    // The tile's sketches, each followed by the sentinel, at an even
    // stride. Where K is even and the matrices 16-byte aligned, thread 0
    // has the bulk copy engine (TMA) move the rows and the first half of
    // the columns on one barrier and the other half on another, so the
    // warps of the first half start while the rest is in flight;
    // otherwise every thread copies with cp.async.
    const int stride = (k + 2) & ~1;
    const int half = (nc + 1) / 2;
    const bool bulk = (k & 1) == 0 &&
        ((reinterpret_cast<uintptr_t>(rows) |
          reinterpret_cast<uintptr_t>(cols)) & 15) == 0;
    if (bulk && threadIdx.x == 0) {
      bar_init(&bars[0]);
      bar_init(&bars[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    for (int s = 0; s < nr + nc; ++s) {
      const long long* src = s < nr
          ? rows + static_cast<size_t>(r0 + s) * k
          : cols + static_cast<size_t>(c0 + s - nr) * k;
      long long* dst = smem + static_cast<size_t>(s) * stride;
      if (!bulk) {
        stage_async(dst, src, k);
      } else if (threadIdx.x == 0) {
        if (s == 0) {
          bar_expect(&bars[0], static_cast<unsigned>((nr + half) * k * 8));
          bar_expect(&bars[1], static_cast<unsigned>((nc - half) * k * 8));
        }
        bulk_copy(dst, src, static_cast<unsigned>(k) * 8,
                  &bars[s < nr + half ? 0 : 1]);
      }
      for (int e = k + threadIdx.x; e < stride; e += blockDim.x) {
        dst[e] = kSentinel;
      }
    }
    if (!bulk) stage_wait();
    __syncthreads();
    if (pr >= nr || pc >= nc) return;
    if (bulk) {
      bar_wait(&bars[0]);
      if (pc >= half) bar_wait(&bars[1]);
    }
    a = smem + static_cast<size_t>(pr) * stride;
    b = smem + static_cast<size_t>(nr + pc) * stride;
  } else if (pr >= nr || pc >= nc) {
    return;
  }
  const int na = merge_walk::valid_prefix(a, k);
  const int nb = merge_walk::valid_prefix(b, k);
  int2 r;
  if constexpr (kStaged) {
    r = merge_walk::merge_stats(merge_walk::SharedRow(a), na,
                                merge_walk::SharedRow(b), nb, sketch_size,
                                intersect, lane);
  } else {
    r = merge_walk::merge_stats(merge_walk::DeviceRow(a), na,
                                merge_walk::DeviceRow(b), nb, sketch_size,
                                intersect, lane);
  }
  if (lane == 0) {
    const size_t o = static_cast<size_t>(r0 + pr) * bc + (c0 + pc);
    common[o] = r.x;
    total[o] = r.y;
  }
}

// the gathered-tile entry's segment (galah_tpu's GATHER_ROWS x
// GATHER_COLS) and its tiles of kGatherTr x kGatherTc cells
constexpr int kGatherRows = 64;
constexpr int kGatherCols = 128;
constexpr int kGatherTr = 4;
constexpr int kGatherTc = 8;
constexpr int kGatherTileCols = kGatherCols / kGatherTc;
constexpr int kGatherTiles = (kGatherRows / kGatherTr) * kGatherTileCols;

template <bool kStaged>
__global__ void __launch_bounds__(1024)
tile_stats_gather_kernel(const long long* __restrict__ mat, int k,
                         const int* __restrict__ lens,
                         const int* __restrict__ ua,
                         const int* __restrict__ ub,
                         const int* __restrict__ tile_off,
                         const int* __restrict__ cells, int sketch_size,
                         int* __restrict__ common, int* __restrict__ total) {
  extern __shared__ __align__(16) long long smem[];
  __shared__ unsigned used;
  const long long tile = blockIdx.x;
  const int p0 = tile_off[tile], p1 = tile_off[tile + 1];
  if (p0 == p1) return;
  const long long seg = tile / kGatherTiles;
  const int t = static_cast<int>(tile % kGatherTiles);
  const int* rows = ua + seg * kGatherRows + (t / kGatherTileCols) * kGatherTr;
  const int* cols = ub + seg * kGatherCols + (t % kGatherTileCols) * kGatherTc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = (k + 2) & ~1;
  if (kStaged) {
    // slots 0-3: the tile's a rows, 4-11: its b rows; only those a
    // listed pair names are staged
    if (threadIdx.x == 0) used = 0;
    __syncthreads();
    for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
      const int c = cells[p];
      atomicOr(&used, (1u << ((c / kGatherCols) % kGatherTr)) |
                          (1u << (kGatherTr + (c % kGatherCols) % kGatherTc)));
    }
    __syncthreads();
    const unsigned mask = used;
    for (int s = 0; s < kGatherTr + kGatherTc; ++s) {
      if (((mask >> s) & 1u) == 0) continue;
      const long long r = s < kGatherTr ? rows[s] : cols[s - kGatherTr];
      long long* dst = smem + static_cast<size_t>(s) * stride;
      const int len = lens[r];
      stage_async(dst, mat + r * k, len);
      if (threadIdx.x == 0) dst[len] = kSentinel;
    }
    stage_wait();
    __syncthreads();
  }
  for (int p = p0 + warp; p < p1; p += 32) {
    const int c = cells[p];
    const int pr = (c / kGatherCols) % kGatherTr;
    const int pc = (c % kGatherCols) % kGatherTc;
    const long long ia = rows[pr], ib = cols[pc];
    const int na = lens[ia], nb = lens[ib];
    int2 r;
    if constexpr (kStaged) {
      r = merge_walk::merge_stats(
          merge_walk::SharedRow(smem + static_cast<size_t>(pr) * stride), na,
          merge_walk::SharedRow(smem +
                                static_cast<size_t>(kGatherTr + pc) * stride),
          nb, sketch_size, false, lane);
    } else {
      r = merge_walk::merge_stats(merge_walk::DeviceRow(mat + ia * k), na,
                                  merge_walk::DeviceRow(mat + ib * k), nb,
                                  sketch_size, false, lane);
    }
    if (lane == 0) {
      common[p] = r.x;
      total[p] = r.y;
    }
  }
}

// each device's opt-in dynamic shared memory a block, set with the
// kernel's attribute at the first launch on that device (the attribute
// is a function's on one device)
constexpr int kMaxDevices = 64;
int g_max_smem[kMaxDevices] = {};
bool g_smem_set[kMaxDevices] = {};
int g_gather_smem[kMaxDevices] = {};
bool g_gather_set[kMaxDevices] = {};

// the opt-in limit of dynamic shared memory for `kernel` on `dev`, set
// as its attribute
template <class Kernel>
cudaError_t optin_smem(Kernel kernel, int dev, int* limit) {
  int optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  // dynamic and static shared memory together stay within opt-in
  *limit = optin - static_cast<int>(attr.sharedSizeBytes);
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
}

}  // namespace

extern "C" int tile_stats_launch(const void* rows, const void* cols,
                                 int br, int bc, int k, int sketch_size,
                                 int intersect, void* common, void* total,
                                 void* stream) {
  if (br <= 0 || bc <= 0 || k < 0) return 0;
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
      err = cudaFuncGetAttributes(&attr, tile_stats_kernel<true>);
    }
    if (err == cudaSuccess) {
      // dynamic and static shared memory together stay within opt-in
      const int limit = optin - static_cast<int>(attr.sharedSizeBytes);
      err = cudaFuncSetAttribute(tile_stats_kernel<true>,
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
  int tr = kInPlace[0], tc = kInPlace[1];
  long long smem = 0;
  for (const auto& tile : kTiles) {
    const long long bytes = (tile[0] + tile[1]) * stride * 8;
    if (bytes <= max_smem) {
      tr = tile[0];
      tc = tile[1];
      smem = bytes;
      break;
    }
  }
  const long long blocks = static_cast<long long>((br + tr - 1) / tr) *
                           ((bc + tc - 1) / tc);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks));
  const dim3 block(32 * tr * tc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const long long*>(rows);
  const auto* c = static_cast<const long long*>(cols);
  if (smem > 0) {
    tile_stats_kernel<true><<<grid, block, smem, s>>>(
        r, c, br, bc, k, sketch_size, intersect, tr, tc,
        static_cast<int*>(common), static_cast<int*>(total));
  } else {
    tile_stats_kernel<false><<<grid, block, 0, s>>>(
        r, c, br, bc, k, sketch_size, intersect, tr, tc,
        static_cast<int*>(common), static_cast<int*>(total));
  }
  return static_cast<int>(cudaGetLastError());
}

// The gathered-tile entry: (common, total) of every listed pair, in the
// tile order of `cells` (see the note at the top). `ua` is (n_seg, 64)
// and `ub` (n_seg, 128) int32 row indices, `tile_off` the n_seg * 256 + 1
// int32 pair offsets of the tiles, `cells` each pair's ra * 128 + rb,
// `lens` each matrix row's valid length.
extern "C" int tile_stats_gather_launch(const void* mat, int k,
                                        const void* lens, const void* ua,
                                        const void* ub, const void* tile_off,
                                        const void* cells, int n_seg,
                                        int sketch_size, void* common,
                                        void* total, void* stream) {
  if (n_seg <= 0) return 0;
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!g_gather_set[dev]) {
    int limit = 0;
    const cudaError_t err =
        optin_smem(tile_stats_gather_kernel<true>, dev, &limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_gather_smem[dev] = limit;
    g_gather_set[dev] = true;
  }
  const long long stride = (static_cast<long long>(k) + 2) & ~1LL;
  const long long smem = (kGatherTr + kGatherTc) * stride * 8;
  const long long blocks = static_cast<long long>(n_seg) * kGatherTiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks));
  const dim3 block(32 * kGatherTr * kGatherTc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const long long*>(mat);
  const auto* l = static_cast<const int*>(lens);
  const auto* a = static_cast<const int*>(ua);
  const auto* b = static_cast<const int*>(ub);
  const auto* off = static_cast<const int*>(tile_off);
  const auto* c = static_cast<const int*>(cells);
  if (smem <= g_gather_smem[dev]) {
    tile_stats_gather_kernel<true><<<grid, block, smem, s>>>(
        m, k, l, a, b, off, c, sketch_size, static_cast<int*>(common),
        static_cast<int*>(total));
  } else {
    tile_stats_gather_kernel<false><<<grid, block, 0, s>>>(
        m, k, l, a, b, off, c, sketch_size, static_cast<int*>(common),
        static_cast<int*>(total));
  }
  return static_cast<int>(cudaGetLastError());
}
