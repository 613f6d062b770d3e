// Pairwise HyperLogLog union statistics over uint8 register rows.
//
// Replaces the TPU kernel galah_tpu/ops/pallas_hll.py
// (hll_union_stats_tile / _kernel). For register rows R (Br, m) and
// C (Bc, m), uint8, m a multiple of 16, it gives per pair (r, c)
//   powsum[r, c] = sum_i 2^-max(R[r, i], C[c, i])      (f32)
//   zeros[r, c]  = #{i : max(R[r, i], C[c, i]) == 0}   (f32)
// the two reductions of the HLL union estimate (ops/hll._estimate).
// The TPU kernel read 2^-reg as f32 (4 B a register), took the min
// (the max of registers) and summed in f32. Here the kernel reads the
// registers themselves (1 B each) and forms each term exactly, as the
// double whose exponent field is 1023 - v. Terms are summed in double
// and rounded to f32 once. For registers <= 41 every partial sum is a
// multiple of 2^-41 below 2^12 and so exact, and the result equals
// the plain version's (float64 sum, then f32) bit for bit in any
// order; beyond 41 the two agree within one f32 ulp.
//
// Layout: block (x, y) takes columns [64x, 64x + 64) against rows
// [8y, 8y + 8) with 256 threads. The 8 rows' registers are staged in
// shared memory 4096 at a time (32 KB), and every thread reads them
// from there. Four threads share a column: each takes every fourth
// 16-register word of it (16 B loads; the four read 64 contiguous
// bytes), folds it against all 8 rows, and the four partial sums are
// combined in a fixed order with warp shuffles, so the result does not
// depend on scheduling.
//
// Bound: per register pair ~4 32-bit operations (the byte max, the
// term's exponent, the add, the zero count). The bytes are each row
// and column once and 8 B written per pair, so at m = 4096 operations
// bound it (64 x 1024 pairs: 1.07e9 operations, 16 us at 67e12/s,
// against 5 MB, 1.5 us at 3.35 TB/s).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;                  // rows per block
constexpr int kCols = 64;                 // columns per block
constexpr int kSplit = 4;                 // threads per column
constexpr int kThreads = kCols * kSplit;  // 256
constexpr int kWords = 4096 / 16;         // 16-register words staged a row

__device__ __forceinline__ void fold(unsigned cw, unsigned rw, double& acc,
                                     int& zeros) {
  const unsigned mx = __vmaxu4(cw, rw);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int v = static_cast<int>((mx >> (8 * b)) & 0xffu);
    acc += __hiloint2double((1023 - v) << 20, 0);  // 2^-v, exact
    zeros += (v == 0);
  }
}

__global__ void __launch_bounds__(kThreads)
hll_union_kernel(const uint4* __restrict__ rows,
                 const uint4* __restrict__ cols, int br, int bc, int words,
                 float* __restrict__ powsum, float* __restrict__ zeros) {
  __shared__ uint4 srow[kRows][kWords];
  const int t = threadIdx.x;
  const int q = t % kSplit;
  const int col = blockIdx.x * kCols + t / kSplit;
  const int r0 = blockIdx.y * kRows;
  const bool active = col < bc;
  const uint4* cp = cols + static_cast<long long>(active ? col : 0) * words;

  double acc[kRows];
  int zc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc[r] = 0.0;
    zc[r] = 0;
  }
  for (int w0 = 0; w0 < words; w0 += kWords) {
    const int nw = min(kWords, words - w0);
    __syncthreads();
    for (int i = t; i < kRows * nw; i += kThreads) {
      const int r = i / nw;
      const int w = i - r * nw;
      srow[r][w] = (r0 + r < br)
                       ? rows[static_cast<long long>(r0 + r) * words + w0 + w]
                       : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    if (!active) continue;
    for (int w = q; w < nw; w += kSplit) {
      const uint4 c = cp[w0 + w];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint4 s = srow[r][w];
        fold(c.x, s.x, acc[r], zc[r]);
        fold(c.y, s.y, acc[r], zc[r]);
        fold(c.z, s.z, acc[r], zc[r]);
        fold(c.w, s.w, acc[r], zc[r]);
      }
    }
  }
  // lanes 4j .. 4j + 3 of a warp share a column: lane 4j gets
  // (p0 + p1) + (p2 + p3)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    double a = acc[r];
    int z = zc[r];
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    if (active && q == 0 && r0 + r < br) {
      const long long o = static_cast<long long>(r0 + r) * bc + col;
      powsum[o] = static_cast<float>(a);
      zeros[o] = static_cast<float>(z);
    }
  }
}

}  // namespace

extern "C" int hll_union_launch(const void* rows, const void* cols, int br,
                                int bc, int m, void* powsum, void* zeros,
                                void* stream) {
  if (br <= 0 || bc <= 0) return 0;
  if (m <= 0 || m % 16 != 0 || (br + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((bc + kCols - 1) / kCols, (br + kRows - 1) / kRows);
  hll_union_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), static_cast<const uint4*>(cols), br,
      bc, m / 16, static_cast<float*>(powsum), static_cast<float*>(zeros));
  return static_cast<int>(cudaGetLastError());
}
