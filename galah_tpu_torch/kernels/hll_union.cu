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
// double whose high word is 0x3ff00000 - (v << 20) (exponent field
// 1023 - v) and whose low word is 0. Terms are summed in double and
// rounded to f32 once. For registers <= 41 every partial sum is a
// multiple of 2^-41 below 2^12 and so exact, and the result equals
// the plain version's (float64 sum, then f32) bit for bit in any
// order; beyond 41 the two agree within one f32 ulp.
//
// Bound: per register pair ~4 32-bit operations (the byte max, the
// term's exponent, the add, the zero count). The bytes are each row
// and column once and 8 B written per pair, so at m = 4096 operations
// bound it (64 x 1024 pairs: 1.07e9 operations, 16 us at 67e12/s,
// against 5 MB, 1.5 us at 3.35 TB/s).
//
// Geometry. Block (x, y, z) takes columns [64x, 64x + 64) against rows
// [8y, 8y + 8) over the z-th slice of the register axis: 16-register
// words [z * chunk, min(words, (z + 1) * chunk)), with 256 threads.
// The dashing pair pass launches one row block of 64 rows against
// 256-1024 columns, 32-128 tiles of 8 x 64: unsplit, one partial wave
// on 132 SMs in which every block runs the whole register axis. The
// wrapper (ops/hll_union.plan_launch) picks chunk, a multiple of 4
// words, so that a launch has at least 4 x 132 blocks where m allows
// (slices = ceil(words / chunk), the last one ragged); chunk = words
// is one slice and the unsplit kernel's arithmetic. Eight rows a
// block, as before the split: the column's preparation that 16 rows
// would share further is ~1/8 of an instruction a register pair, and
// 8 rows keep a thread at 74 registers (3 blocks, 24 warps an SM).
//
// Combine. With one slice the block writes f32 directly. With S > 1
// each block writes its double partial sums and int32 zero counts to
// scratch (S, Br, Bc) that the wrapper allocates, and a second kernel
// here adds the S partials of a pair in slice order and rounds to f32
// once. No atomics: every sum is taken in a fixed order (registers in
// order within a thread, the four threads of a column by shuffles,
// slices in order), so the result does not depend on how blocks are
// scheduled.
//
// Issue slots per register pair. The top 16 bits of the high word of
// 2^-v are 0x3ff0 - (v << 4) and every other bit of the double is 0,
// so a register's term fits a 16-bit half. Rows are staged in shared
// memory as packed pairs of halves (32 B a 16-register word, two 16 B
// loads, laid out so that the four threads of a column, which read
// four consecutive words at once, hit distinct banks); each column
// word is loaded with one 16 B load (the next one in flight while this
// one is folded) and packed once for all 8 rows, a byte permute and a
// multiply-add for two registers. Since 2^-v falls with v, the union
// terms of two registers are one 16x2 unsigned min (a native
// instruction on sm_90); a shift or an and places each half in a
// double's high word, and a double add takes it. Zero counts come from
// a 16-bit mask of zero registers per word (bit 8 b + 7 - j set iff
// register 4 j + b is 0, from a byte-SIMD compare of each 4-register
// word), one per row word staged and one per column word: per 16
// register pairs one and, one popc, one add. So ~2.8 instructions a
// register pair as written; ptxas adds moves that re-zero the low word
// of most terms' register pairs (PERF.md counts its inner loop, from
// kernels/rehearse_hll_union.py).
//
// Four threads share a column: each takes every fourth word of the
// slice, and the four partial sums are combined in a fixed order with
// warp shuffles, (p0 + p1) + (p2 + p3).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;                  // rows per block
constexpr int kCols = 64;                 // columns per block
constexpr int kSplit = 4;                 // threads per column
constexpr int kThreads = kCols * kSplit;  // 256
constexpr int kStage = 64;                // words of a slice staged at once
constexpr unsigned kOne2 = 0x3ff03ff0u;   // two halves 0x3ff0: 2^-0

// Two registers' terms as packed 16-bit halves: the top 16 bits of the
// high word of 2^-v are 0x3ff0 - (v << 4) (the rest of the double is
// 0). Bytes (b, b + 1) of x, b = 0 or 2, into halves (low, high).
__device__ __forceinline__ unsigned term_pair(unsigned x, unsigned b) {
  return kOne2 - (__byte_perm(x, 0u, b == 0 ? 0x4140u : 0x4342u) << 4);
}

// the 16 registers of a word as 8 packed term pairs
__device__ __forceinline__ void term_pairs(const uint4& w, unsigned (&p)[8]) {
  const unsigned part[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[2 * j] = term_pair(part[j], 0);
    p[2 * j + 1] = term_pair(part[j], 2);
  }
}

// bit 8 b + 7 set iff byte b of x is 0
__device__ __forceinline__ unsigned zero_bytes(unsigned x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

__device__ __forceinline__ unsigned zero_mask(const uint4& w) {
  return zero_bytes(w.x) | (zero_bytes(w.y) >> 1) |
         (zero_bytes(w.z) >> 2) | (zero_bytes(w.w) >> 3);
}

// staged term pairs of word w (stage-relative), half j of its 32 B:
// the four threads of a column read words 4i .. 4i + 3 together, 64 B
// in a row
__device__ __forceinline__ int slot(int w, int j) {
  return ((w >> 2) * 2 + j) * 4 + (w & 3);
}

// the two union terms of a packed pair of row and column term pairs,
// added to acc in register order (low half first)
__device__ __forceinline__ void add_pair(unsigned rp, unsigned cp,
                                         double& acc) {
  const unsigned m = __vminu2(rp, cp);  // 2^-v falls with v: min = max
  const unsigned lo = m << 16;
  const unsigned hi = m & 0xffff0000u;
  acc += __hiloint2double(static_cast<int>(lo), 0);
  acc += __hiloint2double(static_cast<int>(hi), 0);
}

__global__ void __launch_bounds__(kThreads)
hll_union_kernel(const uint4* __restrict__ rows,
                 const uint4* __restrict__ cols, int br, int bc, int words,
                 int chunk, int sw, float* __restrict__ powsum,
                 float* __restrict__ zeros, double* __restrict__ part_pow,
                 int* __restrict__ part_zeros) {
  extern __shared__ uint4 smem[];
  uint4* spair = smem;                                       // [kRows][2 sw]
  unsigned* smask = reinterpret_cast<unsigned*>(smem + kRows * 2 * sw);
  const int t = threadIdx.x;
  const int q = t % kSplit;
  const int col = blockIdx.x * kCols + t / kSplit;
  const int r0 = blockIdx.y * kRows;
  const int w_begin = blockIdx.z * chunk;
  const int w_end = min(words, w_begin + chunk);
  const bool active = col < bc;
  const uint4* cp = cols + static_cast<long long>(active ? col : 0) * words;

  double acc[kRows];
  int zc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc[r] = 0.0;
    zc[r] = 0;
  }
  for (int s0 = w_begin; s0 < w_end; s0 += sw) {
    const int nw = min(sw, w_end - s0);
    __syncthreads();
    for (int i = t; i < kRows * nw; i += kThreads) {
      const int r = i / nw;
      const int w = i - r * nw;
      const uint4 x =
          (r0 + r < br) ? rows[static_cast<long long>(r0 + r) * words + s0 + w]
                        : make_uint4(0u, 0u, 0u, 0u);
      unsigned p[8];
      term_pairs(x, p);
      uint4* dst = spair + r * 2 * sw;
      dst[slot(w, 0)] = make_uint4(p[0], p[1], p[2], p[3]);
      dst[slot(w, 1)] = make_uint4(p[4], p[5], p[6], p[7]);
      smask[r * sw + w] = zero_mask(x);
    }
    __syncthreads();
    if (!active) continue;
    // the next column word is loaded while this one is folded
    uint4 next = q < nw ? cp[s0 + q] : make_uint4(0u, 0u, 0u, 0u);
    for (int w = q; w < nw; w += kSplit) {
      const uint4 c = next;
      if (w + kSplit < nw) next = cp[s0 + w + kSplit];
      const unsigned cm = zero_mask(c);
      unsigned cpair[8];
      term_pairs(c, cpair);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint4* src = spair + r * 2 * sw;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint4 s = src[slot(w, j)];
          add_pair(s.x, cpair[4 * j + 0], acc[r]);
          add_pair(s.y, cpair[4 * j + 1], acc[r]);
          add_pair(s.z, cpair[4 * j + 2], acc[r]);
          add_pair(s.w, cpair[4 * j + 3], acc[r]);
        }
        zc[r] += __popc(smask[r * sw + w] & cm);
      }
    }
  }
  // lanes 4j .. 4j + 3 of a warp share a column: lane 4j gets
  // (p0 + p1) + (p2 + p3)
  const bool direct = gridDim.z == 1;
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
      if (direct) {
        powsum[o] = static_cast<float>(a);
        zeros[o] = static_cast<float>(z);
      } else {
        const long long p =
            static_cast<long long>(blockIdx.z) * br * bc + o;
        part_pow[p] = a;
        part_zeros[p] = z;
      }
    }
  }
}

// the S partials of each pair, added in slice order, rounded once
__global__ void hll_union_combine(const double* __restrict__ part_pow,
                                  const int* __restrict__ part_zeros,
                                  int slices, long long n,
                                  float* __restrict__ powsum,
                                  float* __restrict__ zeros) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double a = 0.0;
  int z = 0;
  for (int s = 0; s < slices; ++s) {
    a += part_pow[s * n + i];
    z += part_zeros[s * n + i];
  }
  powsum[i] = static_cast<float>(a);
  zeros[i] = static_cast<float>(z);
}

}  // namespace

// chunk: 16-register words a slice; slices = ceil((m / 16) / chunk).
// part_pow (double) and part_zeros (int32) hold slices x br x bc
// partials and are read only when slices > 1 (null otherwise).
extern "C" int hll_union_launch(const void* rows, const void* cols, int br,
                                int bc, int m, int chunk, void* part_pow,
                                void* part_zeros, void* powsum, void* zeros,
                                void* stream) {
  if (br <= 0 || bc <= 0) return 0;
  const int words = m / 16;
  if (m <= 0 || m % 16 != 0 || chunk <= 0 ||
      (br + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (words + chunk - 1) / chunk;
  if (slices > 65535 || (slices > 1 && (!part_pow || !part_zeros)))
    return static_cast<int>(cudaErrorInvalidValue);
  // staged words a pass, a multiple of kSplit so that thread q keeps
  // the slice's words = q mod 4 across stages
  const int sw = (min(chunk, kStage) + kSplit - 1) / kSplit * kSplit;
  const size_t smem = static_cast<size_t>(kRows) * sw * (32 + 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((bc + kCols - 1) / kCols, (br + kRows - 1) / kRows,
                  slices);
  hll_union_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint4*>(rows), static_cast<const uint4*>(cols), br,
      bc, words, chunk, sw, static_cast<float*>(powsum),
      static_cast<float*>(zeros), static_cast<double*>(part_pow),
      static_cast<int*>(part_zeros));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(br) * bc;
  hll_union_combine<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const double*>(part_pow),
      static_cast<const int*>(part_zeros), slices, n,
      static_cast<float*>(powsum), static_cast<float*>(zeros));
  return static_cast<int>(cudaGetLastError());
}
