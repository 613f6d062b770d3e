// Fused canonical k-mer hash + per-class distinct-minima fold, from a
// launch group's codes: the candidate file of the fused MinHash sketch.
//
// Replaces the TPU kernel galah_tpu/ops/pallas_sketch.py
// (_fused_sketch_call / _make_fused_kernel) together with the XLA
// preamble that galah_tpu fuses into that kernel's operands in the same
// jit (galah_tpu/ops/hashing.py canonical_kmer_words_batch: unpack the
// codes, pack and mask the windows, select the canonical orientation,
// assemble the key words). Input: the group's genomes' codes laid end
// to end (uint8, 0-3 or 255 ambiguous), the sorted contig starts of
// that sequence (every genome start among them), and each job's
// (first window, window count). Output, per job and per class c in
// [0, 2048): the 8 smallest DISTINCT valid hashes among the job's
// windows p with p mod 2048 == c, ascending, padded with the u64
// sentinel, as (jobs, 8, 2048) register-major int64 in the port's
// biased form (u64 ^ 2^63). The Pallas class (sublane mod 16, lane) of
// a (512, 128) block is exactly p mod 2048, and the file does not
// depend on visiting order (registers only decrease, a value already
// held is dropped), so it equals the TPU kernel's.
//
// Layout: block (s, j) owns the 128 classes [128 s, 128 s + 128) of job
// j. Each stage hashes 64 rows of 2048 windows: thread t takes the run
// of 16 consecutive windows at column 128 s + 16 (t mod 8) of row
// t / 8, rolls the canonical packs along it (canonical.cuh) and writes
// its 16 hashes to shared memory (a 17-word pitch a run keeps the
// writes and the reads free of bank conflicts). After a barrier thread
// t folds class t mod 128 of rows t / 128, t / 128 + 4, ... into its 8
// registers. At the end the 4 files of a class are merged through
// shared memory (a merge of "8 smallest distinct" files is again the 8
// smallest distinct of the union). Hashing is murmur3 x64_128 h1 (seed
// 0, on native 64-bit integers; murmur3.cuh) of the ASCII canonical
// k-mer, or the multiply-free tpufast mixer of its 2-bit pack. The
// kernel is a template over the murmur3 key: the k = 21 instance
// (murmur3_canonical21: one block and a 5-byte tail, fixed) also
// carries tpufast at any k; the other instance hashes murmur3 at any
// k <= 32 (canonical.cuh's murmur3_canonical: k / 16 blocks and a tail
// of k mod 16 bytes, words assembled from the canonical pack in
// registers). The launch picks the instance by (algorithm, k), so the
// finch default (murmur3, k = 21) runs the same code as before.
//
// Bound: bytes are 1 B a base in (the run's k - 1 halo is reread from
// L1/L2) and 8 x 2048 x 8 B a job out: a 16-genome group of 32 M bases
// moves 34 MB, 0.010 ms at 3.35 TB/s. Operations a valid window, in
// 32-bit operations: the roll ~12, the canonical select and the ASCII
// key words ~50, the murmur3 hash ~100 (12 64-bit multiplies at ~3, ~30
// other 64-bit operations at ~2), the register compare ~4: ~180
// (tpufast: roll, select, mixer, compare ~70). At another k, murmur3
// costs 94 + 12 a key word + 35 a 16-byte block + 15 a tail word: 121
// at k = 8, 153 at 16, 207 at 31, 212 at 32 (180 at 21 again). 32 M windows x 180 at
// 67e12/s is 0.086 ms, so operations bound it, 9x over the bytes. The
// design therefore spends nothing per window that the bound does not
// count: no key word or mask reaches device memory, a window costs one
// byte load and the run's halo, and the fold's common case is one
// shared load and one compare.
//
// ptxas (sm_90a, `python -m galah_tpu_torch.kernels.build --ptxas`):
// 60 registers for the k = 21 instance and 64 for the any-k instance
// (the launch bound's cap), no spills, 69,632 B of dynamic shared memory
// a block, so two 512-thread blocks an SM (32 warps).

#include <cstdint>
#include <cuda_runtime.h>

#include "canonical.cuh"

namespace {

using galah::u64;
using galah::u8;

constexpr int kClasses = 2048;
constexpr int kRegs = 8;
constexpr int kSlices = 16;                          // blocks a job
constexpr int kSliceClasses = kClasses / kSlices;    // 128
constexpr int kRun = 16;                             // windows a thread
constexpr int kRunsPerRow = kSliceClasses / kRun;    // 8
constexpr int kThreads = 512;
constexpr int kStageRows = kThreads / kRunsPerRow;   // 64
constexpr int kSplit = kThreads / kSliceClasses;     // 4 folds a class
constexpr int kRunPitch = kRun + 1;
constexpr int kRowPitch = kRunsPerRow * kRunPitch;   // 136
constexpr int kSmemBytes = kStageRows * kRowPitch * 8;  // 69,632
constexpr u64 kSent = ~0ull;
constexpr u64 kBias = 1ull << 63;

static_assert((kSplit - 1) * kRegs * kSliceClasses <= kStageRows * kRowPitch,
              "the merge reuses the stage buffer");

// the multiply-free shift-add mixer (galah_tpu ops/hashing._tpufast_mix)
// at seed 0
__device__ __forceinline__ u64 tpufast(u64 x) {
  x ^= 0x1B873593ull;
  x = x + (x << 21) + (x << 37);
  x ^= x >> 29;
  x = x + (x << 13) + (x << 47);
  x ^= x >> 31;
  x = x + (x << 17) + (x << 41);
  x ^= x >> 33;
  x = x + (x << 26);
  return x ^ (x >> 32);
}

// r holds the smallest distinct values seen so far, ascending.
__device__ __forceinline__ void insert(u64 (&r)[kRegs], u64 v) {
  if (v >= r[kRegs - 1]) return;
  bool dup = false;
#pragma unroll
  for (int i = 0; i < kRegs - 1; ++i) dup |= (v == r[i]);
  if (dup) return;
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    const bool lt = v < r[i];
    const u64 keep = lt ? v : r[i];
    v = lt ? r[i] : v;
    r[i] = keep;
  }
}

// kAnyK: murmur3 at any k (murmur3_canonical); else murmur3 at k = 21
// (murmur3_canonical21) or, with tpufast_algo, tpufast at any k
template <bool kAnyK>
__global__ void __launch_bounds__(kThreads, 2)
fused_sketch_kernel(const u8* __restrict__ codes,
                    const long long* __restrict__ starts, long long n_starts,
                    const long long* __restrict__ job_off,
                    const long long* __restrict__ job_len, int k,
                    int tpufast_algo, long long* __restrict__ out) {
  extern __shared__ u64 hs[];
  const int t = threadIdx.x;
  const int slice = blockIdx.x;
  const long long job = blockIdx.y;
  const long long off = job_off[job];
  const long long len = job_len[job];
  const long long rows = (len + kClasses - 1) / kClasses;
  // hashing role: a run of kRun windows of one row
  const int run_row = t / kRunsPerRow;
  const int run = t % kRunsPerRow;
  u64* slot = hs + run_row * kRowPitch + run * kRunPitch;
  // folding role: one class, every kSplit-th row of a stage
  const int cls = t % kSliceClasses;
  const int split = t / kSliceClasses;
  const int cls_at = (cls / kRun) * kRunPitch + cls % kRun;

  u64 r[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) r[i] = kSent;
  for (long long row0 = 0; row0 < rows; row0 += kStageRows) {
    const long long q0 = (row0 + run_row) * kClasses +
                         slice * kSliceClasses + run * kRun;
    const long long left = len - q0;
    const int n = left <= 0 ? 0 : (left < kRun ? static_cast<int>(left) : kRun);
    for (int i = n; i < kRun; ++i) slot[i] = kSent;
    if (n > 0) {
      galah::for_each_window(
          codes, starts, n_starts, off + q0, n, k,
          [&](int i, bool valid, u64 f, u64 rv) {
            u64 h = kSent;
            if (valid) {
              if (kAnyK) {
                h = galah::murmur3_canonical(f, rv, k);
              } else {
                h = tpufast_algo ? tpufast(f <= rv ? f : rv)
                                 : galah::murmur3_canonical21(f, rv);
              }
            }
            slot[i] = h;
          });
    }
    __syncthreads();
    for (int row = split; row < kStageRows; row += kSplit)
      insert(r, hs[row * kRowPitch + cls_at]);
    __syncthreads();
  }
  if (split > 0) {
#pragma unroll
    for (int i = 0; i < kRegs; ++i)
      hs[((split - 1) * kRegs + i) * kSliceClasses + cls] = r[i];
  }
  __syncthreads();
  if (split != 0) return;
  for (int s = 0; s < kSplit - 1; ++s) {
#pragma unroll
    for (int i = 0; i < kRegs; ++i)
      insert(r, hs[(s * kRegs + i) * kSliceClasses + cls]);
  }
  long long* o = out + job * kRegs * kClasses + slice * kSliceClasses + cls;
#pragma unroll
  for (int i = 0; i < kRegs; ++i)
    o[static_cast<long long>(i) * kClasses] =
        static_cast<long long>(r[i] ^ kBias);
}

template <bool kAnyK>
cudaError_t launch(const dim3 grid, cudaStream_t stream, const u8* codes,
                   const long long* starts, long long n_starts,
                   const long long* job_off, const long long* job_len, int k,
                   int tpufast_algo, long long* out) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_sketch_kernel<kAnyK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  fused_sketch_kernel<kAnyK><<<grid, kThreads, kSmemBytes, stream>>>(
      codes, starts, n_starts, job_off, job_len, k, tpufast_algo, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_sketch_launch(const void* codes, const void* starts,
                                   long long n_starts, const void* job_off,
                                   const void* job_len, int jobs, int k,
                                   int tpufast_algo, void* out,
                                   void* stream) {
  if (jobs <= 0) return 0;
  if (jobs > 65535 || k < 1 || k > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kSlices, jobs);
  const auto* c = static_cast<const u8*>(codes);
  const auto* st = static_cast<const long long*>(starts);
  const auto* jo = static_cast<const long long*>(job_off);
  const auto* jl = static_cast<const long long*>(job_len);
  auto* o = static_cast<long long*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (!tpufast_algo && k != 21)
          ? launch<true>(grid, s, c, st, n_starts, jo, jl, k, 0, o)
          : launch<false>(grid, s, c, st, n_starts, jo, jl, k, tpufast_algo,
                          o);
  return static_cast<int>(err);
}
