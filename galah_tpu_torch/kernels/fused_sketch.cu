// Fused k-mer hash + per-class distinct-minima fold: the candidate
// file of the fused MinHash sketch.
//
// Replaces the TPU kernel galah_tpu/ops/pallas_sketch.py
// (_fused_sketch_call / _make_fused_kernel). Input: the canonical key
// words of every window of a launch group's genomes, concatenated
// (ops/hashing.canonical_key_words: three little-endian ASCII words
// k1, k2, tail of a k=21 key for murmur3, or one 2-bit packed word for
// tpufast), a validity byte per window, and each job's (offset,
// window count) in those arrays. Output, per job and per class c in
// [0, 2048): the 8 smallest DISTINCT valid hashes among the job's
// window positions p with p mod 2048 == c, ascending, padded with the
// u64 sentinel, as (jobs, 8, 2048) register-major int64 in the port's
// biased form (u64 ^ 2^63). The Pallas class (sublane mod 16, lane)
// of a (512, 128) block is exactly p mod 2048, so the file equals the
// TPU kernel's whatever order the positions are visited in: a value
// is dropped when a register already holds it, and registers only
// decrease, so what is left is that set.
//
// Hashing uses native 64-bit integer arithmetic (murmur3 x64_128 h1,
// seed 0, length 21, from murmur3.cuh; or the multiply-free tpufast
// mixer). The TPU
// kernel's 16-bit-limb schoolbook multiply existed only because the
// TPU vector unit has no u64 multiply.
//
// Layout: block (x, y) takes classes [128x, 128x + 128) of job y with
// 128 x kSplit threads; thread (lane, split) visits positions
// class + 2048 * (split + kSplit * i), so a warp reads 32 neighbouring
// windows at each step (coalesced), and folds them into 8 registers.
// The kSplit files of a class are then merged through shared memory
// (a merge of "8 smallest distinct" files is again the 8 smallest
// distinct of the union).
//
// Bound: per window the kernel reads the key words and the validity
// byte once (25 B for murmur3, 9 B for tpufast) and writes 8 x 2048
// x 8 B per job. A murmur3 hash is 12 64-bit multiplies (~3 32-bit
// operations each) and ~30 other 64-bit operations (~2 each): ~100
// 32-bit operations with the register compare, ~45 for tpufast. At
// 25 B per window the bytes bound it (25 B at 3.35 TB/s is 7.5 ps,
// 100 operations at 67e12/s 1.5 ps).

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

using galah::u64;

constexpr int kClasses = 2048;
constexpr int kRegs = 8;
constexpr int kLanes = 128;  // classes per block
constexpr int kSplit = 4;    // threads per class
constexpr u64 kSent = ~0ull;
constexpr u64 kBias = 1ull << 63;

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

__global__ void __launch_bounds__(kLanes * kSplit)
fused_sketch_kernel(const u64* __restrict__ w0, const u64* __restrict__ w1,
                    const u64* __restrict__ w2,
                    const unsigned char* __restrict__ valid,
                    const long long* __restrict__ job_off,
                    const long long* __restrict__ job_len, int tpufast_algo,
                    long long* __restrict__ out) {
  __shared__ u64 files[kSplit - 1][kRegs][kLanes];
  const int lane = threadIdx.x;
  const int split = threadIdx.y;
  const int cls = blockIdx.x * kLanes + lane;
  const long long job = blockIdx.y;
  const long long off = job_off[job];
  const long long len = job_len[job];

  u64 r[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) r[i] = kSent;
  for (long long p = cls + static_cast<long long>(kClasses) * split; p < len;
       p += static_cast<long long>(kClasses) * kSplit) {
    const long long q = off + p;
    if (!valid[q]) continue;
    insert(r, tpufast_algo ? tpufast(w0[q])
                           : galah::murmur3_k21(w0[q], w1[q], w2[q]));
  }
  if (split > 0) {
#pragma unroll
    for (int i = 0; i < kRegs; ++i) files[split - 1][i][lane] = r[i];
  }
  __syncthreads();
  if (split != 0) return;
  for (int s = 0; s < kSplit - 1; ++s) {
#pragma unroll
    for (int i = 0; i < kRegs; ++i) insert(r, files[s][i][lane]);
  }
  long long* o = out + job * kRegs * kClasses + cls;
#pragma unroll
  for (int i = 0; i < kRegs; ++i)
    o[static_cast<long long>(i) * kClasses] = static_cast<long long>(r[i] ^ kBias);
}

}  // namespace

extern "C" int fused_sketch_launch(const void* w0, const void* w1,
                                   const void* w2, const void* valid,
                                   const void* job_off, const void* job_len,
                                   int jobs, int tpufast_algo, void* out,
                                   void* stream) {
  if (jobs <= 0) return 0;
  if (jobs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kClasses / kLanes, jobs);
  const dim3 block(kLanes, kSplit);
  fused_sketch_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(w0), static_cast<const u64*>(w1),
      static_cast<const u64*>(w2), static_cast<const unsigned char*>(valid),
      static_cast<const long long*>(job_off),
      static_cast<const long long*>(job_len), tpufast_algo,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
