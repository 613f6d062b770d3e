// k=21 murmur3 window hash: one hash per window of canonical key words.
//
// Replaces the TPU kernel galah_tpu/ops/pallas_sketch.py
// (murmur3_k21_pallas / _make_kernel), the murmur3 stage of the
// k-mer hash (galah_tpu/ops/hashing._hash_core at k=21). Input: the
// three canonical key words of every window (ops/hashing
// .canonical_key_words: bytes 0-7, 8-15 and 16-20 of the canonical
// ASCII k-mer) and a validity byte per window. Output: per window the
// murmur3 x64_128 h1 (seed 0, length 21) in the port's biased form
// (u64 ^ 2^63), or the sentinel INT64_MAX where the window is invalid.
//
// The TPU kernel emulated every 64-bit multiply with 16-bit limb
// products over (hi, lo) u32 planes, because the TPU vector unit has no
// u64 multiply, and ran at 0.06x XLA's emulation there. Here one
// thread hashes one window with native 64-bit arithmetic
// (murmur3.cuh, shared with fused_sketch.cu), in a grid-stride loop so
// any window count takes one launch.
//
// Bound: per window the kernel reads 3 x 8 B of key words and 1 B of
// mask and writes 8 B: 33 B, 9.9 ps at 3.35 TB/s. The hash is ~100
// 32-bit operations (12 64-bit multiplies at ~3, ~30 other 64-bit
// operations at ~2): 1.5 ps at 67e12/s. So bytes bound it; consecutive
// threads read and write consecutive words, so every access coalesces.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

using galah::u64;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // grid-stride beyond this
constexpr u64 kBias = 1ull << 63;

__global__ void __launch_bounds__(kThreads)
murmur3_k21_kernel(const u64* __restrict__ k1, const u64* __restrict__ k2,
                   const u64* __restrict__ tail,
                   const unsigned char* __restrict__ valid, long long n,
                   long long* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = valid[i]
                 ? static_cast<long long>(
                       galah::murmur3_k21(k1[i], k2[i], tail[i]) ^ kBias)
                 : INT64_MAX;
  }
}

}  // namespace

extern "C" int murmur3_k21_launch(const void* k1, const void* k2,
                                  const void* tail, const void* valid,
                                  long long n, void* out, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  murmur3_k21_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(k1), static_cast<const u64*>(k2),
      static_cast<const u64*>(tail),
      static_cast<const unsigned char*>(valid), n,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
