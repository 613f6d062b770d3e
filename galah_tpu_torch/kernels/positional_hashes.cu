// k=15 positional window hashes, from a group's codes: one hash per
// window, murmur3 or tpufast.
//
// No TPU kernel is its counterpart: galah_tpu hashes its k=15 profile
// windows in XLA (galah_tpu/ops/hashing.py _hash_core, reached from
// ops/fragment_ani.positional_hashes_batch through
// canonical_kmer_hashes_batch_jit). This kernel computes that function
// at k=15 for both hashes: input, a sequence's codes (uint8, 0-3 or 255
// ambiguous; a profile group's genomes laid end to end, each genome
// start a contig start), its sorted contig starts, and a range of
// windows; output, per window the hash of its canonical 15-mer in the
// port's biased form (u64 ^ 2^63), or the sentinel INT64_MAX where the
// window holds an ambiguous base or a contig start lies in (p, p + 14].
// It is the same function as ops/hashing.positional_hashes' torch route
// at k=15 (ops/positional_hashes.positional_hashes_plain).
//
// murmur3: x64_128 h1 (seed 0, length 15) of the canonical ASCII
// 15-mer. The key has no 16-byte block: word 0 holds bytes 0-7 (k1)
// and a 7-byte tail bytes 8-14 (k2, top byte zero); 15 & 15 > 8, so the
// tail mixes k2 into h2 and k1 into h1 (ops/hashing.murmur3_h1_words).
// tpufast: the multiply-free mixer of the canonical 2-bit pack (30
// bits, MSB-first; ops/hashing.tpufast_mix).
//
// Design: the layout of murmur3_k21.cu. A thread takes a run of 16
// consecutive windows and rolls the canonical packs along it
// (canonical.cuh for_each_window: one byte load a window, one binary
// search of the contig starts a run), hashing each window with native
// 64-bit arithmetic. The block's 4096 hashes go through shared memory
// (a 17-word pitch a run: no bank conflicts) so that the stores to
// device memory coalesce. A grid-stride loop over 4096-window tiles
// takes any window count in one launch. The k=15 helpers live here and
// not in canonical.cuh or murmur3.cuh: build.py hashes every .cuh into
// every library's name, and the k=21 kernels stay as verified.
//
// Bound: 1 B a base in, 8 B a window out: 9 B a window, 2.7 ps at 3.35
// TB/s (a 16 M-window group: 0.045 ms). 32-bit operations a valid
// window: the roll ~12, the canonical select and ASCII key words ~40,
// the hash ~90, the sentinel select ~4: ~150 for murmur3, 2.2 ps at
// 67e12/s; tpufast ~45. Bytes bound both, murmur3 narrowly.

#include <cstdint>
#include <cuda_runtime.h>

#include "canonical.cuh"

namespace {

using galah::u64;
using galah::u8;

constexpr int kK = 15;
constexpr int kThreads = 256;
constexpr int kRun = 16;                // windows a thread
constexpr int kPitch = kRun + 1;
constexpr int kTile = kThreads * kRun;  // windows a block a step
constexpr long long kMaxBlocks = 1 << 16;  // grid-stride beyond this
constexpr u64 kBias = 1ull << 63;

// murmur3 x64_128 h1 (seed 0, length 15) of a key given as its
// little-endian words: bytes 0-7 (k1) and 8-14 (k2)
__device__ __forceinline__ u64 murmur3_k15(u64 k1, u64 k2) {
  constexpr u64 c1 = 0x87C37B91114253D5ull;
  constexpr u64 c2 = 0x4CF5AD432745937Full;
  u64 h2 = galah::rotl(k2 * c2, 33) * c1;
  u64 h1 = galah::rotl(k1 * c1, 31) * c2;
  h1 ^= kK;
  h2 ^= kK;
  h1 += h2;
  h2 += h1;
  return galah::fmix(h1) + galah::fmix(h2);
}

// murmur3 of the canonical 15-mer whose forward and reverse-complement
// packs (MSB-first) are f and r: the canonical string's LSB-first pack
// is one select (canonical.cuh), and its 15 ASCII bytes two words
__device__ __forceinline__ u64 murmur3_canonical15(u64 f, u64 r) {
  constexpr u64 kMask = (1ull << (2 * kK)) - 1;
  const u64 lsb = (f <= r ? r : f) ^ kMask;
  const u64 k1 = galah::ascii8(lsb);
  const u64 k2 =
      static_cast<u64>(
          galah::ascii4(static_cast<unsigned>(lsb >> 16) & 0xFFu)) |
      (static_cast<u64>(
           galah::ascii4(static_cast<unsigned>(lsb >> 24) & 0x3Fu) &
           0x00FFFFFFu)
       << 32);
  return murmur3_k15(k1, k2);
}

// the multiply-free shift-add mixer (ops/hashing.tpufast_mix) at seed 0
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

template <bool kTpufast>
__global__ void __launch_bounds__(kThreads)
positional_hashes_kernel(const u8* __restrict__ codes,
                         const long long* __restrict__ starts,
                         long long n_starts, long long win0,
                         long long n_win, long long* __restrict__ out) {
  __shared__ long long hs[kThreads * kPitch];
  const int t = threadIdx.x;
  long long* slot = hs + t * kPitch;
  for (long long base = static_cast<long long>(blockIdx.x) * kTile;
       base < n_win; base += static_cast<long long>(gridDim.x) * kTile) {
    const long long q0 = base + t * kRun;
    const long long left = n_win - q0;
    const int n = left <= 0 ? 0 : (left < kRun ? static_cast<int>(left) : kRun);
    if (n > 0) {
      galah::for_each_window(
          codes, starts, n_starts, win0 + q0, n, kK,
          [&](int i, bool valid, u64 f, u64 r) {
            const u64 h = kTpufast ? tpufast(f <= r ? f : r)
                                   : murmur3_canonical15(f, r);
            slot[i] = valid ? static_cast<long long>(h ^ kBias) : INT64_MAX;
          });
    }
    __syncthreads();
    const long long m = n_win - base < kTile ? n_win - base : kTile;
    for (int i = t; i < m; i += kThreads)
      out[base + i] = hs[(i / kRun) * kPitch + i % kRun];
    __syncthreads();
  }
}

}  // namespace

// algo: 0 murmur3, 1 tpufast
extern "C" int positional_hashes_launch(const void* codes, const void* starts,
                                        long long n_starts, long long win0,
                                        long long n_win, int algo, void* out,
                                        void* stream) {
  if (n_win <= 0) return 0;
  if (algo != 0 && algo != 1) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n_win + kTile - 1) / kTile;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const auto c = static_cast<const u8*>(codes);
  const auto s = static_cast<const long long*>(starts);
  const auto o = static_cast<long long*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (algo == 1) {
    positional_hashes_kernel<true><<<static_cast<unsigned>(blocks), kThreads,
                                     0, st>>>(c, s, n_starts, win0, n_win, o);
  } else {
    positional_hashes_kernel<false><<<static_cast<unsigned>(blocks), kThreads,
                                      0, st>>>(c, s, n_starts, win0, n_win, o);
  }
  return static_cast<int>(cudaGetLastError());
}
