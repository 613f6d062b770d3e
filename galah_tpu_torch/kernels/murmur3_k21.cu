// k=21 murmur3 window hashes, from a sequence's codes: one hash per
// window.
//
// Replaces the TPU kernel galah_tpu/ops/pallas_sketch.py
// (murmur3_k21_pallas / _make_kernel), the murmur3 stage of the k-mer
// hash (galah_tpu/ops/hashing._hash_core at k=21), together with the
// XLA preamble whose key words that kernel consumes (window packing,
// boundary masking, canonical selection and the key-word assembly of
// galah_tpu/ops/hashing.py _murmur3_k21_1d). Input: a sequence's codes
// (uint8, 0-3 or 255 ambiguous; a genome, or a launch group's genomes
// laid end to end), its sorted contig starts, and a range of windows.
// Output: per window the murmur3 x64_128 h1 (seed 0, length 21) of its
// canonical ASCII 21-mer in the port's biased form (u64 ^ 2^63), or the
// sentinel INT64_MAX where the window is invalid (canonical.cuh).
//
// The TPU kernel emulated every 64-bit multiply with 16-bit limb
// products over (hi, lo) u32 planes, because the TPU vector unit has no
// u64 multiply. Here a thread takes a run of 16 consecutive windows,
// rolls the canonical packs along it (canonical.cuh: one byte load a
// window and the run's 20-base halo) and hashes each window with native
// 64-bit arithmetic (murmur3.cuh, shared with fused_sketch.cu). The
// block's 4096 hashes go through shared memory (a 17-word pitch a run:
// no bank conflicts) so that the stores to device memory coalesce. A
// grid-stride loop over 4096-window tiles takes any window count in one
// launch.
//
// Bound: 1 B a base in, 8 B a window out: 9 B a window, 2.7 ps at 3.35
// TB/s. Operations a valid window, in 32-bit operations: the roll ~12,
// the canonical select and the ASCII key words ~50, the hash ~100, the
// sentinel select ~4: ~170, 2.5 ps at 67e12/s. Bytes and operations
// are about even (32 M windows: 0.086 ms by bytes, 0.081 ms by
// operations); the design writes each hash once, coalesced, and keeps
// the key words in registers.
//
// ptxas (sm_90a, `python -m galah_tpu_torch.kernels.build --ptxas`):
// 36 registers, no spills, 34,816 B of static shared memory a block,
// so six 256-thread blocks an SM (48 warps).

#include <cstdint>
#include <cuda_runtime.h>

#include "canonical.cuh"

namespace {

using galah::u64;
using galah::u8;

constexpr int kK = 21;
constexpr int kThreads = 256;
constexpr int kRun = 16;                // windows a thread
constexpr int kPitch = kRun + 1;
constexpr int kTile = kThreads * kRun;  // windows a block a step
constexpr long long kMaxBlocks = 1 << 16;  // grid-stride beyond this
constexpr u64 kBias = 1ull << 63;

__global__ void __launch_bounds__(kThreads)
murmur3_k21_kernel(const u8* __restrict__ codes,
                   const long long* __restrict__ starts, long long n_starts,
                   long long win0, long long n_win,
                   long long* __restrict__ out) {
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
            slot[i] = valid ? static_cast<long long>(
                                  galah::murmur3_canonical21(f, r) ^ kBias)
                            : INT64_MAX;
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

extern "C" int murmur3_k21_launch(const void* codes, const void* starts,
                                  long long n_starts, long long win0,
                                  long long n_win, void* out, void* stream) {
  if (n_win <= 0) return 0;
  long long blocks = (n_win + kTile - 1) / kTile;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  murmur3_k21_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u8*>(codes), static_cast<const long long*>(starts),
      n_starts, win0, n_win, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
