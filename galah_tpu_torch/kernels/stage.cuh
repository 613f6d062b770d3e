// Staging of an int64 run from device memory into shared memory with
// cp.async, shared by window_hits.cu, tile_stats.cu and pairlist.cu.
//
// Where source and destination share their offset modulo 16 bytes the
// run moves as 16-byte copies (one 8-byte copy at each ragged end);
// otherwise as 8-byte copies. Threads t of nt (the whole block, or the
// lanes of one warp) call it with the same arguments; the copies land
// once the caller has run stage_wait() and then __syncthreads() (or,
// for one warp's copies, __syncwarp()).

#pragma once

#include <cstdint>
#include <cuda_pipeline.h>

__device__ __forceinline__ void stage_async(long long* dst,
                                            const long long* src,
                                            long long n, int t, int nt) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  if (((s ^ d) & 15) != 0) {
    for (long long i = t; i < n; i += nt) {
      __pipeline_memcpy_async(dst + i, src + i, 8);
    }
    return;
  }
  const long long head = ((s & 15) != 0 && n > 0) ? 1 : 0;
  const long long pairs = (n - head) >> 1;
  if (t == 0 && head) __pipeline_memcpy_async(dst, src, 8);
  for (long long v = t; v < pairs; v += nt) {
    __pipeline_memcpy_async(dst + head + 2 * v, src + head + 2 * v, 16);
  }
  const long long tail = head + 2 * pairs;
  if (t == 0 && tail < n) {
    __pipeline_memcpy_async(dst + tail, src + tail, 8);
  }
}

// the whole block copies
__device__ __forceinline__ void stage_async(long long* dst,
                                            const long long* src,
                                            long long n) {
  stage_async(dst, src, n, threadIdx.x, blockDim.x);
}

__device__ __forceinline__ void stage_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}
