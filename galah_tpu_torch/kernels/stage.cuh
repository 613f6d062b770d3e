// Block-wide staging of an int64 run from device memory into shared
// memory with cp.async, shared by window_hits.cu and tile_stats.cu.
//
// Where source and destination share their offset modulo 16 bytes the
// run moves as 16-byte copies (one 8-byte copy at each ragged end);
// otherwise as 8-byte copies. Every thread of the block calls it with
// the same arguments; the copies land once the caller has run
// stage_wait() and then __syncthreads().

#pragma once

#include <cstdint>
#include <cuda_pipeline.h>

__device__ __forceinline__ void stage_async(long long* dst,
                                            const long long* src,
                                            long long n) {
  const int t = threadIdx.x;
  const int nt = blockDim.x;
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

__device__ __forceinline__ void stage_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}
