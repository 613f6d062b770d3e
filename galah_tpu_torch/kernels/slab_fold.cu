// Slab fold: the greedy peeling recurrence over one slab's edge list,
// in one launch.
//
// Port-only, like positional_hashes.cu: in galah_tpu the fold is XLA
// (galah_tpu/ops/megakernel.py:109 _slab_fold_jit, a lax.while_loop of
// scatter-max passes), not a Pallas kernel. Input: the pair queue's
// dense prefix of `count` 16-byte records (i int32, j int32, ani
// float64; i < j, both slab positions below `width`,
// ops/device_queue.py), the slab's already-clustered flags `ext` and
// the threshold. Output: per position, rep and still-undecided flags
// (one byte each, 0 or 1), and the number of iterations run.
//
// The recurrence, iterated to a fixpoint or to `max_iters` (the slab
// width: each iteration decides at least the lowest undecided
// position, so a slab converges within it):
//   an edge passes when ani >= thr (one IEEE compare: NaN never
//   passes, and ani == thr does);
//   und_at[j] = some passing edge (i, j) has i undecided;
//   rep_at[j] = some passing edge (i, j) has i a rep;
//   an undecided j with rep_at becomes a member, one with neither
//   becomes a rep.
// Stored values are compared as they are, never re-derived, so the
// flags equal the dense window fold's and the host scan's.
//
// The fold exists to make one device program out of a slab of round
// windows: a torch loop to the fixpoint would pay a host sync an
// iteration. One block of 1024 threads runs every iteration, with the
// flags in global memory (width bytes each, cached in L1/L2): strided
// passes clear the two scatter flags, scatter over [0, count) (plain
// byte stores: every writer stores 1), then update the positions;
// __syncthreads separates the passes and __syncthreads_or tells every
// thread whether anything changed.
//
// Bound: each record read once (16 B), ext read and the two outputs
// written once: 16 count + 3 width bytes; at count 4096 and width
// 16,384 that is 115 KB, 0.034 us at 3.35 TB/s. Operations a run:
// about 6 an edge and 6 a position an iteration (the launch is
// latency bound: its ~4 barriers an iteration and one block set the
// time, not the bytes).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

struct Record {
  int i;
  int j;
  double v;
};

__global__ void __launch_bounds__(kThreads)
slab_fold_kernel(const Record* __restrict__ q, int count,
                 const unsigned char* __restrict__ ext, int width,
                 double thr, int max_iters, unsigned char* rep,
                 unsigned char* und, unsigned char* und_at,
                 unsigned char* rep_at, int* __restrict__ iters) {
  const int t = threadIdx.x;
  for (int p = t; p < width; p += kThreads) {
    und[p] = ext[p] ? 0 : 1;
    rep[p] = 0;
  }
  __syncthreads();
  int it = 0;
  bool changed = true;  // the same in every thread of the block
  while (changed && it < max_iters) {
    for (int p = t; p < width; p += kThreads) {
      und_at[p] = 0;
      rep_at[p] = 0;
    }
    __syncthreads();
    for (int e = t; e < count; e += kThreads) {
      const Record r = q[e];
      if (r.v >= thr) {
        if (und[r.i]) und_at[r.j] = 1;
        if (rep[r.i]) rep_at[r.j] = 1;
      }
    }
    __syncthreads();
    int mine = 0;
    for (int p = t; p < width; p += kThreads) {
      if (!und[p]) continue;
      if (rep_at[p]) {
        und[p] = 0;
        mine = 1;
      } else if (!und_at[p]) {
        rep[p] = 1;
        und[p] = 0;
        mine = 1;
      }
    }
    changed = __syncthreads_or(mine) != 0;
    ++it;
  }
  if (t == 0) *iters = it;
}

}  // namespace

// `thr_bits`: the threshold's IEEE float64 bits, so the kernel compares
// against the very double the host holds. `scratch`: 2 x width bytes.
extern "C" int slab_fold_launch(const void* records, int count,
                                const void* ext, int width,
                                long long thr_bits, int max_iters,
                                void* rep, void* und, void* scratch,
                                void* iters, void* stream) {
  if (width <= 0) return 0;
  double thr;
  std::memcpy(&thr, &thr_bits, sizeof thr);
  unsigned char* flags = static_cast<unsigned char*>(scratch);
  slab_fold_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Record*>(records), count,
      static_cast<const unsigned char*>(ext), width, thr, max_iters,
      static_cast<unsigned char*>(rep), static_cast<unsigned char*>(und),
      flags, flags + width, static_cast<int*>(iters));
  return static_cast<int>(cudaGetLastError());
}
