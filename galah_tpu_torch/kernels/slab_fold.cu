// Slab fold: the greedy peeling recurrence over one slab's edge list,
// in one launch.
//
// Port-only, like positional_hashes.cu: in galah_tpu the fold is XLA
// (galah_tpu/ops/megakernel.py:107 _slab_fold_jit, a lax.while_loop of
// scatter-max passes), not a Pallas kernel. Input: the pair queue's
// dense prefix of `count` 16-byte records (i int32, j int32, ani
// float64; i < j, both slab positions below `width`,
// ops/device_queue.py), the slab's already-clustered flags `ext` and
// the threshold. Output: one packed buffer (ops/megakernel.py
// packed_layout): the rep flags (one byte a position, 0 or 1) at 0, the
// still-undecided flags at `und_off`, and at `tail_off` the int32
// number of iterations run and the int32 number of undecided positions,
// so that one copy brings back all the host needs.
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
// What bounds it: not bytes (each record is read once, 16 B, and the
// flags cross device memory twice: 115 KB at count 4,096 and width
// 16,384, 0.034 us at 3.35 TB/s) but the chain of iterations, each a
// pass over the edges and the positions behind a barrier. The design
// keeps that chain on chip and short:
//
// * State in shared memory. The four flag arrays (und, rep, und_at,
//   rep_at: 4 bytes a position) and the passing edges live in the
//   shared memory of a thread-block cluster of 1, 2, 4 or 8 blocks of
//   1024 threads, the smallest that holds them (the wrapper's
//   fold_plan). Positions are split across the blocks in contiguous
//   ranges of `per_block`; a block's flags are read and written by
//   the others through distributed shared memory (mapa).
// * One prologue. A block reads its share of the records once
//   (16-byte loads, a warp on 32 consecutive records, the block's warps
//   taking chunks of 32 in turn so that a run of edges that stays live,
//   a chain, spreads over them), keeps only the passing ones as
//   (source, target) pairs, two uint16 up to a width of 65,536 and two
//   int32 above, in a segment of `per_warp` slots a warp, compacted by
//   ballot; `ext` is read once into the und flags, while the first
//   records are still in flight.
// * Live-edge compaction. An edge whose target is decided, or whose
//   source became a member, can never change a flag again. The pass
//   that scatters an iteration's edges drops them (ballot and popc, in
//   place within the warp's segment: a chunk's 32 edges are read before
//   any is written, and an edge only moves down), so later iterations
//   touch only edges that can still decide something. The edges it
//   drops would set flags of decided positions only, which the update
//   ignores, so the iterations and flags are those of the full pass.
// * Word-wide updates. A thread updates four positions at a time from
//   the 32-bit words of the four flag arrays, writes back only a word
//   where something was decided, and clears only the at-flags that
//   were set.
// * Two barriers an iteration: after the scatter and after the update
//   (__syncthreads in a lone block, barrier.cluster in a cluster).
//   Before the second, each warp that decided something sets its
//   block's "changed" word (two words by iteration parity, so no reset
//   races a reader); after it every thread reads all blocks' words.
//   Measured on the H100 (kernels/rehearse_slab_fold.py), an iteration
//   with little work costs about half a microsecond: the barriers and
//   three dependent shared-memory round trips, not the bytes.
//
// A slab whose state does not fit 8 SMs' shared memory takes the
// global-memory tier, the first design kept as it was (one block,
// flags in global memory as bytes, every record re-read and re-tested
// each iteration), chosen by the wrapper from the slab's size alone.
// Its epilogue also writes the undecided count into the packed tail.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// shared-memory header: two "changed" words (by iteration parity) and
// the block's undecided count
constexpr int kHead = 16;
constexpr int kMaxU16Width = 65536;
// chunks of 32 records a warp loads before the prologue reads ext
constexpr int kPrologueChunks = 4;

struct Record {
  int i;
  int j;
  double v;
};

// -- the cluster, in PTX (barrier.cluster and mapa; sm_90) ------------------

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return static_cast<int>(n);
}

// Every thread of every block of the cluster arrives; this block's
// shared-memory writes are then visible to the others' reads.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of `p` (in this block's shared memory) in the shared
// memory of the cluster's block `rank`.
template <class T>
__device__ __forceinline__ T* map_rank(T* p, int rank) {
  T* out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out)
               : "l"(p), "r"(rank));
  return out;
}

// -- the global-memory tier ------------------------------------------------

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
  // the packed tail: iterations, then undecided positions
  __shared__ int undecided;
  if (t == 0) undecided = 0;
  __syncthreads();
  int left = 0;
  for (int p = t; p < width; p += kThreads) left += und[p];
  if (left) atomicAdd(&undecided, left);
  __syncthreads();
  if (t == 0) {
    iters[0] = it;
    iters[1] = undecided;
  }
}

// -- the shared-memory tier ------------------------------------------------

// An edge in shared memory: (source, target) slab positions.
struct EdgeU16 {  // width <= 65,536: two uint16 in one word
  using Word = uint32_t;
  static __device__ Word pack(int s, int d) {
    return static_cast<uint32_t>(s) | (static_cast<uint32_t>(d) << 16);
  }
  static __device__ int src(Word w) { return static_cast<int>(w & 0xffffu); }
  static __device__ int dst(Word w) { return static_cast<int>(w >> 16); }
};

struct EdgeI32 {  // wider slabs: two int32
  using Word = int2;
  static __device__ Word pack(int s, int d) { return make_int2(s, d); }
  static __device__ int src(Word w) { return w.x; }
  static __device__ int dst(Word w) { return w.y; }
};

// The flag byte of slab position `p` in the array `local` (an array of
// this block's shared memory): in a cluster, the same array in the
// shared memory of the block that owns p. The owner is p / per_block,
// from a float product (p < 2^24, so at most one below) and a fix-up.
template <bool kCluster>
__device__ __forceinline__ unsigned char* flag_at(unsigned char* local,
                                                  int p, int per_block,
                                                  float inv_block) {
  if (!kCluster) return local + p;
  int owner = __float2int_rz(__int2float_rz(p) * inv_block);
  if ((owner + 1) * per_block <= p) ++owner;
  return map_rank(local, owner) +
         (p - owner * per_block);
}

// One pass of a warp over kChunks chunks of 32 of its live edges from
// `base`: each edge's target and source flags read, the at-flags of a
// live target set, and the edges that can still decide something
// written back from `kept` on. All the chunks are read before any is
// written, and an edge only moves down, so the pass is in place.
template <class E, bool kCluster, int kChunks>
__device__ __forceinline__ void scatter_chunks(
    typename E::Word* edges, int base, int live, int& kept, int lane,
    unsigned below, unsigned char* und, unsigned char* rep,
    unsigned char* und_at, unsigned char* rep_at, int per_block,
    float inv_block) {
  typename E::Word w[kChunks];
  bool keep[kChunks];
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int e = base + 32 * u + lane;
    w[u] = edges[e < live ? e : base];
  }
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const bool valid = base + 32 * u + lane < live;
    const int s = E::src(w[u]);
    const int d = E::dst(w[u]);
    const bool ud = valid && *flag_at<kCluster>(und, d, per_block, inv_block);
    const bool us = *flag_at<kCluster>(und, s, per_block, inv_block);
    const bool rs = *flag_at<kCluster>(rep, s, per_block, inv_block);
    if (ud && us) *flag_at<kCluster>(und_at, d, per_block, inv_block) = 1;
    if (ud && rs) *flag_at<kCluster>(rep_at, d, per_block, inv_block) = 1;
    keep[u] = ud && (us || rs);
  }
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const unsigned m = __ballot_sync(0xffffffffu, keep[u]);
    if (keep[u]) edges[kept + __popc(m & below)] = w[u];
    kept += __popc(m);
  }
}

template <class E, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
slab_fold_kernel_smem(const Record* __restrict__ q, int count,
                      const unsigned char* __restrict__ ext, int width,
                      double thr, int max_iters, int per_block,
                      int per_warp, unsigned char* __restrict__ out,
                      int und_off, int tail_off) {
  using Word = typename E::Word;
  extern __shared__ __align__(16) unsigned char smem[];
  int* head = reinterpret_cast<int*>(smem);  // changed[2], undecided
  unsigned char* und = smem + kHead;
  unsigned char* rep = und + per_block;
  unsigned char* und_at = rep + per_block;
  unsigned char* rep_at = und_at + per_block;
  uint32_t* und_w = reinterpret_cast<uint32_t*>(und);
  uint32_t* rep_w = reinterpret_cast<uint32_t*>(rep);
  uint32_t* und_at_w = reinterpret_cast<uint32_t*>(und_at);
  uint32_t* rep_at_w = reinterpret_cast<uint32_t*>(rep_at);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int blocks = kCluster ? cluster_blocks() : 1;
  const int rank = kCluster ? cluster_rank() : 0;
  const int p0 = rank * per_block;  // the first position this block owns
  const int words = per_block >> 2;
  const float inv_block = 1.0f / static_cast<float>(per_block);
  Word* edges = reinterpret_cast<Word*>(rep_at + per_block) + warp * per_warp;

  // prologue: a block takes ceil(count / blocks) records, its warps
  // their chunks of 32 in turn (so that a run of edges that stays live,
  // a chain, spreads over the warps); the loads of a warp's first
  // kPrologueChunks chunks are issued before ext is read, so that the
  // two reads of device memory overlap
  const int per_block_records = (count + blocks - 1) / blocks;
  const int b_lo = min(count, rank * per_block_records);
  const int b_hi = min(count, b_lo + per_block_records);
  const int4* raw = reinterpret_cast<const int4*>(q);
  const int first = b_lo + 32 * warp;
  int4 early[kPrologueChunks] = {};
#pragma unroll
  for (int u = 0; u < kPrologueChunks; ++u) {
    const int r = first + u * 32 * kWarps + lane;
    if (r < b_hi) early[u] = __ldg(raw + r);
  }
  // this block's positions: und from ext (past the width a position
  // reads as clustered, so it never changes), the other flags clear
  if (t < 3) head[t] = 0;
  for (int x = t; x < words; x += kThreads) {
    const int g = p0 + 4 * x;
    uint32_t e;  // ext bytes are 0 or 1
    if (g + 4 <= width) {
      e = *reinterpret_cast<const uint32_t*>(ext + g);
    } else {
      e = 0;
      for (int k = 0; k < 4; ++k) {
        e |= static_cast<uint32_t>(g + k < width ? ext[g + k] : 1) << (8 * k);
      }
    }
    und_w[x] = (e ^ 0x01010101u) & 0x01010101u;
    rep_w[x] = 0;
    und_at_w[x] = 0;
    rep_at_w[x] = 0;
  }
  // the passing records kept as edges, in order, in the warp's segment
  int live = 0;
  auto keep_chunk = [&](int base, const int4& rec) {
    const bool valid = base + lane < b_hi;
    const bool keep = valid && __hiloint2double(rec.w, rec.z) >= thr;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (keep) edges[live + __popc(m & below)] = E::pack(rec.x, rec.y);
    live += __popc(m);
  };
#pragma unroll
  for (int u = 0; u < kPrologueChunks; ++u) {
    const int base = first + u * 32 * kWarps;
    if (base < b_hi) keep_chunk(base, early[u]);
  }
  for (int base = first + kPrologueChunks * 32 * kWarps; base < b_hi;
       base += 32 * kWarps) {
    int4 rec{};
    if (base + lane < b_hi) rec = __ldg(raw + base + lane);
    keep_chunk(base, rec);
  }
  if (kCluster) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  int it = 0;
  bool changed = true;  // the same in every thread of the cluster
  while (changed && it < max_iters) {
    // scatter the live edges, dropping those that can no longer decide
    // anything (target decided, or source a member)
    int kept = 0;
    int base = 0;
    for (; base + 96 < live; base += 128) {
      scatter_chunks<E, kCluster, 4>(edges, base, live, kept, lane, below,
                                     und, rep, und_at, rep_at, per_block,
                                     inv_block);
    }
    for (; base < live; base += 32) {
      scatter_chunks<E, kCluster, 1>(edges, base, live, kept, lane, below,
                                     und, rep, und_at, rep_at, per_block,
                                     inv_block);
    }
    live = kept;
    if (kCluster) {
      cluster_sync();
    } else {
      __syncthreads();
    }
    // update this block's positions, four at a time
    int mine = 0;
    for (int x = t; x < words; x += kThreads) {
      const uint32_t u = und_w[x];
      const uint32_t ua = und_at_w[x];
      const uint32_t ra = rep_at_w[x];
      // a member (rep_at) or a new rep (neither flag)
      const uint32_t decided = u & (ra | ~ua);
      if (decided) {
        und_w[x] = u ^ decided;
        rep_w[x] |= u & ~ua & ~ra;
        mine = 1;
      }
      if (ua | ra) {
        und_at_w[x] = 0;
        rep_at_w[x] = 0;
      }
    }
    // "changed": a word a block, by iteration parity (every thread read
    // the other parity's words before this iteration's first barrier)
    if (t == 0) head[(it + 1) & 1] = 0;
    if (__any_sync(0xffffffffu, mine) && lane == 0) head[it & 1] = 1;
    if (kCluster) {
      cluster_sync();
      int any = 0;
      for (int r = 0; r < blocks; ++r) any |= *map_rank(head + (it & 1), r);
      changed = any != 0;
    } else {
      __syncthreads();
      changed = head[it & 1] != 0;
    }
    ++it;
  }

  // outputs: this block's positions, a word at a time (past the width
  // they fall in the packed layout's padding, as zeros)
  const int owned = min(per_block, width - p0);
  int left = 0;
  for (int x = t; 4 * x < owned; x += kThreads) {
    const uint32_t u = und_w[x];
    reinterpret_cast<uint32_t*>(out + p0)[x] = rep_w[x];
    reinterpret_cast<uint32_t*>(out + und_off + p0)[x] = u;
    left += __popc(u);
  }
  for (int o = 16; o; o >>= 1) left += __shfl_xor_sync(0xffffffffu, left, o);
  if (lane == 0 && left) atomicAdd(head + 2, left);
  if (kCluster) {
    cluster_sync();
    if (rank == 0 && t == 0) {
      int total = 0;
      for (int r = 0; r < blocks; ++r) total += *map_rank(head + 2, r);
      reinterpret_cast<int*>(out + tail_off)[0] = it;
      reinterpret_cast<int*>(out + tail_off)[1] = total;
    }
    // no block leaves while block 0 may still read its shared memory
    cluster_sync();
  } else {
    __syncthreads();
    if (t == 0) {
      reinterpret_cast<int*>(out + tail_off)[0] = it;
      reinterpret_cast<int*>(out + tail_off)[1] = head[2];
    }
  }
}

__global__ void slab_fold_empty_kernel() {}

// Each device's opt-in dynamic shared memory a block, set on each
// shared-memory instantiation at its first launch on that device (the
// attribute is a function's on one device).
constexpr int kMaxDevices = 64;
constexpr int kSmemKernels = 3;
int g_smem_limit[kMaxDevices][kSmemKernels] = {};
bool g_smem_set[kMaxDevices][kSmemKernels] = {};

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int slot, int dev, int* limit) {
  if (!g_smem_set[dev][slot]) {
    int optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    const int room = optin - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    if (err != cudaSuccess) return err;
    g_smem_limit[dev][slot] = room;
    g_smem_set[dev][slot] = true;
  }
  *limit = g_smem_limit[dev][slot];
  return cudaSuccess;
}

template <class E, bool kCluster>
cudaError_t launch_smem(int slot, int dev, int cluster, int smem,
                        cudaStream_t s, const Record* q, int count,
                        const unsigned char* ext, int width, double thr,
                        int max_iters, int per_block, int per_warp,
                        unsigned char* out, int und_off, int tail_off) {
  auto kernel = slab_fold_kernel_smem<E, kCluster>;
  int limit = 0;
  cudaError_t err = allow_smem(kernel, slot, dev, &limit);
  if (err != cudaSuccess) return err;
  if (smem > limit) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, q, count, ext, width, thr,
                            max_iters, per_block, per_warp, out, und_off,
                            tail_off);
}

}  // namespace

// `thr_bits`: the threshold's IEEE float64 bits, so the kernel compares
// against the very double the host holds. `cluster`: blocks in the
// cluster (1, 2, 4 or 8), or 0 for the global-memory tier, which takes
// `scratch` (2 x width bytes). `per_block`, `per_warp`: the plan's
// positions a block (a multiple of 16) and edge slots a warp. `out`:
// the packed output, `und_off` and `tail_off` 16-byte aligned.
extern "C" int slab_fold_launch(const void* records, int count,
                                const void* ext, int width,
                                long long thr_bits, int max_iters,
                                int cluster, int per_block, int per_warp,
                                void* out, int und_off, int tail_off,
                                void* scratch, void* stream) {
  if (width <= 0) return 0;
  double thr;
  std::memcpy(&thr, &thr_bits, sizeof thr);
  const auto* q = static_cast<const Record*>(records);
  const auto* e = static_cast<const unsigned char*>(ext);
  auto* o = static_cast<unsigned char*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 0) {
    unsigned char* flags = static_cast<unsigned char*>(scratch);
    slab_fold_kernel<<<1, kThreads, 0, s>>>(
        q, count, e, width, thr, max_iters, o, o + und_off, flags,
        flags + width, reinterpret_cast<int*>(o + tail_off));
    return static_cast<int>(cudaGetLastError());
  }
  const int per_block_records = (count + cluster - 1) / cluster;
  if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      per_block <= 0 || per_block % 16 != 0 ||
      static_cast<long long>(per_block) * cluster < width ||
      per_warp < 32 * ((per_block_records + 32 * kWarps - 1) /
                       (32 * kWarps)) ||
      und_off % 16 != 0 || tail_off % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const bool narrow = width <= kMaxU16Width;
  const long long smem = kHead + 4LL * per_block +
                         static_cast<long long>(per_warp) * kWarps *
                             (narrow ? 4 : 8);
  if (smem > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(smem);
  // (no lone block holds a slab wider than 65,536: its 4 flag bytes a
  // position alone pass 227 KB, so int32 edges always run as a cluster)
  if (narrow && cluster == 1) {
    err = launch_smem<EdgeU16, false>(0, dev, 1, bytes, s, q, count, e,
                                      width, thr, max_iters, per_block,
                                      per_warp, o, und_off, tail_off);
  } else if (narrow) {
    err = launch_smem<EdgeU16, true>(1, dev, cluster, bytes, s, q, count, e,
                                     width, thr, max_iters, per_block,
                                     per_warp, o, und_off, tail_off);
  } else {
    err = launch_smem<EdgeI32, true>(2, dev, cluster, bytes, s, q, count, e,
                                     width, thr, max_iters, per_block,
                                     per_warp, o, und_off, tail_off);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of the fold's block shape on `stream`: the launch
// floor the fold's time is read beside.
extern "C" int slab_fold_empty(void* stream) {
  slab_fold_empty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
