// k=15 positional window hashes, from a group's codes: one hash per
// window, murmur3 or tpufast.
//
// No TPU kernel is its counterpart: galah_tpu hashes its k=15 profile
// windows in XLA (galah_tpu/ops/hashing.py _hash_core, reached from
// ops/fragment_ani.positional_hashes_batch through
// canonical_kmer_hashes_batch_jit). This kernel computes that function
// at k=15 for both hashes: input, a sequence's codes (uint8, 0-3 or 255
// ambiguous; a profile group's genomes laid end to end, each genome
// start a contig start) and its sorted contig starts; output, per
// window the hash of its canonical 15-mer in the port's biased form
// (u64 ^ 2^63), or the sentinel INT64_MAX where the window holds an
// ambiguous base or a contig start lies in (p, p + 14]. It is the same
// function as ops/hashing.positional_hashes' torch route at k=15
// (ops/positional_hashes.positional_hashes_plain).
//
// murmur3: x64_128 h1 (seed 0, length 15) of the canonical ASCII
// 15-mer. The key has no 16-byte block: word 0 holds bytes 0-7 (k1)
// and a 7-byte tail bytes 8-14 (k2, top byte zero); 15 & 15 > 8, so the
// tail mixes k2 into h2 and k1 into h1 (ops/hashing.murmur3_h1_words).
// tpufast: the multiply-free mixer of the canonical 2-bit pack (30
// bits, MSB-first; ops/hashing.tpufast_mix).
//
// Two entries share the kernel. positional_hashes_launch hashes a range
// of windows into one output. positional_hashes_group_launch hashes a
// profile group: a device table gives each genome its first window,
// window count and output address, every genome's windows land in its
// own tensor, the 14 windows that straddle two genomes are not hashed,
// and hashes at or above the subsample cut (2^64 / c, biased) become
// the sentinel in the same pass.
//
// Design. Tiles of 8192 windows are cut from each genome's first
// window, so no tile crosses a genome; the grid is the blocks that fit
// on the card at once (5 a multiprocessor for murmur3, 8 for tpufast),
// and each block takes a contiguous run of the tiles. A block finds its
// first genome (a search of the table's running tile counts) and its
// first contig start (a search of the starts), 32 probes a warp step,
// once; after that thread 0 walks the genomes tile by tile (the next
// genome's row loaded ahead) and the start index is carried from one
// tile to the next by the count of starts the scan below passed. Each
// tile's 8206 bases are staged in shared memory by 16-byte cp.async
// copies (the ragged bytes at either end by loads into registers,
// stored before the tile's barrier), double-buffered: the next tile's
// copy is in flight while this one is built and hashed. Once a tile,
// from the staged bytes: a forward 2-bit pack (16 bases a word,
// MSB-first), an ambiguity bit a base, and a contig-start bit a base
// (the starts in the tile's span, one shared atomicOr each). Then a
// thread takes two neighbouring windows at a time, consecutive threads
// on consecutive pairs: one funnel shift of two pack words gives the 16
// bases of both windows (the top 30 bits window s's forward pack, the
// low 30 bits window s + 1's); one bit reversal of their complement,
// each 2-bit field's bits swapped back, gives both reverse complements;
// validity is one funnel shift of each bit array, masked twice (bases
// s .. s + 14 unambiguous, no start in s + 1 .. s + 14); and the pair
// goes to device memory as one 16-byte streaming store, so no
// shared-memory transpose stands between the hashes and the stores.
//
// The ASCII key words: the canonical string's LSB-first pack is one
// select (r ^ mask where f <= r, else f ^ mask), and each of its four
// bytes (four codes) indexes a 256-word table in shared memory that
// holds their four ASCII bytes (A C G T = 65 67 71 84); k2 drops the
// eighth byte. The table took 0.0804-0.0809 ms against 0.0947-0.0952
// for byte permutes of each window's codes spread to nibble selectors
// by three shift-and-mask steps (rehearse_positional_hashes.py's
// ascii-prmt variant; NVIDIA H100 80GB HBM3, 700.00 W). murmur3's
// 64-bit multiplies (8 a window, ~3 IMADs each) are as the compiler
// emits them.
//
// Bound, from the SASS of the window loop (cuobjdump -sass, counted by
// rehearse_positional_hashes.py: one loop iteration is a pair) and
// ptxas (-Xptxas -v: murmur3 47 registers, tpufast 32, 22,960 bytes of
// static shared memory, no spills). Instructions a window: murmur3
// 100.5, of which 50.5 on the integer ALU pipe, 42 IMADs on the FMA
// pipe and 7 shared loads; tpufast 50.5, of which 29 ALU, 17.5 IMAD, 3
// shared. An sm_90 multiprocessor issues 128 thread-instructions a
// clock (4 schedulers x 32 lanes), its ALU pipe and its IMAD pipe take
// 64 lanes a clock each, its shared memory 32 (CUDA C++ Programming
// Guide, arithmetic instruction throughput, compute capability 9.0);
// at 132 multiprocessors and the 1980 MHz maximum SM clock
// (nvidia-smi clocks.max.sm) the ALU pipe binds murmur3: 15,987,522
// valid windows x 50.5 / 64 / 132 / 1.98e9 = 0.0483 ms, above its bytes'
// 0.0430 ms (1 byte a base in, 8 a window out: 144 MB at 3.35 TB/s).
// tpufast: ALU 0.0277 ms, so its bytes bind (0.0430 ms). In 32-bit
// operations at 67e12/s, the rule of kernels/costs.py, an ALU
// instruction counts 4 (64 lanes a clock against the 128 two-operation
// FMAs behind 67e12/s): 202 a window for murmur3, 116 for tpufast.
// Measured at that group: murmur3 0.0804-0.0809 ms, 60% of its bound;
// tpufast 0.0554-0.0563 ms, 77% of its bytes' (a fill_ of the same
// output alone takes 0.0416-0.0418 ms). What the design does about it:
// pairs of windows halve the frame's share (the funnel shifts, bit
// tests, reversal and loop) of the ALU count, the table halves the
// key words', and the staging keeps every global load off the window
// loop; what remains of murmur3 is its own arithmetic.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

using galah::u64;
typedef unsigned char u8;

constexpr int kK = 15;
constexpr int kThreads = 256;
constexpr int kTile = 8192;  // windows a tile
// staged bytes: up to 15 before the first base's 16-byte alignment, the
// tile's kTile + 14 bases, rounded up to whole 32-base units, one spare
constexpr int kUnits = (15 + kTile + kK - 1 + 31) / 32 + 2;
constexpr u64 kBias = 1ull << 63;
constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFll;
constexpr unsigned kMask30 = (1u << (2 * kK)) - 1;

// A genome table: (4, n) int64, rows the running tile count through
// each genome, its first window, its window count and its output's
// address; or, with no table, the one range below.
struct Jobs {
  const long long* table;
  long long n;
  long long first, count;
  long long* out;
};

// a tile: its first window, its output's address, its window count (0:
// no tile)
struct Geo {
  long long p0;
  long long* out;
  int n;
};

// Thread 0's walk over the block's tiles: the next tile to describe and
// the block's end, its genome j and that genome's first tile, genome
// j's row and genome j + 1's, loaded ahead.
struct Cursor {
  long long t, t_end, j, tstart;
  long long first, count, nfirst, ncount;
  long long* out;
  long long* nout;
};

struct Smem {
  alignas(16) u8 codes[2][kUnits * 32];  // the staged bases, two tiles
  unsigned pack[2 * kUnits];  // 16 bases a word, MSB-first
  unsigned amb[kUnits];       // bit j: staged base j is ambiguous
  unsigned st[2][kUnits];     // bit j: staged base j is a contig start
  unsigned ascii[256];        // 4 codes (LSB-first) -> their ASCII bytes
  Geo geo[3];                 // tiles k, k + 1, k + 2
  Cursor cur;
  long long si0;              // the block's first start index
  int cnt[2];                 // starts up to the next tile's first window
};

// the first index in [0, n) whose value is > key (n if none), all 32
// lanes of a full warp calling with the same arguments: 32 probes a step
__device__ __forceinline__ long long warp_first_greater(
    const long long* __restrict__ a, long long n, long long key) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) >> 5;
    const long long idx = lo + lane * step;
    const bool le = idx < hi && __ldg(a + idx) <= key;
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, le));
    const long long nhi = lo + c * step < hi ? lo + c * step : hi;
    lo = c > 0 ? lo + (c - 1) * step + 1 : lo;
    hi = nhi;
  }
  const long long idx = lo + lane;
  const bool le = idx < hi && __ldg(a + idx) <= key;
  return lo + __popc(__ballot_sync(0xFFFFFFFFu, le));
}

__device__ __forceinline__ void read_job(const Jobs& jobs, long long j,
                                         long long& first, long long& count,
                                         long long*& out) {
  if (jobs.table == nullptr) {
    first = jobs.first;
    count = j == 0 ? jobs.count : 0;
    out = jobs.out;
  } else if (j < jobs.n) {
    first = __ldg(jobs.table + jobs.n + j);
    count = __ldg(jobs.table + 2 * jobs.n + j);
    out = reinterpret_cast<long long*>(__ldg(jobs.table + 3 * jobs.n + j));
  } else {
    first = count = 0;
    out = nullptr;
  }
}

// the cursor's next tile (thread 0); into genome j + 1 when genome j's
// tiles are done, loading genome j + 2's row
__device__ __forceinline__ Geo describe(Cursor& c, const Jobs& jobs) {
  Geo g{0, nullptr, 0};
  if (c.t >= c.t_end) return g;
  const long long tiles = (c.count + kTile - 1) / kTile;
  if (c.t - c.tstart >= tiles) {
    c.tstart += tiles;
    ++c.j;
    c.first = c.nfirst;
    c.count = c.ncount;
    c.out = c.nout;
    read_job(jobs, c.j + 1, c.nfirst, c.ncount, c.nout);
  }
  const long long w = (c.t - c.tstart) * kTile;
  g.p0 = c.first + w;
  g.out = c.out + w;
  g.n = static_cast<int>(c.count - w < kTile ? c.count - w : kTile);
  ++c.t;
  return g;
}

// Start the copy of the tile's bases [p0, p0 + n + 14) into buf, staged
// byte s at address (codes + p0) - sh + s, sh = that address mod 16:
// whole 16-byte chunks by cp.async, the ragged bytes at either end
// loaded by threads 0-31 into (rag_at, rag_val), stored by the caller
// before the tile's barrier. Returns sh.
__device__ __forceinline__ int stage_tile(u8* buf, const u8* __restrict__ codes,
                                          const Geo& tile, int& rag_at,
                                          unsigned& rag_val) {
  const u8* src = codes + tile.p0;
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const u8* base = src - sh;
  const int end = sh + tile.n + kK - 1;
  const int c0 = (sh + 15) >> 4;  // whole chunks [c0, c1)
  const int c1 = end >> 4;
  const int t = threadIdx.x;
  for (int c = c0 + t; c < c1; c += kThreads)
    __pipeline_memcpy_async(buf + 16 * c, base + 16 * c, 16);
  rag_at = -1;
  if (t < 16) {
    const int s = sh + t;
    if (s < (16 * c0 < end ? 16 * c0 : end)) rag_at = s;
  } else if (t < 32) {
    const int s = 16 * (c1 > c0 ? c1 : c0) + t - 16;
    if (s < end) rag_at = s;
  }
  if (rag_at >= 0) rag_val = base[rag_at];
  return sh;
}

// the 2-bit codes of 4 staged bytes (little-endian in x), MSB-first
__device__ __forceinline__ unsigned pack4(unsigned x) {
  return ((x & 0x03030303u) * 0x40100401u) >> 24;
}

// bit i: byte i of x is ambiguous (above 3)
__device__ __forceinline__ unsigned amb4(unsigned x) {
  const unsigned y = (x >> 2) & 0x3F3F3F3Fu;
  const unsigned m = ((y + 0x3F3F3F3Fu) >> 6) & 0x01010101u;
  return (m * 0x01020408u) >> 24;
}

// Once a tile: the pack and ambiguity words from the staged bytes; the
// tile's start bits (st[b]) from si, the first start after p0 (s_first
// its value, loaded ahead by thread 0 of the walk); cnt[b], the starts
// up to the next tile's first window (next_p0; -1: no next tile); the
// next tile's start bits and count zeroed.
__device__ __forceinline__ void build_bits(Smem& sm, int b, const Geo& tile,
                                           int sh, long long si,
                                           long long s_first,
                                           long long next_p0,
                                           const long long* __restrict__ starts,
                                           long long n_starts) {
  const int t = threadIdx.x;
  // whole 32-base units, 16 bases (a pack word, half an ambiguity
  // word) a thread
  const int halves = 2 * ((sh + tile.n + kK - 1 + 31) >> 5);
  const u8* buf = sm.codes[b];
  unsigned short* amb16 = reinterpret_cast<unsigned short*>(sm.amb);
  for (int h = t; h < halves; h += kThreads) {
    const uint4 q = *reinterpret_cast<const uint4*>(buf + 16 * h);
    sm.pack[h] = pack4(q.x) << 24 | pack4(q.y) << 16 | pack4(q.z) << 8 |
                 pack4(q.w);
    amb16[h] = static_cast<unsigned short>(amb4(q.x) | amb4(q.y) << 4 |
                                           amb4(q.z) << 8 | amb4(q.w) << 12);
  }
  for (int u = t; u < kUnits; u += kThreads) sm.st[b ^ 1][u] = 0;
  if (t == 0) sm.cnt[b ^ 1] = 0;
  // a start at p0 + n + 13, the last base of the last window, is the
  // last that voids a window
  const long long last = tile.p0 + tile.n + kK - 2;
  const long long lim = next_p0 > last ? next_p0 : last;
  int below_next = 0;
  long long s = s_first;
  for (long long i = si + t; i < n_starts; i += kThreads) {
    if (i != si + t) s = __ldg(starts + i);
    if (s > lim) break;
    if (s <= last) {
      const int at = static_cast<int>(s - tile.p0) + sh;
      atomicOr(&sm.st[b][at >> 5], 1u << (at & 31));
    }
    below_next += s <= next_p0;
  }
  if (below_next > 0) atomicAdd(&sm.cnt[b], below_next);
}

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

// the 2-bit codes of a 16-bit LSB-first pack, one a nibble
__device__ __forceinline__ unsigned nibbles8(unsigned x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  return (x | (x << 2)) & 0x33333333u;
}

// murmur3 of the canonical 15-mer whose forward and reverse-complement
// packs (MSB-first) are f and r: the canonical string's LSB-first pack
// is one select, and each of its bytes (4 codes) indexes the table of
// their ASCII bytes; k2 keeps 7
__device__ __forceinline__ u64 murmur3_canonical15(unsigned f, unsigned r,
                                                   const unsigned* ascii) {
  const unsigned lsb = (f <= r ? r : f) ^ kMask30;
  const u64 k1 = ascii[lsb & 0xFFu] |
                 static_cast<u64>(ascii[(lsb >> 8) & 0xFFu]) << 32;
  const u64 k2 = ascii[(lsb >> 16) & 0xFFu] |
                 static_cast<u64>(ascii[lsb >> 24] & 0x00FFFFFFu) << 32;
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

// the reverse complement of 16 bases packed MSB-first: complement (3 -
// c is ~c in 2 bits), reverse all 32 bits, and swap each field's two
// bits back
__device__ __forceinline__ unsigned revcomp16(unsigned x) {
  x = __brev(~x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// the canonical hash of the window whose forward and reverse-complement
// packs are f and r, biased, or the sentinel where it is not valid or
// at or above the cut
template <bool kTpufast>
__device__ __forceinline__ long long window_hash(unsigned f, unsigned r,
                                                 bool valid, long long cut,
                                                 const unsigned* ascii) {
  const u64 h = kTpufast ? tpufast(f <= r ? f : r)
                         : murmur3_canonical15(f, r, ascii);
  const long long v = static_cast<long long>(h ^ kBias);
  return valid && v < cut ? v : kSentinel;
}

// the 16 bases s .. s + 15 (staged; MSB-first) and the ambiguity and
// start bits from s on
struct Bits {
  unsigned x, amb, st;
};

__device__ __forceinline__ Bits bits_at(const Smem& sm, const unsigned* st,
                                        int s) {
  const int w = s >> 4;
  const int u = s >> 5;
  return {__funnelshift_l(sm.pack[w + 1], sm.pack[w], 2 * (s & 15)),
          __funnelshift_r(sm.amb[u], sm.amb[u + 1], s & 31),
          __funnelshift_r(st[u], st[u + 1], s & 31)};
}

// A thread takes two neighbouring windows s and s + 1 (staged bases):
// one funnel shift gives the 16 bases s .. s + 15, whose top 30 bits are
// window s's forward pack and low 30 bits window s + 1's; the reverse
// complement of the 16 bases holds both reverse packs the other way
// round; one funnel shift of each bit array covers both windows. The
// pair goes to device memory as one 16-byte store (outputs are 16-byte
// aligned, tiles an even number of windows from them). A tile's odd
// last window is thread 0's after the loop.
template <bool kTpufast>
__device__ __forceinline__ void hash_tile(const Smem& sm, int b,
                                          const Geo& tile, int sh,
                                          long long cut) {
  const unsigned* st = sm.st[b];
  const int pairs = tile.n >> 1;
#pragma unroll 1
  for (int q = threadIdx.x; q < pairs; q += kThreads) {
    const Bits k = bits_at(sm, st, sh + 2 * q);
    const unsigned rc = revcomp16(k.x);
    const long long h0 = window_hash<kTpufast>(
        k.x >> 2, rc & kMask30, ((k.amb & 0x7FFFu) | (k.st & 0x7FFEu)) == 0,
        cut, sm.ascii);
    const long long h1 = window_hash<kTpufast>(
        k.x & kMask30, rc >> 2, ((k.amb & 0xFFFEu) | (k.st & 0xFFFCu)) == 0,
        cut, sm.ascii);
    __stcs(reinterpret_cast<longlong2*>(tile.out) + q,
           make_longlong2(h0, h1));
  }
  if ((tile.n & 1) != 0 && threadIdx.x == 0) {
    const Bits k = bits_at(sm, st, sh + tile.n - 1);
    __stcs(tile.out + tile.n - 1,
           window_hash<kTpufast>(
               k.x >> 2, revcomp16(k.x) & kMask30,
               ((k.amb & 0x7FFFu) | (k.st & 0x7FFEu)) == 0, cut, sm.ascii));
  }
}

// Tiles [t0, t1) of the launch's n_tiles go to each block in order, a
// contiguous run: its contig starts are then walked, not searched, from
// one tile to the next.
template <bool kTpufast>
__global__ void __launch_bounds__(kThreads)
positional_hashes_kernel(const u8* __restrict__ codes,
                         const long long* __restrict__ starts,
                         long long n_starts, Jobs jobs, long long n_tiles,
                         long long cut) {
  __shared__ Smem sm;
  const int t = threadIdx.x;
  const long long per = n_tiles / gridDim.x;
  const long long extra = n_tiles % gridDim.x;
  const long long t0 = blockIdx.x * per + (blockIdx.x < extra ? blockIdx.x
                                                               : extra);
  const long long t1 = t0 + per + (blockIdx.x < extra ? 1 : 0);
  if (t0 >= t1) return;
  for (int u = t; u < kUnits; u += kThreads) sm.st[0][u] = 0;
  if (!kTpufast) {
    // the ASCII bytes of 4 codes: each code spread to a nibble, a byte
    // permute of A C G T by the nibbles
    for (int x = t; x < 256; x += kThreads)
      sm.ascii[x] = __byte_perm(0x54474341u, 0u, nibbles8(x));
  }
  if (t < 32) {
    // the genome of tile t0, its first tile and its row, the next row,
    // the first two tiles; then the first start after tile t0's first
    // window
    const long long j =
        jobs.table == nullptr ? 0 : warp_first_greater(jobs.table, jobs.n, t0);
    if (t == 0) {
      Cursor& c = sm.cur;
      c.t = t0;
      c.t_end = t1;
      c.j = j;
      c.tstart = jobs.table == nullptr || j == 0 ? 0 : __ldg(jobs.table + j - 1);
      read_job(jobs, j, c.first, c.count, c.out);
      read_job(jobs, j + 1, c.nfirst, c.ncount, c.nout);
      sm.geo[0] = describe(c, jobs);
      sm.geo[1] = describe(c, jobs);
      sm.cnt[0] = 0;
    }
    __syncwarp();
    const long long si = warp_first_greater(starts, n_starts, sm.geo[0].p0);
    if (t == 0) sm.si0 = si;
  }
  __syncthreads();
  long long si = sm.si0;
  Geo cur = sm.geo[0];
  int rag_at;
  unsigned rag_val = 0;
  int sh = stage_tile(sm.codes[0], codes, cur, rag_at, rag_val);
  __pipeline_commit();
  for (int k = 0, b = 0;; ++k, b ^= 1) {
    if (rag_at >= 0) sm.codes[b][rag_at] = static_cast<u8>(rag_val);
    // this tile's first start, loaded before the barrier
    const long long s_first =
        si + t < n_starts ? __ldg(starts + si + t) : kSentinel;
    __pipeline_wait_prior(0);
    __syncthreads();
    const int g = k % 3;
    const Geo nxt = sm.geo[g == 2 ? 0 : g + 1];
    int nsh = 0;
    if (nxt.n > 0) nsh = stage_tile(sm.codes[b ^ 1], codes, nxt, rag_at,
                                    rag_val);
    __pipeline_commit();
    if (t == 0) sm.geo[g == 0 ? 2 : g - 1] = describe(sm.cur, jobs);
    build_bits(sm, b, cur, sh, si, s_first, nxt.n > 0 ? nxt.p0 : -1, starts,
               n_starts);
    __syncthreads();
    si += sm.cnt[b];
    hash_tile<kTpufast>(sm, b, cur, sh, cut);
    if (nxt.n == 0) break;
    cur = nxt;
    sh = nsh;
  }
}

constexpr int kMaxDevices = 64;
int g_grid[kMaxDevices][2] = {};  // resident blocks on the card, per hash

// blocks for n_tiles tiles: all of them, or as many as fit on the
// current device at once (each then loops over several)
template <bool kTpufast>
cudaError_t grid_for(long long n_tiles, unsigned& blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& resident = g_grid[dev][kTpufast ? 1 : 0];
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, positional_hashes_kernel<kTpufast>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  blocks = static_cast<unsigned>(n_tiles < resident ? n_tiles : resident);
  return cudaSuccess;
}

template <bool kTpufast>
int launch(const void* codes, const void* starts, long long n_starts,
           const Jobs& jobs, long long n_tiles, long long cut,
           void* stream) {
  unsigned blocks = 0;
  const cudaError_t err = grid_for<kTpufast>(n_tiles, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  positional_hashes_kernel<kTpufast>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const u8*>(codes),
          static_cast<const long long*>(starts), n_starts, jobs, n_tiles,
          cut);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* codes, const void* starts, long long n_starts,
             const Jobs& jobs, long long n_tiles, int algo, long long cut,
             void* stream) {
  if (n_tiles <= 0) return 0;
  if (algo == 1)
    return launch<true>(codes, starts, n_starts, jobs, n_tiles, cut, stream);
  if (algo == 0)
    return launch<false>(codes, starts, n_starts, jobs, n_tiles, cut, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// windows [win0, win0 + n_win) into out (16-byte aligned); algo: 0
// murmur3, 1 tpufast
extern "C" int positional_hashes_launch(const void* codes, const void* starts,
                                        long long n_starts, long long win0,
                                        long long n_win, int algo, void* out,
                                        void* stream) {
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Jobs jobs{nullptr, 0, win0, n_win, static_cast<long long*>(out)};
  return dispatch(codes, starts, n_starts, jobs, (n_win + kTile - 1) / kTile,
                  algo, kSentinel, stream);
}

// a group's genomes from the device table (4, n_jobs) (running tile
// counts, first windows, window counts, output addresses, each 16-byte
// aligned; every count above 0), n_tiles its last running count; hashes
// at or above cut (biased) become the sentinel
extern "C" int positional_hashes_group_launch(
    const void* codes, const void* starts, long long n_starts,
    const void* table, long long n_jobs, long long n_tiles, int algo,
    long long cut, void* stream) {
  const Jobs jobs{static_cast<const long long*>(table), n_jobs, 0, 0,
                  nullptr};
  return dispatch(codes, starts, n_starts, jobs, n_tiles, algo, cut, stream);
}

// windows a tile: the group table's running tile counts are in these
extern "C" int positional_hashes_tile() { return kTile; }
