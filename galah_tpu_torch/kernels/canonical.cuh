// Canonical k-mers from a genome's codes, in registers: the preamble
// that galah_tpu's XLA fuses into the operands of its sketch kernels
// (galah_tpu/ops/hashing.py _canonical_core and canonical_kmer_words),
// shared by fused_sketch.cu and murmur3_k21.cu.
//
// Input: 1-byte codes (0-3 for A, C, G, T; 255 ambiguous) and the
// sorted contig start positions of the same sequence. Window p of width
// k is valid iff codes[p, p + k) holds no ambiguous base and no contig
// start lies in (p, p + k - 1]; ops/hashing._window_chunks gives the
// same mask.
//
// A thread walks a run of consecutive windows and rolls two packs one
// base a step: f, the forward k-mer packed 2 bits a base MSB-first, and
// r, its reverse complement packed the same way (complement is 3 - c).
// The canonical orientation is the forward one iff f <= r (A<C<G<T in
// code and ASCII order, so the integer compare is the string compare).
// The run tracks its last ambiguous base and the next contig start (one
// binary search a run) instead of rereading k bytes a window.
//
// murmur3 reads the canonical k-mer as ASCII bytes. The LSB-first pack
// of the forward k-mer is r ^ mask and that of its reverse complement
// f ^ mask, so the canonical string's LSB-first pack is one select; a
// byte permute (prmt) turns 4 of its 2-bit codes into 4 ASCII bytes.
// At k = 21 the key words are bytes 0-7, 8-15 and 16-20 (little-endian,
// the tail's top 3 bytes zero), as ops/hashing._key_words builds them;
// murmur3_canonical assembles any k <= 32 the same way, word w from
// codes 8w .. 8w + 7 of the pack, its bytes past the k-th zeroed.
// kernels/build.py hashes every .cuh beside the sources into each
// library's name, so an edited header rebuilds both kernels.

#pragma once

#include "murmur3.cuh"

namespace galah {

typedef unsigned char u8;

constexpr long long kNoStart = 0x7FFFFFFFFFFFFFFFll;

// index of the first of the n sorted starts that is > p (n if none)
__device__ __forceinline__ long long first_start_after(
    const long long* __restrict__ starts, long long n, long long p) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (starts[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// the ASCII bytes (A C G T = 65 67 71 84) of the 4 codes packed
// LSB-first in x's low byte, little-endian in one word
__device__ __forceinline__ unsigned ascii4(unsigned x) {
  const unsigned sel = (x & 3u) | ((x << 2) & 0x30u) | ((x << 4) & 0x300u) |
                       ((x << 6) & 0x3000u);
  return __byte_perm(0x54474341u, 0u, sel);
}

// the ASCII byte of one code in the low byte, zeros above (selector 4
// picks byte 0 of the second operand)
__device__ __forceinline__ unsigned ascii1(unsigned x) {
  return __byte_perm(0x54474341u, 0u, (x & 3u) | 0x4440u);
}

__device__ __forceinline__ u64 ascii8(u64 lsb_pack) {
  return static_cast<u64>(ascii4(static_cast<unsigned>(lsb_pack) & 0xFFu)) |
         (static_cast<u64>(
              ascii4(static_cast<unsigned>(lsb_pack >> 8) & 0xFFu))
          << 32);
}

// murmur3 x64_128 h1 (seed 0) of the canonical 21-mer whose forward and
// reverse-complement packs are f and r
__device__ __forceinline__ u64 murmur3_canonical21(u64 f, u64 r) {
  constexpr u64 kMask = (1ull << 42) - 1;
  const u64 lsb = (f <= r ? r : f) ^ kMask;
  const u64 k1 = ascii8(lsb);
  const u64 k2 = ascii8(lsb >> 16);
  const u64 tail =
      static_cast<u64>(ascii4(static_cast<unsigned>(lsb >> 32) & 0xFFu)) |
      (static_cast<u64>(ascii1(static_cast<unsigned>(lsb >> 40))) << 32);
  return murmur3_k21(k1, k2, tail);
}

// the 2-bit packs of a k-mer: the low 2k bits (all 64 at k = 32)
__device__ __forceinline__ u64 pack_mask(int k) {
  return k >= 32 ? ~0ull : (1ull << (2 * k)) - 1;
}

// the ASCII key word of codes 8w .. 8w + 7 of an LSB-first pack, its
// bytes from the k-th on zero
__device__ __forceinline__ u64 key_word(u64 lsb, int w, int k) {
  const u64 word = ascii8(lsb >> (16 * w));
  const int bytes = k - 8 * w;
  return bytes >= 8 ? word : word & ((1ull << (8 * bytes)) - 1);
}

// murmur3 x64_128 h1 (seed 0) of the canonical k-mer (1 <= k <= 32)
// whose forward and reverse-complement packs are f and r: k / 16 blocks,
// then a tail of k mod 16 bytes in two words
__device__ __forceinline__ u64 murmur3_canonical(u64 f, u64 r, int k) {
  const u64 lsb = (f <= r ? r : f) ^ pack_mask(k);
  const int blocks = k >> 4;
  u64 h1 = 0, h2 = 0;
  for (int b = 0; b < blocks; ++b)
    murmur3_block(h1, h2, key_word(lsb, 2 * b, k),
                  key_word(lsb, 2 * b + 1, k));
  const int rem = k & 15;
  const u64 t1 = rem > 0 ? key_word(lsb, 2 * blocks, k) : 0;
  const u64 t2 = rem > 8 ? key_word(lsb, 2 * blocks + 1, k) : 0;
  return murmur3_finish(h1, h2, t1, t2, k);
}

// Walk windows p0 .. p0 + n - 1 (n >= 1) of width k (1 <= k <= 32):
// emit(i, valid, f, r) for window p0 + i, in order. Reads codes
// [p0, p0 + n + k - 1), which the caller keeps inside the sequence.
template <class Emit>
__device__ __forceinline__ void for_each_window(
    const u8* __restrict__ codes, const long long* __restrict__ starts,
    long long n_starts, long long p0, int n, int k, Emit emit) {
  const u64 mask = pack_mask(k);
  const int top = 2 * k - 2;
  long long si = first_start_after(starts, n_starts, p0);
  long long next = si < n_starts ? starts[si] : kNoStart;
  u64 f = 0, r = 0;
  int last_amb = -1;
  for (int j = 0; j < n + k - 1; ++j) {
    unsigned c = codes[p0 + j];
    if (c > 3u) {
      last_amb = j;
      c = 0u;
    }
    f = ((f << 2) | c) & mask;
    r = (r >> 2) | (static_cast<u64>(3u - c) << top);
    const int i = j - (k - 1);
    if (i < 0) continue;
    const long long p = p0 + i;
    while (next <= p) {
      ++si;
      next = si < n_starts ? starts[si] : kNoStart;
    }
    emit(i, last_amb < i && next > p + k - 1, f, r);
  }
}

}  // namespace galah
