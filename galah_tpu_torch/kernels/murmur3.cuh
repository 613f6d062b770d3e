// murmur3 x64_128 h1 (seed 0) of a key given as its little-endian
// 8-byte words, on native 64-bit integers (ops/hashing.murmur3_h1_words
// is the torch form). murmur3_k21 is the k=21 key: bytes 0-7, 8-15 and
// 16-20 (the tail word's top 3 bytes are zero, as canonical.cuh and
// ops/hashing._key_words build it), one 16-byte block and a 5-byte k1
// tail. Any other length goes through murmur3_block for each 16-byte
// block and murmur3_finish for the tail of len mod 16 bytes (t1 its
// bytes 0-7, t2 its bytes 8-15, each zero above the key's end). Shared
// by fused_sketch.cu and murmur3_k21.cu; kernels/build.py hashes every
// .cuh beside the sources into each library's name, so an edited header
// rebuilds them.

#pragma once

namespace galah {

typedef unsigned long long u64;

__device__ __forceinline__ u64 rotl(u64 x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ u64 fmix(u64 x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDull;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ull;
  return x ^ (x >> 33);
}

__device__ __forceinline__ u64 murmur3_k21(u64 k1, u64 k2, u64 tail) {
  constexpr u64 c1 = 0x87C37B91114253D5ull;
  constexpr u64 c2 = 0x4CF5AD432745937Full;
  u64 h1 = 0, h2 = 0;
  h1 ^= rotl(k1 * c1, 31) * c2;
  h1 = (rotl(h1, 27) + h2) * 5 + 0x52DCE729ull;
  h2 ^= rotl(k2 * c2, 33) * c1;
  h2 = (rotl(h2, 31) + h1) * 5 + 0x38495AB5ull;
  h1 ^= rotl(tail * c1, 31) * c2;
  h1 ^= 21;
  h2 ^= 21;
  h1 += h2;
  h2 += h1;
  return fmix(h1) + fmix(h2);
}

// one 16-byte block (words k1, k2) into the state
__device__ __forceinline__ void murmur3_block(u64& h1, u64& h2, u64 k1,
                                              u64 k2) {
  constexpr u64 c1 = 0x87C37B91114253D5ull;
  constexpr u64 c2 = 0x4CF5AD432745937Full;
  h1 ^= rotl(k1 * c1, 31) * c2;
  h1 = (rotl(h1, 27) + h2) * 5 + 0x52DCE729ull;
  h2 ^= rotl(k2 * c2, 33) * c1;
  h2 = (rotl(h2, 31) + h1) * 5 + 0x38495AB5ull;
}

// the tail (len mod 16 bytes as words t1, t2) and the finalization of
// a len-byte key: h1 of the 128-bit hash
__device__ __forceinline__ u64 murmur3_finish(u64 h1, u64 h2, u64 t1,
                                              u64 t2, int len) {
  constexpr u64 c1 = 0x87C37B91114253D5ull;
  constexpr u64 c2 = 0x4CF5AD432745937Full;
  const int rem = len & 15;
  if (rem > 8) h2 ^= rotl(t2 * c2, 33) * c1;
  if (rem > 0) h1 ^= rotl(t1 * c1, 31) * c2;
  h1 ^= static_cast<u64>(len);
  h2 ^= static_cast<u64>(len);
  h1 += h2;
  h2 += h1;
  return fmix(h1) + fmix(h2);
}

}  // namespace galah
