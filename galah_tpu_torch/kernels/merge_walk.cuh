// Merged-bottom-k statistics of one sketch pair by one warp, along the
// merge path of the two sorted rows: shared by tile_stats.cu (a warp
// per (row, col) pair of a tile) and pairlist.cu (a warp per listed
// pair).
//
// For sorted, sentinel-padded rows a (na valid values) and b (nb) it
// computes what galah_tpu/ops/pairwise._pair_stats computes:
//   pos_b(i)  = #(b < a_i)                (searchsorted, left)
//   match(i)  = a_i valid and b[pos_b(i)] == a_i
//   cexcl(i)  = #(match before i)
//   urank(i)  = i + pos_b(i) - cexcl(i)   (rank of a_i in the union)
//   total     = min(sketch_size, na + nb - #match)
//   common    = #(match & urank < total)
// and, in the intersect form, common = #match and total = na.
//
// The 32 lanes split the merge of the valid prefixes (na + nb items)
// along merge diagonals, (na + nb) / 32 items a lane, so ragged rows
// stay balanced. Tie rule: on equal values the a element merges first,
// so a lane's co-rank in b at each a_i is pos_b(i), and a_i matches iff
// the next b value equals it. Each step loads one value, of the side
// that moved. The lanes' match counts, summed across the warp, give
// #match and so total. If the union holds at most sketch_size values,
// every match counts. Otherwise the union rank ai + bj - cexcl never
// falls along the merge, so the counted matches are a prefix of the
// matches in merge order: after an exclusive warp scan of the match
// counts, a lane whose start rank is at least total counts none and a
// lane whose end rank is below total counts all of its own. The one
// lane that straddles total has its segment split across the warp
// again (kLevels), and the sub-segment that straddles it is walked once
// more, stopping at the first match ranked total or more.
//
// Both rows of a pair lie in shared memory (SharedRow) or both in
// device memory (DeviceRow): a load whose lanes mixed the two would be
// a generic load, which the card serves more slowly.
//
// Hashes are biased int64 (u64 ^ 2^63); INT64_MAX is the sentinel, and
// a row's valid values are its prefix before the first INT64_MAX.

#pragma once

#include <cstdint>

namespace merge_walk {

constexpr long long kSentinel = INT64_MAX;

// merge-path splits of a pair before the lane that straddles the union
// rank `total` walks alone: the whole merge, then that lane's segment
constexpr int kLevels = 2;

// first index of v[0, k) holding the sentinel
__device__ __forceinline__ int valid_prefix(const long long* v, int k) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < kSentinel) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A row staged in shared memory and followed by the sentinel, read by
// 32-bit shared-window address (ld.shared: no address-space test, no
// guard).
struct SharedRow {
  unsigned base;
  __device__ __forceinline__ explicit SharedRow(const long long* row)
      : base(static_cast<unsigned>(__cvta_generic_to_shared(row))) {}
  __device__ __forceinline__ static long long load(unsigned addr) {
    long long v;
    asm volatile("ld.shared.b64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
    return v;
  }
  __device__ __forceinline__ long long at(int i) const {
    return load(base + 8u * static_cast<unsigned>(i));
  }
};

// A row read in place from device memory (through L1 and L2), guarded
// at its valid length: a full row's next value belongs to the next row.
struct DeviceRow {
  const long long* base;
  __device__ __forceinline__ explicit DeviceRow(const long long* row)
      : base(row) {}
  __device__ __forceinline__ long long at(int i) const { return base[i]; }
};

// The lane's walk over `steps` merged items from co-rank (ai, bj),
// which it leaves at the co-rank where it stopped. With total < 0 it
// counts matches; otherwise the matches whose union rank is below
// total, cexcl being the matches before the lane's start. A step is
// a 64-bit compare, one load of the side that moved, and selects.
__device__ __forceinline__ int walk(const SharedRow& a, int na,
                                    const SharedRow& b, int nb, int& ai,
                                    int& bj, int steps, int total,
                                    int cexcl) {
  // by shared-window address: one select a step picks the side
  unsigned pa = a.base + 8u * ai, pb = b.base + 8u * bj;
  long long x = SharedRow::load(pa), y = SharedRow::load(pb);
  const int rank0 = ai + bj - cexcl;  // union rank of the next item
  int count = 0;
  for (int s = 0; s < steps; ++s) {
    const bool take_a = x <= y;  // a first on ties; sentinels sort last
    if (x == y) {
      if (total >= 0 && rank0 + s - count >= total) break;
      ++count;
    }
    const unsigned p = (take_a ? pa : pb) + 8u;
    if (take_a) pa = p; else pb = p;
    const long long w = SharedRow::load(p);
    if (take_a) x = w; else y = w;
  }
  ai = static_cast<int>((pa - a.base) >> 3);
  bj = static_cast<int>((pb - b.base) >> 3);
  return count;
}

__device__ __forceinline__ int walk(const DeviceRow& a, int na,
                                    const DeviceRow& b, int nb, int& ai,
                                    int& bj, int steps, int total,
                                    int cexcl) {
  const long long* va = a.base;
  const long long* vb = b.base;
  long long x = ai < na ? va[ai] : kSentinel;
  long long y = bj < nb ? vb[bj] : kSentinel;
  int count = 0;
  for (int s = 0; s < steps; ++s) {
    const bool take_a = x <= y;
    if (x == y) {
      if (total >= 0 && ai + bj - cexcl >= total) break;
      ++count;
      ++cexcl;
    }
    if (take_a) ++ai; else ++bj;
    const long long* v = take_a ? va : vb;
    const int i = take_a ? ai : bj;
    const long long w = i < (take_a ? na : nb) ? v[i] : kSentinel;
    if (take_a) x = w; else y = w;
  }
  return count;
}

// (common, total) of the pair; every lane of the warp calls it with the
// same rows and gets the same result.
template <class Row>
__device__ __forceinline__ int2 merge_stats(const Row& a, int na,
                                            const Row& b, int nb,
                                            int sketch_size, bool intersect,
                                            int lane) {
  // the warp's segment: merged items from co-rank (a_lo, b_lo) to
  // (a_hi, b_hi), with `before` matches ahead of it
  int a_lo = 0, b_lo = 0, a_hi = na, b_hi = nb, before = 0;
  int tot = 0, c = 0;
  for (int level = 0;; ++level) {
    const int d_lo = a_lo + b_lo;
    const long long len = a_hi + b_hi - d_lo;
    const int d0 = d_lo + static_cast<int>(lane * len / 32);
    const int d1 = d_lo + static_cast<int>((lane + 1) * len / 32);
    // co-rank of d0: the a values among the first d0 merged items
    int lo = max(a_lo, d0 - b_hi), hi = min(a_hi, d0 - b_lo);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.at(mid) <= b.at(d0 - mid - 1)) lo = mid + 1; else hi = mid;
    }
    const int ai = lo, bj = d0 - lo;
    int ai1 = ai, bj1 = bj;
    const int m = walk(a, na, b, nb, ai1, bj1, d1 - d0, -1, 0);
    if (level == 0) {
      const int n_match = __reduce_add_sync(~0u, m);
      if (intersect) return make_int2(n_match, na);
      tot = min(sketch_size, na + nb - n_match);
      if (na + nb - n_match <= sketch_size) return make_int2(n_match, tot);
    }
    int incl = m;  // inclusive scan of the lanes' match counts
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += v;
    }
    const int cexcl = before + incl - m;
    // union ranks at the lane's start and end: below total at the end,
    // every match of the lane counts; at total or more at the start,
    // none does
    const int start = ai + bj - cexcl, end = ai1 + bj1 - cexcl - m;
    c += __reduce_add_sync(~0u, end < tot ? m : 0);
    const bool straddle = start < tot && end >= tot;
    const unsigned who = __ballot_sync(~0u, straddle);
    if (who == 0) break;
    if (level == kLevels - 1) {
      int i = ai, j = bj;
      const int mine = straddle ? walk(a, na, b, nb, i, j, d1 - d0, tot,
                                       cexcl) : 0;
      c += __reduce_add_sync(~0u, mine);
      break;
    }
    // split the straddling lane's segment across the warp
    const int l = __ffs(who) - 1;
    a_lo = __shfl_sync(~0u, ai, l);
    b_lo = __shfl_sync(~0u, bj, l);
    a_hi = __shfl_sync(~0u, ai1, l);
    b_hi = __shfl_sync(~0u, bj1, l);
    before = __shfl_sync(~0u, cexcl, l);
  }
  return make_int2(c, tot);
}

}  // namespace merge_walk
