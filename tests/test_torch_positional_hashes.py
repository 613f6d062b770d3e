"""The plan of ``kernels/positional_hashes.cu`` and the group entry of
``ops/positional_hashes``, against galah_tpu's k=15 profile hashes.

``model_group`` is a numpy model of the kernel, step for step: each
block's contiguous run of tiles (a genome's windows cut from its first),
its first genome and first contig start found by the warps' 32-probe
search and then walked; each tile's bases staged from their 16-byte
alignment, the forward 2-bit pack, the ambiguity bits and the
contig-start bits built once a tile (the next tile's start index
counted by the scan); per pair of windows the funnel shifts of the pack
and the bit arrays, both reverse complements from one reversal, the
ASCII key words from the table of 4-code bytes, and the subsample cut.
It runs at the kernel's tile of 8192 windows and at a tile of 64, which
puts many tile and halo edges on small genomes. It must equal the port's
plain version and galah_tpu's ``_hash_core`` at k=15 (through
``fragment_ani.positional_hashes_batch``) on seeded edge groups:
ambiguous bases and contig starts on tile and halo edges, genomes of
k - 1, k and k + 1 bases and an empty one. The group entry's plain
version equals galah_tpu's masked flats (``_profile_from_flat``) at
c = 1, 16 and 125, and ``build_profiles_batch`` galah_tpu's profiles.
On the card chip_smoke.py holds the kernel against the plain version.

Tolerance: none; hashes are uint64 and equal bit for bit.
"""

import numpy as np
import pytest
import torch

from galah_tpu.io.fasta import Genome as JGenome
from galah_tpu.io.fasta import GenomeStats as JStats
from galah_tpu.ops import fragment_ani as jfa
from galah_tpu_torch import convert
from galah_tpu_torch.io import group as tgroup
from galah_tpu_torch.io.fasta import Genome, GenomeStats
from galah_tpu_torch.kernels import LAUNCHES, costs
from galah_tpu_torch.ops import fragment_ani as tfa
from galah_tpu_torch.ops import positional_hashes as k15
from galah_tpu_torch.ops.u64 import from_biased

CPU = torch.device("cpu")
K = 15
TILE = 8192
SENTINEL = (1 << 63) - 1
U32 = np.uint64(0xFFFFFFFF)


# -- the numpy model of the kernel --------------------------------------


def warp_first_greater(a, key):
    """The warps' search: 32 probes a step, a ballot's count of those
    <= key narrowing [lo, hi); the first index whose value is > key."""
    lo, hi = 0, len(a)
    while hi - lo > 32:
        step = (hi - lo + 31) >> 5
        c = sum(1 for lane in range(32)
                if lo + lane * step < hi and a[lo + lane * step] <= key)
        lo, hi = (lo + (c - 1) * step + 1 if c > 0 else lo,
                  min(lo + c * step, hi))
    return lo + sum(1 for lane in range(32)
                    if lo + lane < hi and a[lo + lane] <= key)


def _u(x):
    return np.asarray(x, dtype=np.uint64)


def pack4(x):
    return ((_u(x) & _u(0x03030303)) * _u(0x40100401) & U32) >> _u(24)


def amb4(x):
    y = (_u(x) >> _u(2)) & _u(0x3F3F3F3F)
    m = ((y + _u(0x3F3F3F3F)) >> _u(6)) & _u(0x01010101)
    return (m * _u(0x01020408) & U32) >> _u(24)


def funnel_l(lo, hi, s):
    """__funnelshift_l: the upper 32 bits of (hi:lo) << (s & 31)."""
    return (((_u(hi) << _u(32)) | _u(lo)) << (_u(s) & _u(31))) >> _u(32)


def funnel_r(lo, hi, s):
    """__funnelshift_r: the lower 32 bits of (hi:lo) >> (s & 31)."""
    return (((_u(hi) << _u(32)) | _u(lo)) >> (_u(s) & _u(31))) & U32


def brev32(x):
    x = _u(x)
    out = np.zeros_like(x)
    for b in range(32):
        out |= ((x >> _u(b)) & _u(1)) << _u(31 - b)
    return out


def nibbles8(x):
    x = _u(x)
    x = (x | (x << _u(8))) & _u(0x00FF00FF)
    x = (x | (x << _u(4))) & _u(0x0F0F0F0F)
    return (x | (x << _u(2))) & _u(0x33333333)


ASCII_TABLE = np.array([0x41, 0x43, 0x47, 0x54, 0, 0, 0, 0], dtype=np.uint64)


def byte_perm(sel):
    """__byte_perm(0x54474341, 0, sel): byte i from nibble i's low 3
    bits, 0-3 the ASCII of A C G T and 4-7 zero."""
    sel = _u(sel)
    out = np.zeros_like(sel)
    for i in range(4):
        out |= ASCII_TABLE[((sel >> _u(4 * i)) & _u(7)).astype(np.intp)] \
            << _u(8 * i)
    return out


def ascii8(sel):
    return byte_perm(sel & _u(0xFFFF)) | (byte_perm(sel >> _u(16)) << _u(32))


def rotl(x, r):
    return (x << _u(r)) | (x >> _u(64 - r))


def fmix(x):
    x = x ^ (x >> _u(33))
    x = x * _u(0xFF51AFD7ED558CCD)
    x = x ^ (x >> _u(33))
    x = x * _u(0xC4CEB9FE1A85EC53)
    return x ^ (x >> _u(33))


# the key bytes of 4 codes (an LSB-first byte of the pack), as the
# kernel's shared table holds them
ASCII_WORDS = byte_perm(nibbles8(np.arange(256, dtype=np.uint64)))


def key_words(lsb, table=True):
    """The canonical string's ASCII key words k1 (bytes 0-7) and k2
    (bytes 8-14) from its LSB-first pack: by the table, or by nibble
    selectors and byte permutes."""
    if table:
        t = ASCII_WORDS
        k1 = t[(lsb & _u(0xFF)).astype(np.intp)] | (
            t[((lsb >> _u(8)) & _u(0xFF)).astype(np.intp)] << _u(32))
        k2 = t[((lsb >> _u(16)) & _u(0xFF)).astype(np.intp)] | (
            (t[(lsb >> _u(24)).astype(np.intp)] & _u(0xFFFFFF)) << _u(32))
        return k1, k2
    return (ascii8(nibbles8(lsb & _u(0xFFFF))),
            ascii8(nibbles8(lsb >> _u(16)) | _u(0x40000000)))


def murmur3_canonical15(f, r, table=True):
    c1, c2 = _u(0x87C37B91114253D5), _u(0x4CF5AD432745937F)
    lsb = np.where(f <= r, r, f) ^ _u((1 << 30) - 1)
    k1, k2 = key_words(lsb, table)
    h2 = rotl(k2 * c2, 33) * c1
    h1 = rotl(k1 * c1, 31) * c2
    h1 = h1 ^ _u(K)
    h2 = h2 ^ _u(K)
    h1 = h1 + h2
    h2 = h2 + h1
    return fmix(h1) + fmix(h2)


def tpufast(x):
    x = _u(x) ^ _u(0x1B873593)
    x = x + (x << _u(21)) + (x << _u(37))
    x = x ^ (x >> _u(29))
    x = x + (x << _u(13)) + (x << _u(47))
    x = x ^ (x >> _u(31))
    x = x + (x << _u(17)) + (x << _u(41))
    x = x ^ (x >> _u(33))
    x = x + (x << _u(26))
    return x ^ (x >> _u(32))


def revcomp16(x):
    x = brev32(~_u(x) & U32)
    return ((x >> _u(1)) & _u(0x55555555)) | ((x & _u(0x55555555)) << _u(1))


def window_hash(f, r, valid, cut, algo, table):
    h = tpufast(np.minimum(f, r)) if algo == "tpufast" \
        else murmur3_canonical15(f, r, table)
    v = (h ^ _u(1 << 63)).view(np.int64)
    return np.where(valid & (v < cut), v, SENTINEL)


def model_tile(codes, starts, tile_geo, si, next_p0, align, algo, cut, tile,
               rng, table=True):
    """One tile's n hashes (int64, biased) as a block computes them, and
    the next tile's first start index: `align` is the codes' address
    mod 16, so the tile's first base sits at staged byte sh = (align +
    p0) mod 16; bytes outside the copied span and words past the built
    ones are garbage. si is the first start after p0; the next tile's
    is si plus the starts up to next_p0 the scan met."""
    p0, n = tile_geo
    units = (15 + tile + K - 1 + 31) // 32 + 2
    sh = (align + p0) % 16
    end = sh + n + K - 1
    buf = rng.integers(0, 256, size=units * 32).astype(np.uint8)
    buf[sh:end] = codes[p0:p0 + n + K - 1]
    words = buf.view("<u4").astype(np.uint64).reshape(units, 8)
    pack = rng.integers(0, 1 << 32, size=2 * units).astype(np.uint64)
    amb = rng.integers(0, 1 << 32, size=units).astype(np.uint64)
    for u in range((end + 31) // 32):
        p = pack4(words[u])
        pack[2 * u] = p[0] << 24 | p[1] << 16 | p[2] << 8 | p[3]
        pack[2 * u + 1] = p[4] << 24 | p[5] << 16 | p[6] << 8 | p[7]
        a = amb4(words[u])
        amb[u] = sum(int(a[i]) << (4 * i) for i in range(8))
    st = np.zeros(units, dtype=np.uint64)
    last = p0 + n + K - 2
    lim = max(last, next_p0)
    below_next = 0
    for i in range(si, len(starts)):
        if starts[i] > lim:
            break
        if starts[i] <= last:
            at = int(starts[i]) - p0 + sh
            st[at >> 5] |= np.uint64(1 << (at & 31))
        below_next += int(starts[i] <= next_p0)
    # a thread a pair of windows i, i + 1
    i = np.arange(0, n, 2)
    s = sh + i
    w = s >> 4
    x = funnel_l(pack[w + 1], pack[w], 2 * (s & 15))
    u = s >> 5
    am = funnel_r(amb[u], amb[u + 1], s & 31)
    sb = funnel_r(st[u], st[u + 1], s & 31)
    rc = revcomp16(x)
    mask = _u((1 << 30) - 1)
    out = np.empty(n, dtype=np.int64)
    out[0::2] = window_hash(x >> _u(2), rc & mask,
                            ((am & _u(0x7FFF)) | (sb & _u(0x7FFE))) == 0,
                            cut, algo, table)
    odd = window_hash(x & mask, rc >> _u(2),
                      ((am & _u(0xFFFE)) | (sb & _u(0xFFFC))) == 0, cut,
                      algo, table)
    out[1::2] = odd[:n // 2]
    return out, si + below_next


def model_group(codes, starts, jobs, algo, subsample_c=1, tile=TILE,
                align=0, blocks=3, seed=0, table=True):
    """Each job's hashes as the group launch writes them: the table of
    the jobs with windows; each of `blocks` blocks takes a contiguous
    run of the tiles, finds its first genome by the warps' search of
    the running tile counts and its first start by a search of the
    starts, then walks both (thread 0's cursor; the starts counted by
    the scan)."""
    rng = np.random.default_rng(seed)
    cut = k15.subsample_cut(subsample_c)
    outs = [np.full(n, -1, dtype=np.int64) for _, n in jobs]
    live = [j for j, (_, n) in enumerate(jobs) if n > 0]
    if not live:
        return outs
    rows = [(jobs[j][0], jobs[j][1], outs[j]) for j in live]
    tile_end = np.cumsum([-(-n // tile) for _, n, _ in rows])
    n_tiles = int(tile_end[-1])
    blocks = min(blocks, n_tiles)
    per, extra = divmod(n_tiles, blocks)
    for b in range(blocks):
        t0 = b * per + min(b, extra)
        t1 = t0 + per + (b < extra)
        j = warp_first_greater(tile_end, t0)
        tstart = int(tile_end[j - 1]) if j > 0 else 0
        geos = []
        for t in range(t0, t1):
            if t - tstart >= -(-rows[j][1] // tile):
                tstart += -(-rows[j][1] // tile)
                j += 1
            first, count, out = rows[j]
            wo = (t - tstart) * tile
            geos.append((first + wo, min(tile, count - wo), out, wo))
        si = warp_first_greater(starts, geos[0][0])
        for k, (p0, n, out, wo) in enumerate(geos):
            next_p0 = geos[k + 1][0] if k + 1 < len(geos) else -1
            out[wo:wo + n], si = model_tile(codes, starts, (p0, n), si,
                                            next_p0, align, algo, cut, tile,
                                            rng, table)
    return outs


# -- inputs -------------------------------------------------------------


def _pair(name, codes, contig_starts=()):
    n = codes.shape[0]
    offsets = np.array([0, *contig_starts, n], dtype=np.int64)
    stats = (len(offsets) - 1, int((codes == 255).sum()), n)
    return (Genome(name, codes, offsets, GenomeStats(*stats)),
            JGenome(name, codes.copy(), offsets.copy(), JStats(*stats)))


def edge_group(seed, tile):
    """Ambiguous bases and contig starts on the tile edges (multiples of
    `tile` windows) and their 14-base halos, genomes of k - 1, k, k + 1
    bases, an empty genome between two others, an all-ambiguous one and
    many short contigs."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return rng.integers(0, 4, size=n).astype(np.uint8)

    t = tile
    edge = rand(3 * t + 300)
    for s, e in ((t - 6, t + 4), (t + K - 1, t + K), (15, 16),
                 (2 * t - 1, 2 * t), (3 * t + 299, 3 * t + 300),
                 (2 * t + K - 2, 2 * t + K - 1)):
        edge[s:e] = 255
    many = np.unique(rng.integers(1, 2 * t, size=max(t // 8, 20)))
    pairs = [
        _pair("tile-edge", edge, [t, t + K, 2 * t - K + 1, 2 * t + 1,
                                  3 * t - 1]),
        _pair("k-1", rand(K - 1)),
        _pair("exactly-k", rand(K)),
        _pair("empty", np.zeros(0, dtype=np.uint8)),
        _pair("k+1", rand(K + 1), [K]),
        _pair("all-n", np.full(t + 40, 255, dtype=np.uint8)),
        _pair("halo", rand(t + K - 1), [t, t + K - 2]),
        _pair("many-contigs", rand(2 * t + 7), many),
        _pair("tile-plus-1", rand(t + K), [1, 2, 2 + K]),
        _pair("short-last", rand(K - 3)),
    ]
    return [a for a, _ in pairs], [b for _, b in pairs]


def _layout(tg):
    codes, starts, jobs = tgroup.host_layout(tg, K)
    return codes, starts, jobs


# -- tests --------------------------------------------------------------


def test_warp_search_is_the_first_greater_index():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 31, 32, 33, 100, 1024, 1025, 40_000):
        a = np.sort(rng.integers(0, 3 * n + 5, size=n))
        for key in [-1, *rng.integers(-1, 3 * n + 6, size=12),
                    *(a[:3] if n else []), 3 * n + 6]:
            assert warp_first_greater(a, key) == \
                np.searchsorted(a, key, side="right"), (n, key)


def test_bit_helpers_match_their_definitions():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 32, size=4000, dtype=np.uint64)
    b = x.astype("<u4").view(np.uint8).reshape(-1, 4).astype(np.uint64)
    codes = b & _u(3)
    assert np.array_equal(pack4(x), codes[:, 0] << _u(6) | codes[:, 1]
                          << _u(4) | codes[:, 2] << _u(2) | codes[:, 3])
    want = sum((b[:, i] > 3).astype(np.uint64) << _u(i) for i in range(4))
    assert np.array_equal(amb4(x), want)
    # codes with each byte 0-3 or 255, as the staged bytes are
    y = rng.choice(np.array([0, 1, 2, 3, 255], dtype=np.uint8),
                   size=(4000, 4))
    assert np.array_equal(
        amb4(y.view("<u4").ravel().astype(np.uint64)),
        sum((y[:, i] > 3).astype(np.uint64) << _u(i) for i in range(4)))
    f = rng.integers(0, 1 << 32, size=4000, dtype=np.uint64)
    fields = [(f >> _u(2 * (15 - i))) & _u(3) for i in range(16)]
    want = sum((_u(3) - fields[i]) << _u(2 * i) for i in range(16))
    assert np.array_equal(revcomp16(f), want)
    sel = nibbles8(f & _u(0xFFFF))
    for i in range(8):
        assert np.array_equal((sel >> _u(4 * i)) & _u(15),
                              (f >> _u(2 * i)) & _u(3))
    # the table's key words equal the byte permutes' for every pack
    lsb = f & _u((1 << 30) - 1)
    for a, b in zip(key_words(lsb, True), key_words(lsb, False)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("tile", [TILE, 64])
@pytest.mark.parametrize("algo", ["murmur3", "tpufast"])
def test_model_equals_plain_and_galah_tpu(tile, algo):
    """The kernel's plan equals the plain version over each genome's
    windows and galah_tpu's grouped hashing, at two codes alignments
    and block counts (one block; several, whose runs start inside
    genomes)."""
    tg, jg = edge_group(seed=3, tile=tile)
    codes, starts, jobs = _layout(tg)
    tc, ts = torch.from_numpy(codes), torch.from_numpy(starts)
    plain = k15.group_hashes_plain(tc, ts, jobs, algo)
    want = jfa.positional_hashes_batch(jg, K, algo=algo)
    for align, blocks in ((0, 1), (7, 5)):
        got = model_group(codes, starts, jobs, algo, tile=tile, align=align,
                          blocks=blocks, seed=align)
        for g, a, b, row in zip(tg, got, plain, want):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=g.path)
            np.testing.assert_array_equal(from_biased(b), row,
                                          err_msg=g.path)
    assert sum(n for _, n in jobs) > 4 * tile


@pytest.mark.parametrize("c", [1, 16, 125])
@pytest.mark.parametrize("algo", ["murmur3", "tpufast"])
def test_group_entry_cut_equals_galah_tpu_masked_flats(c, algo):
    """``group_hashes`` (its plain version on the CPU, no launch) and the
    model at c: galah_tpu's flats after ``_profile_from_flat``'s
    FracMinHash mask, a tensor a genome."""
    tg, jg = edge_group(seed=4, tile=64)
    codes, starts, jobs = _layout(tg)
    tc, ts = torch.from_numpy(codes), torch.from_numpy(starts)
    before = dict(LAUNCHES)
    got = k15.group_hashes(tc, ts, jobs, algo, subsample_c=c)
    assert dict(LAUNCHES) == before
    model = model_group(codes, starts, jobs, algo, subsample_c=c, tile=64,
                        align=3)
    flats = jfa.positional_hashes_batch(jg, K, algo=algo)
    assert len(got) == len(tg)
    for g, t, m, flat in zip(jg, got, model, flats):
        want = jfa._profile_from_flat(g.path, flat, K, 3000, c).flat_hashes
        np.testing.assert_array_equal(from_biased(t), want, err_msg=g.path)
        np.testing.assert_array_equal(m, t.numpy(), err_msg=g.path)
    if c > 1:
        kept = sum(int((t != SENTINEL).sum()) for t in got)
        assert 0 < kept < sum(
            int((k15.group_hashes_plain(tc, ts, jobs, algo)[i] != SENTINEL)
                .sum()) for i in range(len(jobs)))


@pytest.mark.parametrize("algo", ["murmur3", "tpufast"])
@pytest.mark.parametrize("c", [1, 16])
def test_build_profiles_batch_still_matches_galah_tpu(algo, c):
    """Profiles (flat hashes, distinct sets, markers) from the group
    entry equal galah_tpu's batched build."""
    tg, jg = edge_group(seed=5, tile=64)
    got = tfa.build_profiles_batch(tg, K, 3000, CPU, subsample_c=c,
                                   hash_algorithm=algo)
    want = jfa.build_profiles_batch(jg, K, 3000, subsample_c=c,
                                    hash_algorithm=algo)
    assert len(got) == len(want)
    for t, j in zip(got, want):
        fields = convert.profile_to_galah_fields(t)
        for name in ("flat_hashes", "ref_set", "markers"):
            np.testing.assert_array_equal(fields[name], getattr(j, name),
                                          err_msg=f"{j.path} {name}")


def test_group_entry_checks_and_costs():
    tg, _ = edge_group(seed=6, tile=64)
    codes, starts, jobs = _layout(tg)
    tc, ts = torch.from_numpy(codes), torch.from_numpy(starts)
    with pytest.raises(ValueError):
        k15.group_hashes(tc, ts, list(reversed(jobs)), "murmur3")
    with pytest.raises(ValueError):
        k15.group_hashes(tc, ts, [(0, codes.shape[0])], "murmur3")
    with pytest.raises(ValueError):
        k15.group_hashes(tc, ts, jobs, "md5")
    assert k15.subsample_cut(1) == SENTINEL
    assert k15.subsample_cut(16) == (1 << 60) - (1 << 63)
    counts = [n for _, n in jobs]
    live = [n for n in counts if n > 0]
    b, f = costs.group_hashes(counts, K, 7, 100)
    assert b == sum(live) * 9 + 14 * len(live) + 8 * 7 + 32 * len(live)
    assert f == 100 * sum(live)
    assert costs.group_hashes([0, 0], K, 3, 100) == (0.0, 0.0)
