"""Port parity of the two sketch kernels' codes input: the plain
versions of ``fused_sketch`` and ``murmur3_k21``, which take a launch
group's codes and contig starts, against galah_tpu on edge genomes.

The kernels build each window's canonical k-mer, validity and hash from
the codes in registers, in runs of 16 windows over 128-class slices of
2048-window rows (``kernels/fused_sketch.cu``) or 4096-window tiles
(``kernels/murmur3_k21.cu``). The cases put ambiguous runs and contig
starts on those edges and on the (k - 1)-base halo, and hold the plain
versions, which chip_smoke.py holds the kernels against on the card,
to galah_tpu's plain jits (``canonical_kmer_hashes_chunk``,
``canonical_kmer_words``). Candidate files are compared with a numpy
reduction of galah_tpu's hashes: per job and class p mod 2048, the 8
smallest distinct valid hashes.

Tolerance: none. Hashes and candidates are uint64 and must be equal
bit for bit.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galah_tpu.ops import _csketch
from galah_tpu.ops import hashing as jhash
from galah_tpu_torch.io.fasta import Genome, GenomeStats
from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops import fused_sketch as tfs
from galah_tpu_torch.ops import hashing as thash
from galah_tpu_torch.ops import sketch_stream as tss
from galah_tpu_torch.ops.murmur3_k21 import murmur3_k21, murmur3_k21_plain
from galah_tpu_torch.ops.u64 import from_biased

K = 21
CLASSES = 2048
REGS = 8
SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
# every case's codes are padded with ambiguous bases to one length and
# its starts to one count, so each galah_tpu jit compiles once per algo
PAD_CODES = 48_000
PAD_STARTS = 64


def _genome(name, codes, contig_starts=()):
    n = codes.shape[0]
    offsets = np.array([0, *contig_starts, n], dtype=np.int64)
    return Genome(path=name, codes=codes, contig_offsets=offsets,
                  stats=GenomeStats(len(offsets) - 1,
                                    int((codes == 255).sum()), n))


def _rand(rng, n):
    return rng.integers(0, 4, size=n).astype(np.uint8)


def _case(name):
    """The genomes of one launch group."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "tile-edge-ambiguous":
        # ambiguous runs across the row edge at 2048 and its halo, a
        # slice edge (128) and a run edge (16)
        c = _rand(rng, 3 * CLASSES + 700)
        c[2040:2075] = 255
        c[127:131] = 255
        c[15:17] = 255
        c[4096 - 20] = 255
        return [_genome(name, c)]
    if name == "contig-starts":
        # starts at windows = 0, 1 and 2047 (mod 2048), and at the last
        # window; a second genome with a one-base last contig
        c = _rand(rng, 9000)
        d = _rand(rng, 5000)
        return [_genome(name, c, [2048, 4097, 6143, 9000 - K]),
                _genome(name + "-b", d, [4999])]
    if name == "short-contigs":
        # a contig shorter than k between two, and one of exactly k
        c = _rand(rng, 7000)
        return [_genome(name, c, [3000, 3010, 5000, 5000 + K])]
    if name == "tiny-genomes":
        # exactly k bases, all ambiguous, k - 1 bases (no window; last)
        return [_genome("k", _rand(rng, K)),
                _genome("all-n", np.full(3000, 255, dtype=np.uint8)),
                _genome("mid", _rand(rng, 2500), [1200]),
                _genome("k-1", _rand(rng, K - 1))]
    if name == "ragged-group":
        # job lengths that are not multiples of 2048, one long enough
        # (~12 rows) that classes see more than 8 distinct hashes, and
        # a repeated unit with fewer distinct k-mers than registers
        return [_genome("a", _rand(rng, CLASSES + 1 + K - 1)),
                _genome("b", _rand(rng, 4095)),
                _genome("long", _rand(rng, 25_000), [11_111]),
                _genome("repeat", np.tile(_rand(rng, 300), 40)),
                _genome("c", _rand(rng, 31))]
    raise KeyError(name)


CASES = ["tile-edge-ambiguous", "contig-starts", "short-contigs",
         "tiny-genomes", "ragged-group"]


def _galah_hashes(codes, offsets, algo):
    """galah_tpu's hashes (uint64, sentinel where invalid) of every
    window of `codes`."""
    n = codes.shape[0]
    assert n <= PAD_CODES and offsets.shape[0] <= PAD_STARTS
    padded = np.full(PAD_CODES, 255, dtype=np.uint8)
    padded[:n] = codes
    offs = np.full(PAD_STARTS, 1 << 30, dtype=np.int32)
    offs[:offsets.shape[0]] = offsets
    h = jhash.canonical_kmer_hashes_chunk(
        jnp.asarray(padded), jnp.asarray(offs), jnp.int32(0), k=K, seed=0,
        algo=algo)
    return np.asarray(h)[:max(n - K + 1, 0)]


def _candidates_np(hashes, jobs):
    """Per job, the 8 smallest distinct valid hashes of each class."""
    out = np.full((len(jobs), REGS, CLASSES), SENT, dtype=np.uint64)
    for j, (off, length) in enumerate(jobs):
        h = hashes[off:off + length]
        for c in range(CLASSES):
            v = np.unique(h[c::CLASSES])
            v = v[v != SENT][:REGS]
            out[j, :v.shape[0], c] = v
    return out


@pytest.mark.parametrize("algo", ["murmur3", "tpufast"])
@pytest.mark.parametrize("case", CASES)
def test_codes_input_plain_versions_match_galah_tpu(case, algo):
    """On each edge group: the key words and mask equal galah_tpu's
    canonical_kmer_words; the fused candidate files (wrapper and plain
    version, CPU tensors) equal a numpy reduction of galah_tpu's hashes;
    and for murmur3 the k=21 window hashes equal galah_tpu's, whole and
    over window ranges that cut the group where its chunks would."""
    genomes = _case(case)
    codes, offsets, jobs = tss._concat(genomes, K)
    want = _galah_hashes(codes, offsets, algo)
    tc, ts = torch.from_numpy(codes), torch.from_numpy(offsets)

    words, valid = thash.canonical_key_words(codes, offsets, K, "cpu", algo)
    jc = jnp.asarray(codes)
    jwords, jvalid = jhash.canonical_kmer_words(
        jnp.where(jc == 255, jnp.uint8(0), jc), jc != 255,
        jnp.asarray(offsets.astype(np.int32)), jnp.int32(0), K, algo)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert len(words) == len(jwords)
    for w, jw in zip(words, jwords):
        np.testing.assert_array_equal(w.numpy().view(np.uint64),
                                      np.asarray(jw))

    before = dict(LAUNCHES)
    got = tfs.fused_sketch_candidates(tc, ts, jobs, K, algo)
    assert dict(LAUNCHES) == before  # no kernel on the CPU
    assert torch.equal(got, tfs.fused_candidates_plain(tc, ts, jobs, K,
                                                       algo))
    np.testing.assert_array_equal(from_biased(got),
                                  _candidates_np(want, jobs))

    if algo == "murmur3":
        n_win = want.shape[0]
        np.testing.assert_array_equal(
            from_biased(murmur3_k21_plain(tc, ts)), want)
        np.testing.assert_array_equal(from_biased(murmur3_k21(tc, ts)),
                                      want)
        step = 4096 - 5  # ranges that start off every kernel tile edge
        for s in range(0, n_win, step):
            e = min(s + step, n_win)
            np.testing.assert_array_equal(
                from_biased(murmur3_k21_plain(tc, ts, s, e - s)),
                want[s:e])
        for g, (off, length) in zip(genomes, jobs):
            if length:
                np.testing.assert_array_equal(
                    from_biased(thash.positional_hashes(g, K, "cpu",
                                                        chunk=1000)),
                    want[off:off + length])


@pytest.mark.parametrize("k", [9, 15, 16, 31])
@pytest.mark.parametrize("case", CASES)
def test_fused_murmur3_at_other_k_matches_galah_tpu(case, k):
    """murmur3 at k other than 21 (``dist --kmer-length k``): the fused
    candidate files of the plain version equal a numpy reduction of
    galah_tpu's hashes of the same sequence (its C walker, which its
    sketches take at k <= 32 on the CPU), and each genome's positional
    hashes equal galah_tpu's. The kernel's key has k / 16 blocks and a
    tail of k mod 16 bytes; these k put the tail in one word (9, 15),
    none (16) and two (31)."""
    genomes = _case(case)
    codes, offsets, jobs = tss._concat(genomes, k)
    want = _csketch.positional_hashes(codes, offsets, k=k, algo="murmur3")
    tc, ts = torch.from_numpy(codes), torch.from_numpy(offsets)
    words, _ = thash.canonical_key_words(codes, offsets, k, "cpu",
                                         "murmur3")
    assert len(words) == -(-k // 8)
    got = tfs.fused_candidates_plain(tc, ts, jobs, k, "murmur3")
    assert torch.equal(got, tfs.fused_sketch_candidates(tc, ts, jobs, k,
                                                        "murmur3"))
    np.testing.assert_array_equal(from_biased(got),
                                  _candidates_np(want, jobs))
    for g in genomes:
        np.testing.assert_array_equal(
            from_biased(thash.positional_hashes(g, k, "cpu")),
            _csketch.positional_hashes(g.codes, g.contig_offsets, k=k,
                                       algo="murmur3"))


def test_plain_versions_take_cpu_tensors_only():
    """The plain versions never run on another device: on the card the
    wrappers launch the kernels or raise."""
    meta = torch.zeros(30, dtype=torch.uint8, device="meta")
    starts = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CPU"):
        murmur3_k21_plain(meta, starts)
    with pytest.raises(ValueError, match="CPU"):
        tfs.fused_candidates_plain(meta, starts, [(0, 10)], K, "murmur3")
