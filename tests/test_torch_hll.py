"""Port parity of the dashing precluster's pieces: HLL registers, the
register fold, the union statistics (the hll_union kernel's plain
version), cardinalities, the thresholded pair dict and the k=21 murmur3
hash (the murmur3_k21 kernel's plain version), against galah_tpu on
the same numpy-seeded inputs.

Tolerances: registers and hashes are integers and must be equal.
Union statistics against galah_tpu's f32 sums: powsum rtol 1e-5 and
zeros exact (tests/test_pallas.py's own tolerances); cardinalities rtol
1e-5; pair ANIs |d| < 1e-5 (tests/test_pallas.py:103) with the same pair
sets, no pair lying within 1e-5 of the threshold. The plain union
statistics sum in float64 and round once, so against the exact sum
they are equal while every register is at most 41. The kernels
themselves need the card and are held against these plain versions by
chip_smoke.py; here, on the CPU, the wrappers run the plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galah_tpu.io import read_genome as jread
from galah_tpu.ops import hashing as jhash
from galah_tpu.ops import hll as jhll
from galah_tpu.ops.pallas_hll import hll_union_stats_tile
from galah_tpu_torch import convert
from galah_tpu_torch.io.fasta import read_genome
from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops import hashing as thash
from galah_tpu_torch.ops import hll as thll
from galah_tpu_torch.ops.hll_union import (hll_union_stats,
                                           hll_union_stats_plain)
from galah_tpu_torch.ops.murmur3_k21 import murmur3_k21, murmur3_k21_plain
from galah_tpu_torch.ops.u64 import from_biased, to_biased

CPU = torch.device("cpu")
ACGT = np.array(list("ACGT"))

# The suite runs in several pytest worker processes on one host, and
# torch's intra-op pool in each would claim every core: the pools then
# contend and small torch ops slow down many times over. Every worker
# imports this module when it collects the suite, so one thread a
# process holds for all of it.
torch.set_num_threads(1)


def _seq(rng, n):
    return "".join(ACGT[rng.integers(0, 4, size=n)])


@pytest.fixture(scope="module")
def genome_paths(tmp_path_factory):
    """Contig breaks, N runs, a contig shorter than k, a genome shorter
    than k, an all-N genome and lowercase; every genome under one
    64 Ki hashing chunk of galah_tpu."""
    d = tmp_path_factory.mktemp("hll")
    rng = np.random.default_rng(21)
    s = _seq(rng, 40_000)
    bodies = {
        "a.fna": (f">x\n{s[:15_000]}NNNN{s[15_000:30_000]}\n>y\n"
                  f"{_seq(rng, 12)}\n>z\n{s[30_000:]}\n"),
        "b.fna": f">s\n{_seq(rng, 10)}\n",
        "c.fna": f">n\n{'N' * 300}\n",
        "d.fna": f">l\n{_seq(rng, 20_000).lower()}N{_seq(rng, 5_000)}\n",
        "e.fna": f">f\n{s[:25_000]}{_seq(rng, 3_000)}\n",
    }
    paths = []
    for name, body in sorted(bodies.items()):
        p = d / name
        p.write_text(body)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("grouping", ["one-group", "split"])
@pytest.mark.parametrize("algo", ["murmur3", "tpufast"])
def test_registers_bit_identical(genome_paths, monkeypatch, algo,
                                 grouping):
    """Registers of genomes sketched together equal galah_tpu's
    per-genome hll_sketch_genome; "split" forces a group per few
    genomes and a fold in several chunks."""
    if grouping == "split":
        monkeypatch.setattr(thll, "FUSED_BUDGET", 30_000)
        monkeypatch.setattr(thll, "FOLD_CHUNK", 7_001)
    genomes = [read_genome(p) for p in genome_paths]
    clock = thll.StageClock(CPU)
    got = thll.hll_sketch_genomes(genomes, algo=algo, device="cpu",
                                  clock=clock)
    assert got.dtype == torch.uint8 and got.shape == (len(genomes), 4096)
    for p, row in zip(genome_paths, convert.hll_registers_to_galah(got)):
        want = jhll.hll_sketch_genome(jread(p), algo=algo)
        np.testing.assert_array_equal(row, want)
    assert clock.counts["hll-launch-groups"] == (
        1 if grouping == "one-group" else 3)
    assert int(got[1].max()) == 0 and int(got[2].max()) == 0  # < k, all N


@pytest.mark.parametrize("p", [12, 10])
def test_fold_matches_hll_update_with_all_ones_hashes(p):
    """The fold against galah_tpu's _hll_update on hashes that hit the
    edges: 0 and tiny values (clz past the cap), the all-ones sentinel
    (rho 0, even where it is a real hash), all-ones but one bit, and
    register indices 0 and m-1."""
    rng = np.random.default_rng(p)
    edge = np.array([0, 1, (1 << (64 - p)) - 1, 1 << (64 - p),
                     (1 << 64) - 1, (1 << 64) - 2, (1 << 63),
                     ((1 << p) - 1) << (64 - p)], dtype=np.uint64)
    hashes = np.concatenate([
        rng.integers(0, 1 << 63, size=5000, dtype=np.uint64) * 2 + 1,
        rng.integers(0, 1 << 40, size=500, dtype=np.uint64),
        edge, np.full(50, (1 << 64) - 1, dtype=np.uint64)])
    start = np.zeros(1 << p, dtype=np.uint8)
    start[:7] = [0, 3, 60, 1, 0, 2, 9]
    want = np.asarray(jhll._hll_update(jnp.asarray(start),
                                       jnp.asarray(hashes), p))
    got = thll.hll_update(torch.from_numpy(start), to_biased(hashes), p)
    np.testing.assert_array_equal(got.numpy(), want)
    # all-ones alone leaves every register as it was
    ones = to_biased(np.full(3, (1 << 64) - 1, dtype=np.uint64))
    np.testing.assert_array_equal(
        thll.hll_update(torch.from_numpy(start), ones, p).numpy(), start)


def test_clz64_edges():
    vals = np.array([0, 1, 2, 3, (1 << 63), (1 << 64) - 1, 1 << 52,
                     (1 << 53) + 1, 0x0000FFFF00000000], dtype=np.uint64)
    want = [64 - int(v).bit_length() for v in vals]
    got = thll.clz64(torch.from_numpy(vals.view(np.int64)))
    assert got.tolist() == want


def _regs(rng, n, m, hi):
    return rng.integers(0, hi + 1, size=(n, m)).astype(np.uint8)


@pytest.mark.parametrize("hi", [41, 53])
def test_union_stats_match_pallas_interpret(hi):
    """(8, 8, 1024) against galah_tpu's Pallas kernel in interpret
    mode, which takes 2^-reg in f32."""
    rng = np.random.default_rng(hi)
    r, c = _regs(rng, 8, 1024, hi), _regs(rng, 8, 1024, hi)
    r[0] = 0
    c[1] = 0
    c[2] = hi
    ps, z = hll_union_stats_tile(
        jnp.asarray(np.exp2(-r.astype(np.float32))),
        jnp.asarray(np.exp2(-c.astype(np.float32))), chunk=1024,
        interpret=True)
    tps, tz = hll_union_stats(torch.from_numpy(r), torch.from_numpy(c))
    assert tps.dtype == torch.float32 and tz.dtype == torch.float32
    np.testing.assert_allclose(tps.numpy(), np.asarray(ps), rtol=1e-5)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))


@pytest.mark.parametrize("hi", [41, 53])
def test_union_stats_match_xla_and_exact_sum(hi):
    """(16, 24, 4096) against galah_tpu's XLA union statistics, and,
    for registers at most 41, bit for bit against the exact sum
    rounded once to f32."""
    rng = np.random.default_rng(100 + hi)
    r, c = _regs(rng, 16, 4096, hi), _regs(rng, 24, 4096, hi)
    c[3] = r[5]
    ps, z = jhll._xla_union_stats(
        jnp.asarray(np.exp2(-r.astype(np.float32))),
        jnp.asarray(np.exp2(-c.astype(np.float32))))
    tps, tz = hll_union_stats_plain(torch.from_numpy(r),
                                    torch.from_numpy(c))
    np.testing.assert_allclose(tps.numpy(), np.asarray(ps), rtol=1e-5)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
    if hi <= 41:
        mx = np.maximum(r[:, None, :], c[None, :, :]).astype(np.int64)
        exact = (np.left_shift(1, 41 - mx).sum(-1).astype(np.float64)
                 / 2.0 ** 41).astype(np.float32)
        np.testing.assert_array_equal(tps.numpy(), exact)


def test_union_stats_wrapper_checks_and_stays_plain_on_cpu():
    r = torch.zeros(3, 64, dtype=torch.uint8)
    before = dict(LAUNCHES)
    ps, z = hll_union_stats(r, r)
    assert torch.equal(ps, torch.full((3, 3), 64.0))
    assert torch.equal(z, torch.full((3, 3), 64.0))
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError, match="uint8"):
        hll_union_stats(r.to(torch.int32), r)
    with pytest.raises(ValueError, match="do not match"):
        hll_union_stats(r, r[:, :32].contiguous())


@pytest.mark.parametrize("n_items", [500, 20_000, 300_000])
def test_cardinality_matches(n_items):
    rng = np.random.default_rng(42)
    h = rng.integers(0, 1 << 63, size=n_items, dtype=np.uint64) * 2 + 1
    regs = thll.hll_update(torch.zeros(4096, dtype=torch.uint8),
                           to_biased(h), 12)
    mat = torch.stack([regs, torch.zeros_like(regs)])
    want = np.asarray(jhll.hll_cardinality(mat.numpy()))
    got = thll.hll_cardinality(mat)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert abs(float(got[0]) - n_items) / n_items < 0.065


def _family_registers(seed, n, p):
    """(n, 2^p) registers of hash sets in families of 5: members share
    a family core and differ in a random share of their items, so pair
    ANIs spread over 0.90-1.0 and unrelated pairs sit near 0."""
    rng = np.random.default_rng(seed)
    mat = np.zeros((n, 1 << p), dtype=np.uint8)
    core = None
    for i in range(n):
        if i % 5 == 0:
            core = rng.integers(0, 1 << 63, size=40_000,
                                dtype=np.uint64) * 2 + 1
        keep = rng.random(core.shape[0]) >= rng.uniform(0.0, 0.7)
        own = rng.integers(0, 1 << 63, size=int((~keep).sum()),
                           dtype=np.uint64) * 2 + 1
        h = np.concatenate([core[keep], own])
        mat[i] = thll.hll_update(torch.zeros(1 << p, dtype=torch.uint8),
                                 to_biased(h), p).numpy()
    mat[-1] = mat[16]  # an identical pair at the tail
    return mat


@pytest.mark.parametrize("tiles", [(64, 256), (64, 80), (8, 16)])
def test_threshold_pairs_match(tiles):
    """The pair dict against galah_tpu's single-device XLA pass
    (use_pallas=False keeps it off conftest's 8-device mesh)."""
    row_tile, col_tile = tiles
    mat = _family_registers(5, 70, 12)
    min_ani = 0.95
    want = jhll.hll_threshold_pairs(mat, k=21, min_ani=min_ani,
                                    row_tile=row_tile, col_tile=col_tile,
                                    use_pallas=False)
    regs = convert.hll_registers_from_galah(mat)
    got = thll.hll_threshold_pairs(regs, 21, min_ani, row_tile=row_tile,
                                   col_tile=col_tile)
    assert set(got) == set(want)
    assert len(got) >= 20 and (16, 69) in got
    for key, v in got.items():
        assert abs(v - want[key]) < 1e-5, key
    every = thll.hll_threshold_pairs(regs, 21, 0.0, row_tile=row_tile,
                                     col_tile=col_tile, cap_per_row=1)
    assert len(every) == 70 * 69 // 2
    assert min(abs(v - min_ani) for v in every.values()) > 1e-5


def test_murmur3_plain_matches_xla_hash_core():
    """The k=21 murmur3 hash of codes with N runs and a contig break
    against galah_tpu's XLA _hash_core (canonical_kmer_hashes_chunk);
    the wrapper on the CPU is the plain version, a window range gives
    the same slice, and positional_hashes gives the same."""
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=70_000).astype(np.uint8)
    codes[1000:1010] = 255
    codes[50_000] = 255
    offsets = np.array([0, 30_000, 70_000], dtype=np.int64)
    want = np.asarray(jhash.canonical_kmer_hashes_chunk(
        jnp.asarray(codes), jnp.asarray(np.array([30_000], np.int32)),
        jnp.int32(0), k=21, seed=0, algo="murmur3"))
    tc, ts = torch.from_numpy(codes), torch.from_numpy(offsets)
    got = from_biased(murmur3_k21_plain(tc, ts))
    np.testing.assert_array_equal(got, want)
    before = LAUNCHES["murmur3_k21"]
    assert torch.equal(murmur3_k21(tc, ts), murmur3_k21_plain(tc, ts))
    assert LAUNCHES["murmur3_k21"] == before  # no kernel on the CPU
    np.testing.assert_array_equal(
        from_biased(murmur3_k21(tc, ts, 29_990, 30)), want[29_990:30_020])
    from galah_tpu_torch.io.fasta import Genome, GenomeStats

    g = Genome("g", codes, offsets, GenomeStats(2, 11, 40_000))
    np.testing.assert_array_equal(
        from_biased(thash.positional_hashes(g, 21, "cpu")), want)
    np.testing.assert_array_equal(
        from_biased(thash.positional_hashes(g, 21, "cpu", chunk=4099)),
        want)
    with pytest.raises(ValueError, match="outside"):
        murmur3_k21(tc, ts, 69_980, 2)
    with pytest.raises(ValueError, match="uint8"):
        murmur3_k21(tc.long(), ts)
    with pytest.raises(ValueError, match="int64"):
        murmur3_k21(tc, ts.int())


def test_register_conversion_round_trip():
    mat = np.random.default_rng(1).integers(0, 30, size=(5, 4096)
                                            ).astype(np.uint8)
    t = convert.hll_registers_from_galah(mat)
    assert t.dtype == torch.uint8
    np.testing.assert_array_equal(convert.hll_registers_to_galah(t), mat)
    with pytest.raises(ValueError):
        convert.hll_registers_from_galah(mat.astype(np.int32))
