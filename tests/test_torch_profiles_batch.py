"""Port parity of the batched profile build: groups, the k=15 group hash
and the profiles, against galah_tpu.

The same seeded genomes (numpy codes) go through galah_tpu's
``build_profiles_batch``, ``build_profile`` and ``positional_hashes_batch``
and through the port on the CPU, where ``ops/positional_hashes`` runs its
plain version (the CUDA kernel is held against that plain version on the
card by chip_smoke.py). Tolerance: none. Hashes, distinct sets and
markers are uint64 and must be equal bit for bit; cluster TSVs byte for
byte.
"""

import numpy as np
import pytest
import torch

from galah_tpu.cli import main as jmain
from galah_tpu.io.fasta import Genome as JGenome
from galah_tpu.io.fasta import GenomeStats as JStats
from galah_tpu.ops import collision as jcol
from galah_tpu.ops import fragment_ani as jfa
from galah_tpu_torch import cli as tcli
from galah_tpu_torch import convert
from galah_tpu_torch.backends import ProfileStore
from galah_tpu_torch.io import group as tgroup
from galah_tpu_torch.io.fasta import Genome, GenomeStats
from galah_tpu_torch.io.prefetch import iter_batches
from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops import fragment_ani as tfa
from galah_tpu_torch.ops import hashing
from galah_tpu_torch.ops import sketch_stream
from galah_tpu_torch.ops.positional_hashes import (positional_hashes,
                                                   positional_hashes_plain)
from galah_tpu_torch.ops.u64 import from_biased

from test_torch_cluster import _families

CPU = torch.device("cpu")
K = 15
FRAGLEN = 3000
FIELDS = ("flat_hashes", "ref_set", "markers")
# the long genome's length, above the monkeypatched ALONE_ABOVE
LONG = 9000
ALONE = 8000


def _codes(rng, n, n_runs=0):
    c = rng.integers(0, 4, size=n).astype(np.uint8)
    for s in rng.integers(0, max(n - 40, 1), size=n_runs):
        c[s:s + int(rng.integers(1, 40))] = 255
    return c


def _pair(name, codes, contig_starts=()):
    """The same genome as a port Genome and a galah_tpu Genome."""
    n = codes.shape[0]
    offsets = np.array([0, *contig_starts, n], dtype=np.int64)
    stats = (len(offsets) - 1, int((codes == 255).sum()), n)
    return (Genome(name, codes, offsets, GenomeStats(*stats)),
            JGenome(name, codes.copy(), offsets.copy(), JStats(*stats)))


def _corpus(seed=0):
    """Port and galah_tpu genomes: shorter than k, exactly k, k + 1, N
    runs (one all ambiguous), many short contigs (some shorter than k,
    one empty), a repeated unit, and one longer than ALONE."""
    rng = np.random.default_rng(seed)
    many = np.unique(rng.integers(1, 5000, size=300))
    genomes = [
        _pair("short", _codes(rng, 9)),
        _pair("exactly-k", _codes(rng, K)),
        _pair("k-plus-1", _codes(rng, K + 1), [1]),
        _pair("n-runs", _codes(rng, 6000, n_runs=60), [2500]),
        _pair("all-n", np.full(400, 255, dtype=np.uint8)),
        _pair("many-contigs", _codes(rng, 5000),
              np.concatenate([many, [many[-1]]])),
        _pair("repeat", np.tile(_codes(rng, 300), 12)),
        _pair("long", _codes(rng, LONG, n_runs=10), [4000, 4007]),
        _pair("tail", _codes(rng, 2500, n_runs=5), [2500 - K]),
    ]
    return [t for t, _ in genomes], [j for _, j in genomes]


def _assert_profiles_equal(got, want):
    assert len(got) == len(want)
    for t, j in zip(got, want):
        fields = convert.profile_to_galah_fields(t)
        assert t.path == j.path
        for name in FIELDS:
            np.testing.assert_array_equal(fields[name], getattr(j, name),
                                          err_msg=f"{j.path} {name}")


@pytest.fixture
def small_groups(monkeypatch):
    """Groups of a few genomes, and the long genome alone."""
    monkeypatch.setattr(tfa, "PROFILE_BATCH_BUDGET", 12_000)
    monkeypatch.setattr(tgroup, "ALONE_ABOVE", ALONE)


@pytest.mark.parametrize("algo", ["murmur3", "tpufast"])
def test_build_profiles_batch_matches_galah_tpu(small_groups, algo):
    """Every profile field equals galah_tpu's batched and per-genome
    builds, the long genome forms a group of its own, and on the CPU no
    kernel launches."""
    tg, jg = _corpus()
    groups = list(tgroup.iter_groups(tg, tfa.PROFILE_BATCH_BUDGET))
    assert [7] in groups and len(groups) > 2
    assert all(len(g) == 1 for g in groups if 7 in g)
    before = dict(LAUNCHES)
    got = tfa.build_profiles_batch(tg, K, FRAGLEN, CPU,
                                   hash_algorithm=algo)
    assert dict(LAUNCHES) == before
    _assert_profiles_equal(got, jfa.build_profiles_batch(
        jg, K, FRAGLEN, hash_algorithm=algo))
    _assert_profiles_equal(got, [jfa.build_profile(
        g, K, FRAGLEN, hash_algorithm=algo) for g in jg])
    _assert_profiles_equal(
        [tfa.build_profile(g, K, FRAGLEN, CPU, hash_algorithm=algo)
         for g in tg], [jfa.build_profile(g, K, FRAGLEN,
                                          hash_algorithm=algo) for g in jg])


@pytest.mark.parametrize("algo", ["murmur3", "tpufast"])
def test_group_hashes_match_positional_hashes_batch(algo):
    """``positional_hashes_plain`` over a group's codes, cut at each
    genome's windows, equals galah_tpu's grouped XLA hashing
    (``positional_hashes_batch``, its long genomes per genome) row by
    row, and the port's per-genome ``hashing.positional_hashes``; the
    windows across a genome start are the sentinel."""
    tg, jg = _corpus(seed=1)
    want = jfa.positional_hashes_batch(jg, K, algo=algo)
    codes, starts, jobs = tgroup.host_layout(tg, K)
    tc, ts = torch.from_numpy(codes), torch.from_numpy(starts)
    got = positional_hashes_plain(tc, ts, algo=algo)
    assert torch.equal(got, positional_hashes(tc, ts, algo=algo))
    covered = np.zeros(got.shape[0], dtype=bool)
    for g, (w0, n), row in zip(tg, jobs, want):
        np.testing.assert_array_equal(from_biased(got[w0:w0 + n]), row,
                                      err_msg=g.path)
        np.testing.assert_array_equal(
            from_biased(hashing.positional_hashes(g, K, CPU, algo=algo)),
            row, err_msg=g.path)
        covered[w0:w0 + n] = True
    assert (from_biased(got[~covered]) == np.uint64(2**64 - 1)).all()
    # a window range that starts and ends inside genomes
    w0 = jobs[3][0] + 17
    np.testing.assert_array_equal(
        positional_hashes_plain(tc, ts, w0, 5000, algo).numpy(),
        got[w0:w0 + 5000].numpy())


@pytest.mark.parametrize("budget", [1, 2_000, 9_000, 20_000, 1 << 24])
def test_profiles_do_not_depend_on_the_group_cut(monkeypatch, budget):
    """One genome list cut into groups at budgets from one genome a
    group to one group: the same profiles as galah_tpu's."""
    monkeypatch.setattr(tfa, "PROFILE_BATCH_BUDGET", budget)
    tg, jg = _corpus(seed=2)
    n_groups = len(list(tgroup.iter_groups(tg, budget)))
    assert n_groups == {1: len(tg), 1 << 24: 1}.get(budget, n_groups) > 0
    _assert_profiles_equal(tfa.build_profiles_batch(tg, K, FRAGLEN, CPU),
                           [jfa.build_profile(g, K, FRAGLEN) for g in jg])


def test_iter_batches_cuts_in_order_under_the_budget():
    items = [(str(i), n) for i, n in enumerate([5, 5, 1, 30, 4, 2, 9, 1])]
    got = [[int(p) for p, _ in b]
           for b in iter_batches(iter(items), lambda n: n, 10,
                                 alone_above=8)]
    assert got == [[0, 1], [2], [3], [4, 5], [6], [7]]
    assert [p for b in iter_batches(iter(items), lambda n: n, 10)
            for p, _ in b] == [p for p, _ in items]


def test_group_layout_marks_every_genome_start():
    """A group's codes are the genomes' laid end to end; its starts hold
    each genome's start and interior contig starts, then its length
    (the layout the sketch kernels' and positional_hashes' plain
    versions read); job j is genome j's (first window, window count)."""
    tg, _ = _corpus(seed=3)
    loaded = tgroup.load_group(tg, 21, CPU)
    pos = np.cumsum([0] + [g.codes.shape[0] for g in tg])
    np.testing.assert_array_equal(loaded.codes.numpy(),
                                  np.concatenate([g.codes for g in tg]))
    np.testing.assert_array_equal(loaded.starts.numpy(), np.concatenate(
        [g.contig_offsets[:-1] + p for g, p in zip(tg, pos)] + [pos[-1:]]))
    assert loaded.jobs == [(int(p), max(g.codes.shape[0] - 20, 0))
                           for p, g in zip(pos, tg)]
    codes, starts, jobs = sketch_stream._concat(tg, 21)
    np.testing.assert_array_equal(codes, loaded.codes.numpy())
    np.testing.assert_array_equal(starts, loaded.starts.numpy())
    assert jobs == loaded.jobs


def test_positional_hashes_rejects_bad_inputs():
    codes = torch.zeros(100, dtype=torch.uint8)
    starts = torch.tensor([0, 100])
    with pytest.raises(ValueError, match="uint8"):
        positional_hashes(codes.to(torch.int64), starts)
    with pytest.raises(ValueError, match="int64"):
        positional_hashes(codes, starts.to(torch.int32))
    with pytest.raises(ValueError, match="outside"):
        positional_hashes(codes, starts, 80, 10)
    with pytest.raises(ValueError, match="algorithm"):
        positional_hashes(codes, starts, algo="xxhash")
    assert positional_hashes(codes[:K - 1], starts).numel() == 0


def _write_fasta(tmp_path, genomes):
    paths = []
    for g in genomes:
        p = tmp_path / f"{g.path}.fna"
        seq = np.frombuffer(b"ACGT", dtype=np.uint8)[
            np.minimum(g.codes, 3)].copy()
        seq[g.codes == 255] = ord("N")
        with open(p, "wb") as fh:
            for c, (a, b) in enumerate(zip(g.contig_offsets[:-1],
                                           g.contig_offsets[1:])):
                fh.write(b">c%d\n" % c + seq[a:b].tobytes() + b"\n")
        paths.append(str(p))
    return paths


def test_profile_store_get_many_order_duplicates_and_lru(tmp_path,
                                                         small_groups):
    """Profiles come back in path order with duplicates, equal to
    galah_tpu's; the store counts its groups and batched genomes; its
    LRU bound holds again after ``reserve``."""
    tg, jg = _corpus(seed=4)
    tg = [g for g in tg if g.stats.num_contigs > 0]
    paths = _write_fasta(tmp_path, tg)
    order = [3, 0, 3, 7, 1, 0, 8, 2, 7]
    store = ProfileStore(CPU, maxsize=2, threads=2)
    with store.reserve(len(tg)):
        got = store.get_many([paths[i] for i in order])
        assert len(store._cache) == len(set(order))
    assert [p.path for p in got] == [paths[i] for i in order]
    want = {g.path: jfa.build_profile(g, K, FRAGLEN) for g in jg}
    for prof, i in zip(got, order):
        fields = convert.profile_to_galah_fields(prof)
        for name in FIELDS:
            np.testing.assert_array_equal(fields[name],
                                          getattr(want[tg[i].path], name))
    assert len(store._cache) == 2
    counts = store.clock.counts
    assert counts["genomes-read"] == len(set(order))
    assert counts["profile-groups"] == len(list(tgroup.iter_groups(
        [tg[i] for i in dict.fromkeys(order)], tfa.PROFILE_BATCH_BUDGET)))
    # the long genome (index 7) is no batched genome, as in galah_tpu
    assert counts["profile-batched-genomes"] == len(set(order)) - 1
    # the two most recent stay cached: no read the second time
    again = store.get_many([paths[2], paths[8]])
    assert counts["genomes-read"] == len(set(order))
    assert again[0] is got[7]


@pytest.fixture(scope="module")
def families24(tmp_path_factory):
    """24 genomes: 8 families x 3 members, 30 kb, ~2% divergence (the
    fixture of tests/test_torch_cluster.py)."""
    return _families(tmp_path_factory.mktemp("batch24"), 7, 8, 3, 30_000,
                     0.02)


@pytest.mark.parametrize("precluster", ["skani", "finch"])
def test_cluster_tsv_byte_identical_in_small_groups(families24, monkeypatch,
                                                    tmp_path, precluster):
    """Whole ``cluster`` runs, skani and finch preclusters with the skani
    clusterer, profiles built 3 genomes a group: galah_tpu's TSV byte for
    byte (its crossover at 0 keeps its pair passes off conftest's
    8-device mesh)."""
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    monkeypatch.setattr(tfa, "PROFILE_BATCH_BUDGET", 100_000)
    paths, _ = families24
    want, got = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    common = ["cluster", "-f", *paths, "--ani", "97",
              "--precluster-ani", "90", "--min-aligned-fraction", "20",
              "--precluster-method", precluster, "--cluster-method",
              "skani"]
    assert jmain([*common, "--output-cluster-definition", str(want)]) == 0
    assert tcli.main([*common, "--device", "cpu", "--threads", "2",
                      "--output-cluster-definition", str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
