"""The port's HLL cardinality bands (galah_tpu_torch/ops/bucketing.py)
against galah_tpu's, and the finch backend's bucketed route.

Tolerance: none for the band width, the bands, the pair counts, the pair
dicts (float64 ANIs), the gauges and the hll-buckets event. The HLL
cardinalities are float32 estimates: galah_tpu sums 2^-reg in float32
in XLA's order, the port in float64 then rounds, so they may differ by
an ulp (rtol 1e-6); the bands they give must be equal on the corpus.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galah_tpu.obs import events as jevents
from galah_tpu.obs import metrics as jmetrics
from galah_tpu.ops import _csketch
from galah_tpu.ops import bucketing as jbuck
from galah_tpu.ops import collision as jcol
from galah_tpu.ops import hll as jhll
from galah_tpu_torch.backends import MinHashPreclusterer, SketchStore
from galah_tpu_torch.backends import minhash_backend
from galah_tpu_torch.io.fasta import read_genome
from galah_tpu_torch.obs import events as tevents
from galah_tpu_torch.obs import metrics as tmetrics
from galah_tpu_torch.ops import bucketing as tbuck
from galah_tpu_torch.ops import collision as tcol
from galah_tpu_torch.ops.hll import (DEFAULT_P, hll_cardinality,
                                     hll_sketch_genomes)
from galah_tpu_torch.ops.minhash import sketch_matrix
from galah_tpu_torch.ops.pairwise import threshold_pairs
from galah_tpu_torch.ops.sketch_stream import sketch_genomes_fused
from galah_tpu_torch.ops.u64 import from_biased

# several pytest workers share the host: one torch thread a worker
torch.set_num_threads(1)

CPU = torch.device("cpu")
ACGT = np.array(list("ACGT"))
GAUGES = ("precluster.bucket_pruned_pairs",
          "precluster.bucket_pruned_fraction", "precluster.bucket_count")


def _write(path, codes):
    seq = "".join(ACGT[codes])
    with open(path, "w") as f:
        f.write(">c\n" + "\n".join(seq[i:i + 70]
                                   for i in range(0, len(seq), 70)) + "\n")


def tiered_corpus(root, seed=23, lengths=(1_500, 15_000, 150_000),
                  n_fam=2, size=3, rate=0.01):
    """Families of `size` members (~`rate` divergence) at each length:
    the cardinalities of the tiers lie bands apart at 95% ANI, so the
    walk forms several bands and prunes pairs."""
    rng = np.random.default_rng(seed)
    paths = []
    for t, length in enumerate(lengths):
        for fam in range(n_fam):
            base = rng.integers(0, 4, size=length)
            for m in range(size):
                codes = base.copy()
                if m:
                    sites = rng.random(length) < rate
                    codes[sites] = (codes[sites] + rng.integers(
                        1, 4, size=int(sites.sum()))) % 4
                paths.append(str(root / f"t{t}_f{fam}_m{m}.fna"))
                _write(paths[-1], codes)
    # interleave the tiers so the bands are not contiguous row ranges
    order = np.random.default_rng(seed + 1).permutation(len(paths))
    return [paths[i] for i in order]


@pytest.fixture(scope="module")
def tiered(tmp_path_factory):
    paths = tiered_corpus(tmp_path_factory.mktemp("tiered"))
    genomes = [read_genome(p) for p in paths]
    sketches = sketch_genomes_fused(genomes, 1000, 21, "murmur3", CPU)
    mat = sketch_matrix(sketches, 1000, CPU)
    regs = hll_sketch_genomes(genomes, DEFAULT_P, 21, "murmur3", CPU)
    return {"paths": paths, "genomes": genomes, "mat": mat, "regs": regs}


@pytest.mark.parametrize("min_ani", [0.8, 0.9, 0.95, 0.99, 0.999])
@pytest.mark.parametrize("k,p,size", [(21, 12, 1000), (15, 10, 200),
                                      (21, 4, 1000), (21, 12, 3)])
def test_band_width_and_bands_equal_galah_tpu(min_ani, k, p, size):
    want = jbuck.band_width(min_ani, k, p, size)
    got = tbuck.band_width(min_ani, k, p, size)
    assert got == want or (math.isinf(got) and math.isinf(want))
    cards = np.exp(np.random.default_rng(3).uniform(0, 16, size=200))
    cards[:3] = [0.0, 0.5, 1.0]
    np.testing.assert_array_equal(
        tbuck.assign_bands(cards, min_ani, k, p, size),
        jbuck.assign_bands(cards, min_ani, k, p, size))


@pytest.mark.parametrize("seed", range(4))
def test_pair_counts_equal_galah_tpu(seed):
    bands = np.random.default_rng(seed).integers(0, 6, size=50 + seed)
    got = tbuck._pair_counts(bands)
    assert got == jbuck._pair_counts(bands)
    assert got[0] == (50 + seed) * (49 + seed) // 2 >= got[1]


def test_registers_cards_and_bands_equal_galah_tpu(tiered):
    """The port's registers are galah_tpu's (its C walker), their
    cardinalities agree to an ulp, and the bands are equal."""
    regs = tiered["regs"].numpy()
    for g, row in zip(tiered["genomes"], regs):
        np.testing.assert_array_equal(row, _csketch.hll_registers(
            g.codes, g.contig_offsets, k=21, p=DEFAULT_P, seed=0,
            algo="murmur3"))
    got = hll_cardinality(tiered["regs"]).numpy().astype(np.float64)
    want = np.asarray(jhll.hll_cardinality(jnp.asarray(regs)),
                      dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for ani in (0.9, 0.95):
        bands = tbuck.assign_bands(got, ani, 21, DEFAULT_P, 1000)
        np.testing.assert_array_equal(
            bands, jbuck.assign_bands(want, ani, 21, DEFAULT_P, 1000))
    assert len(set(tbuck.assign_bands(got, 0.95, 21, DEFAULT_P, 1000))) == 3


@pytest.mark.parametrize("min_ani", [0.9, 0.95])
def test_bucketed_pairs_equal_galah_tpu_and_unbucketed(tiered, monkeypatch,
                                                       min_ani):
    """The band walk's pair dict equals the port's unbucketed pass and
    galah_tpu's band walk over the same rows and cardinalities (its
    crossover at 0 keeps its pair passes off conftest's mesh), bit for
    bit; at 95% the tiers prune pairs."""
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    mat = tiered["mat"]
    cards = hll_cardinality(tiered["regs"]).numpy().astype(np.float64)
    got = tbuck.bucketed_threshold_pairs(mat, cards, 21, min_ani, 1000,
                                         p=DEFAULT_P)
    want = jbuck.bucketed_threshold_pairs(from_biased(mat), cards, 21,
                                          min_ani, 1000, p=DEFAULT_P)
    assert got == want
    assert got == threshold_pairs(mat, 21, min_ani, 1000)
    assert len(got) >= 18  # every family's three pairs
    possible, scheduled = tbuck._pair_counts(
        tbuck.assign_bands(cards, min_ani, 21, DEFAULT_P, 1000))
    if min_ani == 0.95:
        assert possible > scheduled


def test_sparse_bands_equal_dense(tiered, monkeypatch):
    """A band at or past the crossover takes the collision screen and
    pairlist pass; its integers are the dense pass's."""
    mat = tiered["mat"]
    cards = hll_cardinality(tiered["regs"]).numpy().astype(np.float64)
    dense = tbuck.bucketed_threshold_pairs(mat, cards, 21, 0.95, 1000)
    monkeypatch.setattr(tcol, "SPARSE_SCREEN_MIN_N", 0)
    assert tbuck.bucketed_threshold_pairs(mat, cards, 21, 0.95,
                                          1000) == dense


def test_gauges_and_event_equal_galah_tpu(tiered, monkeypatch):
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    mat = tiered["mat"]
    cards = hll_cardinality(tiered["regs"]).numpy().astype(np.float64)
    tevents.reset()
    jevents.reset()
    tbuck.bucketed_threshold_pairs(mat, cards, 21, 0.95, 1000)
    jbuck.bucketed_threshold_pairs(from_biased(mat), cards, 21, 0.95, 1000)
    tsnap, jsnap = tmetrics.snapshot(), jmetrics.snapshot()
    for name in GAUGES:
        assert tsnap[name] == jsnap[name], name
    assert tsnap["precluster.bucket_count"]["value"] == 3.0
    assert tsnap["precluster.bucket_pruned_pairs"]["value"] > 0

    def last(evs):
        ev = [e for e in evs if e["kind"] == "hll-buckets"][-1]
        return {k: v for k, v in ev.items() if k != "time"}

    assert last(tevents.snapshot()) == last(jevents.snapshot())


@pytest.mark.parametrize("flag,n,crossover,want", [
    ("0", 5000, 1024, False), ("1", 2, 1024, True), ("1", 1, 1024, False),
    ("auto", 1023, 1024, False), ("auto", 1024, 1024, True),
    ("auto", 10, 8, True), (None, 10, 8, True), (None, 7, 8, False)])
def test_bucketing_tristate_equals_galah_tpu(monkeypatch, flag, n,
                                             crossover, want):
    if flag is None:
        monkeypatch.delenv("GALAH_TPU_HLL_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("GALAH_TPU_HLL_BUCKETS", flag)
    monkeypatch.delenv("GALAH_TPU_SPARSE_MIN_N", raising=False)  # galah-lint: ignore[GL401] galah_tpu's flag, for its side
    monkeypatch.setattr(tcol, "SPARSE_SCREEN_MIN_N", crossover)
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", crossover)
    assert tbuck.bucketing_engaged(n) is want
    assert jbuck.bucketing_engaged(n) is want
    assert tbuck.resolve_hll_buckets() == jbuck.resolve_hll_buckets()


def test_streamed_pass_declines_when_bucketing(tiered, monkeypatch):
    """GALAH_TPU_HLL_BUCKETS=1 below the crossover: no stream, so the
    staged bucketed route (and not the overlapped engine) runs; =0
    streams as before."""
    paths = tiered["paths"]
    monkeypatch.setenv("GALAH_TPU_HLL_BUCKETS", "1")
    pre = MinHashPreclusterer(0.95, SketchStore(CPU))
    assert pre.distances_streamed(paths) is None
    monkeypatch.setenv("GALAH_TPU_HLL_BUCKETS", "0")
    stream = pre.distances_streamed(paths)
    assert stream is not None
    stream.close()


def test_backend_bucketed_route(tiered, monkeypatch):
    """MinHashPreclusterer.distances under GALAH_TPU_HLL_BUCKETS=1: the
    cardinalities in stage precluster-hll-cards (one register group,
    the murmur3_k21 path), the band walk, and the unbucketed pair dict;
    with the page store forced too, the same dict from pages."""
    paths = tiered["paths"]
    monkeypatch.setenv("GALAH_TPU_HLL_BUCKETS", "0")
    want = MinHashPreclusterer(0.95, SketchStore(CPU)).distances(paths)
    monkeypatch.setenv("GALAH_TPU_HLL_BUCKETS", "1")
    tevents.reset()
    calls = []
    real = minhash_backend.bucketing.bucketed_threshold_pairs
    monkeypatch.setattr(minhash_backend.bucketing,
                        "bucketed_threshold_pairs",
                        lambda *a, **kw: calls.append(a[0])
                        or real(*a, **kw))
    for paged in ("0", "1"):
        monkeypatch.setenv("GALAH_TPU_PAGESTORE", paged)
        store = SketchStore(CPU)
        calls.clear()
        got = MinHashPreclusterer(0.95, store).distances(paths)
        assert got == want and len(got) > 0
        assert "precluster-hll-cards" in store.clock.seconds
        assert store.clock.counts["hll-launch-groups"] == 1
        assert (store.pagestore is not None) == (paged == "1")
        assert hasattr(calls[0], "band_gather") == (paged == "1")
    assert len([e for e in tevents.snapshot()
                if e["kind"] == "hll-buckets"]) == 2
