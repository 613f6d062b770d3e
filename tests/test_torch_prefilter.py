"""The port's ingest prefilter (galah_tpu_torch/ops/prefilter.py) and
its place in the finch sketch stream, against galah_tpu's.

Tolerance: none — window and digest decisions, sketches (uint64), pair
dicts (float64 ANIs), the four prefilter counters and the pre-warmed
hll cache entries (names and bytes) are equal.
"""

import logging
import os
import shutil

import numpy as np
import pytest
import torch

from galah_tpu.backends.minhash_backend import SketchStore as JSketchStore
from galah_tpu.io import diskcache as jdiskcache
from galah_tpu.obs import metrics as jmetrics
from galah_tpu.ops import prefilter as jpre
from galah_tpu.ops import sketch_stream as jstream
from galah_tpu_torch.backends import MinHashPreclusterer, SketchStore
from galah_tpu_torch.io import diskcache as tdiskcache
from galah_tpu_torch.io.fasta import Genome, GenomeStats
from galah_tpu_torch.obs import metrics as tmetrics
from galah_tpu_torch.ops import hll as thll
from galah_tpu_torch.ops import prefilter as tpre
from galah_tpu_torch.ops import sketch_stream as tstream

# several pytest workers share the host: one torch thread a worker
torch.set_num_threads(1)

CPU = torch.device("cpu")
ACGT = np.array(list("ACGT"))
COUNTERS = ("prefilter.skipped", "prefilter.skipped_duplicate",
            "prefilter.skipped_degenerate", "prefilter.hll_prewarmed")


def _genome(codes, offsets):
    codes = np.asarray(codes, dtype=np.uint8)
    return Genome(path="g", codes=codes,
                  contig_offsets=np.asarray(offsets, dtype=np.int64),
                  stats=GenomeStats(len(offsets) - 1, 0, 0))


def _write(path, contigs):
    with open(path, "w") as f:
        for i, seq in enumerate(contigs):
            f.write(f">c{i}\n")
            for s in range(0, len(seq), 70):
                f.write(seq[s:s + 70] + "\n")


def dup_corpus(root, seed=31, length=30_000):
    """3 families x 2 members interleaved with 3 byte-duplicates under
    other paths and 4 degenerate genomes (all N, shorter than k, every
    contig shorter than k, an N every 15 bases)."""
    rng = np.random.default_rng(seed)
    fams = []
    for fam in range(3):
        base = rng.integers(0, 4, size=length)
        for m in range(2):
            codes = base.copy()
            if m:
                sites = rng.random(length) < 0.01
                codes[sites] = (codes[sites] + 1) % 4
            p = str(root / f"f{fam}_{m}.fna")
            _write(p, ["".join(ACGT[codes])])
            fams.append(p)
    dups = []
    for i, src in enumerate((fams[0], fams[3], fams[0])):
        p = str(root / f"copy{i}.fna")
        shutil.copyfile(src, p)
        dups.append(p)
    degen = []
    rand = "".join(ACGT[rng.integers(0, 4, size=600)])
    for name, contigs in (("alln", ["N" * 5000]), ("short", ["ACGTACGTAC"]),
                          ("frag", [rand[i:i + 20] for i in range(0, 600, 20)]),
                          ("gappy", ["".join(
                              rand[i:i + 15] + "N"
                              for i in range(0, 585, 15))])):
        p = str(root / f"degen_{name}.fna")
        _write(p, contigs)
        degen.append(p)
    order = [fams[0], degen[0], fams[1], dups[0], fams[2], degen[1],
             dups[1], fams[3], degen[2], fams[4], dups[2], degen[3],
             fams[5]]
    return order


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return dup_corpus(tmp_path_factory.mktemp("prefilter"))


# -- the screens ------------------------------------------------------------


@pytest.mark.parametrize("codes,offsets,k,want", [
    ([0] * 21, [0, 21], 21, True),
    ([0] * 20, [0, 20], 21, False),
    ([255] * 50, [0, 50], 21, False),
    ([0] * 30 + [255] + [0] * 30, [0, 61], 21, True),
    ([0] * 20 + [255] + [0] * 20, [0, 41], 21, False),
    ([0] * 40, [0, 20, 40], 21, False),        # two contigs of 20
    ([0] * 41, [0, 20, 41], 21, True),         # the second holds 21
    ([1, 2] * 10 + [255] * 3 + [3] * 21, [0, 44], 21, True),
    ([0] * 15, [0, 15], 15, True),
    ([], [0], 21, False),
])
def test_has_valid_window_equals_galah_tpu(codes, offsets, k, want):
    g = _genome(codes, offsets)
    assert tpre._has_valid_window(g, k) is want
    assert jpre._has_valid_window(g, k) is want


def test_digest_separates_content_not_paths():
    a = _genome([0, 1, 2, 3] * 10, [0, 40])
    b = _genome([0, 1, 2, 3] * 10, [0, 40])
    b.path = "elsewhere"
    c = _genome([0, 1, 2, 3] * 10, [0, 20, 40])  # same codes, 2 contigs
    d = _genome([0, 1, 2, 2] + [0, 1, 2, 3] * 9, [0, 40])
    assert tpre._digest(a) == tpre._digest(b) == jpre._digest(a)
    assert len({tpre._digest(g) for g in (a, c, d)}) == 3
    for g in (c, d):
        assert tpre._digest(g) == jpre._digest(g)


@pytest.mark.parametrize("flag", [None, "auto", "0", "1", "bogus"])
def test_engagement_tristate_equals_galah_tpu(monkeypatch, flag):
    if flag is None:
        monkeypatch.delenv("GALAH_TPU_PREFILTER", raising=False)
    else:
        monkeypatch.setenv("GALAH_TPU_PREFILTER", flag)
    assert tpre.prefilter_mode() == jpre.prefilter_mode()
    assert tpre.prefilter_engaged() is jpre.prefilter_engaged()
    assert tpre.prefilter_engaged() is (flag != "0")


# -- the stream ---------------------------------------------------------------


def _counts(snapshot_fn):
    snap = snapshot_fn()
    return {n: (snap.get(n) or {}).get("value", 0) for n in COUNTERS}


def _delta(before, after):
    return {n: after[n] - before[n] for n in COUNTERS}


def _port_stream(paths, cache_dir=None, monkeypatch=None, budget=None):
    if budget is not None:
        monkeypatch.setattr(tstream, "FUSED_BUDGET", budget)
    cache = tdiskcache.CacheDir(cache_dir)
    store = SketchStore(CPU, cache=cache)
    before = _counts(tmetrics.snapshot)
    got = list(tstream.iter_path_sketches(paths, store))
    return got, _delta(before, _counts(tmetrics.snapshot)), store


@pytest.mark.parametrize("budget", [None, 40_000])
def test_prefilter_on_and_off_equal(corpus, monkeypatch, budget):
    """Prefilter on and off yield the same paths and sketches in path
    order, read groups of one genome (the pushback across groups) or of
    all; on skips the 3 duplicates and 4 degenerate genomes."""
    paths = corpus + corpus[:2]  # a repeated path is walked once
    monkeypatch.setenv("GALAH_TPU_PREFILTER", "0")
    off, d_off, _ = _port_stream(paths, monkeypatch=monkeypatch,
                                 budget=budget)
    monkeypatch.setenv("GALAH_TPU_PREFILTER", "1")
    on, d_on, store = _port_stream(paths, monkeypatch=monkeypatch,
                                   budget=budget)
    assert [p for p, _ in on] == [p for p, _ in off] == corpus
    for (_, a), (_, b) in zip(on, off):
        np.testing.assert_array_equal(a.hashes, b.hashes)
        assert a.hashes.dtype == np.uint64
    assert d_off == dict.fromkeys(COUNTERS, 0)
    assert d_on == {"prefilter.skipped": 7,
                    "prefilter.skipped_duplicate": 3,
                    "prefilter.skipped_degenerate": 4,
                    "prefilter.hll_prewarmed": 0}  # no disk cache
    assert sum(s.hashes.shape[0] == 0 for _, s in on) == 4


def test_counters_and_prewarmed_entries_equal_galah_tpu(corpus, tmp_path,
                                                        monkeypatch):
    """With a disk cache: galah_tpu's stream (its C sketcher) and the
    port's count the same skips and pre-warm the same hll entries, name
    for name and byte for byte; the sketches are equal."""
    monkeypatch.setenv("GALAH_TPU_PREFILTER", "1")
    monkeypatch.setenv("GALAH_TPU_SKETCH_STRATEGY", "c")  # galah-lint: ignore[GL401] galah_tpu's flag, for its side
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jstore = JSketchStore(1000, 21, cache=jdiskcache.CacheDir(jdir))
    before = _counts(jmetrics.snapshot)
    want = list(jstream.iter_path_sketches(corpus, jstore))
    jd = _delta(before, _counts(jmetrics.snapshot))
    got, td, _ = _port_stream(corpus, cache_dir=tdir)
    assert td == jd
    assert td["prefilter.hll_prewarmed"] == len(corpus)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.hashes, b.hashes)
    hll = sorted(n for n in os.listdir(jdir) if n.startswith("hll-"))
    assert len(hll) == len(corpus)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in sorted(os.listdir(jdir)):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    # a second pass finds every entry: nothing read, nothing pre-warmed
    again, td2, _ = _port_stream(corpus, cache_dir=tdir)
    assert td2 == dict.fromkeys(COUNTERS, 0)


def test_prewarm_is_one_register_call_a_read_group(corpus, tmp_path,
                                                   monkeypatch):
    """The pre-warm runs one hll_sketch_genomes call a read group (one
    murmur3_k21 launch a group on the card), over the group's
    genomes."""
    monkeypatch.setenv("GALAH_TPU_PREFILTER", "1")
    calls = []
    real = thll.hll_sketch_genomes
    monkeypatch.setattr(thll, "hll_sketch_genomes",
                        lambda gs, *a: calls.append(len(gs)) or real(gs, *a))
    _port_stream(corpus, cache_dir=str(tmp_path / "one"))
    assert calls == [len(corpus)]
    calls.clear()
    _port_stream(corpus, cache_dir=str(tmp_path / "many"),
                 monkeypatch=monkeypatch, budget=70_000)
    assert len(calls) > 3 and sum(calls) == len(corpus)


def test_prewarm_launch_failure_raises(corpus, tmp_path, monkeypatch):
    """A failure of the register pass is not swallowed: the stream
    raises (galah_tpu logs it and turns the pre-warm off)."""
    monkeypatch.setenv("GALAH_TPU_PREFILTER", "1")

    def boom(*a, **kw):
        raise RuntimeError("murmur3_k21 launch failed")

    monkeypatch.setattr(thll, "hll_sketch_genomes", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        _port_stream(corpus, cache_dir=str(tmp_path / "c"))


def test_prewarm_cache_oserror_warns_and_stops(corpus, tmp_path,
                                               monkeypatch, caplog):
    """A disk-cache OSError keeps galah_tpu's warning: the pre-warm
    stops, the stream goes on with the same sketches."""
    monkeypatch.setenv("GALAH_TPU_PREFILTER", "1")
    real = tdiskcache.CacheDir.store

    def store(self, path, kind, params, arrays):
        if kind == "hll":
            raise OSError(28, "No space left on device")
        return real(self, path, kind, params, arrays)

    monkeypatch.setattr(tdiskcache.CacheDir, "store", store)
    with caplog.at_level(logging.WARNING):
        got, d, _ = _port_stream(corpus, cache_dir=str(tmp_path / "c"))
    assert "HLL pre-warm stopped" in caplog.text
    assert d["prefilter.hll_prewarmed"] == 0 and d["prefilter.skipped"] == 7
    monkeypatch.setenv("GALAH_TPU_PREFILTER", "0")
    off, _, _ = _port_stream(corpus)
    for (_, a), (_, b) in zip(got, off):
        np.testing.assert_array_equal(a.hashes, b.hashes)


def test_hll_store_is_never_prefiltered(corpus, monkeypatch):
    """The dashing store's registers take the stream unscreened, as
    galah_tpu's HLL pass does: duplicates and degenerate genomes are
    sketched."""
    from galah_tpu_torch.backends.hll_backend import HLLStore

    monkeypatch.setenv("GALAH_TPU_PREFILTER", "1")
    before = _counts(tmetrics.snapshot)
    regs = dict(tstream.iter_path_sketches(corpus, HLLStore(CPU)))
    assert _delta(before, _counts(tmetrics.snapshot)) == \
        dict.fromkeys(COUNTERS, 0)
    assert len(regs) == len(corpus)


@pytest.mark.parametrize("threads", [1, 3])
def test_precluster_pairs_equal_with_prefilter(corpus, monkeypatch,
                                               threads):
    monkeypatch.setenv("GALAH_TPU_PREFILTER", "0")
    off = MinHashPreclusterer(0.9, SketchStore(CPU)).distances(corpus)
    monkeypatch.setenv("GALAH_TPU_PREFILTER", "1")
    on = MinHashPreclusterer(0.9, SketchStore(CPU),
                             threads=threads).distances(corpus)
    assert on == off
    # each duplicate pairs with its original at ANI 1
    assert on.get((0, 3)) == 1.0
