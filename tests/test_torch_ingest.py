"""The port's native FASTA ingest and read-ahead against galah_tpu.

The C parser (``galah_tpu_torch/io/_cingest.py`` over
``galah_tpu_torch/csrc/ingest.c``) is held against galah_tpu's numpy
reader, galah_tpu's own C reader and the port's plain numpy parser, on
the cases of tests/test_cingest.py and on fuzzed byte strings, plain
and gzip; the read-ahead (``io/prefetch.py``) against galah_tpu's.

Tolerance: none — codes, offsets and stats equal, items equal and in
order.
"""

import gzip
import sys
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from galah_tpu.io import _cingest as jcingest
from galah_tpu.io import prefetch as jprefetch
from galah_tpu.io.fasta import read_genome_numpy
from galah_tpu_torch import quality as tq
from galah_tpu_torch.backends import ProfileStore
from galah_tpu_torch.io import _cingest, prefetch
from galah_tpu_torch.io.fasta import (read_genome, read_genome_plain,
                                      read_genome_stats,
                                      read_genome_stats_plain)

from test_torch_cluster import _families

CPU = torch.device("cpu")

CASES = {
    "plain.fna": b">a\nACGT\nNNacgt\n>b\nTTTT\n",
    "crlf.fna": b">a desc\r\nAC GT\r\n\r\n>b\r\nNN\r\n",
    "leading_junk.fna": b"ACGT\n>a\nACGT\n",
    "empty_contig.fna": b">a\n>b\nACGT\n",
    "no_trailing_newline.fna": b">a\nACGTAC",
    "indented_header.fna": b"  >a\nACGT\n  >b\nTT\n",
    "iupac_and_ws.fna": b">a\nRYKM\x0bACG\x0c\n\t \n>b x\n  acgtn  \n",
    "bare.fna": b">hACGT",
}


def _write(path, data: bytes, gz: bool):
    if gz:
        with gzip.open(path, "wb") as fh:
            fh.write(data)
    else:
        path.write_bytes(data)
    return str(path)


def _assert_all_readers_agree(path):
    want = read_genome_numpy(path)
    j_codes, j_offsets, j_amb, j_n50 = jcingest.read_fasta(path)
    got = read_genome(path)
    plain = read_genome_plain(path)
    for g in (got, plain):
        np.testing.assert_array_equal(g.codes, want.codes)
        np.testing.assert_array_equal(g.contig_offsets, want.contig_offsets)
        assert g.codes.dtype == np.uint8
        assert g.contig_offsets.dtype == np.int64
        assert (g.stats.num_contigs, g.stats.num_ambiguous_bases,
                g.stats.n50) == (want.stats.num_contigs,
                                 want.stats.num_ambiguous_bases,
                                 want.stats.n50)
    np.testing.assert_array_equal(got.codes, j_codes)
    np.testing.assert_array_equal(got.contig_offsets, j_offsets)
    assert (got.stats.num_ambiguous_bases, got.stats.n50) == (j_amb, j_n50)
    assert read_genome_stats(path) == got.stats
    assert read_genome_stats_plain(path) == got.stats


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_c_parser_matches_every_reader(tmp_path, name, gz):
    p = _write(tmp_path / (name + (".gz" if gz else "")), CASES[name], gz)
    _assert_all_readers_agree(p)


@pytest.mark.parametrize("gz", [False, True])
def test_no_records_raises_like_galah_tpu(tmp_path, gz):
    p = _write(tmp_path / "empty.fna", b"\n  \nACGT\n", gz)
    with pytest.raises(ValueError, match="no FASTA records"):
        read_genome_numpy(p)
    for fn in (read_genome, read_genome_plain, read_genome_stats,
               read_genome_stats_plain):
        with pytest.raises(ValueError, match="no FASTA records"):
            fn(p)


def test_corrupt_gzip_raises(tmp_path):
    good = gzip.compress(b">a\n" + b"ACGT" * 5000 + b"\n")
    p = tmp_path / "cut.fna.gz"
    p.write_bytes(good[:len(good) // 2])
    for fn in (read_genome, read_genome_plain, read_genome_stats):
        with pytest.raises((EOFError, OSError)):
            fn(str(p))


_FASTA_BYTES = hst.lists(
    hst.sampled_from([b"A", b"C", b"G", b"T", b"a", b"c", b"g", b"t",
                      b"N", b"R", b"y", b">", b">hdr ", b"\n", b"\r\n",
                      b" ", b"\t", b"\x0b", b"\x0c", b"\n\n", b"\x00",
                      b"\xff"]),
    min_size=0, max_size=80).map(b"".join)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(body=_FASTA_BYTES, gz=hst.booleans(), header=hst.booleans())
def test_fuzzed_fasta_bytes(tmp_path_factory, body, gz, header):
    """Random FASTA byte strings, plain and gzip: every reader agrees,
    or every reader refuses the file."""
    data = (b">first\n" if header else b"") + body
    p = _write(tmp_path_factory.mktemp("fuzz") / "f.fna", data, gz)
    try:
        read_genome_numpy(p)
    except ValueError:
        for fn in (read_genome, read_genome_plain):
            with pytest.raises(ValueError, match="no FASTA records"):
                fn(p)
        return
    _assert_all_readers_agree(p)


def test_broken_compiler_raises_and_never_parses_with_numpy(
        tmp_path, monkeypatch):
    """CC=false: the build raises with the compiler's status, and
    read_genome raises instead of reading with numpy."""
    p = _write(tmp_path / "a.fna", CASES["plain.fna"], False)
    monkeypatch.setattr(_cingest, "_LIB", None)
    monkeypatch.setattr(_cingest, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="C parser build failed"):
        _cingest.build(_cingest.SOURCE, str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="C parser build failed"):
        read_genome(p)
    with pytest.raises(RuntimeError, match="C parser build failed"):
        read_genome_stats(p)
    assert read_genome_plain(p).stats.num_contigs == 2


def test_bad_source_path_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_cingest, "_LIB", None)
    monkeypatch.setattr(_cingest, "SOURCE", str(tmp_path / "missing.c"))
    with pytest.raises(RuntimeError, match="source unreadable"):
        read_genome(_write(tmp_path / "a.fna", CASES["plain.fna"], False))


def test_parallel_first_use_builds_once_and_parses(tmp_path, monkeypatch):
    """Sixteen threads race the first build into an empty directory,
    under a short switch interval; every parse equals the plain one."""
    monkeypatch.setattr(_cingest, "_LIB", None)
    monkeypatch.setattr(_cingest, "BUILD_DIR", str(tmp_path / "build"))
    paths = [_write(tmp_path / f"{n}.fna", data, n % 2 == 1)
             for n, data in enumerate(CASES.values())]
    results = {}
    errors = []

    def work(t):
        try:
            results[t] = [read_genome(p) for p in paths]
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 16
    want = [read_genome_plain(p) for p in paths]
    for got in results.values():
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.codes, w.codes)
            assert g.stats == w.stats
    assert len(list((tmp_path / "build").glob("libingest-*.so"))) == 1


# -- read-ahead -------------------------------------------------------------


def _load(path):
    if path.startswith("bad"):
        raise KeyError(path)
    time.sleep(0.002 * (hash(path) % 3))
    return path.upper()


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_iter_prefetched_order_matches_galah_tpu(depth):
    paths = [f"g{i}" for i in range(23)]
    got = list(prefetch.iter_prefetched(paths, _load, depth=depth))
    assert got == list(jprefetch.iter_prefetched(paths, _load, depth=depth))
    assert got == [(p, p.upper()) for p in paths]
    assert list(prefetch.iter_prefetched([], _load, depth)) == []


@pytest.mark.parametrize("depth", [1, 3])
def test_iter_prefetched_raises_at_the_failing_items_turn(depth):
    paths = ["g0", "g1", "bad2", "g3", "g4"]
    for mod in (prefetch, jprefetch):
        seen = []
        with pytest.raises(KeyError, match="bad2"):
            for p, v in mod.iter_prefetched(paths, _load, depth=depth):
                seen.append(p)
        assert seen == ["g0", "g1"]


def test_iter_prefetched_settles_pending_reads_on_close():
    """Closing the stream early returns only after every read it
    started has finished, and starts no new one."""
    running = []
    started = []
    lock = threading.Lock()

    def slow(path):
        with lock:
            started.append(path)
            running.append(path)
        time.sleep(0.05)
        with lock:
            running.remove(path)
        return path

    it = prefetch.iter_prefetched([f"g{i}" for i in range(20)], slow, 4)
    assert next(it) == ("g0", "g0")
    it.close()
    assert running == []
    n = len(started)
    time.sleep(0.1)
    assert len(started) == n <= 5


def test_ingest_depth():
    assert [prefetch.ingest_depth(t) for t in (1, 2, 3, 8)] == [
        2, 2, 3, 8]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _families(tmp_path_factory.mktemp("ingest"), 3, 3, 3, 12_000,
                     0.02)


def test_profile_store_read_ahead_matches_one_thread(corpus):
    paths, _ = corpus
    one = ProfileStore(CPU)
    many = ProfileStore(CPU, threads=4)
    a = one.get_many(paths + paths[:2])
    b = many.get_many(paths + paths[:2])
    for x, y in zip(a, b):
        assert torch.equal(x.markers, y.markers)
    assert many.clock.counts["genomes-read"] == len(paths)
    work = many.clock.work_seconds["read"]
    assert work > 0
    assert many.get_many(paths[:3])[0] is b[0]  # cached, no new read
    assert many.clock.counts["genomes-read"] == len(paths)
    assert many.clock.work_seconds["read"] == work


def test_quality_stats_fan_out_keeps_the_order(corpus, tmp_path):
    paths, _ = corpus
    report = tmp_path / "q.tsv"
    rng = np.random.default_rng(0)
    with open(report, "w") as fh:
        fh.write("Name\tCompleteness\tContamination\n")
        for p in paths:
            name = p.rsplit("/", 1)[1].rsplit(".", 1)[0]
            fh.write(f"{name}\t{rng.choice([90.0, 95.0])}\t1.0\n")
    one, _ = tq.quality_order_genomes(paths,
                                      checkm2_quality_report=str(report))
    many, _ = tq.quality_order_genomes(
        paths, checkm2_quality_report=str(report), threads=4)
    assert many == one
