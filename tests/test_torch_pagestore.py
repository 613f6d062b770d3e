"""The port's paged sketch store (galah_tpu_torch/io/pagestore.py)
against galah_tpu's: the counterparts of tests/test_pagestore.py's
sixteen cases, page directories read across the packages both ways,
GALAH_FI faults at both page sites, the index's PagedSketchList, and an
index built and grown with paging forced.

Tolerance: none — rows, gathers, directory records, page file bytes
and index directory bytes are equal.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from galah_tpu.index import incremental as jinc
from galah_tpu.index import store as jstore
from galah_tpu.io import pagestore as jps
from galah_tpu_torch.index import incremental as tinc
from galah_tpu_torch.index import store as tstore
from galah_tpu_torch.io import atomic
from galah_tpu_torch.io.pagestore import (DIR_NAME, PageStoreError,
                                          PagedRowView, SketchPageStore,
                                          pagestore_engaged,
                                          pagestore_mode, ram_budget_bytes)
from galah_tpu_torch.ops.constants import SENTINEL_U64
from galah_tpu_torch.resilience import faults

# several pytest workers share the host: one torch thread a worker
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _rows(n, cols, seed=0, short_every=3):
    """Seeded rows; every `short_every`-th row is short (cols - 2
    hashes) to exercise the fill padding."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        width = cols - 2 if short_every and i % short_every == 0 else cols
        out.append(rng.integers(0, 1 << 62, size=width, dtype=np.uint64))
    return out


def _pages(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".gpg"))


# -- page format and round trip ----------------------------------------


def test_roundtrip_padding_and_key_lookup(tmp_path):
    store = SketchPageStore(str(tmp_path), cols=8, page_rows=4,
                            fill=int(SENTINEL_U64))
    rows = _rows(10, 8, seed=1)
    assert [store.append(f"g{i}", r) for i, r in enumerate(rows)] == \
        list(range(10))
    store.flush()
    assert len(store) == 10 and store.shape == (10, 8)
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(store.hashes(i), r)
        assert store.n_valid(i) == r.size
        full = store.row(i)
        assert full.shape == (8,)
        # the sentinel pads short rows: a pad slot never counts as common
        np.testing.assert_array_equal(
            full[r.size:], np.full(8 - r.size, SENTINEL_U64, np.uint64))
        assert store.rid_for(f"g{i}") == i
        np.testing.assert_array_equal(store.get(f"g{i}"), r)
    assert store.rid_for("nope") is None and store.get("nope") is None
    np.testing.assert_array_equal(store.valid_counts(),
                                  np.asarray([r.size for r in rows]))


def test_open_page_rows_readable_before_flush(tmp_path):
    store = SketchPageStore(str(tmp_path), cols=4, page_rows=100)
    r = np.arange(3, dtype=np.uint64)
    rid = store.append("k", r)
    assert _pages(tmp_path) == []  # nothing committed yet
    assert len(store) == 1 and store.n_valid(rid) == 3
    np.testing.assert_array_equal(store.hashes(rid), r)
    assert store.rid_for("k") == rid
    store.flush()
    assert _pages(tmp_path)
    np.testing.assert_array_equal(store.hashes(rid), r)


def test_page_boundary_auto_commit(tmp_path):
    store = SketchPageStore(str(tmp_path), cols=4, page_rows=2)
    for i in range(5):
        store.append(f"g{i}", np.full(4, i, np.uint64))
    assert len(_pages(tmp_path)) == 2  # rows 0-3 committed, row 4 open
    assert len(store) == 5


def test_oversized_row_rejected(tmp_path):
    store = SketchPageStore(str(tmp_path), cols=4)
    with pytest.raises(ValueError):
        store.append("big", np.zeros(5, np.uint64))


# -- zero-copy views -----------------------------------------------------


def test_committed_views_are_zero_copy_and_readonly(tmp_path):
    store = SketchPageStore(str(tmp_path), cols=8, page_rows=4)
    for i, r in enumerate(_rows(4, 8, seed=2, short_every=0)):
        store.append(f"g{i}", r)
    store.flush()
    a, b = store.row(1), store.hashes(1)
    assert not a.flags.writeable  # the map is read-only
    assert np.shares_memory(a, b)
    assert np.shares_memory(a, store.row(1))


def test_eviction_never_invalidates_live_views(tmp_path):
    """A one-page budget: reading pages 1 and 2 evicts page 0, whose
    view stays valid (eviction never closes a map)."""
    cols, page_rows = 8, 2
    page_bytes = cols * page_rows * 8
    store = SketchPageStore(str(tmp_path), cols=cols, page_rows=page_rows,
                            budget_bytes=page_bytes)
    rows = _rows(6, cols, seed=3, short_every=0)
    for i, r in enumerate(rows):
        store.append(f"g{i}", r)
    store.flush()
    view0 = store.row(0)
    for rid in (2, 4):
        store.row(rid)
    assert store.resident_bytes <= page_bytes
    np.testing.assert_array_equal(view0, rows[0])


# -- LRU, budget, pins --------------------------------------------------


def test_lru_eviction_respects_budget(tmp_path):
    cols, page_rows = 8, 2
    page_bytes = cols * page_rows * 8
    store = SketchPageStore(str(tmp_path), cols=cols, page_rows=page_rows,
                            budget_bytes=2 * page_bytes)
    rows = _rows(10, cols, seed=4, short_every=0)
    for i, r in enumerate(rows):
        store.append(f"g{i}", r)
    store.flush()  # 5 pages
    ins0, outs0 = store._c_page_ins.value, store._c_page_outs.value
    for rid in range(10):
        np.testing.assert_array_equal(store.hashes(rid), rows[rid])
        assert store.resident_bytes <= 2 * page_bytes
    assert store._c_page_ins.value - ins0 == 5
    assert store._c_page_outs.value - outs0 == 3
    # an evicted page maps again, its rows bit for bit
    np.testing.assert_array_equal(store.hashes(0), rows[0])
    assert store._c_page_ins.value - ins0 == 6
    assert store._g_resident.value == store.resident_bytes
    # a page maps before the eviction pass that makes room for it
    assert store.peak_resident_bytes == 3 * page_bytes


def test_gather_pins_beat_budget_then_release(tmp_path):
    """gather() touches every page under a one-page budget: the pins let
    residency pass the budget for the copy, then eviction brings it
    back; the copy is the caller's own."""
    cols, page_rows = 8, 2
    page_bytes = cols * page_rows * 8
    store = SketchPageStore(str(tmp_path), cols=cols, page_rows=page_rows,
                            budget_bytes=page_bytes)
    rows = _rows(8, cols, seed=5, short_every=0)
    for i, r in enumerate(rows):
        store.append(f"g{i}", r)
    idx = np.asarray([7, 0, 3, 5, 3])
    sub = store.gather(idx)  # also flushes the open page
    np.testing.assert_array_equal(sub, np.vstack([rows[i] for i in idx]))
    assert sub.flags.writeable and sub.flags.c_contiguous
    assert store.resident_bytes <= page_bytes
    assert store.peak_resident_bytes == 4 * page_bytes
    np.testing.assert_array_equal(store.band_gather(idx), sub)


def test_paged_row_view_maps_positions_to_rids(tmp_path):
    store = SketchPageStore(str(tmp_path), cols=4, page_rows=2)
    rows = _rows(3, 4, seed=6, short_every=0)
    for i, r in enumerate(rows):
        store.append(f"g{i}", r)
    store.flush()
    # positions 1 and 3 share store row 1 (a duplicate path)
    view = PagedRowView(store, [0, 1, 2, 1])
    assert view.shape == (4, 4)
    np.testing.assert_array_equal(
        view.band_gather([3, 0, 1]), np.vstack([rows[1], rows[0], rows[1]]))


# -- second writers and durability ---------------------------------------


def test_refresh_adopts_second_writer(tmp_path):
    a = SketchPageStore(str(tmp_path), cols=4, page_rows=2)
    r0 = np.arange(4, dtype=np.uint64)
    a.append("g0", r0)
    a.flush()
    b = SketchPageStore(str(tmp_path), cols=4, page_rows=2)
    assert len(b) == 1  # adopted at construction
    np.testing.assert_array_equal(b.get("g0"), r0)
    r1 = np.arange(4, 8, dtype=np.uint64)
    a.append("g1", r1)
    a.flush()
    assert b.rid_for("g1") is None
    assert b.refresh() == 1
    np.testing.assert_array_equal(b.get("g1"), r1)
    assert b.refresh() == 0


def test_orphan_page_ignored_and_torn_directory_tail_healed(tmp_path):
    store = SketchPageStore(str(tmp_path), cols=4, page_rows=1)
    store.append("g0", np.arange(4, dtype=np.uint64))
    store.flush()
    # a crash between the page write and its record: an orphan page
    with open(tmp_path / "page-deadbeef-000000.gpg", "wb") as f:
        f.write(b"orphan")
    # a crash inside a record's append: a torn tail
    with open(tmp_path / DIR_NAME, "ab") as f:
        f.write(b'{"page": "page-trunc')
    fresh = SketchPageStore(str(tmp_path), cols=4, page_rows=1)
    assert len(fresh) == 1
    np.testing.assert_array_equal(fresh.get("g0"),
                                  np.arange(4, dtype=np.uint64))


def _one_page(tmp_path):
    store = SketchPageStore(str(tmp_path), cols=4, page_rows=1)
    store.append("g0", np.arange(4, dtype=np.uint64))
    store.flush()
    return os.path.join(str(tmp_path), _pages(tmp_path)[0])


def test_corrupt_payload_detected(tmp_path):
    p = _one_page(tmp_path)
    data = bytearray(open(p, "rb").read())
    data[-1] ^= 0xFF
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises(PageStoreError, match="crc"):
        SketchPageStore(str(tmp_path), cols=4, page_rows=1).row(0)


def test_corrupt_header_detected(tmp_path):
    p = _one_page(tmp_path)
    data = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(b"x" + data[1:])  # breaks the header frame's crc
    with pytest.raises(PageStoreError, match="header"):
        SketchPageStore(str(tmp_path), cols=4, page_rows=1).row(0)


def test_inconsistent_directory_record_detected(tmp_path):
    name = os.path.basename(_one_page(tmp_path))
    atomic.append_jsonl(os.path.join(str(tmp_path), DIR_NAME),
                        {"page": name + ".bogus", "rows": 2, "cols": 4,
                         "keys": ["a"], "valid": [4]})
    with pytest.raises(PageStoreError, match="inconsistent"):
        SketchPageStore(str(tmp_path), cols=4, page_rows=1)


# -- the gate -------------------------------------------------------------


def test_pagestore_engaged_tristate(monkeypatch):
    """Both packages' gates agree on every setting."""
    cases = [("0", "512", 10**9), ("1", "512", 2), ("1", "512", 1),
             ("auto", "1", 100), ("auto", "1", 8), ("auto", "banana", 100),
             ("bogus", "1", 100)]
    got = []
    for mode, mb, n in cases:
        monkeypatch.setenv("GALAH_TPU_PAGESTORE", mode)
        monkeypatch.setenv("GALAH_TPU_SKETCH_RAM_MB", mb)
        got.append(pagestore_engaged(n, 1000))
        assert got[-1] == jps.pagestore_engaged(n, 1000), (mode, mb, n)
        assert pagestore_mode() == jps.pagestore_mode()
        assert ram_budget_bytes() == jps.ram_budget_bytes()
    # 1 MiB: half of it is 65,536 u64 slots; a malformed budget is 512
    assert got == [False, True, False, True, False, False, True]


# -- two processes: evictions racing reads, SIGKILL mid page-out -----------

_WRITER = r"""
import sys
import numpy as np
from galah_tpu_torch.io.pagestore import SketchPageStore

d, seed = sys.argv[1], int(sys.argv[2])
store = SketchPageStore(d, cols=16, page_rows=4, budget_bytes=16 * 4 * 8)
i = 0
while True:
    # a row is a function of its key, so a reader checks every row
    store.append(f"w{i}", np.full(16, np.uint64(i * 1000 + seed)))
    if i % 4 == 3:
        store.flush()
        print(i, flush=True)
    i += 1
"""


def test_two_process_torture_never_torn_rows(tmp_path):
    """Another process writes pages without pause and is SIGKILLed
    mid-stream, while this one races refresh() and reads against its
    commits under a one-page budget. Every row seen is the writer's
    content: a torn page has no record or fails its crc."""
    seed = 7
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _WRITER, str(tmp_path), str(seed)],
        stdout=subprocess.PIPE, env=env)
    reader = SketchPageStore(str(tmp_path), cols=16, page_rows=4,
                             budget_bytes=16 * 4 * 8)

    def check_all():
        n = len(reader)
        for rid in range(n):
            row = reader.row(rid)
            np.testing.assert_array_equal(row, np.full(16, row[0]))
            assert (int(row[0]) - seed) % 1000 == 0
        return n

    try:
        assert proc.stdout.readline().strip()
        seen = 0
        for _ in range(10):
            reader.refresh()
            seen = max(seen, check_all())
            proc.stdout.readline()
        assert seen >= 4
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    time.sleep(0.1)
    fresh = SketchPageStore(str(tmp_path), cols=16, page_rows=4)
    n = len(fresh)
    assert n >= 4
    for rid in range(n):
        row = fresh.row(rid)
        np.testing.assert_array_equal(row, np.full(16, row[0]))
    counts = fresh.valid_counts()
    assert counts.shape == (n,) and (counts == 16).all()


# -- across the packages ---------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "galah_tpu"])
def test_page_directories_interchangeable(tmp_path, writer):
    """A directory either package writes reads in the other, row for
    row; the page files hold the same bytes, page for page."""
    rows = _rows(11, 8, seed=8)
    dirs = {}
    for side, cls in (("port", SketchPageStore),
                      ("galah_tpu", jps.SketchPageStore)):
        d = str(tmp_path / side)
        w = cls(d, cols=8, page_rows=4, fill=int(SENTINEL_U64))
        for i, r in enumerate(rows):
            w.append(f"g{i}", r)
        w.flush()
        dirs[side] = d
    reader_cls = (jps.SketchPageStore if writer == "port"
                  else SketchPageStore)
    other = reader_cls(dirs[writer], cols=8, page_rows=4)
    assert len(other) == 11
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(other.get(f"g{i}"), r)
    np.testing.assert_array_equal(other.gather(np.arange(11)[::-1]),
                                  SketchPageStore(dirs["port"], cols=8)
                                  .gather(np.arange(11)[::-1]))
    pages = [[open(os.path.join(dirs[s], f), "rb").read()
              for f in _pages(dirs[s])] for s in ("port", "galah_tpu")]
    assert len(pages[0]) == 3 and pages[0] == pages[1]
    recs = [atomic.read_jsonl(os.path.join(dirs[s], DIR_NAME))[0]
            for s in ("port", "galah_tpu")]
    for r in recs:
        for rec in r:
            rec.pop("page")  # names carry each writer's random token
    assert recs[0] == recs[1]


@pytest.mark.fault_injection
@pytest.mark.parametrize("site", ["io.atomic.write[pagestore.page]",
                                  "io.atomic.append[pagestore.dir]"])
@pytest.mark.parametrize("kind", ["torn-write", "eio"])
def test_faults_at_page_sites_leave_no_torn_row(tmp_path, monkeypatch,
                                                site, kind):
    """A fault at either commit site fails that commit; a fresh store of
    either package then holds only whole pages of the right rows."""
    rows = _rows(12, 8, seed=9, short_every=0)
    store = SketchPageStore(str(tmp_path), cols=8, page_rows=4)
    for i, r in enumerate(rows[:4]):
        store.append(f"g{i}", r)
    store.flush()
    monkeypatch.setenv("GALAH_FI", f"site={site};kind={kind};prob=1;"
                                   "seed=1;max=1")
    faults.reset()
    try:
        with pytest.raises(OSError):
            for i, r in enumerate(rows[4:8], start=4):
                store.append(f"g{i}", r)
    finally:
        monkeypatch.delenv("GALAH_FI")
        faults.reset()
    for cls in (SketchPageStore, jps.SketchPageStore):
        fresh = cls(str(tmp_path), cols=8, page_rows=4)
        assert len(fresh) == 4
        for i in range(4):
            np.testing.assert_array_equal(fresh.get(f"g{i}"), rows[i])
    # the writer goes on: a later page commits whole
    w = SketchPageStore(str(tmp_path), cols=8, page_rows=4)
    for i, r in enumerate(rows[8:], start=8):
        w.append(f"g{i}", r)
    w.flush()
    fresh = jps.SketchPageStore(str(tmp_path), cols=8)
    assert len(fresh) == 8
    for i in list(range(4)) + list(range(8, 12)):
        np.testing.assert_array_equal(fresh.get(f"g{i}"), rows[i])


def test_paged_sketch_list_equals_galah_tpus(tmp_path):
    """PagedSketchList reads, appends, slices and iterates as
    galah_tpu's over the same rows."""
    rows = _rows(9, 16, seed=10, short_every=2)
    t = tstore.PagedSketchList(SketchPageStore(str(tmp_path / "t"),
                                               cols=16, page_rows=4))
    j = jstore.PagedSketchList(jps.SketchPageStore(str(tmp_path / "j"),
                                                   cols=16, page_rows=4))
    for r in rows:
        t.append(r)
        j.append(r)
    assert len(t) == len(j) == 9
    for a, b, r in zip(t, j, rows):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, r)
    np.testing.assert_array_equal(t[-1], j[-1])
    for a, b in zip(t[2:7:2], j[2:7:2]):
        np.testing.assert_array_equal(a, b)


def test_index_spill_gate(monkeypatch):
    monkeypatch.setenv("GALAH_TPU_PAGESTORE", "0")
    assert tstore._paged_sketch_spill(10**7, 1000) is None
    monkeypatch.setenv("GALAH_TPU_PAGESTORE", "1")
    assert isinstance(tstore._paged_sketch_spill(2, 1000),
                      tstore.PagedSketchList)


BASES = np.array(list("ACGT"))


def _write(path, codes):
    seq = "".join(BASES[codes])
    with open(path, "w") as f:
        f.write(">c\n" + "\n".join(seq[i:i + 70]
                                   for i in range(0, len(seq), 70)) + "\n")


def _dir_bytes(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))
            if name != "interruptions.jsonl"}


def test_index_build_and_insert_paged_equal_galah_tpu(tmp_path,
                                                      monkeypatch):
    """`index build` and an insert with GALAH_TPU_PAGESTORE=1: the port's
    load holds its sketches in pages, under its declared lock order
    (GalahSan armed), and its directory holds galah_tpu's bytes (its
    unpaged index: paging changes no byte)."""
    from galah_tpu_torch.analysis import sanitizer as tsan

    tsan.maybe_install()
    rng = np.random.default_rng(19)
    paths = []
    for fam in range(3):
        base = rng.integers(0, 4, size=8_000)
        for m in range(2):
            codes = base.copy()
            if m:
                sites = rng.random(codes.shape[0]) < 0.005
                codes[sites] = (codes[sites] + 1) % 4
            paths.append(str(tmp_path / f"f{fam}_{m}.fna"))
            _write(paths[-1], codes)
    base, new = paths[:4], paths[4:]
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    monkeypatch.setenv("GALAH_TPU_PAGESTORE", "0")
    jinc.build(jd, base, ani=0.95, precluster_ani=0.90)
    jbuilt = _dir_bytes(jd)
    jinc.insert(jstore.IndexStore(jd), new)
    jsketches = jstore.IndexStore(jd).load().sketches
    monkeypatch.setenv("GALAH_TPU_PAGESTORE", "1")
    tinc.build(td, base, ani=0.95, precluster_ani=0.90, device=CPU)
    assert _dir_bytes(td) == jbuilt
    state = tstore.IndexStore(td).load()
    assert isinstance(state.sketches, tstore.PagedSketchList)
    assert len(state.sketches) == 4
    tinc.insert(tstore.IndexStore(td), new, device=CPU)
    got = _dir_bytes(td)
    assert got == _dir_bytes(jd)
    assert json.loads(got["gen-000002.json"])["n_genomes"] == 6
    paged = tstore.IndexStore(td).load().sketches
    assert isinstance(paged, tstore.PagedSketchList)
    assert len(paged) == len(jsketches) == 6
    for a, b in zip(paged, jsketches):
        np.testing.assert_array_equal(a, b)
    if tsan.GLOBAL.installed:
        assert tsan.GLOBAL.errors() == []
