"""The device-policy flags on the port against galah_tpu: the sparse
crossover (GALAH_TPU_SPARSE_MIN_N) and the dense pin
(GALAH_TPU_DENSE_PAIRS), the survivor strategies
(GALAH_TPU_PAIRLIST_STRATEGY: the gather planner and route, the
resolver, GALAH_TPU_PAIR_BATCH), the fragment pins
(GALAH_TPU_FRAGMENT_STRATEGY, GALAH_TPU_FRAGMENT_PAIRS), the sketch pins
(GALAH_TPU_SKETCH_STRATEGY), GALAH_TPU_INDEX_BATCH, the ledger's
strategy fingerprint, and a walk of both flag registries.

Tolerance: none. Planner segments, pair integers, DirectedANI floats,
sketches, TSV bytes and index bytes are equal; both packages read every
flag these tests set. galah_tpu's whole runs take its collision route
with its crossover moved to 0, off conftest's 8-device mesh.
"""

import logging
import os
import re
import shutil

import numpy as np
import pytest
import torch

from galah_tpu import config as jconfig
from galah_tpu.backends import minhash_backend as jmb
from galah_tpu.cli import main as jmain
from galah_tpu.io.fasta import read_genome_numpy
from galah_tpu.obs import ledger as jledger
from galah_tpu.obs import report as jreport
from galah_tpu.ops import collision as jcol
from galah_tpu.ops import fragment_ani as jfa
from galah_tpu.ops import sparse_device as jsd
from galah_tpu.ops.constants import SENTINEL
from galah_tpu_torch import cli as tcli
from galah_tpu_torch import config as tconfig
from galah_tpu_torch import convert, device as tdevice
from galah_tpu_torch.backends import MinHashPreclusterer, SketchStore
from galah_tpu_torch.index import incremental as tinc
from galah_tpu_torch.obs import ledger as tledger
from galah_tpu_torch.obs import report as treport
from galah_tpu_torch.ops import collision as tcol
from galah_tpu_torch.ops import fragment_ani as tfa
from galah_tpu_torch.ops import sketch_stream as tstream
from galah_tpu_torch.ops import sparse_device as tsd
from galah_tpu_torch.ops import tile_stats as tts
from galah_tpu_torch.ops.sketch_stream import iter_path_sketches
from galah_tpu_torch.ops.u64 import to_biased
from galah_tpu_torch.resilience import interrupt as tinterrupt
from galah_tpu_torch.timing import StageClock

# several pytest workers share the host: one torch thread a worker
torch.set_num_threads(1)

CPU = torch.device("cpu")
ACGT = np.array(list("ACGT"))
README = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "README.md")
POLICY_FLAGS = ("GALAH_TPU_SPARSE_MIN_N", "GALAH_TPU_DENSE_PAIRS",
                "GALAH_TPU_PAIRLIST_STRATEGY", "GALAH_TPU_PAIR_BATCH",
                "GALAH_TPU_FRAGMENT_STRATEGY", "GALAH_TPU_FRAGMENT_PAIRS",
                "GALAH_TPU_SKETCH_STRATEGY", "GALAH_TPU_INDEX_BATCH")


@pytest.fixture(autouse=True)
def _unpinned(monkeypatch):
    for name in POLICY_FLAGS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def root_logger():
    """main() replaces the root handlers; put them back after."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield root
    root.handlers[:] = handlers
    root.setLevel(level)


def _write(path, codes):
    seq = "".join(ACGT[codes])
    with open(path, "w") as f:
        f.write(">c\n" + "\n".join(seq[i:i + 70]
                                   for i in range(0, len(seq), 70)) + "\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """5 families of 3 (0.5-2% divergence) and 3 singletons, 20 kb."""
    root = tmp_path_factory.mktemp("strategies")
    rng = np.random.default_rng(28)
    paths = []
    for fam in range(5):
        base = rng.integers(0, 4, size=20_000)
        for m in range(3):
            codes = base.copy()
            sites = rng.random(codes.size) < 0.005 * m + 0.001 * fam
            codes[sites] = (codes[sites] + 1) % 4
            paths.append(str(root / f"f{fam}m{m}.fna"))
            _write(paths[-1], codes)
    for i in range(3):
        paths.append(str(root / f"solo{i}.fna"))
        _write(paths[-1], rng.integers(0, 4, size=20_000))
    return [paths[i] for i in np.random.default_rng(3).permutation(
        len(paths))]


def _family_sketches(n, width=48, n_fam=10, seed=17, mutations=8):
    """tests/test_sparse_device.py's family-structured sorted sketch
    matrix, with a ragged and an empty row."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 62, size=(n_fam, width), dtype=np.uint64)
    mat = np.empty((n, width), dtype=np.uint64)
    for i in range(n):
        row = base[i % n_fam].copy()
        n_mut = int(rng.integers(0, mutations))
        idx = rng.choice(width, size=n_mut, replace=False)
        row[idx] = rng.integers(0, 1 << 62, size=n_mut, dtype=np.uint64)
        row.sort()
        mat[i] = row
    mat[3, 10:] = np.uint64(SENTINEL)
    mat[9] = np.uint64(SENTINEL)
    mat.sort(axis=1)
    return mat


def _pair_list(shape):
    """(mat, pi, pj): tests/test_sparse_device.py's padded list (one
    full row block) and ragged list (two row blocks, several column
    pieces), and one over three row blocks with duplicate pairs."""
    n = 80 if shape != "blocks3" else 300
    mat = _family_sketches(n)
    rng = np.random.default_rng(17)
    if shape == "padded":
        pi = np.arange(jsd.GATHER_ROWS, dtype=np.int64) % n
        pj = (pi + 1) % n
    elif shape == "ragged":
        pi = rng.integers(0, n - 1, size=333).astype(np.int64)
        pj = np.minimum(pi + 1 + rng.integers(0, 30, size=333), n - 1)
    else:
        pi = rng.integers(0, n - 1, size=2000).astype(np.int64)
        pj = np.minimum(pi + 1 + rng.integers(0, 200, size=2000), n - 1)
        pi[-5:], pj[-5:] = pi[:5], pj[:5]
    return mat, pi, pj


# -- (a) the crossover ----------------------------------------------------

@pytest.mark.parametrize("value", [None, "", "512", "0", "bogus"])
def test_sparse_screen_min_n_equals_galah_tpus(monkeypatch, value):
    """Unset, empty, valid and malformed values: the port's crossover is
    galah_tpu's, and a moved module constant is read at each call."""
    if value is None:
        monkeypatch.delenv("GALAH_TPU_SPARSE_MIN_N", raising=False)
    else:
        monkeypatch.setenv("GALAH_TPU_SPARSE_MIN_N", value)
    assert tcol.sparse_screen_min_n() == jcol.sparse_screen_min_n()
    monkeypatch.setattr(tcol, "SPARSE_SCREEN_MIN_N", 7)
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 7)
    assert tcol.sparse_screen_min_n() == jcol.sparse_screen_min_n()
    monkeypatch.setenv("GALAH_TPU_SPARSE_MIN_N", "33")
    assert tcol.sparse_screen_min_n() == 33 == jcol.sparse_screen_min_n()


@pytest.mark.parametrize("value, pinned", [(None, False), ("", False),
                                           ("1", True), ("0", True)])
def test_dense_pin_reads_as_galah_tpus(monkeypatch, value, pinned):
    """Any value pins the dense passes, as galah_tpu's
    `not os.environ.get(...)` reads it."""
    if value is None:
        monkeypatch.delenv("GALAH_TPU_DENSE_PAIRS", raising=False)
    else:
        monkeypatch.setenv("GALAH_TPU_DENSE_PAIRS", value)
    assert tcol.dense_pairs_pinned() is pinned
    assert bool(os.environ.get("GALAH_TPU_DENSE_PAIRS")) is pinned


# -- (b) the gather planner ----------------------------------------------

@pytest.mark.parametrize("shape", ["padded", "ragged", "blocks3"])
def test_gather_plan_equals_galah_tpus(shape):
    _mat, pi, pj = _pair_list(shape)
    pi32, pj32 = pi.astype(np.int32), pj.astype(np.int32)
    order = np.lexsort((pj32, pi32))
    got, got_cells = tsd.plan_gather_segments(pi32[order], pj32[order])
    want, want_cells = jsd._plan_gather_segments(pi32[order], pj32[order])
    assert got_cells == want_cells
    assert len(got) == len(want)
    if shape == "blocks3":
        assert len({tuple(s[0]) for s in got}) >= 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# -- (c) the gather route ------------------------------------------------

@pytest.mark.parametrize("shape", ["padded", "ragged", "blocks3"])
def test_gather_route_integers_equal_galah_tpus(shape, monkeypatch):
    """The gather route (planner, then tile_stats' gathered plain
    version) gives galah_tpu's integers, and counts galah_tpu's
    pairlist-gather-used and -cells from the plan; pinned through the
    flag, pair_stats_for_pairs takes it and counts the pick."""
    mat, pi, pj = _pair_list(shape)
    want_c, want_t = jsd.pair_stats_for_pairs(mat, pi, pj, mat.shape[1],
                                              use_pallas=False)
    tmat = to_biased(mat, CPU)
    clock = StageClock(CPU)
    got_c, got_t = tsd.gather_pair_stats(
        tmat, pi.astype(np.int32), pj.astype(np.int32), mat.shape[1],
        clock)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_t, want_t)
    order = np.lexsort((pj, pi))
    _, cells = jsd._plan_gather_segments(pi.astype(np.int32)[order],
                                         pj.astype(np.int32)[order])
    assert clock.counts["pairlist-gather-used"] == pi.shape[0]
    assert clock.counts["pairlist-gather-cells"] == cells
    monkeypatch.setenv("GALAH_TPU_PAIRLIST_STRATEGY", "gather")
    clock = StageClock(CPU)
    got_c, got_t = tsd.pair_stats_for_pairs(tmat, pi, pj, mat.shape[1],
                                            clock)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_t, want_t)
    assert clock.counts["pairlist-strategy-gather"] == 1


def test_gathered_cells_equal_the_full_forms_plain_version():
    """gather_stats_plain against tile_stats_plain cell by cell, and the
    kernel's tile plan: each tile's pairs in input order, every pair
    once, offsets counting them."""
    mat, pi, pj = _pair_list("ragged")
    tmat = to_biased(mat, CPU)
    rng = np.random.default_rng(5)
    ua = rng.integers(0, mat.shape[0], size=(2, tts.GATHER_ROWS))
    ub = rng.integers(0, mat.shape[0], size=(2, tts.GATHER_COLS))
    seg = rng.integers(0, 2, size=500)
    ra = rng.integers(0, tts.GATHER_ROWS, size=500)
    rb = rng.integers(0, tts.GATHER_COLS, size=500)
    c, t = tts.gather_stats(tmat, ua, ub, seg, ra, rb, 40)
    for s in range(2):
        fc, ft = tts.tile_stats_plain(tmat[torch.from_numpy(ua[s])],
                                      tmat[torch.from_numpy(ub[s])], 40)
        sel = seg == s
        np.testing.assert_array_equal(c[sel], fc.numpy()[ra[sel], rb[sel]])
        np.testing.assert_array_equal(t[sel], ft.numpy()[ra[sel], rb[sel]])
    plan = tts.plan_gather(CPU, ua, ub, seg, ra, rb)
    pua, pub, off, cells = (x.numpy() for x in plan.parts())
    np.testing.assert_array_equal(pua, ua.reshape(-1))
    np.testing.assert_array_equal(pub, ub.reshape(-1))
    assert sorted(plan.order.tolist()) == list(range(500))
    assert off[0] == 0 and off[-1] == 500 and np.all(np.diff(off) >= 0)
    tile = (seg * tts.TILES_PER_SEGMENT + (ra // 4) * 16 + rb // 8)
    for q in range(1, 500):
        a, b = plan.order[q - 1], plan.order[q]
        assert (tile[a], a) < (tile[b], b)
    np.testing.assert_array_equal(cells, (ra * 128 + rb)[plan.order])
    with pytest.raises(ValueError, match="outside"):
        tts.gather_stats(tmat, ua, ub, seg, ra + 64, rb, 40)


@pytest.mark.parametrize("shape", ["padded", "ragged", "blocks3"])
def test_gathered_bound_counts_named_rows_once(shape):
    """The gathered entry's bytes count the distinct rows the listed
    pairs name, once each (with their valid lengths), not the 192 table
    rows of every segment: no row-0 padding, no row shared by segments
    counted twice."""
    from galah_tpu_torch.kernels import costs

    mat, pi, pj = _pair_list(shape)
    order = np.lexsort((pj, pi))
    segs, _ = tsd.plan_gather_segments(pi[order], pj[order])
    ua, ub, seg, ra, rb, _ = tsd.segment_tables(segs)
    plan = tts.plan_gather(CPU, ua, ub, seg, ra, rb)
    rows = np.union1d(pi, pj).size
    assert plan.n_rows == costs.named_rows(ua, ub, seg, ra, rb) == rows
    assert rows < 192 * len(segs)
    k, n_pairs = mat.shape[1], pi.shape[0]
    nbytes, ops = costs.tile_stats_gather(rows, len(segs), n_pairs, k)
    assert nbytes == (8 * k + 4) * rows + 4 * (
        448 * len(segs) + 1 + n_pairs) + 8 * n_pairs
    assert ops == 4 * n_pairs * k


@pytest.mark.parametrize("batch", [None, "1", "37", "100000"])
def test_pair_batch_cuts_the_blocked_route(monkeypatch, batch):
    """GALAH_TPU_PAIR_BATCH cuts the blocked route into calls of that
    many pairs (one call on the card when unset); integers unchanged."""
    mat, pi, pj = _pair_list("ragged")
    want = jsd.pair_stats_for_pairs(mat, pi, pj, mat.shape[1],
                                    use_pallas=False)
    calls = []
    real = tsd.run_launch

    def counting(m, lens, a, b, *rest):
        calls.append(a.shape[0])
        return real(m, lens, a, b, *rest)

    monkeypatch.setattr(tsd, "run_launch", counting)
    if batch is not None:
        monkeypatch.setenv("GALAH_TPU_PAIR_BATCH", batch)
    got = tsd.pair_stats_for_pairs(to_biased(mat, CPU), pi, pj,
                                   mat.shape[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    step = int(batch) if batch else tsd.PAIR_BATCH
    assert calls == [min(step, pi.shape[0] - s)
                     for s in range(0, pi.shape[0], step)]


# -- (d) the resolvers ---------------------------------------------------

class _Mesh:
    def __init__(self, size):
        self.size = size


def _clique_list(n_fam=4, size=32):
    """Families of `size` rows, every pair within each: duplication
    ~size / 2, tiles filled up to the planner's caps."""
    pi, pj = [], []
    for f in range(n_fam):
        rows = np.arange(f * size, (f + 1) * size)
        a, b = np.triu_indices(size, 1)
        pi.append(rows[a])
        pj.append(rows[b])
    return (np.concatenate(pi).astype(np.int32),
            np.concatenate(pj).astype(np.int32))


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
@pytest.mark.parametrize("pin", ["blocked", "gather", "xla", "cpu", "",
                                 "bogus"])
def test_pairlist_resolver_pins(monkeypatch, device_type, pin):
    """A pin wins, on the CPU and over a mesh; xla and cpu are refused
    on cuda, by name; a value naming no route is AUTO, as galah_tpu
    reads it."""
    monkeypatch.setenv("GALAH_TPU_PAIRLIST_STRATEGY", pin)
    for mesh in (None, _Mesh(4)):
        if device_type == "cuda" and pin in ("xla", "cpu"):
            with pytest.raises(ValueError, match=(
                    f"GALAH_TPU_PAIRLIST_STRATEGY={pin}")):
                tsd.resolve_pairlist_strategy(device_type, mesh)
            continue
        got = tsd.resolve_pairlist_strategy(device_type, mesh)
        if pin in tsd.PAIRLIST_STRATEGIES:
            assert got == pin
        elif mesh is not None or device_type == "cuda":
            assert got == "blocked"
        else:
            assert got == "xla"


# the H100's whole-route rates (NVIDIA H100 80GB HBM3, 700.00 W;
# kernels/rehearse_gather.py, PERF.md §6): the gathered route's cells a
# second at tile fill 1.0 and the blocked route's pairs a second
H100_GATHER_CELLS_PER_S = 3_718_520.0
H100_BLOCKED_PAIRS_PER_S = 83_174_325.0


def _full_tiles():
    """Every cell of two 64 x 128 segments listed: tile fill 1.0."""
    a, b = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    pi = np.concatenate([a.reshape(-1), a.reshape(-1) + 64])
    pj = np.concatenate([b.reshape(-1) + 128, b.reshape(-1) + 256])
    return pi.astype(np.int32), pj.astype(np.int32)


@pytest.mark.parametrize("shape", ["low duplication", "cliques",
                                   "full tiles"])
def test_pairlist_resolver_auto(monkeypatch, shape):
    """AUTO: xla on the CPU (galah_tpu's pick on its CPU backend);
    blocked over a mesh; blocked on cuda, which is galah_tpu's
    duplication and fill test on the H100's measured rates for every
    list, tile fill 1.0 included."""
    if shape == "low duplication":
        pi = np.arange(2000, dtype=np.int32)
        pj = pi + 1 + np.random.default_rng(7).integers(
            0, 5, size=2000).astype(np.int32)
    elif shape == "cliques":
        pi, pj = _clique_list()
    else:
        pi, pj = _full_tiles()
    assert jsd._resolve_pairlist_strategy(
        pi, pj, False, False, None, None) == "xla"
    assert tsd.resolve_pairlist_strategy("cpu") == "xla"
    assert tsd.resolve_pairlist_strategy("cpu", _Mesh(2)) == "blocked"
    assert tsd.resolve_pairlist_strategy("cuda", _Mesh(2)) == "blocked"
    assert tsd.resolve_pairlist_strategy("cuda") == "blocked"
    monkeypatch.setattr(jsd, "DENSE_RATE_EST", H100_GATHER_CELLS_PER_S)
    monkeypatch.setattr(jsd, "BLOCKED_RATE_EST", H100_BLOCKED_PAIRS_PER_S)
    monkeypatch.setattr(jsd, "PAIRLIST_CPU_MAX", 0)
    assert jsd._resolve_pairlist_strategy(
        pi, pj, True, False, None, None) == "blocked"
    if shape == "full tiles":
        order = np.lexsort((pj, pi))
        _, cells = tsd.plan_gather_segments(pi[order], pj[order])
        assert cells == pi.shape[0]
        # the rule itself picks gather at fill 1.0 once its rate wins
        monkeypatch.setattr(jsd, "DENSE_RATE_EST",
                            2 * H100_BLOCKED_PAIRS_PER_S)
        assert jsd._resolve_pairlist_strategy(
            pi, pj, True, False, None, None) == "gather"


@pytest.mark.parametrize("flag, value, refused", [
    ("GALAH_TPU_PAIRLIST_STRATEGY", "xla", True),
    ("GALAH_TPU_PAIRLIST_STRATEGY", "CPU", True),
    ("GALAH_TPU_PAIRLIST_STRATEGY", "gather", False),
    ("GALAH_TPU_FRAGMENT_STRATEGY", "xla", True),
    ("GALAH_TPU_FRAGMENT_STRATEGY", "c", True),
    ("GALAH_TPU_FRAGMENT_STRATEGY", "pallas", False),
    ("GALAH_TPU_SKETCH_STRATEGY", "c", True),
    ("GALAH_TPU_SKETCH_STRATEGY", "xla", False),
    ("GALAH_TPU_SKETCH_STRATEGY", "fused", False)])
def test_refused_pins_stop_before_any_read(monkeypatch, flag, value,
                                           refused):
    """The card's refusals: device.check_pins (which resolve_device
    calls before any read) and each route's own resolver raise a
    ValueError naming the flag and its value on cuda; the CPU takes
    every pin."""
    monkeypatch.setenv(flag, value)
    tdevice.check_pins("cpu")
    resolvers = {
        "GALAH_TPU_PAIRLIST_STRATEGY": lambda d: tsd.pinned_strategy(d),
        "GALAH_TPU_FRAGMENT_STRATEGY": tfa.resolve_fragment_strategy,
        "GALAH_TPU_SKETCH_STRATEGY": tstream.resolve_sketch_strategy}
    assert resolvers[flag]("cpu") == value.lower()
    if refused:
        for check in (tdevice.check_pins, resolvers[flag]):
            with pytest.raises(ValueError,
                               match=f"{flag}={value.lower()}"):
                check("cuda")
    else:
        tdevice.check_pins("cuda")
        assert resolvers[flag]("cuda") == value


def test_fragment_and_sketch_auto_keep_the_ports_routes():
    assert tfa.resolve_fragment_strategy("cpu") == "pallas"
    assert tfa.resolve_fragment_strategy("cuda") == "pallas"
    assert tstream.resolve_sketch_strategy("cpu") == "fused"
    assert tstream.resolve_sketch_strategy("cuda") == "fused"


# -- (e) whole finch runs ------------------------------------------------

@pytest.fixture(scope="module")
def finch_tsv(corpus, tmp_path_factory):
    """galah_tpu's TSV of the finch run, off its mesh (its collision
    route, crossover 0), with no policy flag set."""
    d = tmp_path_factory.mktemp("finch_ref")
    mp = pytest.MonkeyPatch()
    try:
        for name in POLICY_FLAGS:
            mp.delenv(name, raising=False)
        mp.setenv("GALAH_TPU_HLL_BUCKETS", "0")
        mp.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
        out = str(d / "j.tsv")
        assert _main(jmain, _finch_argv(corpus, out)) == 0
    finally:
        mp.undo()
    with open(out, "rb") as fh:
        return fh.read()


def _finch_argv(corpus, out):
    return ["cluster", "-f", *corpus, "--precluster-method", "finch",
            "--ani", "97", "--precluster-ani", "93", "-q",
            "--output-cluster-definition", out]


def _main(main, argv):
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        return main(argv)
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)


@pytest.mark.parametrize("flag, value", [
    ("GALAH_TPU_PAIRLIST_STRATEGY", "blocked"),
    ("GALAH_TPU_PAIRLIST_STRATEGY", "gather"),
    ("GALAH_TPU_PAIRLIST_STRATEGY", "xla"),
    ("GALAH_TPU_PAIRLIST_STRATEGY", "cpu"),
    ("GALAH_TPU_DENSE_PAIRS", "1"),
    ("GALAH_TPU_SPARSE_MIN_N", "4")])
def test_finch_runs_equal_galah_tpus(corpus, finch_tsv, tmp_path,
                                     monkeypatch, flag, value):
    """Whole finch `cluster` runs on the CPU under each pairlist pin,
    the dense pin and a moved crossover: the port's TSV bytes are
    galah_tpu's under the same flags, and the port's run report shows
    the route the flag asks for."""
    import json

    monkeypatch.setenv("GALAH_TPU_HLL_BUCKETS", "0")
    monkeypatch.setenv(flag, value)
    if flag != "GALAH_TPU_SPARSE_MIN_N":
        # the collision route in both packages (the dense pin overrides
        # it; galah_tpu then runs its dense pass)
        monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
        monkeypatch.setattr(tcol, "SPARSE_SCREEN_MIN_N", 0)
    want = str(tmp_path / "j.tsv")
    assert _main(jmain, _finch_argv(corpus, want)) == 0
    with open(want, "rb") as fh:
        assert fh.read() == finch_tsv
    got = str(tmp_path / "t.tsv")
    rep = str(tmp_path / "r.json")
    assert _main(tcli.main, [*_finch_argv(corpus, got), "--device", "cpu",
                             "--run-report", rep]) == 0
    with open(got, "rb") as fh:
        assert fh.read() == finch_tsv
    with open(rep) as fh:
        counters = json.load(fh)["counters"]
    if flag == "GALAH_TPU_DENSE_PAIRS":
        assert not any(c.startswith("pairlist-strategy-") for c in counters)
        assert counters.get("pairs-streamed-stripes", 0) >= 1
    else:
        picked = value if flag == "GALAH_TPU_PAIRLIST_STRATEGY" else "xla"
        assert counters[f"pairlist-strategy-{picked}"] == 1
        assert ("pairlist-gather-used" in counters) == (picked == "gather")


# -- (f) the fragment pair cap -------------------------------------------

@pytest.mark.parametrize("cap", [None, "1", "2", "5"])
def test_fragment_pair_cap_splits_launches(corpus, monkeypatch, cap):
    """GALAH_TPU_FRAGMENT_PAIRS caps the directed queries a window_hits
    launch takes; the DirectedANI are galah_tpu's, float for float,
    whatever the cut."""
    jprofs = [jfa.build_profile(read_genome_numpy(p), k=15, fraglen=3000)
              for p in corpus[:6]]
    tprofs = [convert.profile_from_galah(p) for p in jprofs]
    pairs = [(a, b) for a in range(6) for b in range(6) if a != b]
    want = jfa.directed_ani_batch([(jprofs[a], jprofs[b])
                                   for a, b in pairs])
    launches = []

    def hits(items, device):
        launches.append(len(items))
        return tfa.window_element_hits(items, device)

    if cap is not None:
        monkeypatch.setenv("GALAH_TPU_FRAGMENT_PAIRS", cap)
    got = tfa.directed_ani_batch([(tprofs[a], tprofs[b]) for a, b in pairs],
                                 hits=hits)
    def fields(d):
        return (d.ani, d.aligned_fraction, d.frags_matching, d.frags_total)

    assert [fields(d) for d in got] == [fields(d) for d in want]
    assert any(d.frags_matching for d in got)
    per = int(cap) if cap else len(pairs)
    assert launches == [min(per, len(pairs) - s)
                        for s in range(0, len(pairs), per)]


# -- (g) the sketch pins -------------------------------------------------

@pytest.mark.parametrize("pin", [None, "fused", "xla", "c"])
def test_sketch_pins_on_the_cpu(corpus, monkeypatch, pin):
    """On the CPU every sketch route gives the same sketches and counts
    itself; `c` declines the streamed pair pass (and so the overlapped
    engine), as galah_tpu's stream declines its C sketcher."""
    if pin is not None:
        monkeypatch.setenv("GALAH_TPU_SKETCH_STRATEGY", pin)
    store = SketchStore(CPU)
    got = dict(iter_path_sketches(corpus, store))
    ref = dict(iter_path_sketches(corpus, SketchStore(CPU)))
    for p in corpus:
        np.testing.assert_array_equal(got[p].hashes, ref[p].hashes)
    assert store.clock.counts[f"sketch-strategy-{pin or 'fused'}"] == 1
    stream = MinHashPreclusterer(0.93, SketchStore(CPU)).distances_streamed(
        corpus)
    assert (stream is None) == (pin == "c")
    jstream = jmb.MinHashPreclusterer(0.93, jmb.SketchStore(1000, 21)
                                      ).distances_streamed(corpus)
    if pin in ("c", "xla"):
        assert (jstream is None) == (pin == "c")


def test_sketch_xla_route_skips_the_fused_kernel(corpus, monkeypatch):
    monkeypatch.setenv("GALAH_TPU_SKETCH_STRATEGY", "xla")
    called = []
    monkeypatch.setattr(
        "galah_tpu_torch.backends.minhash_backend.sketch_genomes_fused",
        lambda *a, **k: called.append(1))
    store = SketchStore(CPU)
    dict(iter_path_sketches(corpus[:4], store))
    assert not called


# -- (h) the index batch ------------------------------------------------

def test_index_batch_flag_is_inserts_default(corpus, tmp_path, monkeypatch,
                                             root_logger):
    """`index insert` under GALAH_TPU_INDEX_BATCH writes the bytes of one
    with --batch, in as many batches; unset, galah_tpu's 32."""
    base = str(tmp_path / "base")
    tinc.build(base, corpus[:10], ani=0.97, precluster_ani=0.93,
               device=CPU)
    assert tinc.default_batch() == 32
    monkeypatch.setenv("GALAH_TPU_INDEX_BATCH", "3")
    from galah_tpu.index import incremental as jinc

    assert tinc.default_batch() == jinc._default_batch() == 3
    monkeypatch.delenv("GALAH_TPU_INDEX_BATCH")
    saved = []
    real = tinterrupt.check

    def count(where):
        saved.append(where)
        return real(where)

    monkeypatch.setattr(tinterrupt, "check", count)
    runs = {}
    for how in ("flag", "env"):
        d = str(tmp_path / how)
        shutil.copytree(base, d)
        extra = []
        if how == "flag":
            extra = ["--batch", "3"]
        else:
            monkeypatch.setenv("GALAH_TPU_INDEX_BATCH", "3")
        saved.clear()
        assert tcli.main(["index", "--index-dir", d, "--device", "cpu",
                          "-q", "insert", "-f", *corpus[10:], *extra]) == 0
        runs[how] = ({n: open(os.path.join(d, n), "rb").read()
                      for n in sorted(os.listdir(d))},
                     saved.count("index-batch-saved"))
    assert runs["flag"] == runs["env"]
    assert runs["env"][1] == -(-len(corpus[10:]) // 3)


# -- (i) the ledger's fingerprint ---------------------------------------

def test_strategy_fingerprint_reads_a_pinned_strategy(monkeypatch):
    monkeypatch.setenv("GALAH_TPU_PAIRLIST_STRATEGY", "gather")
    monkeypatch.setenv("GALAH_TPU_SKETCH_STRATEGY", "xla")
    got = tledger.strategy_fingerprint({"flags": treport.flag_snapshot()})
    want = jledger.strategy_fingerprint({"flags": jreport.flag_snapshot()})
    assert got == want == "gather/auto/auto/xla/auto/auto"


# -- the registries -------------------------------------------------------

def _readme_unported_flags():
    """The README's named list of galah_tpu's flags without a
    counterpart in the port: the `GALAH_*` names of the bullets under
    its heading line."""
    with open(README) as fh:
        text = fh.read()
    head = "Flags of `galah_tpu` without a counterpart in the port"
    body = text[text.index(head):].split("\n\n", 2)[1]
    return set(re.findall(r"^- `(GALAH_[A-Z0-9_]+)`", body, re.M))


def test_every_galah_tpu_flag_is_read_or_named():
    """Each flag of galah_tpu's registry is in the port's, with its
    kind, section, choices and default, or on the README's list of flags
    without a counterpart, each with its reason; none is both."""
    unported = _readme_unported_flags()
    assert "GALAH_TPU_PAIRLIST_BLOCK" in unported
    for name, flag in jconfig.FLAGS.items():
        port = tconfig.FLAGS.get(name)
        assert (port is None) == (name in unported), name
        if port is not None:
            assert (port.kind, port.section, port.choices, port.default) \
                == (flag.kind, flag.section, flag.choices, flag.default), \
                name
    assert unported <= set(jconfig.FLAGS)
    assert set(tconfig.FLAGS) <= set(jconfig.FLAGS)


def test_pair_index_checks_hold_on_every_route(monkeypatch):
    mat = to_biased(_family_sketches(20), CPU)
    for pin in ("blocked", "gather"):
        monkeypatch.setenv("GALAH_TPU_PAIRLIST_STRATEGY", pin)
        with pytest.raises(ValueError, match="outside"):
            tsd.pair_stats_for_pairs(mat, np.array([0, 20]),
                                     np.array([1, 2]), 48)
        c, t = tsd.pair_stats_for_pairs(mat, np.zeros(0, np.int64),
                                        np.zeros(0, np.int64), 48)
        assert c.shape == t.shape == (0,)
