"""The port's 2D tiled mesh and its one-process mesh over every local
card (galah_tpu_torch/parallel/mesh.py) against galah_tpu's on the CPU.

- ``resolve_mesh_shape`` gives galah_tpu's shapes, ``mesh-demoted``
  events and ``mesh.demoted_1d`` counts for 1-16 slots under each
  ``GALAH_TPU_MESH_SHAPE``.
- The screen, threshold, HLL and stripe passes on port grids (2, 2),
  (2, 4), (4, 2) and (1, 8) of CPU slots equal galah_tpu's passes on
  the same grids over conftest's CPU devices, and the port's
  single-device passes.
- Each operand reaches each slot device at most once a pass.
- ``cluster`` in one process with the local-card enumeration
  (``local_devices``) stood in by 4 and 8 CPU "cards" takes
  ``auto_mesh``'s one-process branch (2 x 2 and 2 x 4) and writes
  galah_tpu's TSVs (its default runs over conftest's 8 devices, auto
  2 x 4) and the port's unsharded TSVs; a checkpoint written on 4
  slots resumes on one device to the same TSV.

Tolerances: pair lists, pair dicts (keys and float64 values), integer
statistics and TSV bytes are equal. HLL values equal the port's
single-device pass exactly, and galah_tpu's (XLA float32 sums) within
1e-5 with the same pair set (tests/test_torch_hll.py's tolerance).
"""

import logging
import math

import numpy as np
import pytest
import torch

from galah_tpu.cli import main as jmain
from galah_tpu.obs import events as jevents
from galah_tpu.obs import metrics as jmetrics
from galah_tpu.parallel import mesh as jmesh
from galah_tpu_torch import cli as tcli
from galah_tpu_torch import convert
from galah_tpu_torch.cluster import checkpoint as tckpt
from galah_tpu_torch.obs import events as tevents
from galah_tpu_torch.obs import metrics as tmetrics
from galah_tpu_torch.ops import hll as thll
from galah_tpu_torch.ops import pairwise as tpair
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.tile_stats import tile_stats
from galah_tpu_torch.ops.u64 import to_biased
from galah_tpu_torch.parallel import mesh as tmesh
from galah_tpu_torch.resilience import interrupt as tinterrupt

from test_torch_mesh import _hll_registers, _sketches

GRIDS = [(2, 2), (2, 4), (4, 2), (1, 8)]
ROW_TILE, COL_TILE = 16, 32
CPU = torch.device("cpu")


def _grid(shape):
    """(the port's grid of CPU slots, galah_tpu's grid over conftest's
    devices)."""
    return (tmesh.make_mesh([CPU] * math.prod(shape), shape=shape),
            jmesh.make_mesh_2d(shape))


@pytest.fixture(scope="module")
def sketches():
    mat = _sketches()
    return mat, to_biased(mat, "cpu")


@pytest.fixture(scope="module")
def hll_registers():
    mat = _hll_registers()
    return mat, convert.hll_registers_from_galah(mat)


# -- the shape ------------------------------------------------------------


def _demotions(events, metrics):
    rows = [{k: e[k] for k in ("kind", "shape", "n_devices", "reason")}
            for e in events.snapshot() if e["kind"] == "mesh-demoted"]
    count = metrics.snapshot().get("mesh.demoted_1d", {}).get("value", 0)
    return rows, count


@pytest.mark.parametrize("spec", ["auto", "1d", "1", "2x2", "4x2", "3x3",
                                  "8x1", "garbage"])
def test_resolve_mesh_shape_matches_galah_tpu(monkeypatch, caplog, spec):
    """For 1-16 slots: the same shape, the same mesh-demoted events and
    the same demotion count, and a warning a demotion."""
    monkeypatch.setenv("GALAH_TPU_MESH_SHAPE", spec)
    for n in range(1, 17):
        for mod in (tevents, jevents, tmetrics, jmetrics):
            mod.reset()
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            got = tmesh.resolve_mesh_shape(n)
        warned = [r for r in caplog.records if "demoted" in r.getMessage()]
        want = jmesh.resolve_mesh_shape(n)
        assert got == want, (spec, n)
        events, count = _demotions(tevents, tmetrics)
        assert (events, count) == _demotions(jevents, jmetrics), (spec, n)
        assert len(warned) == count == len(events)


def test_auto_mesh_takes_every_local_card(monkeypatch):
    """One process: one slot a local card on the resolved shape, the
    row with an event where the count is prime, none for one card."""
    monkeypatch.setenv("GALAH_TPU_MESH_SHAPE", "auto")
    assert tmesh.auto_mesh("cpu") is None
    assert tmesh.local_devices("cpu") == [CPU]
    for n, shape in ((1, None), (2, (2,)), (3, (3,)), (4, (2, 2)),
                     (6, (2, 3)), (8, (2, 4))):
        monkeypatch.setattr(tmesh, "local_devices",
                            lambda device, _n=n: [CPU] * _n)
        tevents.reset()
        m = tmesh.auto_mesh("cpu")
        demoted = [e for e in tevents.snapshot()
                   if e["kind"] == "mesh-demoted"]
        if shape is None:
            assert m is None
            continue
        assert m.shape == shape and m.devices == [CPU] * n
        assert tmesh.mesh_is_2d(m) == (len(shape) == 2)
        assert len(demoted) == (n in (2, 3))
        assert m.flat().shape == (n,)
    monkeypatch.setenv("GALAH_TPU_MESH_SHAPE", "1d")
    assert tmesh.auto_mesh("cpu").shape == (8,)
    with pytest.raises(ValueError, match="does not hold"):
        tmesh.make_mesh([CPU] * 6, shape=(2, 2))


@pytest.mark.parametrize("shape", [(2,), (8,), (2, 2), (2, 4), (4, 2),
                                   (1, 8), (3, 3)])
def test_row_copies_are_galah_tpus_crossings_on_distinct_cards(shape):
    """On slots that are distinct cards the copy gauge counts
    galah_tpu's crossings: n - 1 on the row, (r-1)+(c-1) on a grid;
    on one device, none."""
    n = math.prod(shape)
    jm = (jmesh.make_mesh_2d(shape) if len(shape) == 2 else
          jmesh.make_mesh(n)) if n <= 8 else None
    cards = tmesh.make_mesh([f"cuda:{i}" for i in range(n)], shape=shape)
    want = (shape[0] - 1) + (shape[1] - 1) if len(shape) == 2 else n - 1
    assert tmesh._row_copies(cards) == want
    if jm is not None:
        assert want == jmesh._dcn_crossings(jm)
    assert tmesh._row_copies(tmesh.make_mesh([CPU] * n, shape=shape)) == 0


@pytest.mark.parametrize("grid,n", [((2, 2), 100), ((2, 4), 100),
                                    ((4, 2), 64), ((1, 8), 50),
                                    ((3, 3), 70), ((2, 2), 9)])
def test_grid_schedule_covers_upper_triangle_exactly_once(grid, n):
    """Every i<j cell lands in exactly one slot's tile, each tile inside
    its slot's row and column bands, and no tile wholly below the
    diagonal tile of its row."""
    sched = tmesh.grid_schedule(n, grid, ROW_TILE, COL_TILE)
    cover = np.zeros((n, n), dtype=np.int64)
    for lb in range(0, sched.extent, ROW_TILE):
        for t in sched.tiles(lb):
            ra, rb = sched.row_span(t.slot)
            ca, cb = sched.col_span(t.slot)
            assert ra <= t.r0 < t.r1 <= rb and ca <= t.c_lo < t.c_hi <= cb
            assert t.c_lo >= (t.r0 // COL_TILE) * COL_TILE
            for gi in range(t.r0, t.r1):
                cover[gi, max(t.c_lo, gi + 1):t.c_hi] += 1
    iu = np.triu_indices(n, k=1)
    assert cover[iu].min() == 1 and cover[iu].max() == 1


# -- the four passes on grids ---------------------------------------------


@pytest.mark.parametrize("shape", GRIDS)
def test_screen_pairs_on_grids(sketches, shape):
    mat, t = sketches
    counts = (mat != np.iinfo(np.uint64).max).sum(axis=1)
    tm, jm = _grid(shape)
    got = tmesh.sharded_screen_pairs(t, counts, 0.3, tm, row_tile=ROW_TILE,
                                     col_tile=COL_TILE)
    want = jmesh.sharded_screen_pairs(mat, counts, 0.3, jm,
                                      row_tile=ROW_TILE, col_tile=COL_TILE,
                                      use_pallas=False)
    assert got == want == sorted(tpair.screen_pairs(t, counts, 0.3))
    assert {(4, 10), (20, 90), (21, 60)} <= set(got)


@pytest.mark.parametrize("shape", GRIDS)
def test_threshold_pairs_on_grids(sketches, shape):
    """cap_per_row 1: every row block overflows and is run again."""
    mat, t = sketches
    tm, jm = _grid(shape)
    got = tmesh.sharded_threshold_pairs(t, 21, 0.9, tm, row_tile=ROW_TILE,
                                        col_tile=COL_TILE, cap_per_row=1)
    want = jmesh.sharded_threshold_pairs(mat, 21, 0.9, jm,
                                         row_tile=ROW_TILE,
                                         col_tile=COL_TILE,
                                         use_pallas=False)
    assert got == want == tpair.threshold_pairs(t, 21, 0.9)
    assert list(got) == list(want)  # galah_tpu's order too
    assert {(4, 10), (20, 90), (70, 71)} <= set(got)


@pytest.mark.parametrize("shape", GRIDS)
def test_hll_threshold_pairs_on_grids(hll_registers, shape):
    mat, regs = hll_registers
    tm, jm = _grid(shape)
    got = tmesh.sharded_hll_threshold_pairs(regs, 21, 0.95, tm,
                                            row_tile=ROW_TILE,
                                            col_tile=COL_TILE)
    want = jmesh.sharded_hll_threshold_pairs(mat, 21, 0.95, jm,
                                             row_tile=ROW_TILE,
                                             col_tile=COL_TILE)
    assert got == thll.hll_threshold_pairs(regs, 21, 0.95)
    assert set(got) == set(want) and (16, 69) in got and len(got) >= 20
    for key, v in got.items():
        assert abs(v - want[key]) < 1e-5, key


@pytest.mark.parametrize("shape", GRIDS)
def test_stripe_stats_on_grids(sketches, shape):
    """100 done rows (padded to 128) against a 64-column block of 20
    new rows: rows over the mesh rows, the block over the mesh
    columns."""
    mat, t = sketches
    tm, jm = _grid(shape)
    cols = np.full((64, 64), np.iinfo(np.uint64).max, dtype=np.uint64)
    cols[:20] = mat[100:120]
    tcols = to_biased(cols, "cpu")
    got = tmesh.sharded_stripe_stats(t[:100], tcols, 64, tm,
                                     row_tile=ROW_TILE, r_pad=128)
    want = jmesh.sharded_stripe_stats(mat[:100], cols, 64, 21, jm,
                                      row_tile=ROW_TILE, r_pad=128)
    pad = torch.full((28, 64), SENTINEL_BIASED, dtype=torch.int64)
    single = tile_stats(torch.cat([t[:100], pad]), tcols, 64)
    for g, w, s in zip(got, want, single):
        assert g.dtype == np.int32 and g.shape == (128, 64)
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, s.numpy())


def test_stripe_stats_refuse_what_galah_tpu_refuses(sketches):
    """A column block the mesh columns do not divide, and rows not a
    multiple of mesh rows x row_tile, raise as in galah_tpu."""
    mat, t = sketches
    tm, jm = _grid((2, 4))
    cols = to_biased(mat[:30], "cpu")
    with pytest.raises(ValueError, match="not divisible by mesh cols 4"):
        tmesh.sharded_stripe_stats(t[:64], cols, 64, tm, row_tile=ROW_TILE)
    with pytest.raises(ValueError, match="not divisible by mesh cols 4"):
        jmesh.sharded_stripe_stats(mat[:64], mat[:30], 64, 21, jm,
                                   row_tile=ROW_TILE)
    with pytest.raises(ValueError, match="mesh rows 2"):
        tmesh.sharded_stripe_stats(t[:64], cols[:28], 64, tm,
                                   row_tile=ROW_TILE, r_pad=48)


# -- each operand placed once a pass --------------------------------------


def test_each_operand_reaches_each_slot_device_once_a_pass(
        monkeypatch, sketches, hll_registers):
    """Every pass places each operand span on each slot device once,
    before its first row block: no (span, device) repeats, and the
    count does not grow with the row blocks (row_tile 8 gives 15, 16
    gives 8, both with the same bands). On the row an operand is placed whole once a device;
    on an R x C grid at most a span a mesh row and a mesh column (one
    device here, so a span inside one already placed is a view of
    it)."""
    mat, t = sketches
    counts = (mat != np.iinfo(np.uint64).max).sum(axis=1)
    _, regs = hll_registers
    calls = []
    orig = tmesh._place

    def spy(x, device):
        calls.append((x.data_ptr(), tuple(x.shape), str(device)))
        return orig(x, device)

    monkeypatch.setattr(tmesh, "_place", spy)

    def placed(fn):
        calls.clear()
        fn()
        assert len(calls) == len(set(calls)), calls
        return len(calls)

    for shape in ((4,), (8,), (2, 2), (2, 4), (4, 2)):
        tm = tmesh.make_mesh([CPU] * math.prod(shape), shape=shape)
        bound = sum(shape) if len(shape) == 2 else 1
        for n_ops, run in (
                (1, lambda rt: tmesh.sharded_threshold_pairs(
                    t, 21, 0.9, tm, row_tile=rt, col_tile=COL_TILE)),
                # the marker matrix and its counts
                (2, lambda rt: tmesh.sharded_screen_pairs(
                    t, counts, 0.3, tm, row_tile=rt, col_tile=COL_TILE)),
                # the registers and their cardinalities
                (2, lambda rt: tmesh.sharded_hll_threshold_pairs(
                    regs, 21, 0.95, tm, row_tile=rt, col_tile=COL_TILE))):
            many, few = placed(lambda: run(8)), placed(lambda: run(16))
            assert many == few <= n_ops * bound, shape
            if len(shape) == 1:
                assert many == n_ops
        pi, pj = np.arange(0, 50), np.arange(50, 100)
        assert placed(lambda: tmesh.sharded_pair_stats_for_pairs(
            t, pi, pj, 64, tm)) == 1  # the matrix, once a device
    # a stripe: a row shard a mesh row, a column chunk a mesh column
    tm = tmesh.make_mesh([CPU] * 8, shape=(2, 4))
    assert placed(lambda: tmesh.sharded_stripe_stats(
        t[:100], t[:64], 64, tm, row_tile=ROW_TILE, r_pad=128)) == 2 + 4


# -- one process over stood-in cards --------------------------------------


def _corpus(root):
    """Two families of four 30 kb genomes, members 0-3% apart."""
    rng = np.random.default_rng(11)
    paths = []
    for fam in range(2):
        base = rng.integers(0, 4, size=30_000)
        for m in range(4):
            codes = base.copy()
            sites = rng.random(codes.shape[0]) < 0.01 * m
            codes[sites] = (codes[sites] + 1) % 4
            p = root / f"fam{fam}_m{m}.fna"
            p.write_text(">c\n" + "".join(np.array(list("ACGT"))[codes])
                         + "\n")
            paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("mesh2d_corpus"))


RUNS = {
    "skani": ([], {}),
    "finch streamed": (["--precluster-method", "finch"], {}),
    # the collision screen and the pair list over the cards in a row
    "finch crossover": (["--precluster-method", "finch"],
                        {"GALAH_TPU_SPARSE_MIN_N": "4"}),
    "dashing": (["--precluster-method", "dashing"], {}),
}

#: the mesh pass each run must take
CORES = {"skani": "_extract", "finch streamed": "sharded_stripe_stats",
         "finch crossover": "sharded_pair_stats_for_pairs",
         "dashing": "_extract"}


def _run(main, paths, out, extra, device=()):
    """One `cluster` through `main` (-q replaces the root logger's
    handlers; they are put back after). Returns the TSV's bytes."""
    log_root = logging.getLogger()
    handlers, level = log_root.handlers[:], log_root.level
    try:
        assert main(["cluster", "-f", *paths, "-q", *extra, *device,
                     "--output-cluster-definition", str(out)]) == 0
    finally:
        log_root.handlers[:] = handlers
        log_root.setLevel(level)
    return out.read_bytes()


@pytest.fixture(scope="module")
def galah_tpu_tsvs(corpus, tmp_path_factory):
    """galah_tpu's default runs, over conftest's 8 devices (auto
    2 x 4), one a run, made on first use."""
    d = tmp_path_factory.mktemp("mesh2d_jax")
    done = {}

    def tsv(what):
        if what not in done:
            extra, env = RUNS[what]
            mp = pytest.MonkeyPatch()
            try:
                for k, v in env.items():
                    mp.setenv(k, v)
                done[what] = _run(jmain, corpus,
                                  d / f"{what.replace(' ', '_')}.tsv", extra)
            finally:
                mp.undo()
        return done[what]

    return tsv


@pytest.mark.parametrize("cards", [4, 8])
@pytest.mark.parametrize("what", list(RUNS))
def test_cluster_over_stood_in_cards_writes_galah_tpus_tsv(
        monkeypatch, tmp_path, corpus, galah_tpu_tsvs, what, cards):
    """`cluster` in one process whose local-card enumeration gives 4 or
    8 CPU "cards": auto_mesh's one-process branch shards the run's pair
    pass over the 2 x 2 or 2 x 4 grid (the pair list over the cards in a
    row), and the TSV equals the unsharded run's and galah_tpu's."""
    extra, env = RUNS[what]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    one = _run(tcli.main, corpus, tmp_path / "one.tsv", extra,
               ("--device", "cpu"))
    meshes = []
    core = CORES[what]
    orig = getattr(tmesh, core)

    def spy(*a, **kw):
        meshes.append(next(m for m in [*a, *kw.values()]
                           if isinstance(m, tmesh.Mesh)).shape)
        return orig(*a, **kw)

    monkeypatch.setattr(tmesh, core, spy)
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda device: [CPU] * cards)
    got = _run(tcli.main, corpus, tmp_path / "mesh.tsv", extra,
               ("--device", "cpu"))
    assert got == one == galah_tpu_tsvs(what)
    grid = {4: (2, 2), 8: (2, 4)}[cards]
    assert meshes and set(meshes) == {
        (cards,) if core == "sharded_pair_stats_for_pairs" else grid}
    assert len(got.splitlines()) == 8


def test_checkpoint_on_four_slots_resumes_on_one_device(monkeypatch,
                                                       tmp_path, corpus):
    """A run on 4 stood-in cards stopped after its first greedy round
    resumes on one device to the unsharded run's TSV."""
    argv = ["--cluster-method", "fastani", "--precluster-ani", "90",
            "--ani", "95", "--rep-rounds", "1"]
    cpu = ("--device", "cpu")
    plain = _run(tcli.main, corpus, tmp_path / "plain.tsv", argv, cpu)
    ck = str(tmp_path / "ck")
    save = tckpt.ClusterCheckpoint.save_greedy_round

    def save_then_stop(self, digest, pairs):
        save(self, digest, pairs)
        tinterrupt.request_stop("SIGTERM")

    monkeypatch.setattr(tckpt.ClusterCheckpoint, "save_greedy_round",
                        save_then_stop)
    monkeypatch.setattr(tmesh, "local_devices", lambda device: [CPU] * 4)
    log_root = logging.getLogger()
    handlers, level = log_root.handlers[:], log_root.level
    try:
        assert tcli.main(["cluster", "-f", *corpus, "-q", *argv, *cpu,
                          "--checkpoint-dir", ck,
                          "--output-cluster-definition",
                          str(tmp_path / "stopped.tsv")]) == 75
    finally:
        log_root.handlers[:] = handlers
        log_root.setLevel(level)
    monkeypatch.undo()
    assert tmesh.auto_mesh("cpu") is None
    resumed = _run(tcli.main, corpus, tmp_path / "resumed.tsv",
                   [*argv, "--checkpoint-dir", ck, "--resume"], cpu)
    assert resumed == plain
