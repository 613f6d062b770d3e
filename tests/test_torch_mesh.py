"""The port's device mesh (galah_tpu_torch/parallel/mesh.py) against
galah_tpu's on the CPU.

Each of the five sharded passes (screen, threshold, the streamed
stripe, the pair list and HLL) runs on a mesh of CPU slots and must
equal both the port's single-device pass and galah_tpu's sharded pass
over as many of conftest's CPU devices: galah_tpu's 1-D meshes of 2
and 4, and its 2D meshes (1, 8), (2, 2), (2, 4) and (4, 2) against the
port's 1-D mesh of 8, 4, 8 and 8 slots (the port has only the 1-D
mesh; every geometry gives the same pairs).

Tolerances: pair lists, pair dicts (keys and float64 values) and
integer statistics are equal. HLL values equal the port's
single-device pass exactly, and galah_tpu's (XLA float32 sums) within
1e-5 with the same pair set (tests/test_torch_hll.py's tolerance).
"""

import logging
import math

import numpy as np
import pytest
import torch

from galah_tpu.ops import sparse_device as jsparse
from galah_tpu.parallel import mesh as jmesh
from galah_tpu_torch import cli as tcli
from galah_tpu_torch import convert
from galah_tpu_torch.obs import metrics as tmetrics
from galah_tpu_torch.ops import hll as thll
from galah_tpu_torch.ops import pairwise as tpair
from galah_tpu_torch.ops import sparse_device as tsparse
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.tile_stats import tile_stats
from galah_tpu_torch.ops.u64 import to_biased
from galah_tpu_torch.parallel import mesh as tmesh

SHAPES = [(2,), (4,), (1, 8), (2, 2), (2, 4), (4, 2)]
ROW_TILE, COL_TILE = 16, 32


def _meshes(shape):
    """(the port's mesh of as many CPU slots, galah_tpu's mesh of
    `shape`)."""
    n = math.prod(shape)
    jm = jmesh.make_mesh(n) if len(shape) == 1 else jmesh.make_mesh_2d(
        shape)
    return tmesh.make_mesh(["cpu"] * n), jm


def _cpu_slots(monkeypatch, n=4):
    """Make `auto_mesh` give the entry points n slots on the CPU, as a
    multi-process job gives one a rank."""
    monkeypatch.setattr(tmesh, "auto_mesh",
                        lambda device: tmesh.make_mesh(["cpu"] * n))


def _sketches(n=120, k=64, seed=1):
    """Sorted uint64 rows with planted equal rows and partial overlaps,
    so that the pair dicts hold pairs at several ANIs."""
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 1 << 62, size=(n, k), dtype=np.uint64)
    for src, dst in ((4, 10), (4, 33), (5, 77), (100, 119)):
        mat[dst] = mat[src]
    for src, dst, share in ((20, 90, 48), (21, 60, 40), (70, 71, 56)):
        mat[dst, :share] = mat[src, :share]
    mat[111, 40:] = np.iinfo(np.uint64).max  # a short row
    mat.sort(axis=1)
    return mat


@pytest.fixture(scope="module")
def sketches():
    mat = _sketches()
    return mat, to_biased(mat, "cpu")


def _hll_registers(seed=5, n=70, p=10):
    rng = np.random.default_rng(seed)
    mat = np.zeros((n, 1 << p), dtype=np.uint8)
    core = None
    for i in range(n):
        if i % 5 == 0:
            core = rng.integers(0, 1 << 63, size=20_000,
                                dtype=np.uint64) * 2 + 1
        keep = rng.random(core.shape[0]) >= rng.uniform(0.0, 0.7)
        own = rng.integers(0, 1 << 63, size=int((~keep).sum()),
                           dtype=np.uint64) * 2 + 1
        h = np.concatenate([core[keep], own])
        mat[i] = thll.hll_update(torch.zeros(1 << p, dtype=torch.uint8),
                                 to_biased(h), p).numpy()
    mat[-1] = mat[16]
    return mat


# -- the mesh -------------------------------------------------------------


def test_auto_mesh_is_one_slot_a_rank():
    """One process drives one device and takes the single-device
    passes; a mesh is what a multi-process job gives each rank
    (tests/test_torch_distributed.py)."""
    assert tmesh.auto_mesh("cpu") is None
    m = tmesh.make_mesh(["cpu", torch.device("cpu")], owners=[0, 1])
    assert m.shape == (2,) and m.owners == [0, 1]
    assert m.owned(0) and not m.owned(1)
    with pytest.raises(ValueError, match="owners"):
        tmesh.make_mesh(["cpu"] * 3, owners=[0, 1])


@pytest.mark.parametrize("devices,owners,copies", [
    (["cpu"] * 4, None, 0),
    (["cpu"] * 4, [0, 0, 1, 1], 1),
    (["cpu", "meta", "cpu", "meta"], None, 1),
    (["cpu", "meta"] * 2, [0, 0, 1, 1], 3),
])
def test_row_copy_gauge_counts_the_places_a_row_is_held(devices, owners,
                                                        copies):
    """mesh.dcn_bytes_per_row is row bytes x the places beyond the first
    that hold a row: one a distinct (rank, device)."""
    m = tmesh.make_mesh(devices, owners=owners)
    assert tmesh._row_copies(m) == copies
    tmetrics.reset()
    tmesh._emit_copy_gauge(m, 512)
    assert tmetrics.snapshot()["mesh.dcn_bytes_per_row"]["value"] == \
        512 * copies


@pytest.mark.parametrize("slots,n", [(8, 100), (8, 64), (8, 50), (4, 37),
                                     (4, 45), (2, 9), (3, 70)])
def test_tile_schedule_covers_upper_triangle_exactly_once(slots, n):
    """Every i<j cell lands in exactly one slot's tile, and no tile lies
    wholly below the diagonal tile of its row block."""
    tiles_of = tmesh.tile_schedule(n, slots, ROW_TILE, COL_TILE)
    cover = np.zeros((n, n), dtype=np.int64)
    for r0 in range(0, n, ROW_TILE):
        for t in tiles_of(r0):
            assert t.c_lo >= (t.r0 // COL_TILE) * COL_TILE
            for gi in range(t.r0, t.r1):
                cover[gi, max(t.c_lo, gi + 1):t.c_hi] += 1
    iu = np.triu_indices(n, k=1)
    assert cover[iu].min() == 1 and cover[iu].max() == 1
    assert not np.tril(cover).any()


# -- the five sharded passes ----------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_screen_pairs_sharded(sketches, shape):
    mat, t = sketches
    counts = (mat != np.iinfo(np.uint64).max).sum(axis=1)
    tm, jm = _meshes(shape)
    single = tpair.screen_pairs(t, counts, 0.3)
    got = tmesh.sharded_screen_pairs(t, counts, 0.3, tm, row_tile=ROW_TILE,
                                     col_tile=COL_TILE)
    want = jmesh.sharded_screen_pairs(mat, counts, 0.3, jm,
                                      row_tile=ROW_TILE, col_tile=COL_TILE,
                                      use_pallas=False)
    assert got == want == sorted(single)
    assert {(4, 10), (20, 90), (21, 60)} <= set(got)


@pytest.mark.parametrize("shape", SHAPES)
def test_threshold_pairs_sharded(sketches, shape):
    mat, t = sketches
    tm, jm = _meshes(shape)
    single = tpair.threshold_pairs(t, 21, 0.9)
    got = tmesh.sharded_threshold_pairs(t, 21, 0.9, tm, row_tile=ROW_TILE,
                                        col_tile=COL_TILE, cap_per_row=1)
    want = jmesh.sharded_threshold_pairs(mat, 21, 0.9, jm,
                                         row_tile=ROW_TILE,
                                         col_tile=COL_TILE,
                                         use_pallas=False)
    assert got == want == single
    assert {(4, 10), (20, 90), (70, 71)} <= set(got)


@pytest.mark.parametrize("shape", SHAPES)
def test_stripe_stats_sharded(sketches, shape):
    """The streamed pass's stripe: 100 done rows (padded to 128) against
    a 64-column block of 36 new rows."""
    mat, t = sketches
    tm, jm = _meshes(shape)
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


@pytest.mark.parametrize("shape", SHAPES)
def test_pair_list_sharded(sketches, shape):
    """The candidate list split over the slots, one pairlist pass each,
    and the whole sparse pass with it."""
    mat, t = sketches
    tm, jm = _meshes(shape)
    rng = np.random.default_rng(2)
    pi = np.concatenate([rng.integers(0, 60, size=237), [4, 20]])
    pj = np.concatenate([rng.integers(60, 120, size=237), [10, 90]])
    got = tmesh.sharded_pair_stats_for_pairs(t, pi, pj, 64, tm)
    single = tsparse.pair_stats_for_pairs(t, pi, pj, 64)
    want = jsparse.pair_stats_for_pairs(mat, pi, pj, 64,
                                        mesh=jmesh.make_mesh(tm.size),
                                        use_pallas=False)
    for g, s, w in zip(got, single, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, s)
        np.testing.assert_array_equal(g, np.asarray(w))
    pairs = tsparse.threshold_pairs_sparse(t, 21, 0.9, mesh=tm)
    assert pairs == tsparse.threshold_pairs_sparse(t, 21, 0.9)
    assert pairs == jsparse.threshold_pairs_sparse(
        mat, 21, 0.9, mesh=jmesh.make_mesh(tm.size))


@pytest.fixture(scope="module")
def hll_registers():
    mat = _hll_registers()
    return mat, convert.hll_registers_from_galah(mat)


@pytest.mark.parametrize("shape", SHAPES)
def test_hll_threshold_pairs_sharded(hll_registers, shape):
    mat, regs = hll_registers
    tm, jm = _meshes(shape)
    single = thll.hll_threshold_pairs(regs, 21, 0.95)
    got = tmesh.sharded_hll_threshold_pairs(regs, 21, 0.95, tm,
                                            row_tile=ROW_TILE,
                                            col_tile=COL_TILE)
    want = jmesh.sharded_hll_threshold_pairs(mat, 21, 0.95, jm,
                                             row_tile=ROW_TILE,
                                             col_tile=COL_TILE)
    assert got == single
    assert set(got) == set(want) and (16, 69) in got and len(got) >= 20
    for key, v in got.items():
        assert abs(v - want[key]) < 1e-5, key


# -- the entry points engage the mesh -------------------------------------


def test_entry_points_route_through_the_mesh(monkeypatch, sketches,
                                                hll_registers):
    """With a mesh of four slots the screen, the threshold pass (dense and
    sparse), the streamed stripes and the HLL pass go through the mesh
    and give the single-device results."""
    mat, t = sketches
    counts = (mat != np.iinfo(np.uint64).max).sum(axis=1)
    _, regs = hll_registers
    want = {"screen": tpair.screen_pairs(t, counts, 0.3),
            "threshold": tpair.threshold_pairs(t, 21, 0.9),
            "sparse": tsparse.threshold_pairs_sparse(t, 21, 0.9),
            "hll": thll.hll_threshold_pairs(regs, 21, 0.95)}
    blocks = [(r0, t[r0:r0 + 32]) for r0 in range(0, 120, 32)]
    want["streamed"] = tpair.threshold_pairs_streamed(blocks, 120, 21, 0.9,
                                                      64, block=32)
    calls = []
    for name in ("sharded_screen_pairs", "sharded_threshold_pairs",
                 "sharded_pair_stats_for_pairs", "sharded_stripe_stats",
                 "sharded_hll_threshold_pairs"):
        orig = getattr(tmesh, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(tmesh, name, spy)
    _cpu_slots(monkeypatch)
    monkeypatch.setattr(tpair.collision, "SPARSE_SCREEN_MIN_N", 100)
    got = {"screen": tpair.screen_pairs(t[:90], counts[:90], 0.3),
           "threshold": tpair.threshold_pairs(t[:90], 21, 0.9),
           "sparse": tpair.threshold_pairs(t, 21, 0.9),
           "hll": thll.hll_threshold_pairs(regs, 21, 0.95),
           "streamed": tpair.threshold_pairs_streamed(
               blocks, 120, 21, 0.9, 64, block=32,
               mesh=tmesh.auto_mesh("cpu"))}
    assert got["screen"] == [p for p in want["screen"] if p[1] < 90]
    assert got["threshold"] == {p: v for p, v in want["threshold"].items()
                                if p[1] < 90}
    for name in ("sparse", "hll", "streamed"):
        assert got[name] == want[name], name
    assert calls == [
        "sharded_screen_pairs", "sharded_threshold_pairs",
        "sharded_pair_stats_for_pairs", "sharded_hll_threshold_pairs"] + [
        "sharded_stripe_stats"] * 4
    # four slots on the one device: each row is held in one place
    assert tmetrics.snapshot()["mesh.dcn_bytes_per_row"]["value"] == 0


def test_cluster_runs_on_a_mesh_of_cpu_slots(monkeypatch, tmp_path):
    """skani, finch (the streamed stripes) and dashing `cluster` runs
    in one process over four CPU slots write the TSVs of the runs
    without a mesh."""
    rng = np.random.default_rng(11)
    paths = []
    for fam in range(2):
        base = rng.integers(0, 4, size=30_000)
        for m in range(4):
            codes = base.copy()
            sites = rng.random(codes.shape[0]) < 0.01 * m
            codes[sites] = (codes[sites] + 1) % 4
            p = tmp_path / f"fam{fam}_m{m}.fna"
            p.write_text(">c\n" + "".join(np.array(list("ACGT"))[codes])
                         + "\n")
            paths.append(str(p))
    runs = {"skani": [], "finch": ["--precluster-method", "finch"],
            "dashing": ["--precluster-method", "dashing"]}

    log_root = logging.getLogger()
    handlers, level = log_root.handlers[:], log_root.level

    def run(name, extra, tag):
        """One `cluster` through main, the root logger, which main's -q
        replaces, put back after."""
        out = tmp_path / f"{name}_{tag}.tsv"
        try:
            assert tcli.main(["cluster", "-f", *paths, "--device", "cpu",
                              "-q", *extra, "--output-cluster-definition",
                              str(out)]) == 0
        finally:
            log_root.handlers[:] = handlers
            log_root.setLevel(level)
        return out.read_bytes()

    want = {name: run(name, extra, "one") for name, extra in runs.items()}
    _cpu_slots(monkeypatch)
    calls = []
    for core in ("_extract", "sharded_stripe_stats"):
        orig = getattr(tmesh, core)

        def spy(*a, _orig=orig, _core=core, **kw):
            calls.append(_core)
            return _orig(*a, **kw)

        monkeypatch.setattr(tmesh, core, spy)
    for name, extra in runs.items():
        assert run(name, extra, "mesh") == want[name], name
    # the skani screen, finch's one streamed stripe, the HLL pass
    assert calls == ["_extract", "sharded_stripe_stats", "_extract"]
    assert len(want["skani"].splitlines()) == 8
