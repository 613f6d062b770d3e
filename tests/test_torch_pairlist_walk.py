"""The pairlist kernel's plan and the survivor pass, on the CPU.

``kernels/pairlist.cu`` needs the card; ``chip_smoke.py`` holds it
against ``pair_stats_pairs_plain`` there. Here a numpy model repeats its
plan step for step: pairs to blocks of kWarps warps, the block's first
a row staged (its valid prefix and a sentinel) and shared by every warp
of the block with the same pi, which also stages its b row; the other
warps read both rows in place, guarded at their valid length; the 32
lanes of a warp on merge diagonals (``kernels/merge_walk.cuh``), the
lanes' union ranks from a warp scan, and the segment that straddles
`total` split across the warp again (kLevels) before its straddling
sub-segment is walked once more.
The model reads the constants from the sources, so it follows them.

The model is held against ``pair_stats_pairs_plain`` and against
galah_tpu's Pallas pairlist kernel in interpret mode (at K <= 128: one
interpret-mode compile at K = 1000 takes minutes); the survivor pass
(``ops/sparse_device.pair_stats_for_pairs``: one upload, launches of
PAIR_BATCH pairs, one download) against galah_tpu's pass and pair dicts.

Tolerance: none. (common, total) are int32 and equal element for
element; pair dicts map to float64 ANIs and must be equal as dicts.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galah_tpu.ops import pairwise as jpw
from galah_tpu.ops import sparse_device as jsd
from galah_tpu.ops.constants import SENTINEL
from galah_tpu.ops.pallas_pairlist import pair_stats_pairs_pallas
from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.kernels import rehearse_pairlist as rpl
from galah_tpu_torch.ops import pairlist as tpl
from galah_tpu_torch.ops import sparse_device as tsd
from galah_tpu_torch.ops import tile_stats as tts
from galah_tpu_torch.ops.u64 import from_biased, to_biased

KERNELS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "galah_tpu_torch", "kernels")
SENT = int(np.iinfo(np.int64).max)  # biased
U64_SENT = np.uint64(SENTINEL)
LANES = 32


def _const(source: str, name: str) -> int:
    with open(os.path.join(KERNELS, source)) as fh:
        m = re.search(rf"constexpr \w+ {name} = (-?\d+);", fh.read())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


WARPS = _const("pairlist.cu", "kWarps")
MAX_STAGED_K = _const("pairlist.cu", "kMaxStagedK")
MIN_STAGED_PAIRS = _const("pairlist.cu", "kMinStagedPairs")
LEVELS = _const("merge_walk.cuh", "kLevels")


# -- the numpy model ------------------------------------------------------


class Trace:
    """What the model saw: warps on the staged a row or in place, and
    the steps of each final re-walk against its segment."""

    def __init__(self):
        self.shared = 0
        self.in_place = 0
        self.rewalks = []  # (steps taken, segment length)


def _at(v, i, n, guard):
    # a staged row holds the sentinel at its valid length; a row read in
    # place is guarded there (an unguarded read past a full row raises)
    return SENT if guard and i >= n else v[i]


def _walk(a, na, ga, b, nb, gb, ai, bj, steps, total, cexcl):
    """merge_walk.cuh's walk: (count, ai, bj, steps taken)."""
    count = 0
    x, y = _at(a, ai, na, ga), _at(b, bj, nb, gb)
    taken = 0
    for _ in range(steps):
        if x == y:
            if total >= 0 and ai + bj - cexcl >= total:
                break
            count += 1
            cexcl += 1
        if x <= y:
            ai += 1
            x = _at(a, ai, na, ga)
        else:
            bj += 1
            y = _at(b, bj, nb, gb)
        taken += 1
    return count, ai, bj, taken


def _co_rank(a, b, d, a_lo, b_lo, a_hi, b_hi):
    lo, hi = max(a_lo, d - b_hi), min(a_hi, d - b_lo)
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= b[d - mid - 1]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def model_merge_stats(a, na, ga, b, nb, gb, sketch_size, trace,
                      intersect=False, levels=LEVELS):
    """merge_walk.cuh's merge_stats for one warp, lane by lane."""
    a_lo = b_lo = before = 0
    a_hi, b_hi = na, nb
    tot = c = 0
    level = 0
    while True:
        d_lo = a_lo + b_lo
        n = a_hi + b_hi - d_lo
        lanes = []
        for lane in range(LANES):
            d0 = d_lo + lane * n // LANES
            d1 = d_lo + (lane + 1) * n // LANES
            ai = _co_rank(a, b, d0, a_lo, b_lo, a_hi, b_hi)
            m, ai1, bj1, _ = _walk(a, na, ga, b, nb, gb, ai, d0 - ai,
                                   d1 - d0, -1, 0)
            lanes.append((ai, d0 - ai, ai1, bj1, m, d1 - d0))
        if level == 0:
            n_match = sum(lane[4] for lane in lanes)
            if intersect:
                return n_match, na
            tot = min(sketch_size, na + nb - n_match)
            if na + nb - n_match <= sketch_size:
                return n_match, tot
        incl = 0
        straddling = []
        for ai, bj, ai1, bj1, m, steps in lanes:
            cexcl = before + incl
            incl += m
            start, end = ai + bj - cexcl, ai1 + bj1 - cexcl - m
            if end < tot:
                c += m
            if start < tot <= end:
                straddling.append((ai, bj, ai1, bj1, cexcl, steps))
        assert len(straddling) <= 1  # one lane at most straddles total
        if not straddling:
            return c, tot
        ai, bj, ai1, bj1, cexcl, steps = straddling[0]
        if level == levels - 1:
            mine, _, _, taken = _walk(a, na, ga, b, nb, gb, ai, bj, steps,
                                      tot, cexcl)
            trace.rewalks.append((taken, ai1 + bj1 - ai - bj))
            return c + mine, tot
        a_lo, b_lo, a_hi, b_hi, before = ai, bj, ai1, bj1, cexcl
        level += 1


def model_pairlist(mat, pi, pj, sketch_size, trace, levels=LEVELS,
                   min_staged=MIN_STAGED_PAIRS):
    """pairlist.cu's plan over a biased (N, K) matrix: (common, total).
    `min_staged` stands in for kMinStagedPairs, so that short lists can
    take the staged plan too."""
    k = mat.shape[1]
    lens = (mat != SENT).sum(axis=1).tolist()
    rows = mat.tolist()
    b = len(pi)
    staged = k <= MAX_STAGED_K and b >= min_staged
    common = np.empty(b, dtype=np.int32)
    total = np.empty(b, dtype=np.int32)
    for p0 in range(0, b, WARPS):
        ra = int(pi[p0])
        shared = rows[ra][:lens[ra]] + [SENT]
        for p in range(p0, min(p0 + WARPS, b)):
            ia, ib = int(pi[p]), int(pj[p])
            if staged and ia == ra:
                # both rows in shared memory: the block's a, the warp's b
                a, bv, guard = shared, rows[ib][:lens[ib]] + [SENT], False
                trace.shared += 1
            else:
                a, bv, guard = rows[ia], rows[ib], True
                trace.in_place += 1
            common[p], total[p] = model_merge_stats(
                a, lens[ia], guard, bv, lens[ib], guard, sketch_size, trace,
                levels=levels)
    return common, total


# -- inputs ---------------------------------------------------------------


def _hashes(rng, n):
    return rng.integers(-(1 << 63), SENT, size=n, dtype=np.int64)


def _matrix(rng, n, k):
    """(n, k) biased rows drawn from one shared pool (so pairs overlap
    by about 2/3), with an empty row (1), a full row (0), identical rows
    (2, 3), a row disjoint from the pool (4) and ragged rows."""
    pool = np.unique(_hashes(rng, k + k // 2 + 1))
    mat = np.full((n, k), SENT, dtype=np.int64)
    for i in range(n):
        cnt = (k, int(rng.integers(0, k + 1)), min(k, 3), k)[i % 4]
        mat[i, :cnt] = np.sort(rng.choice(pool, size=cnt, replace=False))
    mat[1] = SENT
    mat[2] = mat[3]
    other = np.setdiff1d(np.unique(_hashes(rng, k)), pool)[:k]
    mat[4] = SENT
    mat[4, :other.shape[0]] = other
    return mat


SPECIAL = [(1, 0), (0, 1), (1, 1), (2, 3), (3, 2), (4, 0), (0, 4), (5, 5),
           (0, 0), (6, 1)]


def _pairs(rng, n, kind):
    """Pair lists: the special rows first then random pairs; runs of
    equal pi (3, 13, 8, 1 and 21 long) that start and end inside blocks
    of WARPS pairs, sorted as the collision screen emits them; or a
    random order."""
    if kind == "special":
        extra = rng.integers(0, n, size=(13, 2))
        pairs = np.concatenate([np.array(SPECIAL), extra])
    elif kind == "runs":
        runs = [3, 13, 8, 1, 21]
        pi = np.repeat(rng.choice(n, size=len(runs), replace=False), runs)
        pairs = np.stack([pi, rng.integers(0, n, size=pi.shape[0])], 1)
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    else:
        pairs = rng.integers(0, n, size=(37, 2))
    return (np.ascontiguousarray(pairs[:, 0], dtype=np.int64),
            np.ascontiguousarray(pairs[:, 1], dtype=np.int64))


def _plain(mat, pi, pj, sketch_size):
    c, t = tpl.pair_stats_pairs_plain(torch.from_numpy(mat),
                                      torch.from_numpy(pi),
                                      torch.from_numpy(pj), sketch_size)
    return c.numpy(), t.numpy()


# -- the model against the plain version and galah_tpu --------------------


@pytest.mark.parametrize("staging", [True, False])
@pytest.mark.parametrize("kind", ["special", "runs", "random"])
@pytest.mark.parametrize("third", [False, True])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 1000, 2419])
def test_model_matches_plain(k, third, kind, staging):
    """Empty, identical, disjoint and ragged rows, pi == pj, runs of
    equal pi across blocks and a random order, at sketch_size K and
    K // 3, on the staged plan of a long list and the in-place plan of
    a short one: the model's integers are the plain version's."""
    rng = np.random.default_rng(k * 7 + third * 3 + len(kind))
    mat = _matrix(rng, 24, k)
    pi, pj = _pairs(rng, 24, kind)
    sketch_size = max(k // 3, 1) if third else k
    trace = Trace()
    got = model_pairlist(mat, pi, pj, sketch_size, trace,
                         min_staged=0 if staging else MIN_STAGED_PAIRS)
    want = _plain(mat, pi, pj, sketch_size)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert trace.shared + trace.in_place == pi.shape[0]
    if k > MAX_STAGED_K or not staging:  # every row in place
        assert trace.shared == 0
    elif kind == "runs":
        # runs share their block's staged row where the block starts one
        assert trace.shared > pi.shape[0] // 3
    for taken, segment in trace.rewalks:
        # each level cuts the straddling segment 32 ways
        assert taken <= segment <= -(-2 * k // LANES ** LEVELS)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_model_levels_agree(levels):
    """One, two or three merge-path levels give the same integers; the
    deeper the split, the shorter the last walk."""
    rng = np.random.default_rng(levels)
    mat = _matrix(rng, 16, 1000)
    pi, pj = _pairs(rng, 16, "random")
    want = _plain(mat, pi, pj, 333)
    trace = Trace()
    got = model_pairlist(mat, pi, pj, 333, trace, levels=levels,
                         min_staged=0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert trace.rewalks
    assert max(t for t, _ in trace.rewalks) <= -(-2000 // LANES ** levels)


def test_model_empty_list_and_all_sentinel_rows():
    mat = np.full((3, 40), SENT, dtype=np.int64)
    empty = np.zeros(0, dtype=np.int64)
    c, t = model_pairlist(mat, empty, empty, 40, Trace())
    assert c.shape == t.shape == (0,)
    pi = np.array([0, 1, 2, 0], dtype=np.int64)
    c, t = model_pairlist(mat, pi, pi[::-1].copy(), 40, Trace())
    assert c.tolist() == [0] * 4 and t.tolist() == [0] * 4


@pytest.mark.parametrize("k,third", [(1, False), (33, False), (33, True),
                                     (128, True)])
def test_model_matches_pallas_interpret(k, third):
    """galah_tpu's Pallas pairlist kernel in interpret mode, on the
    special list (empty, identical, disjoint, ragged, pi == pj)."""
    rng = np.random.default_rng(k + 100 * third)
    mat = _matrix(rng, 24, k)
    pi, pj = _pairs(rng, 24, "special")
    sketch_size = max(k // 3, 1) if third else k
    got = model_pairlist(mat, pi, pj, sketch_size, Trace())
    u = from_biased(torch.from_numpy(mat))
    c, t = pair_stats_pairs_pallas(jnp.asarray(u[pi]), jnp.asarray(u[pj]),
                                   sketch_size, interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(c))
    np.testing.assert_array_equal(got[1], np.asarray(t))


@pytest.mark.parametrize("k", [1, 33, 1000])
def test_shared_walk_matches_tile_stats(k):
    """tile_stats.cu's use of merge_walk.cuh (both rows staged with a
    sentinel, valid prefixes searched, the intersect and full forms)
    gives tile_stats' plain integers."""
    rng = np.random.default_rng(k)
    rows, cols = _matrix(rng, 5, k), _matrix(rng, 7, k)
    full = tts.tile_stats_plain(torch.from_numpy(rows),
                                torch.from_numpy(cols), max(k // 3, 1))
    inter = tts.tile_intersect_plain(torch.from_numpy(rows),
                                     torch.from_numpy(cols))
    for i, a in enumerate(rows.tolist()):
        for j, b in enumerate(cols.tolist()):
            na, nb = sum(v < SENT for v in a), sum(v < SENT for v in b)
            a_s, b_s = a + [SENT], b + [SENT]
            got = model_merge_stats(a_s, na, False, b_s, nb, False,
                                    max(k // 3, 1), Trace())
            assert got == (int(full[0][i, j]), int(full[1][i, j]))
            got = model_merge_stats(a_s, na, False, b_s, nb, False, k,
                                    Trace(), intersect=True)
            assert got == (int(inter[i, j]), na)


# -- the survivor pass ----------------------------------------------------


@pytest.fixture(scope="module")
def family():
    """Family-structured u64 sketches (galah_tpu's sparse-pass recipe)
    with a ragged, an empty and two identical rows."""
    rng = np.random.default_rng(29)
    n, width = 120, 64
    base = rng.integers(0, 1 << 62, size=(12, width), dtype=np.uint64)
    mat = np.empty((n, width), dtype=np.uint64)
    for i in range(n):
        row = base[i % 12].copy()
        swap = rng.random(width) < rng.random() * 0.4
        row[swap] = rng.integers(0, 1 << 62, size=int(swap.sum()),
                                 dtype=np.uint64)
        mat[i] = np.sort(row)
    mat[3, width // 3:] = U64_SENT
    mat[9] = U64_SENT
    mat[11] = mat[12]
    return mat


@pytest.mark.parametrize("batch", [1, 7, 1 << 16])
def test_pass_matches_galah_tpu(family, monkeypatch, batch):
    """The pass on the CPU (one upload, the plain version `batch` pairs
    a call, one download): galah_tpu's integers for every candidate
    pair, at K and K // 3."""
    monkeypatch.setattr(tsd, "PAIR_BATCH", batch)
    rng = np.random.default_rng(batch)
    pi = rng.integers(0, family.shape[0], size=300)
    pj = rng.integers(0, family.shape[0], size=300)
    before = LAUNCHES["pairlist"]
    for sketch_size in (64, 21):
        got = tsd.pair_stats_for_pairs(to_biased(family), pi, pj,
                                       sketch_size)
        want = jsd.pair_stats_for_pairs(family, pi, pj, sketch_size,
                                        use_pallas=False)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    assert LAUNCHES["pairlist"] == before  # no kernel on the CPU


@pytest.mark.parametrize("min_ani", [0.90, 0.95, 0.99])
def test_sparse_pass_dict_matches_galah_tpu(family, monkeypatch, min_ani):
    """threshold_pairs_sparse over the new pass, whole and 5 pairs a
    call, gives galah_tpu's sparse and dense pair dicts."""
    want = jsd.threshold_pairs_sparse(family, k=21, min_ani=min_ani)
    assert want == jpw.threshold_pairs(family, k=21, min_ani=min_ani,
                                       use_pallas=False, row_tile=64,
                                       col_tile=128)
    whole = tsd.threshold_pairs_sparse(to_biased(family), 21, min_ani)
    monkeypatch.setattr(tsd, "PAIR_BATCH", 5)
    assert tsd.threshold_pairs_sparse(to_biased(family), 21,
                                      min_ani) == whole == want
    assert len(want) > 5


def test_pass_checks_its_list_on_the_host(family):
    mat = to_biased(family)
    none = np.zeros(0, dtype=np.int64)
    c, t = tsd.pair_stats_for_pairs(mat, none, none, 64)
    assert c.shape == t.shape == (0,)
    with pytest.raises(ValueError):  # index out of range
        tsd.pair_stats_for_pairs(mat, np.array([0, 1]),
                                 np.array([0, family.shape[0]]), 64)
    with pytest.raises(ValueError):  # negative index
        tsd.pair_stats_for_pairs(mat, np.array([-1]), np.array([0]), 64)
    with pytest.raises(ValueError):  # lengths differ
        tsd.pair_stats_for_pairs(mat, np.array([0, 1]), np.array([0]), 64)


def test_run_launch_fills_outputs_on_the_cpu(family):
    """run_launch on CPU tensors writes the plain version's integers
    into the caller's outputs, and launches nothing."""
    mat = to_biased(family)
    pi = torch.arange(0, 40, dtype=torch.int64)
    pj = torch.arange(40, 0, -1, dtype=torch.int64)
    common = torch.full((40,), -1, dtype=torch.int32)
    total = torch.full((40,), -1, dtype=torch.int32)
    before = LAUNCHES["pairlist"]
    tpl.run_launch(mat, tpl.valid_lengths(mat), pi, pj, 64, common, total)
    want = tpl.pair_stats_pairs_plain(mat, pi, pj, 64)
    assert torch.equal(common, want[0]) and torch.equal(total, want[1])
    assert LAUNCHES["pairlist"] == before
    assert tpl.valid_lengths(mat).tolist() == (
        (family != U64_SENT).sum(axis=1).tolist())


# -- the rehearsal's inputs and variants ----------------------------------


def test_rehearsal_dense_list():
    """All pairs i < j in the collision screen's row-major order, rows
    sorted and distinct, every 16th row 200-999 values, and a family:
    two full rows share about 0.81^2 of their values."""
    mat, pi, pj = rpl.dense_list(np.random.default_rng(0), n=64)
    assert pi.shape == pj.shape == (64 * 63 // 2,)
    assert np.all(pi < pj)
    key = pi * 64 + pj
    assert np.all(np.diff(key) > 0)
    lens = (mat != SENT).sum(axis=1)
    for i, row in enumerate(mat):
        v = row[:lens[i]]
        assert np.all(np.diff(v) > 0) and np.all(row[lens[i]:] == SENT)
        assert (200 <= lens[i] <= 999) if i % 16 == 15 else lens[i] > 950
    shared = np.intersect1d(mat[0], mat[1]).shape[0] / 1000
    assert 0.6 < shared < 0.72
    assert rpl.dense_list(np.random.default_rng(0), n=2048)[1].shape == (
        2_096_128,)


def test_rehearsal_finch_list_and_work():
    mat, pi, pj = rpl.finch_list(np.random.default_rng(1))
    assert mat.shape == (1024, 1000) and pi.shape == (1536,)
    assert np.all(np.diff(pi * 1024 + pj) > 0)
    assert np.all(pi // 4 == pj // 4)
    m = torch.from_numpy(mat)
    common, total = (t.numpy() for t in tpl.pair_stats_pairs_plain(
        m, torch.from_numpy(pi), torch.from_numpy(pj), 1000))
    bytes_moved, _ = rpl.work(pi, pj, 1000, common, total)
    assert bytes_moved == 8 * 1000 * 1024 + 1536 * 24
    # the operations: OPS_PER_ITEM for each item that a one-thread merge
    # takes, on the first pairs of this list and of the dense list,
    # whose short rows end their merges early
    dmat, dpi, dpj = rpl.dense_list(np.random.default_rng(2), n=64)
    for mat, pi, pj in ((mat, pi[:64], pj[:64]),
                        (dmat, dpi[-64:], dpj[-64:])):
        common, total = (t.numpy() for t in tpl.pair_stats_pairs_plain(
            torch.from_numpy(mat), torch.from_numpy(pi),
            torch.from_numpy(pj), 1000))
        rows = [r[r != SENT] for r in mat]
        items = sum(_merge_items(rows[a], rows[b], 1000)
                    for a, b in zip(pi, pj))
        assert rpl.work(pi, pj, 1000, common, total)[1] == \
            rpl.OPS_PER_ITEM * items


def _merge_items(a, b, sketch_size):
    """Items a one-thread merge of the sorted distinct rows a and b
    takes to emit the union's first min(sketch_size, |union|) values."""
    i = j = emitted = 0
    while emitted < sketch_size and (i < len(a) or j < len(b)):
        if j == len(b) or (i < len(a) and a[i] < b[j]):
            i += 1
        elif i == len(a) or b[j] < a[i]:
            j += 1
        else:
            i, j = i + 1, j + 1
        emitted += 1
    return i + j


def test_rehearsal_variants_each_change_the_committed_source():
    variants = rpl._variants(None)
    src, headers = variants["committed"]
    assert "merge_walk.cuh" in headers and "stage.cuh" in headers
    for name in ("in-place", "eight-warps", "one-level"):
        vsrc, vh = variants[name]
        changed = (vsrc != src) + sum(vh[f] != headers[f] for f in headers)
        assert changed == 1, name
    assert rpl.n_params(src) == 10
    old = ('extern "C" int pairlist_launch(const void* mat, int k, '
           'const void* pi,\n const void* pj, int b, int sketch_size,\n'
           ' void* common, void* total, void* stream) {')
    assert rpl.n_params(old) == 9


def test_rehearsal_counts_the_walk_loop():
    sass = """
        Function : _ZN12_GLOBAL__N_115pairlist_kernelILb1EEEvPKx
        /*0000*/                   LDGSTS.E.BYPASS.128 [R2], desc[UR4][R4.64] ;
        /*0010*/                   LDS.64 R6, [R3] ;
        /*0020*/              @P0  BRA 0x0 ;
        /*0030*/                   LDS.64 R8, [R3] ;
        /*0040*/                   LDS.64 R10, [R5] ;
        /*0050*/                   SEL R3, R3, R5, P1 ;
        /*0060*/              @P2  BRA 0x30 ;
        /*0070*/                   ISETP.GE.U32.AND P1, PT, R8, R6, PT ;
        /*0080*/                   SEL R3, R3, R5, P1 ;
        /*0090*/                   SEL R5, R5, R3, P1 ;
        /*00a0*/                   LDS.64 R8, [R3] ;
        /*00b0*/              @!P3 BRA 0x70 ;
        /*00c0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_115pairlist_kernelILb0EEEvPKx
        /*0000*/                   LDS.64 R8, [R3] ;
        /*0010*/                   SEL R3, R3, R5, P1 ;
        /*0020*/                   SEL R3, R3, R5, P1 ;
        /*0030*/                   BRA 0x0 ;
    """
    # not the staging loop (cp.async), not the search (one select for
    # two loads), not the unstaged kernel's loop
    assert rpl.walk_loop(sass) == (5, 1, {"SEL": 2, "ISETP": 1, "LDS": 1,
                                          "BRA": 1})
    with pytest.raises(RuntimeError):
        rpl.walk_loop(sass.replace("SEL", "IMAD"))
