"""The merge-path plan of the window_hits kernel, the kernels' input
checks, and the plain versions on the kernels' edge cases.

``window_hits.block_plan`` is the host half of the CUDA kernel: it cuts
each (query, reference) pair's merge into blocks of ``SEGMENT`` merged
items, and the tests hold it to covering every merged item exactly once.
The edge cases that the CUDA kernels meet on the card (equal query runs
across segment and galah_tpu job boundaries, 1000x length ratios, single
items, exact segment multiples; empty, identical, disjoint and tiny
sketch rows at K = 2176 and K = 1) go through the plain versions here
against galah_tpu: ``window_element_hits`` in Pallas interpret mode and
``tile_stats`` through its XLA twin. Tolerance: none, every int32 flag
and count must be equal. chip_smoke.py holds the kernels against the
plain versions on the same cases.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galah_tpu.ops import fragment_ani as jfa
from galah_tpu.ops import pairwise as jpw
from galah_tpu.ops import pallas_fragment as jpf
from galah_tpu.ops.constants import SENTINEL
from galah_tpu_torch.kernels import rehearse_tile_stats as rts
from galah_tpu_torch.ops import tile_stats as tts
from galah_tpu_torch.ops import window_hits as twh
from galah_tpu_torch.ops.u64 import to_biased

CPU = torch.device("cpu")
SEG = twh.SEGMENT
JOB = jpf.A_SUB * jpf.QLA  # query values a galah_tpu kernel job takes
U64_TOP = 2**64 - 2        # below the sentinel


# -- the block plan ---------------------------------------------------------


def _check_plan(q_len, r_len):
    q_len = np.asarray(q_len, dtype=np.int64)
    r_len = np.asarray(r_len, dtype=np.int64)
    blk_end, out_off = twh.block_plan(q_len, r_len)
    n_blocks = int(blk_end[-1]) if len(q_len) else 0
    covered = [np.zeros(int(q + r), dtype=np.int64)
               for q, r in zip(q_len, r_len)]
    for b in range(n_blocks):
        # the kernel's pair lookup: the first pair whose blocks end past b
        p = int(np.searchsorted(blk_end, b, side="right"))
        local = b - (int(blk_end[p - 1]) if p else 0)
        d0 = local * SEG
        d1 = min(d0 + SEG, int(q_len[p] + r_len[p]))
        assert d0 < d1
        covered[p][d0:d1] += 1
    for p, (q, c) in enumerate(zip(q_len, covered)):
        if q == 0:
            # a pair without query values owns no block
            assert (c == 0).all()
        else:
            assert (c == 1).all(), f"pair {p}: merged items not covered once"
    np.testing.assert_array_equal(
        out_off, np.concatenate([[0], np.cumsum(q_len)[:-1]])
        if len(q_len) else np.zeros(0, dtype=np.int64))
    return blk_end


@pytest.mark.parametrize("q_len,r_len", [
    ([0], [0]),
    ([0], [5000]),                 # empty q: no block
    ([5000], [0]),                 # empty r
    ([SEG // 2], [SEG // 2]),      # one exact segment
    ([SEG], [3 * SEG]),            # an exact multiple
    ([1], [1]),
    ([5_000], [5]),                # 1000x either way
    ([5], [5_000]),
    ([SEG - 1, 0, 1, SEG + 1, 0], [0, 7, SEG, 2 * SEG - 1, 0]),
    ([], []),
])
def test_block_plan_covers_every_merged_item_once(q_len, r_len):
    _check_plan(q_len, r_len)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_plan_random_lengths(seed):
    rng = np.random.default_rng(seed)
    n = 40
    q_len = rng.integers(0, 5 * SEG, size=n)
    r_len = rng.integers(0, 5 * SEG, size=n)
    q_len[rng.random(n) < 0.2] = 0
    r_len[rng.random(n) < 0.2] = 0
    blk_end = _check_plan(q_len, r_len)
    want = np.where(q_len > 0, -(-(q_len + r_len) // SEG), 0)
    np.testing.assert_array_equal(np.diff(blk_end, prepend=0), want)


# -- input checks -----------------------------------------------------------


def test_window_hits_rejects_bad_inputs():
    q = torch.arange(10, dtype=torch.int64)
    r = torch.arange(0, 20, 2, dtype=torch.int64)
    twh.window_element_hits([(q, r)], CPU)  # accepted
    for bad in [(q[::2], r),                          # not contiguous
                (q.reshape(2, 5), r),                 # not 1-D
                (q, r.to(torch.int32)),               # not int64
                (q.to(torch.float64), r)]:
        with pytest.raises(ValueError):
            twh.window_element_hits([bad], CPU)
    # CPU tensors where the caller names the card
    with pytest.raises(ValueError):
        twh.window_element_hits([(q, r)], "cuda")


def test_tile_stats_rejects_bad_inputs():
    a = torch.zeros(3, 4, dtype=torch.int64)
    b = torch.zeros(5, 4, dtype=torch.int64)
    tts.tile_stats(a, b, 4)  # accepted
    for rows, cols in [(a.t(), b),                     # not contiguous
                       (a, b.t().contiguous().t()),
                       (a[0], b),                      # not 2-D
                       (a, b.to(torch.int32)),         # not int64
                       (a, torch.zeros(5, 3, dtype=torch.int64))]:  # K
        with pytest.raises(ValueError):
            tts.tile_stats(rows, cols, 4)
        with pytest.raises(ValueError):
            tts.tile_stats(rows, cols, 4, intersect=True)


# -- window membership edge cases against galah_tpu -------------------------


def _rand(rng, n):
    return rng.integers(0, U64_TOP, size=n, dtype=np.uint64)


def _edge_pairs(rng):
    """(sorted uint64 query, sorted distinct reference) pairs."""
    ref = np.unique(_rand(rng, 2 * SEG))
    run = 2 * SEG + 100
    m = SEG - 200
    pairs = [
        # one equal value through merged items [m + 1, m + 1 + run):
        # across both segment boundaries and galah_tpu's job boundaries
        (np.full(run, ref[m]), ref),
        (np.full(run, ref[m]), np.delete(ref, m)),   # the same run, missed
    ]
    for n_ref, n_q in ((5, 5_000), (5_000, 5)):     # 1000x either way
        r = np.unique(_rand(rng, n_ref))
        q = np.sort(np.concatenate([r[rng.integers(0, r.size, n_q // 2)],
                                    _rand(rng, n_q - n_q // 2)]))
        pairs.append((q, r))
    one = _rand(rng, 1)
    pairs.append((one, one.copy()))                  # a single item
    pairs.append((_rand(rng, 1), one.copy()))        # a single miss
    # nq + nr an exact multiple of the segment
    r = np.unique(_rand(rng, SEG + 16))[:SEG]
    q = np.sort(np.concatenate([r[rng.integers(0, SEG, SEG // 2)],
                                _rand(rng, SEG - SEG // 2)]))
    pairs.append((q, r))
    return pairs


def _job_boundary_runs(rng):
    """Sorted queries whose runs of equal values straddle galah_tpu's
    1024-value job boundaries, some of them in the reference."""
    ref = np.unique(_rand(rng, 3000))
    q = np.sort(np.concatenate([ref[rng.integers(0, ref.size, 2000)],
                                _rand(rng, 2000)]))
    for b, hit in ((JOB, True), (2 * JOB, False), (3 * JOB, True)):
        v = q[b]
        q[b - 40:b + 40] = v  # still sorted: q[b - 40] <= v <= q[b + 40]
        ref = np.union1d(ref, [v]) if hit else ref[ref != v]
    return q, ref


def _galah_flags(pairs):
    items = [(q, r, jfa.pad_ref_set(r)) for q, r in pairs]
    return jpf.window_element_hits(items, interpret=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_window_hits_edge_cases_match_pallas_interpret(seed):
    rng = np.random.default_rng(seed)
    pairs = _edge_pairs(rng) + [_job_boundary_runs(rng)]
    want = _galah_flags(pairs)
    titems = [(to_biased(q), to_biased(r)) for q, r in pairs]
    got = torch.split(twh.window_element_hits(titems, CPU),
                      [q.numel() for q, _ in titems])
    for n, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"pair {n}")
    # the run through both segment boundaries hits everywhere, or nowhere
    assert got[0].all() and not got[1].any()


def test_window_hits_all_sentinel_query_never_hits():
    """galah_tpu's queries never hold the sentinel (its kernel would
    match its own padding); the port's flags stay 0 for it."""
    rng = np.random.default_rng(3)
    ref = np.unique(_rand(rng, 500))
    q = np.full(1000, np.uint64(SENTINEL), dtype=np.uint64)
    got = twh.window_element_hits([(to_biased(q), to_biased(ref))], CPU)
    assert got.shape == (1000,) and not got.any()


# -- tile_stats edge rows against the XLA twin ------------------------------


def _edge_rows(rng, k, br, bc):
    """(rows, cols) uint64 with full, empty, ragged and tiny (na << nb)
    rows; col 0 equals row 0, col 1 equals row 2, col 2 is disjoint from
    every other row."""
    pool = np.unique(_rand(rng, 3 * k))
    other = np.setdiff1d(np.unique(_rand(rng, k)), pool)

    def rows(n):
        m = np.full((n, k), np.uint64(SENTINEL), dtype=np.uint64)
        for i in range(n):
            cnt = (k, 0, int(rng.integers(0, k + 1)), min(k, 3))[i % 4]
            m[i, :cnt] = np.sort(rng.choice(pool, size=cnt, replace=False))
        return m

    r, c = rows(br), rows(bc)
    c[0], c[1] = r[0], r[2]
    c[2] = np.uint64(SENTINEL)
    c[2, :other.size] = other
    return r, c


@pytest.mark.parametrize("k,br,bc", [(2176, 6, 7), (1, 9, 13)])
def test_tile_stats_edge_rows_match_xla(k, br, bc):
    rng = np.random.default_rng(k)
    rows, cols = _edge_rows(rng, k, br, bc)
    trows, tcols = to_biased(rows), to_biased(cols)
    for sketch_size in (k, max(k // 3, 1)):
        jc, jt = jpw.tile_stats(jnp.asarray(rows), jnp.asarray(cols),
                                sketch_size, 21)
        tc, tt = tts.tile_stats(trows, tcols, sketch_size)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    ic, itot = tts.tile_stats(trows, tcols, k, intersect=True)
    np.testing.assert_array_equal(
        ic.numpy(), np.asarray(jpw.tile_intersect_counts(
            jnp.asarray(rows), jnp.asarray(cols))))
    np.testing.assert_array_equal(
        itot.numpy(), np.broadcast_to(
            (rows != np.uint64(SENTINEL)).sum(axis=1)[:, None], (br, bc)))
    # the special rows: identical, empty and disjoint pairs
    assert ic[0, 0] == (rows[0] != np.uint64(SENTINEL)).sum()
    assert ic[1].sum() == 0 and ic[:, 2].sum() == 0


# -- the tile_stats rehearsal's inputs and variants ----------------------------


def test_rehearsal_stripe_rows_are_sorted_sketches_in_families():
    k = 128
    rows, cols = rts.stripe(k, np.random.default_rng(0), br=8, bc=16)
    assert rows.shape == (8, k) and cols.shape == (16, k)
    np.testing.assert_array_equal(rows, cols[:8])
    top = np.iinfo(np.int64).max
    n = (cols != top).sum(axis=1)
    assert (n >= int(0.97 * k)).all() and (n <= k).all()
    for row, m in zip(cols, n):
        assert (np.diff(row[:m]) > 0).all() and (row[m:] == top).all()
    common, _ = tts.tile_stats(torch.from_numpy(rows),
                               torch.from_numpy(cols), k, intersect=True)
    fam = np.arange(16) // 4
    same = fam[:8, None] == fam[None, :]
    assert (common.numpy()[same] > 0).all()
    assert (common.numpy()[~same] == 0).all()


def test_rehearsal_variants_each_change_the_committed_source():
    variants = rts._variants(None)
    assert set(variants) == {"committed", "small-tiles", "in-place"}
    assert len({src for _, src in variants.values()}) == 3
