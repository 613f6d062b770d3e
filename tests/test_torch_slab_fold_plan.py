"""The slab fold's plan and schedule (``kernels/slab_fold.cu``) against
galah_tpu's ``_slab_fold_jit`` and the port's plain version.

* ``ops/megakernel.fold_plan``: one block at every default shape (width
  up to 16 x 1,024, ``GALAH_TPU_QUEUE_CAP`` 4,096), 2, 4 and 8 blocks or
  the global-memory tier at the boundaries, never more than one SM's
  227 KB a block;
* ``kernel_model`` below, a numpy model of the kernel's schedule: each
  block's contiguous range of positions, the prologue that keeps a
  block's passing records as edges (its warps taking chunks of 32 in
  turn), the scatter that reads the owning block's flags and drops, in
  place and in order, the edges that can no longer decide anything, the
  word-wide update, the per-block "changed" flags OR-ed across the
  cluster, and the packed output, decoded by ``megakernel.unpack``. It
  must equal ``slab_fold_plain`` and galah_tpu's fold in rep, undecided
  and iterations on seeded and drawn slabs: NaN values, values at the
  threshold, chains at the depth bound and one short, every position
  clustered, width 1, every cluster size;
* the whole call's held buffers: one staging copy carries the records
  and ``ext``, and ``slab_select`` decodes the packed output.

Tolerance: none — flags, counts and iterations equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from galah_tpu.ops import device_queue as jqueue
from galah_tpu.ops import greedy_select as jgreedy
from galah_tpu.ops import megakernel as jmk
from galah_tpu_torch.ops import device_queue as tqueue
from galah_tpu_torch.ops import megakernel as tmk

THR = 0.95
SMEM = 227 * 1024
U32 = np.dtype("<u4")


# ---------------------------------------------------------------------------
# the kernel's schedule, in numpy
# ---------------------------------------------------------------------------


def kernel_model(rec, ext, thr, max_iters, plan):
    """The packed output (uint8, ``fold_bytes(width)``) of the
    shared-memory tier run with `plan` over the records `rec`
    (``device_queue.RECORD``) and the flags `ext`."""
    width, count = len(ext), len(rec)
    c, per_block, per_warp = plan.cluster, plan.per_block, plan.per_warp
    assert c >= 1 and per_block % 16 == 0 and per_block * c >= width
    if plan.edge_bytes == 4:
        assert width <= tmk.MAX_U16_WIDTH  # two uint16 an edge
    warps = tmk.FOLD_WARPS
    # each block's flags; a position past the width reads as clustered
    clustered = np.ones(c * per_block, dtype=bool)
    clustered[:width] = ext
    und = (~clustered).astype(np.uint8).reshape(c, per_block)
    rep = np.zeros_like(und)
    und_at = np.zeros_like(und)
    rep_at = np.zeros_like(und)
    # prologue: a block's share of the records, its warps' chunks of 32
    # in turn, the passing ones kept in order
    share = -(-count // c)
    segments = []
    for b in range(c):
        lo = min(count, b * share)
        hi = min(count, lo + share)
        for w in range(warps):
            kept = []
            for base in range(lo + 32 * w, hi, 32 * warps):
                chunk = rec[base:min(base + 32, hi)]
                passing = chunk["v"] >= thr  # NaN fails, equality passes
                kept += list(zip(chunk["i"][passing], chunk["j"][passing]))
            assert len(kept) <= per_warp
            segments.append(np.array(kept, dtype=np.int64).reshape(-1, 2))

    def at(flags, p):  # the owning block's flag of positions p
        return flags[p // per_block, p % per_block]

    it, changed = 0, True
    while changed and it < max_iters:
        for k, edges in enumerate(segments):
            s, d = edges[:, 0], edges[:, 1]
            ud = at(und, d) != 0
            us = at(und, s) != 0
            rs = at(rep, s) != 0
            for flags, hit in ((und_at, ud & us), (rep_at, ud & rs)):
                flags[d[hit] // per_block, d[hit] % per_block] = 1
            segments[k] = edges[ud & (us | rs)]
        block_changed = []
        for b in range(c):
            u, ua, ra = (a[b].view(U32) for a in (und, und_at, rep_at))
            decided = u & (ra | ~ua)
            rep[b].view(U32)[:] |= u & ~ua & ~ra
            u ^= decided
            ua[:] = 0
            ra[:] = 0
            block_changed.append(bool(decided.any()))
        changed = any(block_changed)
        it += 1
    und_off, tail_off, _ = tmk.packed_layout(width)
    out = np.zeros(tmk.fold_bytes(width), dtype=np.uint8)
    left = 0
    for b in range(c):
        p0 = b * per_block
        owned = min(per_block, width - p0)
        if owned <= 0:
            continue
        n = 4 * -(-owned // 4)  # whole words
        out[p0:p0 + n] = rep[b, :n]
        out[und_off + p0:und_off + p0 + n] = und[b, :n]
        left += int(und[b, :n].sum())
    out[tail_off:tail_off + 8].view(np.int32)[:] = [it, left]
    return out


def _records(ei, ej, ev):
    rec = np.empty(len(ei), dtype=tqueue.RECORD)
    rec["i"], rec["j"], rec["v"] = ei, ej, ev
    return rec


def _plain(ei, ej, ev, ext, max_iters):
    q = tqueue.PairQueue(max(len(ei), 1), "cpu")
    assert q.enqueue(ei, ej, ev) == len(ei)
    rep, und, it = tmk.slab_fold_plain(q.records, q.count,
                                       torch.from_numpy(ext), THR,
                                       max_iters)
    return rep.numpy(), und.numpy(), int(it)


def _jax(ei, ej, ev, ext):
    """galah_tpu's fold (its depth bound is the padded width, which a
    slab never reaches before its fixpoint)."""
    w = len(ext)
    q = jqueue.PairQueue(cap=max(len(ei), 1))
    assert q.enqueue(ei, ej, ev) == len(ei)
    gb = jgreedy._bucket(w)
    extp = np.zeros(gb, dtype=bool)
    extp[:w] = ext
    valid = np.zeros(gb, dtype=bool)
    valid[:w] = True
    rep, und = jmk._slab_fold_jit(q._qi, q._qj, q._qv, q._count,
                                  jnp.asarray(extp), jnp.asarray(valid),
                                  jnp.float64(THR))
    return np.asarray(rep)[:w], np.asarray(und)[:w]


def _check(ei, ej, ev, ext, cluster, cap=None, max_iters=None,
           jax=True):
    """The model at `cluster` blocks equals the plain version, and
    galah_tpu's fold when the depth bound is the width."""
    w = len(ext)
    cap = cap or max(len(ei), 1)
    iters = w if max_iters is None else max_iters
    plan = tmk.cluster_plan(w, cap, cluster)
    rep, und, it, left = tmk.unpack(
        kernel_model(_records(ei, ej, ev), ext, THR, iters, plan), w)
    prep, pund, pit = _plain(ei, ej, ev, ext, iters)
    assert np.array_equal(rep, prep) and np.array_equal(und, pund)
    assert it == pit and left == int(pund.sum())
    if jax and max_iters is None:
        jrep, jund = _jax(ei, ej, ev, ext)
        assert np.array_equal(rep, jrep) and np.array_equal(und, jund)
    return rep, und, it


def _slab(seed, w, density=0.3, ext_rate=0.2, far=False):
    """(ei, ej, ev, ext): edges i < j with values around the
    threshold, a tenth exactly at it, a twentieth NaN."""
    rng = np.random.default_rng(seed)
    ei, ej = np.nonzero(np.triu(rng.random((w, w)) < density, k=1))
    if not far:  # most of the main path's edges are near the diagonal
        near = ej - ei <= 24
        ei, ej = ei[near], ej[near]
    ev = rng.uniform(0.90, 0.99, size=ei.shape[0])
    pick = rng.random(ei.shape[0])
    ev[pick < 0.1] = THR
    ev[(pick >= 0.1) & (pick < 0.15)] = np.nan
    order = rng.permutation(len(ei))
    return (ei[order].astype(np.int32), ej[order].astype(np.int32),
            ev[order], rng.random(w) < ext_rate)


def _chain(w, positions=None):
    """A chain of passing edges, one decision an iteration: k -> k + 1,
    or through `positions` of a wider slab."""
    pos = np.arange(w) if positions is None else np.asarray(positions)
    ext = np.zeros(w if positions is None else int(pos[-1]) + 1 + 7,
                   dtype=bool)
    return (pos[:-1].astype(np.int32), pos[1:].astype(np.int32),
            np.full(len(pos) - 1, 0.97), ext)


# ---------------------------------------------------------------------------
# fold_plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [8, 256, 1024, 4096])
def test_fold_plan_takes_one_block_at_every_default_shape(cap):
    for width in [1, 15, 16, 17, 64, 1000, 1024, 4096, 16383, 16384,
                  *range(1, 16385, 997)]:
        plan = tmk.fold_plan(width, cap)
        assert plan.cluster == 1 and plan.tier == "cluster 1"
        assert plan.smem <= SMEM and plan.per_block >= width
        assert plan.per_block % 16 == 0
        assert plan.edge_bytes == 4


def test_default_slab_needs_about_80_kb():
    plan = tmk.fold_plan(16 * 1024, 4096)
    # 4 flag bytes a position, 4,096 edges of two uint16, the header
    assert plan.smem == 4 * 16384 + 4 * 4096 + tmk.SMEM_HEAD == 81_936


@pytest.mark.parametrize("width, cap, cluster", [
    (54_000, 4096, 1), (54_001, 4096, 2),
    (65_536, 4096, 2), (108_000, 4096, 2), (108_001, 4096, 4),
    (131_072, 4096, 4), (224_192, 4096, 4), (224_193, 4096, 8),
    (262_144, 4096, 8), (448_384, 4096, 8), (448_385, 4096, 0),
    (524_288, 4096, 0),
    (16_384, 32_768, 1), (16_384, 65_536, 2), (16_384, 131_072, 4),
    (16_384, 262_144, 8), (16_384, 524_288, 0),
])
def test_fold_plan_boundaries(width, cap, cluster):
    """The smallest cluster whose state fits, at the edges of each."""
    plan = tmk.fold_plan(width, cap)
    assert plan.cluster == cluster
    if cluster == 0:
        assert plan == tmk.GLOBAL_TIER and plan.tier == "global"
        assert tmk.cluster_plan(width, cap, 8).smem > tmk.SMEM_PER_BLOCK
    else:
        assert plan.smem <= SMEM
        assert plan.per_block * cluster >= width
        if cluster > 1:
            smaller = tmk.cluster_plan(width, cap, cluster // 2)
            assert smaller.smem > tmk.SMEM_PER_BLOCK


@settings(max_examples=300, deadline=None)
@given(width=hst.integers(0, 1 << 20), cap_log=hst.integers(3, 20))
def test_fold_plan_is_the_smallest_cluster_that_fits(width, cap_log):
    cap = 1 << cap_log
    plan = tmk.fold_plan(width, cap)
    fits = [c for c in tmk.CLUSTER_SIZES
            if tmk.cluster_plan(width, cap, c).smem <= tmk.SMEM_PER_BLOCK]
    assert plan.cluster == (fits[0] if fits else 0)
    assert plan.smem <= SMEM
    if plan.cluster:
        # room for every record as a passing edge, whichever warp holds it
        share = -(-cap // plan.cluster)
        assert plan.per_warp * tmk.FOLD_WARPS >= share
        assert plan.per_warp >= 32 * -(-share // (32 * tmk.FOLD_WARPS))
        assert plan.edge_bytes == (4 if width <= 65_536 else 8)


def test_packed_layout_is_aligned_and_decodes():
    for width in [0, 1, 15, 16, 17, 1000, 16384]:
        und_off, tail_off, nbytes = tmk.packed_layout(width)
        assert und_off % 16 == tail_off % 16 == nbytes % 16 == 0
        assert und_off >= width and tail_off - und_off >= width
        assert tmk.fold_bytes(width) >= nbytes + 2 * width
        buf = np.zeros(tmk.fold_bytes(width), dtype=np.uint8)
        buf[:width] = np.arange(width) % 2
        buf[und_off:und_off + width] = np.arange(width) % 3 == 0
        buf[tail_off:tail_off + 8].view(np.int32)[:] = [7, 9]
        rep, und, it, left = tmk.unpack(buf, width)
        assert rep.dtype == und.dtype == bool and len(rep) == width
        assert rep.tolist() == [k % 2 == 1 for k in range(width)]
        assert und.tolist() == [k % 3 == 0 for k in range(width)]
        assert (it, left) == (7, 9)


# ---------------------------------------------------------------------------
# the model against galah_tpu and the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", range(4))
def test_model_equals_galah_tpu_on_seeded_slabs(seed, cluster):
    w = int(np.random.default_rng(seed).integers(20, 64))
    _check(*_slab(700 + seed, w, far=seed % 2 == 1), cluster)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["empty", "nan", "at_thr", "all_ext",
                                  "w1", "full_cap"])
def test_model_edge_slabs(case, cluster):
    w = 48
    ei, ej = (a.astype(np.int32) for a in np.triu_indices(w, 1))
    ev = np.full(ei.shape[0], 0.97)
    ext = np.zeros(w, dtype=bool)
    cap = None
    if case == "empty":
        ei, ej, ev = ei[:0], ej[:0], ev[:0]
    elif case == "nan":
        ev[:] = np.nan
    elif case == "at_thr":
        ev[:] = THR
    elif case == "all_ext":
        ext[:] = True
    elif case == "w1":
        w, ei, ej, ev, ext = 1, ei[:0], ej[:0], ev[:0], ext[:1]
    else:  # the queue filled to its capacity
        ei, ej, ev = ei[:512], ej[:512], ev[:512]
        cap = 512
    rep, und, it = _check(ei, ej, ev, ext, cluster, cap=cap)
    if case in ("empty", "nan"):
        assert rep.all() and it == 2
    if case == "at_thr":  # v == thr passes: the first position claims all
        assert rep.tolist() == [True] + [False] * (w - 1)
    if case == "all_ext":
        assert not rep.any() and it == 1


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_model_chain_at_the_bound_and_one_short(cluster):
    """A chain through every block takes as many iterations as it has
    positions: at that bound it converges, one short it stops with its
    last position undecided."""
    w = 256
    positions = np.arange(0, w, 2)  # across every block boundary
    ei, ej, ev, ext = _chain(w, positions)
    bound = len(positions)
    rep, und, it = _check(ei, ej, ev, ext, cluster, max_iters=bound)
    assert it == bound and not und.any()
    rep, und, it = _check(ei, ej, ev, ext, cluster, max_iters=bound - 1)
    assert it == bound - 1 and und.tolist().count(True) == 1
    assert und[positions[-1]]


@pytest.mark.parametrize("cluster", [1, 8])
def test_model_chain_at_the_width_equals_galah_tpu(cluster):
    ei, ej, ev, ext = _chain(128)
    rep, und, it = _check(ei, ej, ev, ext, cluster)
    assert it == 128 and rep.tolist() == [k % 2 == 0 for k in range(128)]


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_model_with_more_records_than_a_warp_chunk_round(cluster):
    """More records than one round of 32 x 32 chunks a block, so that
    warps hold several chunks and compaction moves edges within a
    segment."""
    ei, ej, ev, ext = _slab(77, 200, density=0.5, far=True)
    assert len(ei) > 1024 * cluster
    _check(ei, ej, ev, ext, cluster, jax=cluster in (1, 8))


@settings(max_examples=40, deadline=None)
@given(data=hst.data())
def test_model_equals_plain_and_galah_tpu_on_drawn_slabs(data):
    w = data.draw(hst.integers(1, 40), label="width")
    pairs = [(i, j) for i in range(w) for j in range(i + 1, w)]
    chosen = data.draw(hst.lists(hst.sampled_from(pairs), max_size=120)
                       if pairs else hst.just([]), label="edges")
    vals = data.draw(hst.lists(
        hst.sampled_from([0.5, 0.94, THR, 0.96, 0.99, float("nan")]),
        min_size=len(chosen), max_size=len(chosen)), label="values")
    ext = np.array(data.draw(hst.lists(hst.booleans(), min_size=w,
                                       max_size=w), label="ext"))
    if data.draw(hst.booleans(), label="all clustered"):
        ext[:] = True
    cluster = data.draw(hst.sampled_from([1, 2, 4, 8]), label="cluster")
    ei = np.array([p[0] for p in chosen], dtype=np.int32)
    ej = np.array([p[1] for p in chosen], dtype=np.int32)
    ev = np.array(vals, dtype=np.float64)
    short = data.draw(hst.booleans(), label="bounded")
    max_iters = data.draw(hst.integers(0, w), label="max_iters") \
        if short else None
    _check(ei, ej, ev, ext, cluster, cap=128, max_iters=max_iters)


# ---------------------------------------------------------------------------
# the whole call's held buffers
# ---------------------------------------------------------------------------


def test_enqueue_carries_ext_behind_the_records_in_one_copy():
    q = tqueue.PairQueue(16, "cpu")
    ei, ej, ev, ext = _slab(3, 30, density=0.02)
    ext[:3] = [True, False, True]
    assert q.enqueue(ei, ej, ev, ext=ext) == len(ei)
    assert q.ext.dtype == torch.bool and q.ext.tolist() == ext.tolist()
    assert q.ext.data_ptr() == q.records.data_ptr() + 16 * len(ei)
    assert np.array_equal(q.qi[:len(ei)].numpy(), ei)
    assert np.array_equal(q.qj[:len(ei)].numpy(), ej)
    assert np.array_equal(q.qv[:len(ei)].numpy(), ev, equal_nan=True)


def test_ext_room_grows_by_powers_of_two_and_keeps_the_records():
    q = tqueue.PairQueue(8, "cpu")
    assert q.enqueue(np.array([1]), np.array([2]), np.array([0.97])) == 1
    for w in (5, 64, 65, 1000):
        ext = np.arange(w) % 3 == 0
        q.enqueue(np.array([0]), np.array([3]), np.array([0.96]), ext=ext)
        assert q.ext.tolist() == ext.tolist()
        assert q._ext_cap >= w and q._ext_cap & (q._ext_cap - 1) == 0
        assert q.qi[0] == 1 and float(q.qv[0]) == 0.97
        q.reset()
        q.enqueue(np.array([1]), np.array([2]), np.array([0.97]))


def test_workspace_is_held_and_grows_by_powers_of_two():
    q = tqueue.PairQueue(8, "cpu")
    a = q.workspace(100)
    assert a.numel() == 128 and a.dtype == torch.uint8
    assert q.workspace(128).data_ptr() == a.data_ptr()
    assert q.workspace(129).numel() == 256


@pytest.mark.parametrize("seed", range(3))
def test_slab_select_decodes_the_packed_output(seed):
    """slab_select reads rep and convergence from the packed output in
    the queue's workspace (the plain fold packs it on the CPU)."""
    ei, ej, ev, ext = _slab(900 + seed, 50, density=0.2)
    q = tqueue.PairQueue(1024, "cpu")
    rep, converged = tmk.slab_select(q, ei, ej, ev, ext, THR)
    jrep, jund = _jax(ei, ej, ev, ext)
    assert np.array_equal(rep, jrep) and converged == (not jund.any())
    packed = q.workspace(tmk.fold_bytes(50)).numpy()
    prep, pund, pit = _plain(ei, ej, ev, ext, 50)
    got = tmk.unpack(packed, 50)
    assert np.array_equal(got[0], prep) and np.array_equal(got[1], pund)
    assert got[2] == pit and got[3] == int(pund.sum())
    assert q.count == 0
