"""The port's slab fold and device pair queue against galah_tpu's.

* ``ops/megakernel.slab_fold_plain`` (the plain version of
  ``kernels/slab_fold.cu``) against galah_tpu's ``_slab_fold_jit`` and
  against ``window_select`` on the equivalent dense matrix: random
  slabs with NaN values, values equal to the threshold, already
  clustered positions, an empty queue, a full one, and chains that
  reach the depth bound;
* ``ops/megakernel.slab_select`` against galah_tpu's, spills included;
* ``ops/device_queue.PairQueue`` against galah_tpu's on the same
  batches: stored counts, overflow, drained triples bit for bit, the
  power-of-two capacity;
* the five flags' parsing against galah_tpu's resolvers, their
  registration and their place on the man page.

Tolerance: none — flags, counts and float64 bits equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galah_tpu import config as jconfig
from galah_tpu.cluster import engine as jengine
from galah_tpu.ops import device_queue as jqueue
from galah_tpu.ops import greedy_select as jgreedy
from galah_tpu.ops import megakernel as jmk
from galah_tpu_torch import config as tconfig
from galah_tpu_torch import manpage
from galah_tpu_torch.cluster import engine as tengine
from galah_tpu_torch.ops import device_queue as tqueue
from galah_tpu_torch.ops import greedy_select as tgreedy
from galah_tpu_torch.ops import megakernel as tmk

THR = 0.95


def _slab(seed, w, density=0.4, ext_rate=0.2):
    """(ei, ej, ev, ext) of a random slab of width w: edges i < j with
    values around the threshold, some exactly at it, some NaN."""
    rng = np.random.default_rng(seed)
    ei, ej = np.nonzero(np.triu(rng.random((w, w)) < density, k=1))
    ev = rng.uniform(0.90, 0.99, size=ei.shape[0])
    pick = rng.random(ei.shape[0])
    ev[pick < 0.1] = THR
    ev[(pick >= 0.1) & (pick < 0.15)] = np.nan
    ext = rng.random(w) < ext_rate
    return (ei.astype(np.int32), ej.astype(np.int32),
            ev.astype(np.float64), ext)


def _chain(w):
    """A chain k -> k + 1 of passing edges: each iteration decides one
    position, so it takes exactly w iterations."""
    ei = np.arange(w - 1, dtype=np.int32)
    return ei, ei + 1, np.full(w - 1, 0.97), np.zeros(w, dtype=bool)


def _records(ei, ej, ev, cap=None):
    q = tqueue.PairQueue(cap or max(len(ei), 1), "cpu")
    assert q.enqueue(ei, ej, ev) == len(ei)
    return q


def _port_fold(ei, ej, ev, ext, max_iters=None):
    q = _records(ei, ej, ev)
    rep, und, iters = tmk.slab_fold(q.records, q.count,
                                    torch.from_numpy(ext), THR, max_iters)
    return rep.numpy(), und.numpy(), int(iters)


def _jax_fold(ei, ej, ev, ext):
    """galah_tpu's fold over its own queue's buffers, trimmed."""
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


def _dense(ei, ej, ev, w):
    mat = np.full((w, w), np.nan, dtype=np.float64)
    mat[ei, ej] = ev
    return mat


@pytest.mark.parametrize("seed", range(12))
def test_plain_fold_equals_galah_tpu_and_window_select(seed):
    w = int(np.random.default_rng(seed).integers(1, 60))
    ei, ej, ev, ext = _slab(500 + seed, w)
    rep, und, iters = _port_fold(ei, ej, ev, ext)
    jrep, jund = _jax_fold(ei, ej, ev, ext)
    assert np.array_equal(rep, jrep) and np.array_equal(und, jund)
    assert not und.any() and 1 <= iters <= w
    drep, conv = tgreedy.window_select(_dense(ei, ej, ev, w), ext, THR,
                                       "cpu")
    assert conv and np.array_equal(rep, drep)


@pytest.mark.parametrize("case", ["empty", "full", "nan", "at_thr",
                                  "ext", "w1"])
def test_plain_fold_edge_slabs(case):
    """An empty queue (every undecided position a rep), a queue filled
    to its capacity, all-NaN and all-at-threshold values, every
    position already clustered, and a slab of one."""
    w = 64
    ei, ej = (a.astype(np.int32) for a in np.triu_indices(w, 1))
    ev = np.full(ei.shape[0], 0.97)
    ext = np.zeros(w, dtype=bool)
    cap = None
    if case == "empty":
        ei, ej, ev = ei[:0], ej[:0], ev[:0]
    elif case == "full":
        ei, ej, ev = ei[:256], ej[:256], ev[:256]
        cap = 256
    elif case == "nan":
        ev[:] = np.nan
    elif case == "at_thr":
        ev[:] = THR
    elif case == "ext":
        ext[:] = True
    else:
        w, ei, ej, ev, ext = 1, ei[:0], ej[:0], ev[:0], ext[:1]
    q = _records(ei, ej, ev, cap)
    assert q.count == len(ei) and (cap is None or q.count == q.cap)
    rep, und, _ = tmk.slab_fold(q.records, q.count, torch.from_numpy(ext),
                                THR)
    jrep, jund = _jax_fold(ei, ej, ev, ext)
    assert np.array_equal(rep.numpy(), jrep)
    assert np.array_equal(und.numpy(), jund)
    if case in ("empty", "nan"):
        assert rep.all()
    if case == "at_thr":  # v == thr passes: the first position claims all
        assert rep.numpy().tolist() == [True] + [False] * (w - 1)
    if case == "ext":
        assert not rep.any()


def test_deep_chain_reaches_the_depth_bound():
    """A chain of w positions takes w iterations, the bound: it still
    converges, equal to galah_tpu's; one iteration short it stops with
    the last position undecided."""
    w = 1024
    ei, ej, ev, ext = _chain(w)
    rep, und, iters = _port_fold(ei, ej, ev, ext)
    jrep, jund = _jax_fold(ei, ej, ev, ext)
    assert iters == w and not und.any()
    assert np.array_equal(rep, jrep) and np.array_equal(und, jund)
    assert rep.tolist() == [k % 2 == 0 for k in range(w)]
    _rep, und_short, iters = _port_fold(ei, ej, ev, ext, max_iters=w - 1)
    assert iters == w - 1 and und_short.tolist() == [False] * (w - 1) + [True]


@pytest.mark.parametrize("depth", [20, 40])
def test_bounded_fold_equals_window_select_at_fold_iters(depth):
    """At FOLD_ITERS iterations the slab fold and the dense fold stop at
    the same flags, converged (depth 20) or not (depth 40)."""
    ei, ej, ev, ext = _chain(depth)
    rep, und, _ = _port_fold(ei, ej, ev, ext,
                             max_iters=tgreedy.FOLD_ITERS)
    drep, conv = tgreedy.window_select(_dense(ei, ej, ev, depth), ext, THR,
                                       "cpu")
    jrep, jconv = jgreedy.window_select(_dense(ei, ej, ev, depth), ext, THR)
    assert np.array_equal(rep, drep) and np.array_equal(rep, jrep)
    assert conv == jconv == (not und.any()) == (depth <= tgreedy.FOLD_ITERS)


@pytest.mark.parametrize("cap", [8, 64, 1024])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slab_select_equals_galah_tpu(cap, seed):
    """One enqueue and one fold, or a spill when the edges do not fit:
    the same answer as galah_tpu's slab_select, the queue left empty."""
    ei, ej, ev, ext = _slab(seed, 40, density=0.1 + 0.1 * seed)
    tq = tqueue.PairQueue(cap, "cpu")
    jq = jqueue.PairQueue(cap=cap)
    got = tmk.slab_select(tq, ei, ej, ev, ext, THR)
    want = jmk.slab_select(jq, ei, ej, ev, ext, THR)
    assert (got[0] is None) == (want[0] is None)
    if got[0] is not None:
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert got[1] == want[1]
    assert tq.count == jq.count == 0


def test_slab_select_refuses_edges_outside_the_slab():
    q = tqueue.PairQueue(8, "cpu")
    with pytest.raises(ValueError, match="below the slab width"):
        tmk.slab_select(q, np.array([0]), np.array([5]), np.array([0.97]),
                        np.zeros(4, dtype=bool), THR)
    with pytest.raises(ValueError, match="i < j"):
        tmk.slab_select(q, np.array([2]), np.array([1]), np.array([0.97]),
                        np.zeros(4, dtype=bool), THR)


def _bits(a):
    return np.asarray(a, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("cap", [1, 5, 8, 16, 100])
def test_pair_queue_equals_galah_tpu(cap):
    """The same batches into both queues: stored counts, count,
    overflow and the drained triples bit for bit (a NaN payload and
    -0.0 included), then reset with and without the overflow."""
    rng = np.random.default_rng(cap)
    tq, jq = tqueue.PairQueue(cap, "cpu"), jqueue.PairQueue(cap=cap)
    assert tq.cap == jq.cap and tq.cap & (tq.cap - 1) == 0
    odd = np.array([0.0, -0.0, np.nan]).view(np.int64)
    odd[2] |= 0x5A5A  # a NaN with a payload
    for m in (0, 3, 7, 1, 40):
        i = rng.integers(0, 1000, size=m).astype(np.int32)
        j = i + rng.integers(1, 50, size=m).astype(np.int32)
        v = rng.random(m)
        v[:min(m, 3)] = odd.view(np.float64)[:min(m, 3)]
        assert tq.enqueue(i, j, v) == jq.enqueue(i, j, v)
        assert (tq.count, tq.overflow) == (jq.count, jq.overflow)
    ti, tj, tv = tq.drain()
    ji, jj, jv = jq.drain()
    assert np.array_equal(ti, ji) and np.array_equal(tj, jj)
    assert np.array_equal(_bits(tv), _bits(jv))
    assert tq.count == jq.count == 0 and tq.overflow == jq.overflow
    tq.reset(clear_overflow=True)
    jq.reset(clear_overflow=True)
    assert tq.overflow == jq.overflow == 0
    assert len(tq.drain()[0]) == len(jq.drain()[0]) == 0


def test_pair_queue_views_are_the_records():
    q = tqueue.PairQueue(8, "cpu")
    q.enqueue(np.array([3]), np.array([9]), np.array([0.951]))
    assert q.qi[0] == 3 and q.qj[0] == 9 and float(q.qv[0]) == 0.951
    assert q.qi.data_ptr() == q.records.data_ptr()


ENV_CASES = {
    "GALAH_TPU_MEGAKERNEL": [None, "", "auto", "0", "1", " 1 ", "AUTO",
                             "always"],
    "GALAH_TPU_QUEUE_CAP": [None, "", "1000", "8", "3", "0", "-16",
                            "many", "4096"],
    "GALAH_TPU_GREEDY_STRATEGY": [None, "", "device", "host", "HOST",
                                  "gpu"],
    "GALAH_TPU_OVERLAP": [None, "", "auto", "0", "1", "bogus", " 1"],
    "GALAH_TPU_OVERLAP_DEPTH": [None, "", "7", "0", "oops", "512"],
}

RESOLVERS = {
    "GALAH_TPU_MEGAKERNEL": (tmk.resolve_megakernel,
                             jmk.resolve_megakernel),
    "GALAH_TPU_QUEUE_CAP": (tqueue.resolve_queue_cap,
                            jqueue.resolve_queue_cap),
    "GALAH_TPU_GREEDY_STRATEGY": (tgreedy.resolve_greedy_strategy,
                                  jgreedy.resolve_greedy_strategy),
    "GALAH_TPU_OVERLAP": (tengine._overlap_mode, jengine._overlap_mode),
    "GALAH_TPU_OVERLAP_DEPTH": (tengine._overlap_depth,
                                jengine._overlap_depth),
}


@pytest.mark.parametrize("flag", list(ENV_CASES))
def test_flag_parsing_equals_galah_tpu(flag, monkeypatch):
    port, ref = RESOLVERS[flag]
    for value in ENV_CASES[flag]:
        if value is None:
            monkeypatch.delenv(flag, raising=False)
        else:
            monkeypatch.setenv(flag, value)
        assert port() == ref(), (flag, value)


@pytest.mark.parametrize("flag", list(ENV_CASES))
def test_flags_registered_as_galah_tpu_and_on_the_man_page(flag):
    ours, theirs = tconfig.FLAGS[flag], jconfig.FLAGS[flag]
    assert (ours.section, ours.kind, ours.default, ours.choices) == \
        (theirs.section, theirs.kind, theirs.default, theirs.choices)
    assert "demote" not in ours.help
    lines = manpage.render_environment_section().splitlines()
    at = [n for n, line in enumerate(lines)
          if line.startswith("  GALAH") and line.split()[0] == flag]
    assert len(at) == 1
    assert lines.index("  Kernel and device policy:") < at[0] \
        < lines.index("  Resilience:")


def _lint_megakernel(text):
    """(GL1006 lines, GL1101 symbols) of the lint's pipeline and
    effects checkers over `text` as ops/megakernel.py."""
    import ast

    from galah_tpu_torch.analysis import effects_check, pipeline_check
    from galah_tpu_torch.analysis.core import SourceFile

    path = "galah_tpu_torch/ops/megakernel.py"
    src = SourceFile(path=path, text=text, tree=ast.parse(text))
    lexical = [f.line for f in pipeline_check.check_pipeline_file(src)
               if f.code == "GL1006" and not f.suppressed]
    effects = [f.symbol for f in effects_check.check_effects({path: src})
               if f.code == "GL1101"]
    return lexical, effects


@pytest.mark.parametrize("mutation", ["none", "direct", "helper"])
def test_slab_fold_launch_is_a_checked_device_round(mutation):
    """GL1006 (a host sync in run_launch itself) and GL1101 (one behind
    a helper) check the slab fold's launch wrapper: the module as it is
    gives neither."""
    import pathlib

    text = (pathlib.Path(tmk.__file__)).read_text()
    anchor = "    lib = build.load(\"slab_fold\")\n"
    assert text.count(anchor) == 1
    if mutation == "direct":
        text = text.replace(anchor, anchor + "    _n = count.cpu()\n")
    elif mutation == "helper":
        text = text.replace(anchor, anchor + "    _n = _peek(iters)\n")
        text += "\n\ndef _peek(t):\n    return t.item()\n"
    lexical, effects = _lint_megakernel(text)
    assert bool(lexical) == (mutation == "direct")
    assert effects == (["run_launch"] if mutation == "helper" else [])
