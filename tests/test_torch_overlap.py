"""The port's overlapped engine, slab folds and host scan against
galah_tpu's.

On the table-driven stubs of tests/test_torch_streamed_pairs.py (a
streamed precluster whose hit pairs arrive in blocks of rows, each
block completing the prefix [0, r1)), the port's ``cluster`` with
``GALAH_TPU_OVERLAP=1`` against galah_tpu's: clusters, the overlap,
greedy, slab-fold and exact-ANI counters, the speculative pairs, the
occupancy gauges, the checkpoint record and a stage-serial resume;
the forced modes' refusals, a failure raising under auto (where
galah_tpu demotes), a queue-capacity sweep and the slabs' dispatch
count; the host strategy at several ``rep_scan_window``s; the
streamed pair generator; and a finch CLI run on the overlapped route.
Both packages read the same GALAH_TPU_* flags, set alike for both.

Tolerance: none — clusters, counters, pair sets and TSV bytes equal.
"""

import logging
from typing import List, Optional, Sequence

import numpy as np
import pytest
import torch

from galah_tpu.cli import main as jmain
from galah_tpu.cluster import cluster as jcluster
from galah_tpu.cluster.checkpoint import ClusterCheckpoint as JCheckpoint
from galah_tpu.cluster.checkpoint import run_fingerprint as jfingerprint
from galah_tpu.ops import collision as jcol
from galah_tpu.ops.pairwise import (
    iter_threshold_pairs_streamed as jiter_streamed)
from galah_tpu.utils import timing as jtiming
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.cluster import engine as tengine
from galah_tpu_torch.cluster.checkpoint import ClusterCheckpoint
from galah_tpu_torch.cluster.checkpoint import run_fingerprint
from galah_tpu_torch.obs import metrics as tmetrics
from galah_tpu_torch.ops import megakernel as tmk
from galah_tpu_torch.ops import sketch_stream
from galah_tpu_torch.ops.pairwise import iter_threshold_pairs_streamed
from galah_tpu_torch.resilience import interrupt
from galah_tpu_torch.timing import StageClock

from test_torch_cluster import _families
from test_torch_streamed_pairs import (TableCl, TablePre, _blocks,
                                       _dense_workload, _family_workload,
                                       _JStreamPre, _JTableCl, _sketches, g)

CPU = torch.device("cpu")

#: the counters both packages keep for a greedy run
COUNTERS = ("overlap-engaged", "overlap-eager-rounds", "overlap-spec-pairs",
            "overlap-spec-batches", "greedy-rounds", "greedy-subrounds",
            "greedy-conflict-windows", "greedy-select-dispatches",
            "megakernel-slab-folds", "megakernel-overflow-spills",
            "exact-ani-computed", "exact-ani-wasted", "exact-ani-wasted-rep",
            "exact-ani-wasted-membership", "exact-ani-wasted-warm")
WASTE = ("exact-ani-computed", "exact-ani-wasted-rep",
         "exact-ani-wasted-membership", "exact-ani-wasted-warm")


class StreamPre(TablePre):
    """The port's streamed stub: hit pairs arrive in blocks of `block`
    rows, a pair (i, j) with its later row; `fail_at_row` raises once
    the stream passes that row."""

    def __init__(self, pairs, n, block=7, fail_at_row=None):
        super().__init__(pairs)
        self.n, self.block, self.fail_at_row = n, block, fail_at_row

    def distances_streamed(self, genome_paths):
        by_row = {}
        for (i, j), ani in self.pairs.items():
            by_row.setdefault(max(i, j), {})[(i, j)] = ani

        def gen():
            r1 = 0
            while r1 < self.n:
                r0, r1 = r1, min(r1 + self.block, self.n)
                if self.fail_at_row is not None and r1 > self.fail_at_row:
                    raise RuntimeError("injected stream failure")
                inc = {}
                for r in range(r0, r1):
                    inc.update(by_row.get(r, {}))
                yield r1, inc

        return gen()


class CallsCl(TableCl):
    """TableCl keeping each batch it was given."""

    def __init__(self, table, threshold):
        super().__init__(table, threshold)
        self.calls: List[list] = []

    def calculate_ani_batch(self, pairs: Sequence[tuple]
                            ) -> List[Optional[float]]:
        self.calls.append(list(pairs))
        return super().calculate_ani_batch(pairs)


class JCallsCl(_JTableCl):
    def __init__(self, table, threshold):
        super().__init__(table, threshold)
        self.pairs_computed: List[tuple] = []

    def calculate_ani_batch(self, pairs):
        self.pairs_computed.extend(pairs)
        return super().calculate_ani_batch(pairs)


def _flags(monkeypatch, overlap="1", strategy="device", mega=None,
           cap=None, depth=None):
    """Both packages' flags, alike (None: unset)."""
    for name, value in (("GALAH_TPU_OVERLAP", overlap),
                        ("GALAH_TPU_GREEDY_STRATEGY", strategy),
                        ("GALAH_TPU_MEGAKERNEL", mega),
                        ("GALAH_TPU_QUEUE_CAP", cap),
                        ("GALAH_TPU_OVERLAP_DEPTH", depth)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, str(value))


def _port(n, pre, table, block=7, streamed=True, cl=None, **kw):
    """(clusters, counts) of the port's engine."""
    clock = StageClock(CPU)
    backend = StreamPre(pre, n, block) if streamed else TablePre(pre)
    got = tengine.cluster(g(n), backend, cl or TableCl(table, 0.95), CPU,
                          clock=clock, **kw)
    return got, {k: clock.counts.get(k, 0) for k in COUNTERS}


def _jax(n, pre, table, block=7, cl=None, **kw):
    """(clusters, counter deltas) of galah_tpu's engine."""
    before = jtiming.GLOBAL.counters()
    got = jcluster(g(n), _JStreamPre(pre, n, block),
                   cl or _JTableCl(table, 0.95), **kw)
    after = jtiming.GLOBAL.counters()
    return got, {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("workload", ["families_250x4", "dense_96"])
def test_overlapped_equals_galah_tpu(monkeypatch, workload):
    """Planted families and one dense family: the port's overlapped
    clusters and counters are galah_tpu's, its clusters and computed
    ANIs those of its own stage-serial engine."""
    if workload == "families_250x4":
        n, block = 1000, 64
        pre, table = _family_workload(250, 4, seed=11)
    else:
        n, block = 96, 5
        pre, table = _dense_workload(96, seed=3)
    _flags(monkeypatch)
    got, counts = _port(n, pre, table, block)
    want, jcounts = _jax(n, pre, table, block)
    assert got == want and counts == jcounts
    assert counts["overlap-engaged"] == 1 and counts["overlap-eager-rounds"]
    assert counts["megakernel-slab-folds"] > 0
    _flags(monkeypatch, overlap="0")
    serial, scounts = _port(n, pre, table, block)
    assert serial == got
    assert scounts["overlap-engaged"] == 0
    assert scounts["exact-ani-computed"] == counts["exact-ani-computed"]


@pytest.mark.parametrize("width", [1, 3, 8, 64, None])
def test_block_and_width_invariance(monkeypatch, width):
    """Arrival granularity and round width change batching only: every
    (block, rep_rounds) gives galah_tpu's clusters and counters."""
    pre, table = _family_workload(6, 4, seed=7)
    _flags(monkeypatch, overlap="0")
    serial, _ = _port(24, pre, table, streamed=False)
    _flags(monkeypatch)
    for block in (1, 3, 5, 24):
        got, counts = _port(24, pre, table, block, rep_rounds=width)
        want, jcounts = _jax(24, pre, table, block, rep_rounds=width)
        assert got == want == serial, (block, width)
        assert counts == jcounts, (block, width)


@pytest.mark.parametrize("case", ["late_genome", "late_rep"])
def test_frontier_and_membership_wait(monkeypatch, case):
    """A genome whose only hit edge arrives long after its partner's
    window was decided still joins that early rep; a non-rep claimed by
    an early rep goes to a later rep with the higher ANI."""
    if case == "late_genome":
        n, pre = 24, {(0, 23): 0.96}
        table = {("g0.fna", "g23.fna"): 0.97}
        block, width, want_cluster = 2, 2, [0, 23]
    else:
        n, pre = 3, {(0, 1): 0.96, (1, 2): 0.96}
        table = {("g0.fna", "g1.fna"): 0.96, ("g1.fna", "g2.fna"): 0.98}
        block, width, want_cluster = 1, 1, [2, 1]
    _flags(monkeypatch)
    got, counts = _port(n, pre, table, block, rep_rounds=width)
    want, jcounts = _jax(n, pre, table, block, rep_rounds=width)
    assert got == want and counts == jcounts
    assert want_cluster in got


def test_windows_decided_before_the_stream_ends(monkeypatch):
    """Backend batches run before the last block arrives, and one eager
    round runs a window, as in galah_tpu."""
    pre, table = _family_workload(6, 4, seed=5, none_rate=0.0)
    n = 24
    cl = CallsCl(table, 0.95)
    backend = StreamPre(pre, n, block=4)
    inner = backend.distances_streamed
    trace = []

    def traced(paths):
        for r1, inc in inner(paths):
            trace.append((r1, len(cl.calls)))
            yield r1, inc

    backend.distances_streamed = traced
    _flags(monkeypatch)
    clock = StageClock(CPU)
    got = tengine.cluster(g(n), backend, cl, CPU, clock=clock,
                          rep_rounds=4)
    want, jcounts = _jax(n, pre, table, 4, rep_rounds=4)
    assert got == want
    assert any(calls > 0 for r1, calls in trace if r1 < n)
    assert clock.counts["overlap-eager-rounds"] == n // 4 == \
        jcounts["overlap-eager-rounds"]
    assert clock.counts["overlap-spec-pairs"] > 0


def test_speculative_set_is_the_stage_serial_computed_set(monkeypatch):
    """The overlapped engine computes exactly the pairs the stage-serial
    engine computes (and galah_tpu's overlapped engine), earlier."""
    pre, table = _family_workload(30, 5, seed=23)
    n = 150
    _flags(monkeypatch)
    cl = TableCl(table, 0.95)
    _port(n, pre, table, 9, cl=cl, rep_rounds=16)
    jcl = JCallsCl(table, 0.95)
    _jax(n, pre, table, 9, cl=jcl, rep_rounds=16)
    _flags(monkeypatch, overlap="0")
    scl = TableCl(table, 0.95)
    _port(n, pre, table, streamed=False, cl=scl, rep_rounds=16)
    over = set(map(frozenset, cl.pairs_computed))
    assert over == set(map(frozenset, scl.pairs_computed)) == \
        set(map(frozenset, jcl.pairs_computed))
    assert len(cl.pairs_computed) == len(over)  # none computed twice


def test_depth_bounds_the_speculative_buffer(monkeypatch):
    pre, table = _family_workload(8, 6, seed=17, none_rate=0.0)
    n = 48
    _flags(monkeypatch, depth=4)
    tmetrics.reset()
    got, counts = _port(n, pre, table, 3, rep_rounds=6)
    peak = tmetrics.snapshot()["overlap.spec_pending_peak"]["value"]
    want, jcounts = _jax(n, pre, table, 3, rep_rounds=6)
    assert got == want and counts == jcounts
    assert 0 < peak <= 4 and counts["overlap-spec-batches"] >= 2


def test_occupancy_gauges(monkeypatch):
    """The engine's [greedy] and [fragment] gauges and the unlabelled
    mean, each in [0, 1]; the eager rounds and offered pairs as
    metrics."""
    pre, table = _family_workload(8, 4, seed=19)
    n = 32
    _flags(monkeypatch)
    tmetrics.reset()
    _port(n, pre, table, 4, rep_rounds=4)
    snap = tmetrics.snapshot()
    for name in ("workload.pipeline_occupancy[greedy]",
                 "workload.pipeline_occupancy[fragment]",
                 "workload.pipeline_occupancy"):
        v = snap[name]["value"]
        assert v is not None and 0.0 <= v <= 1.0, name
    assert snap["overlap.eager_rounds"]["value"] == n // 4
    assert snap["overlap.spec_pairs"]["value"] > 0


def test_checkpoint_record_and_a_stage_serial_resume(monkeypatch,
                                                     tmp_path):
    """A run stopped at greedy-round-saved leaves ONE greedy-round
    record, byte for byte galah_tpu's; the resume is stage-serial,
    replays it with no pair computed twice, gives the clusters of an
    uninterrupted run and clears the log; an uninterrupted
    checkpointed run clears it too."""
    from galah_tpu.resilience import interrupt as jinterrupt

    pre, table = _family_workload(10, 4, seed=9, none_rate=0.0)
    n = 40
    _flags(monkeypatch, overlap="0")
    serial, _ = _port(n, pre, table, streamed=False)
    _flags(monkeypatch)
    fields = (g(n), "stub-pre", "stub-exact", 0.95, 0.9)
    cl = TableCl(table, 0.95)
    for side, intr, ck in (
            ("port", interrupt,
             ClusterCheckpoint(str(tmp_path / "port"),
                               run_fingerprint(*fields))),
            ("jax", jinterrupt,
             JCheckpoint(str(tmp_path / "jax"), jfingerprint(*fields)))):
        saved = ck.save_greedy_round

        def save_then_stop(digest, pairs, _saved=saved, _intr=intr):
            _saved(digest, pairs)
            _intr.request_stop()

        monkeypatch.setattr(ck, "save_greedy_round", save_then_stop)
        intr.reset()
        try:
            with pytest.raises(intr.PreemptionRequested):
                if side == "port":
                    _port(n, pre, table, 6, cl=cl, checkpoint=ck)
                else:
                    _jax(n, pre, table, 6, checkpoint=ck)
        finally:
            intr.reset()
    logs = [(tmp_path / side / "greedy_rounds.jsonl").read_bytes()
            for side in ("port", "jax")]
    assert logs[0] == logs[1] and logs[0].count(b"\n") == 1
    first = set(map(frozenset, cl.pairs_computed))
    fp = run_fingerprint(*fields)
    cl2 = TableCl(table, 0.95)
    clock = StageClock(CPU)
    out = tengine.cluster(g(n), TablePre(pre), cl2, CPU, clock=clock,
                          checkpoint=ClusterCheckpoint(str(tmp_path / "port"),
                                                       fp))
    assert out == serial
    assert clock.counts["greedy-replayed-pairs"] == len(first) > 0
    assert clock.counts.get("overlap-engaged", 0) == 0
    assert not first & set(map(frozenset, cl2.pairs_computed))
    assert not (tmp_path / "port" / "greedy_rounds.jsonl").exists()
    ck = ClusterCheckpoint(str(tmp_path / "whole"), fp)
    got, counts = _port(n, pre, table, 6, checkpoint=ck)
    assert got == serial and counts["overlap-engaged"] == 1
    assert not (tmp_path / "whole" / "greedy_rounds.jsonl").exists()


@pytest.mark.parametrize("case", ["no_stream", "host_overlap",
                                  "host_megakernel"])
def test_forced_modes_raise_when_ineligible(monkeypatch, case):
    pre, table = _family_workload(2, 3, seed=1)
    if case == "no_stream":
        _flags(monkeypatch)
        match, backend = "did not engage", TablePre(pre)
    elif case == "host_overlap":
        _flags(monkeypatch, strategy="host")
        match, backend = "device greedy", StreamPre(pre, 6)
    else:
        _flags(monkeypatch, overlap="auto", strategy="host", mega="1")
        match, backend = "device greedy strategy", StreamPre(pre, 6)
    with pytest.raises(RuntimeError, match=match):
        tengine.cluster(g(6), backend, TableCl(table, 0.95), CPU)
    with pytest.raises(RuntimeError, match=match):
        jcluster(g(6), _JStreamPre(pre, 6, 7) if case != "no_stream"
                 else _JPlain(pre), _JTableCl(table, 0.95))


class _JPlain(_JStreamPre):
    def __init__(self, pre):
        super().__init__(pre, 0, 1)

    distances_streamed = None


def test_auto_routes_ineligible_runs_stage_serial(monkeypatch):
    """Under auto, a precluster without a stream and the host strategy
    take the stage-serial engine before any work, with the same
    clusters."""
    pre, table = _family_workload(6, 4, seed=13)
    _flags(monkeypatch, overlap="auto")
    got, counts = _port(24, pre, table, streamed=False)
    _flags(monkeypatch, overlap="auto", strategy="host")
    host, hcounts = _port(24, pre, table)
    assert got == host
    assert counts["overlap-engaged"] == hcounts["overlap-engaged"] == 0


@pytest.mark.parametrize("where", ["stream", "slab_fold"])
def test_a_failure_raises_under_auto(monkeypatch, where):
    """galah_tpu under auto demotes a failed overlapped run or slab fold
    to a slower route; the port raises, as under 1."""
    pre, table = _family_workload(6, 4, seed=13)
    _flags(monkeypatch, overlap="auto", mega="auto")
    if where == "stream":
        backend = StreamPre(pre, 24, block=4, fail_at_row=10)
        err = "injected stream failure"
    else:
        def boom(*a, **k):
            raise ValueError("injected fold failure")

        monkeypatch.setattr(tmk, "slab_select", boom)
        backend, err = StreamPre(pre, 24, block=24), "injected fold failure"
    with pytest.raises((RuntimeError, ValueError), match=err):
        tengine.cluster(g(24), backend, TableCl(table, 0.95), CPU,
                        rep_rounds=4)


@pytest.mark.parametrize("cap", [8, 16, 64, 4096])
def test_queue_capacity_sweep(monkeypatch, cap):
    """At any capacity the slab folds give the clusters and the counters
    of galah_tpu; a slab that does not fit spills to the dense fold."""
    pre, table = _family_workload(12, 4, seed=21)
    n = 48
    _flags(monkeypatch, overlap="0", mega="0")
    ref, _ = _port(n, pre, table, streamed=False)
    _flags(monkeypatch, mega="auto", cap=cap)
    for block, width in ((5, 4), (48, 16), (48, 4)):
        got, counts = _port(n, pre, table, block, rep_rounds=width)
        want, jcounts = _jax(n, pre, table, block, rep_rounds=width)
        assert got == want == ref and counts == jcounts, (block, width)
        assert counts["megakernel-slab-folds"] \
            + counts["megakernel-overflow-spills"] > 0
        if cap == 8 and (block, width) == (48, 16):
            assert counts["megakernel-overflow-spills"] > 0


def test_slabs_cut_greedy_select_dispatches_4x(monkeypatch):
    pre, table = _family_workload(64, 4, seed=33)
    n = 256
    _flags(monkeypatch, mega="0")
    off, c_off = _port(n, pre, table, n, rep_rounds=4)
    _flags(monkeypatch, mega="auto")
    on, c_on = _port(n, pre, table, n, rep_rounds=4)
    want, jcounts = _jax(n, pre, table, n, rep_rounds=4)
    assert off == on == want and c_on == jcounts
    d_off, d_on = (c["greedy-select-dispatches"] for c in (c_off, c_on))
    assert d_on > 0 and d_off >= 4 * d_on, (d_off, d_on)


def test_megakernel_pinned_in_stage_serial_rounds(monkeypatch):
    """GALAH_TPU_MEGAKERNEL=1 fuses the stage-serial rounds too."""
    pre, table = _family_workload(10, 4, seed=9)
    _flags(monkeypatch, overlap="0", mega="1", cap=16)
    got, counts = _port(40, pre, table, streamed=False, rep_rounds=4)
    before = jtiming.GLOBAL.counters()
    want = jcluster(g(40), _JStreamPre(pre, 40, 7),
                    _JTableCl(table, 0.95), rep_rounds=4)
    after = jtiming.GLOBAL.counters()
    assert got == want
    for k in ("megakernel-slab-folds", "greedy-select-dispatches",
              "exact-ani-computed"):
        assert counts[k] == after.get(k, 0) - before.get(k, 0), k
    assert counts["megakernel-slab-folds"] > 0


def _host_workload():
    """Small families (the dense warm pass) and one family of 80 past
    DENSE_PRECLUSTER_CAP (the windowed scan)."""
    pre, table = _family_workload(10, 4, seed=41)
    rng = np.random.default_rng(42)
    for a in range(40, 120):
        for b in range(a + 1, 120):
            if rng.random() < 0.3:
                pre[(a, b)] = 0.96
                table[(f"g{a}.fna", f"g{b}.fna")] = round(
                    float(rng.uniform(0.90, 0.99)), 6)
    return 120, pre, table


@pytest.mark.parametrize("window", [1, 7, 128])
def test_host_strategy_equals_galah_tpu(monkeypatch, window):
    n, pre, table = _host_workload()
    _flags(monkeypatch, overlap="auto", strategy="host")
    got, counts = _port(n, pre, table, rep_scan_window=window)
    want, jcounts = _jax(n, pre, table, rep_scan_window=window)
    assert got == want
    assert {k: counts[k] for k in WASTE} == {k: jcounts[k] for k in WASTE}
    assert counts["exact-ani-wasted-warm"] > 0
    _flags(monkeypatch, overlap="0")
    device, _ = _port(n, pre, table, streamed=False)
    assert device == got


def test_host_scan_window_must_be_positive(monkeypatch):
    n, pre, table = _host_workload()
    _flags(monkeypatch, overlap="auto", strategy="host")
    with pytest.raises(ValueError, match="rep_scan_window must be >= 1"):
        _port(n, pre, table, rep_scan_window=0)


@pytest.mark.parametrize("block", [16, 64])
def test_streamed_pair_sequence_equals_galah_tpu(block):
    """iter_threshold_pairs_streamed's (r1, increment) sequence is
    galah_tpu's, block for block."""
    n, k = 100, 256
    mat = _sketches(3, n, k)
    clock = StageClock(CPU)
    got = list(iter_threshold_pairs_streamed(
        _blocks(mat, block, True), n, 21, 0.9, k, clock, block=block))
    want = list(jiter_streamed(_blocks(mat, block, False), n, 21, 0.9, k,
                               mesh=None, block=block))
    assert got == want
    assert [r1 for r1, _ in got] == [min(n, b + block)
                                     for b in range(0, n, block)]
    assert clock.counts["pairs-streamed-stripes"] == len(got)


@pytest.fixture
def root_logger():
    """main() replaces the root handlers; put them back after."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield root
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.fixture(scope="module")
def families30(tmp_path_factory):
    """30 genomes: 10 families x 3 members, 30 kb, ~2% divergence."""
    return _families(tmp_path_factory.mktemp("overlap30"), 17, 10, 3, 30_000,
                     0.02)


def test_finch_cli_on_the_overlapped_route(families30, monkeypatch,
                                           tmp_path):
    """`--precluster-method finch --rep-rounds 4`, streamed in blocks of
    8 rows: the overlapped engine with slab folds writes galah_tpu's
    TSV and the stage-serial run's, with the same exact ANIs."""
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    monkeypatch.setattr(sketch_stream, "ROW_BLOCK", 8)
    paths, _ = families30
    common = ["cluster", "-f", *paths, "--ani", "97", "--precluster-ani",
              "90", "--precluster-method", "finch", "--rep-rounds", "4"]
    want = tmp_path / "jax.tsv"
    assert jmain([*common, "--output-cluster-definition", str(want)]) == 0
    runs = {}
    for mode in ("auto", "0"):
        _flags(monkeypatch, overlap=mode, strategy=None)
        out = tmp_path / f"port_{mode}.tsv"
        runs[mode] = tcli.run_cluster(tcli.parse_args(
            [*common, "--threads", "2", "--device", "cpu",
             "--output-cluster-definition", str(out)])).clock.counts
        assert out.read_bytes() == want.read_bytes(), mode
    over, serial = runs["auto"], runs["0"]
    assert over["overlap-engaged"] == 1 and "overlap-engaged" not in serial
    assert over["overlap-eager-rounds"] == -(-len(paths) // 4)
    assert over["megakernel-slab-folds"] >= 1
    assert over["pairs-streamed-stripes"] == serial[
        "pairs-streamed-stripes"] == 4
    assert over["exact-ani-computed"] == serial["exact-ani-computed"] > 0


def test_overlapped_finch_reports_galah_tpus_gauges_and_counters(
        families30, monkeypatch, tmp_path, root_logger):
    """Both packages' finch runs on the overlapped route (galah_tpu's
    needs its device sketch strategy to stream) report the same
    occupancy gauges, [greedy] and [fragment] among them, and the same
    overlap and exact-ANI counters."""
    import functools
    import json

    from galah_tpu.ops import sketch_stream as jstream

    # blocks of 8 rows in both streams
    monkeypatch.setattr(sketch_stream, "ROW_BLOCK", 8)
    monkeypatch.setattr(jstream, "iter_sketch_row_blocks", functools.partial(
        jstream.iter_sketch_row_blocks, block=8))
    # galah_tpu's flag, for its side: its CPU C sketcher does not stream
    monkeypatch.setenv("GALAH_TPU_SKETCH_STRATEGY", "xla")  # galah-lint: ignore[GL401] galah_tpu's flag, for its side
    _flags(monkeypatch)
    paths, _ = families30
    argv = ["cluster", "-f", *paths, "--ani", "97", "--precluster-ani",
            "90", "--precluster-method", "finch", "--rep-rounds", "4", "-q"]
    reps = {}
    for side, main, extra in (("jax", jmain, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        assert main([*argv, *extra, "--run-report", str(d / "r.json"),
                     "--output-cluster-definition", str(d / "c.tsv")]) == 0
        reps[side] = json.loads((d / "r.json").read_text())
    assert (tmp_path / "port" / "c.tsv").read_bytes() == \
        (tmp_path / "jax" / "c.tsv").read_bytes()
    gauges = {side: sorted(k for k in rep["metrics"]
                           if k.startswith("workload.pipeline_occupancy"))
              for side, rep in reps.items()}
    assert gauges["port"] == gauges["jax"]
    assert {"workload.pipeline_occupancy[greedy]",
            "workload.pipeline_occupancy[fragment]"} <= set(gauges["port"])
    for key in ("overlap-engaged", "overlap-eager-rounds",
                "overlap-spec-pairs", "exact-ani-computed",
                "megakernel-slab-folds"):
        assert reps["port"]["counters"].get(key) == \
            reps["jax"]["counters"].get(key), key
    assert reps["port"]["counters"]["overlap-engaged"] == 1
