"""The port's per-kernel device costs (galah_tpu_torch/obs/profile.py,
kernels/costs.py): the analytic bytes and operations against hand
reckonings at PERF.md's shapes and against chip_smoke.py's and
rehearse_pairlist's formulas; the event pool and the roofline shares
with a stand-in CUDA runtime; CPU runs whose reports carry
``device_costs`` that galah_tpu validates, renders and diffs;
``GALAH_OBS_PROFILE=0``; the nvcc charge; and ``--profile-trace-dir`` on
the CPU.

Tolerance: none (integer arithmetic in float64, equal bytes).
"""

import json
import logging
import math
import stat
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import chip_smoke
from galah_tpu.obs import report as jreport
from galah_tpu_torch import cli as tcli
from galah_tpu_torch import obs as tobs
from galah_tpu_torch.kernels import build as kbuild
from galah_tpu_torch.kernels import costs
from galah_tpu_torch.kernels import rehearse_pairlist
from galah_tpu_torch.obs import profile as tprofile
from galah_tpu_torch.ops.pairlist import pair_stats_pairs
from test_torch_cluster import _families

H100 = "NVIDIA H100 80GB HBM3"


# -- the formulas ----------------------------------------------------------


def test_costs_equal_hand_reckonings_at_perf_md_shapes():
    """PERF.md's kernel table: tile_stats intersect at 64 x 512, K =
    2176; hll_union at 64 x 1024, m = 4096 (bound 0.0160 ms, operations);
    murmur3_k21 over 16 genomes of 2 Mbp (0.0860 ms, bytes);
    positional_hashes over 8 of them (0.0430 ms, bytes); fused_sketch
    k = 21 over 16 genomes (0.0859 ms at the valid windows)."""
    assert costs.tile_stats(64, 512, 2176) == (
        8 * 2176 * 576 + 8 * 64 * 512, 4 * 64 * 512 * 2176)
    assert costs.tile_stats(64, 512, 2176) == (10_289_152.0, 285_212_672.0)
    b, f = costs.hll_union(64, 1024, 4096)
    assert (b, f) == (4096 * 1088 + 8 * 65_536, 4 * 65_536 * 4096)
    assert round(f / 67e12 * 1e3, 4) == 0.0160
    n = 32_000_000 - 20
    b, f = costs.window_hashes(n, 21, 16, costs.MURMUR3_K21_OPS_PER_WINDOW)
    assert (b, f) == (32_000_000 + 8 * 16 + 8 * n, 170 * n)
    assert round(b / 3.35e12 * 1e3, 4) == 0.0860
    n = 16_000_000 - 14
    b, f = costs.window_hashes(n, 15, 8, costs.K15_OPS_PER_WINDOW["murmur3"])
    assert (b, f) == (16_000_000 + 8 * 8 + 8 * n, 202 * n)
    assert round(b / 3.35e12 * 1e3, 4) == 0.0430
    jobs = [(g * 2_000_000, 2_000_000 - 20) for g in range(16)]
    b, f = costs.fused_sketch(32_000_000, 16, sum(n for _, n in jobs),
                              len(jobs), 21, "murmur3")
    assert b == 32_000_000 + 8 * 16 + 16 * (16 + 8 * 2048 * 8)
    assert f == 180 * (32_000_000 - 320)
    assert round(f / 67e12 * 1e3, 3) == 0.086
    assert costs.fused_sketch(100, 1, 80, 1, 21, "tpufast")[1] == 70 * 80
    assert costs.window_hashes(0, 21, 3, 170) == (0.0, 0.0)


def test_costs_share_chip_smokes_constants():
    assert costs.MURMUR3_K21_OPS_PER_WINDOW == \
        chip_smoke.MURMUR3_OPS_PER_WINDOW
    assert costs.K15_OPS_PER_WINDOW == chip_smoke.K15_OPS_PER_WINDOW
    assert costs.HLL_UNION_OPS_PER_REGISTER == \
        chip_smoke.HLL_UNION_OPS_PER_REGISTER
    assert costs.FUSED_OPS_PER_WINDOW_TPUFAST == \
        chip_smoke.FUSED_OPS_PER_WINDOW["tpufast"]
    for k in range(1, 33):
        assert costs.fused_murmur3_ops(k) == chip_smoke.fused_murmur3_ops(k)
    assert costs.fused_murmur3_ops(21) == \
        chip_smoke.FUSED_OPS_PER_WINDOW["murmur3"]


@pytest.mark.parametrize("seed", range(3))
def test_window_hits_cost_is_chip_smokes_reckoning(seed):
    """Each distinct array read once (shared references counted once),
    a flag a query element, two operations a binary-search step."""
    rng = np.random.default_rng(seed)
    arrays = [torch.zeros(int(rng.integers(0, 5000)), dtype=torch.int64)
              for _ in range(6)]
    items = [(arrays[int(rng.integers(0, 6))], arrays[int(rng.integers(0, 6))])
             for _ in range(20)]
    uq = {q.data_ptr(): q.numel() for q, _ in items}
    ur = {r.data_ptr(): r.numel() for _, r in items}
    n_elem = sum(q.numel() for q, _ in items)
    want = (8 * (sum(uq.values()) + sum(ur.values())) + 4 * n_elem,
            2 * sum(q.numel() * math.ceil(math.log2(r.numel() + 1))
                    for q, r in items))
    from galah_tpu_torch.ops.window_hits import _cost

    assert _cost(items) == want


@pytest.mark.parametrize("seed", range(3))
def test_pairlist_cost_is_rehearse_pairlists_work(seed, fresh_profile):
    """The wrapper's deferred counts (device scalars, read at snapshot)
    equal ``rehearse_pairlist.work`` over the same list and results."""
    rng = np.random.default_rng(seed)
    n, k = 40, 64
    mat = np.sort(rng.integers(-2**62, 2**62, size=(n, k)), axis=1)
    mat[:, k - int(rng.integers(0, 20)):] = np.iinfo(np.int64).max
    mat_t = torch.from_numpy(mat)
    pi = rng.integers(0, n, size=300)
    pj = rng.integers(0, n, size=300)
    common, total = pair_stats_pairs(mat_t, torch.from_numpy(pi),
                                     torch.from_numpy(pj), k)
    want = rehearse_pairlist.work(pi, pj, k, common.numpy(), total.numpy())
    e = tprofile.snapshot(torch.device("cpu"))["entries"]["pairlist"]
    assert (e["bytes_accessed"], e["flops"]) == want
    assert e["plain_calls"] == 1 and e["calls"] == 0
    assert e["device_s"] is None and e["bandwidth_utilization"] is None


# -- the event pool, with a stand-in CUDA runtime --------------------------


class _FakeEvent:
    clock = [0.0]

    def __init__(self, enable_timing=False):
        self.t = None
        self.done = False

    def record(self, stream=None):
        _FakeEvent.clock[0] += 1.0  # a millisecond a record
        self.t = _FakeEvent.clock[0]

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fresh_profile():
    tprofile.reset()
    yield
    tprofile.reset()


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda as far as obs/profile.py uses it: events on a clock of
    a millisecond a record, a synchronize that finishes them all, the
    allocator's peak, the card's name."""
    made = []
    syncs = []

    def event(enable_timing=False):
        ev = _FakeEvent(enable_timing)
        made.append(ev)
        return ev

    @contextmanager
    def device(_d):
        yield

    def synchronize(d=None):
        syncs.append(d)
        for ev in made:
            ev.done = True

    _FakeEvent.clock[0] = 0.0
    for name, value in (("Event", event), ("device", device),
                        ("synchronize", synchronize),
                        ("current_stream", lambda d=None: "stream"),
                        ("is_initialized", lambda: True),
                        ("current_device", lambda: 0),
                        ("get_device_name", lambda d=None: H100),
                        ("memory_stats", lambda d=None: {
                            "allocated_bytes.all.peak": 4096 + len(made)}),
                        ("reset_peak_memory_stats", lambda d=None: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    return made, syncs


def test_events_poll_without_waiting_and_resolve_at_snapshot(
        fake_cuda, fresh_profile, monkeypatch):
    made, syncs = fake_cuda
    monkeypatch.setattr(tprofile, "PENDING_POOL", 4)
    pf = tprofile.profiled("tile_stats")
    dev = torch.device("cuda", 0)
    for i in range(10):
        with pf.launch(dev, ("int64", 64, 512, 2176, i % 2),
                       lambda: costs.tile_stats(64, 512, 2176)):
            pass
        if i == 5:
            made[1].done = made[3].done = True  # the first two pairs end
    assert syncs == [] and pf.calls == 10 and pf.signatures == {
        ("int64", 64, 512, 2176, 0), ("int64", 64, 512, 2176, 1)}
    assert pf.device_s == pytest.approx(2e-3)  # polled, no wait
    assert len(pf._pending) == 8
    snap = tprofile.snapshot(dev)
    assert syncs == [dev]
    e = snap["entries"]["tile_stats"]
    assert e["device_s"] == pytest.approx(10e-3)
    b, f = costs.tile_stats(64, 512, 2176)
    assert (e["bytes_accessed"], e["flops"]) == (10 * b, 10 * f)
    assert e["achieved_bytes_per_s"] == pytest.approx(10 * b / 10e-3)
    assert e["bandwidth_utilization"] == pytest.approx(
        10 * b / 10e-3 / 3.35e12)
    assert e["flops_utilization"] == pytest.approx(10 * f / 10e-3 / 67e12)
    assert snap["peaks"] == {"device_kind": H100, "peak_flops_per_s": 67e12,
                             "peak_bytes_per_s": 3.35e12}
    assert snap["hbm"]["source"] == "memory_stats"
    assert snap["hbm"]["peak_bytes"] >= 4096


def test_a_launch_that_raises_is_not_counted(fake_cuda, fresh_profile):
    pf = tprofile.profiled("window_hits")
    with pytest.raises(RuntimeError):
        with pf.launch(torch.device("cuda"), ("int64", 1),
                       lambda: (1.0, 1.0)):
            raise RuntimeError("cudaError_t 2")
    assert pf.calls == 0 and not pf._pending


def test_profile_off_is_a_pass_through(fresh_profile, monkeypatch):
    """GALAH_OBS_PROFILE=0: the body runs (the kernel launches), no
    event is made, nothing is counted."""
    monkeypatch.setenv("GALAH_OBS_PROFILE", "0")

    def no_events(*a, **k):
        raise AssertionError("an event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_events)
    pf = tprofile.profiled("hll_union")
    ran = []
    with pf.launch(torch.device("cuda"), ("uint8", 1, 1, 16),
                   lambda: (1.0, 1.0)):
        ran.append(1)
    pf.plain_call(("uint8",), lambda: (1.0, 1.0))
    assert ran == [1] and pf.calls == pf.plain_calls == 0
    snap = tprofile.snapshot(torch.device("cpu"))
    assert snap["profiling_enabled"] is False and snap["entries"] == {}


def test_an_nvcc_build_is_charged_to_its_kernel(tmp_path, monkeypatch,
                                                fresh_profile):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nsleep 0.05\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi; shift\n"
                    "done\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(kbuild, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kbuild, "_lib_path",
                        lambda name: str(tmp_path / "build" / f"{name}.so"))
    kbuild.build(["murmur3_k21"])
    kbuild.build(["murmur3_k21"])  # built: no second charge
    entries = tprofile.snapshot(torch.device("cpu"))["entries"]
    assert set(entries) == {"murmur3_k21"}
    e = entries["murmur3_k21"]
    assert 0.05 <= e["compile_wall_s"] < 5 and e["calls"] == 0


# -- whole CPU runs ----------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_runs(tmp_path_factory):
    """The port's skani and finch runs on 24 genomes, with a report;
    finch also with GALAH_OBS_PROFILE=0 and with --profile-trace-dir."""
    root = tmp_path_factory.mktemp("profile_runs")
    paths, _ = _families(root, 7, 8, 3, 30_000, 0.02)
    runs = {"skani": ([], {}), "finch": (["--precluster-method", "finch"],
                                         {}),
            "finch-off": (["--precluster-method", "finch"],
                          {"GALAH_OBS_PROFILE": "0"}),
            "finch-trace": (["--precluster-method", "finch",
                             "--profile-trace-dir", str(root / "trace")],
                            {})}
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for what, (flags, env) in runs.items():
            for k, v in env.items():
                mp.setenv(k, v)
            d = root / what
            d.mkdir()
            assert tcli.main(["cluster", "-f", *paths, "--device", "cpu",
                              *flags, "--run-report", str(d / "r.json"),
                              "--output-cluster-definition",
                              str(d / "c.tsv")]) == 0
            mp.undo()
            out[what] = d
    finally:
        mp.undo()
        log.handlers[:] = handlers
        log.setLevel(level)
    out["trace"] = root / "trace"
    return out


def _rep(d):
    return json.loads((d / "r.json").read_text())


@pytest.mark.parametrize("what,kernels", [
    ("skani", {"tile_stats", "window_hits", "positional_hashes"}),
    # finch takes the overlapped route, whose slabs fold in slab_fold
    ("finch", {"tile_stats", "window_hits", "positional_hashes",
               "fused_sketch", "slab_fold"})])
def test_cpu_report_counts_plain_calls(cpu_runs, what, kernels):
    rep = _rep(cpu_runs[what])
    dc = rep["device_costs"]
    assert dc["profiling_enabled"] is True
    assert set(dc["entries"]) == kernels
    assert rep["dispatch"]["dispatches"] == {}
    for e in dc["entries"].values():
        assert e["calls"] == 0 and e["plain_calls"] >= 1
        assert e["flops"] > 0 and e["bytes_accessed"] > 0
        assert e["device_s"] is None and e["bandwidth_utilization"] is None
    assert dc["peaks"] == {"device_kind": "cpu", "peak_flops_per_s": None,
                           "peak_bytes_per_s": None}
    assert dc["hbm"]["peak_bytes"] is None
    if what == "finch":
        stripes = rep["counters"]["pairs-streamed-stripes"]
        assert dc["entries"]["tile_stats"]["plain_calls"] == stripes


@pytest.mark.parametrize("what", ["skani", "finch"])
def test_cpu_report_validates_renders_and_diffs_in_galah_tpu(cpu_runs,
                                                             what):
    rep = _rep(cpu_runs[what])
    assert jreport.validate(rep) == []
    page = jreport.render(rep)
    assert "device costs (profiled entry points):" in page
    assert "flow critical path" in page or what == "skani"
    other = _rep(cpu_runs["finch-off"])
    diff = jreport.diff(rep, other)
    assert diff.startswith("run report diff:")


def test_profile_off_keeps_the_tsv_and_empties_the_section(cpu_runs):
    on, off = cpu_runs["finch"], cpu_runs["finch-off"]
    assert (on / "c.tsv").read_bytes() == (off / "c.tsv").read_bytes()
    dc = _rep(off)["device_costs"]
    assert dc["profiling_enabled"] is False and dc["entries"] == {}


def test_profile_trace_dir_on_the_cpu(cpu_runs):
    """One *.pt.trace.json that json.load reads, holding the run's host
    ops; the TSV is the unprofiled run's."""
    files = sorted(cpu_runs["trace"].iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(ev.get("cat") == "cpu_op" for ev in events)
    assert (cpu_runs["finch-trace"] / "c.tsv").read_bytes() == \
        (cpu_runs["finch"] / "c.tsv").read_bytes()


def test_reset_run_clears_the_entries(fresh_profile):
    tprofile.profiled("tile_stats").plain_call(
        ("int64",), lambda: costs.tile_stats(1, 1, 1))
    assert tprofile.snapshot(torch.device("cpu"))["entries"]
    tobs.reset_run()
    assert tprofile.snapshot(torch.device("cpu"))["entries"] == {}
