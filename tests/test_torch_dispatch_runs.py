"""Whole `cluster` runs of the port and of galah_tpu on the CPU under the
same GALAH_FI dispatch faults: one fault of each kind at each guarded
site both packages share (prob=1;max=1) is retried once, and the TSVs
are byte-equal. When the retries run out, galah_tpu demotes the site to
its fallback; the port raises, naming the site, and a --resume without
faults writes the same TSV.

The runs take galah_tpu's routes that reach its guarded sites on the
CPU: its collision screen at any size (``collision.SPARSE_SCREEN_MIN_N``
at 0 in both packages, ROADMAP's ground rules), its ``xla`` sketch
strategy (the only one it guards) and its batched HLL sketch
(``GALAH_PACKED_TRANSFER=1``), with both packages' HLL bucketing and
ingest prefilter off; its dashing pair pass is pinned to the XLA form.

Tolerance: none. TSVs are compared byte for byte, retry counts exactly.
"""

import json
import logging
import threading

import numpy as np
import pytest

from galah_tpu.cli import main as jmain
from galah_tpu.ops import collision as jcollision
from galah_tpu.ops import hll as jhll
from galah_tpu.resilience import dispatch as jdispatch
from galah_tpu.resilience import faults as jfaults
from galah_tpu.resilience import policy as jpolicy
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.ops import collision as tcollision
from galah_tpu_torch.resilience import dispatch as tdispatch
from galah_tpu_torch.resilience import faults as tfaults
from galah_tpu_torch.resilience.policy import TransientDispatchError

pytestmark = pytest.mark.fault_injection

#: each shared site, with the precluster method whose run reaches it
SITES = {
    "dispatch.ani": "finch",
    "dispatch.sketch-minhash": "finch",
    "dispatch.fragment-ani": "skani",
    "dispatch.sketch-hll": "dashing",
}
KINDS = ("raise", "device-lost", "garbage", "hang")
#: the attempt deadline of the hang cases, seconds, for each package:
#: it holds every dispatch of the run, so it stays well above a loaded
#: CPU's longest (the port's plain versions take a few seconds there,
#: galah_tpu's XLA tenths)
HANG_DEADLINE_S = {"port": 10.0, "jax": 3.0}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 families x 3 members, 40 kb, ~1% divergence."""
    root = tmp_path_factory.mktemp("dispatch_corpus")
    rng = np.random.default_rng(17)
    paths = []
    for fam in range(3):
        base = rng.integers(0, 4, size=40_000)
        for m in range(3):
            codes = base.copy()
            sites = rng.random(40_000) < 0.01
            codes[sites] = (codes[sites] + 1) % 4
            p = root / f"fam{fam}_m{m}.fna"
            p.write_text(">c\n" + "".join("ACGT"[c] for c in codes) + "\n")
            paths.append(str(p))
    return paths


def _pinned_hll(orig):
    def pinned(regs_mat, k, min_ani, **kw):
        return orig(regs_mat, k=k, min_ani=min_ani, use_pallas=False, **kw)
    return pinned


def _set_routes(mp):
    mp.setattr(jcollision, "SPARSE_SCREEN_MIN_N", 0)
    mp.setattr(tcollision, "SPARSE_SCREEN_MIN_N", 0)
    mp.setattr(jhll, "hll_threshold_pairs",
               _pinned_hll(jhll.hll_threshold_pairs))
    mp.setenv("GALAH_TPU_HLL_BUCKETS", "0")
    mp.setenv("GALAH_TPU_PREFILTER", "0")
    mp.setenv("GALAH_TPU_SKETCH_STRATEGY", "xla")  # galah-lint: ignore[GL401] galah_tpu's flag, for its side
    mp.setenv("GALAH_PACKED_TRANSFER", "1")  # galah-lint: ignore[GL401] galah_tpu's flag, for its side
    mp.setenv("GALAH_RETRY_BASE_DELAY", "0.01")
    mp.setenv("GALAH_RETRY_SEED", "1")


@pytest.fixture
def routes(monkeypatch):
    _set_routes(monkeypatch)
    yield monkeypatch
    for mod in (tfaults, jfaults):
        mod.reset()
    tdispatch.reset()
    # galah_tpu's supervisor read the environment when it was made, and
    # may hold a demotion: a fresh one with the default policy
    jdispatch.reset(jpolicy.RetryPolicy())


def _arm(mp, fi=None, deadline=None):
    """GALAH_FI (None: none) and the attempt deadline for the next runs
    of both packages, re-read by each."""
    for name, value in (("GALAH_FI", fi),
                        ("GALAH_RETRY_ATTEMPT_DEADLINE", deadline)):
        if value is None:
            mp.delenv(name, raising=False)
        else:
            mp.setenv(name, value)
    tfaults.reset()
    jfaults.reset()
    jdispatch.reset()  # galah_tpu reads GALAH_RETRY when it is made


def _argv(paths, method, out, report, *extra):
    return ["cluster", "-f", *paths, "--precluster-method", method,
            "--cluster-method", "skani", "--ani", "95",
            "--output-cluster-definition", str(out),
            "--run-report", str(report), *extra]


def _run(side, argv):
    """`argv` through `side`'s main, the root logger put back after
    (main replaces its handlers); the exit status."""
    log = logging.getLogger()
    handlers, level = log.handlers[:], log.level
    try:
        if side == "port":
            return tcli.main([*argv, "--device", "cpu"])
        return jmain(argv)
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)


def _resilience(report):
    with open(report) as fh:
        return json.load(fh)["resilience"]


@pytest.fixture(scope="module")
def baselines(corpus, tmp_path_factory):
    """Each method's TSV without faults, equal in both packages on the
    faulted runs' routes. These runs also compile galah_tpu's dispatches
    once, so that no compile runs inside a faulted run's attempt
    deadline."""
    root = tmp_path_factory.mktemp("dispatch_base")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _set_routes(mp)
        _arm(mp)
        for method in sorted(set(SITES.values())):
            got = []
            for side in ("port", "jax"):
                tsv = root / f"{method}_{side}.tsv"
                rep = root / f"{method}_{side}.json"
                assert _run(side, _argv(corpus, method, tsv, rep)) == 0
                got.append(tsv.read_bytes())
                res = _resilience(rep)
                assert (res["retries"], res["demotions"]) == ({}, [])
            assert got[0] == got[1]
            out[method] = got[0]
    jdispatch.reset(jpolicy.RetryPolicy())
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("site", list(SITES))
def test_one_fault_is_retried_once_and_tsvs_equal(corpus, baselines, routes,
                                                  tmp_path, site, kind):
    fi = f"site={site};kind={kind};prob=1;max=1"
    _arm(routes, None if kind == "hang" else fi)
    method = SITES[site]
    got = {}
    for side, mod in (("port", tfaults), ("jax", jfaults)):
        release = threading.Event()
        if kind == "hang":
            routes.setenv("GALAH_RETRY_ATTEMPT_DEADLINE",
                          str(HANG_DEADLINE_S[side]))
            jdispatch.reset()  # galah_tpu reads GALAH_RETRY when made
            # the hang holds its attempt until this side's run is over:
            # galah_tpu's abandoned attempt then dispatches (the port's
            # returns without dispatching), never beside the run's or a
            # later test's JAX calls
            mod.install(mod.FaultInjector(
                mod.parse_spec(fi), sleep=lambda _s, e=release: e.wait()))
        tsv, rep = tmp_path / f"{side}.tsv", tmp_path / f"{side}.json"
        try:
            assert _run(side, _argv(corpus, method, tsv, rep)) == 0, side
        finally:
            release.set()
            for t in threading.enumerate():
                if t.name == "galah-attempt":
                    t.join(timeout=120)
        got[side] = (tsv.read_bytes(), _resilience(rep))
    assert got["port"][0] == got["jax"][0] == baselines[method]
    assert got["port"][1]["retries"] == {site: 1}
    assert got["port"][1]["demotions"] == []
    assert got["jax"][1]["retries"] == {site: 1}
    assert got["jax"][1]["demotions"] == []


def test_nested_hang_retries_dispatch_ani_and_never_dispatches_late(
        corpus, baselines, routes, tmp_path, monkeypatch):
    """A hang at dispatch.fragment-ani under a deadline, on the finch
    route, where that site's first call runs inside dispatch.ani's
    attempt: the port retries the enclosing dispatch.ani attempt, as
    galah_tpu does, and writes the TSV that both packages write without
    faults. Its abandoned thread never calls the nested site's primary,
    during the run or after the hang ends: the primary's calls are the
    same once every attempt thread has ended.

    galah_tpu is not run under this fault here: its abandoned thread
    retries the nested call at once, beside the run's own JAX calls,
    and a loaded CPU then takes its attempts past the deadline again
    and again until XLA aborts the process."""
    from galah_tpu_torch.backends import fragment_backend

    calls = []
    orig = fragment_backend.fragment_ani.bidirectional_ani_values

    def counting(*args, **kw):
        calls.append(threading.current_thread().name)
        return orig(*args, **kw)

    monkeypatch.setattr(fragment_backend.fragment_ani,
                        "bidirectional_ani_values", counting)
    _arm(routes, deadline=str(HANG_DEADLINE_S["port"]))
    release = threading.Event()
    tfaults.install(tfaults.FaultInjector(
        tfaults.parse_spec("site=dispatch.fragment-ani;kind=hang;prob=1;"
                           "max=1"),
        sleep=lambda _s: release.wait()))
    tsv, rep = tmp_path / "port.tsv", tmp_path / "port.json"
    try:
        assert _run("port", _argv(corpus, "finch", tsv, rep)) == 0
        in_run = len(calls)
    finally:
        release.set()
        for t in threading.enumerate():
            if t.name == "galah-attempt":
                t.join(timeout=120)
    assert in_run > 0 and len(calls) == in_run
    assert tsv.read_bytes() == baselines["finch"]
    res = _resilience(rep)
    assert res["retries"] == {"dispatch.ani": 1}
    assert res["demotions"] == []


def test_exhausted_retries_raise_then_resume_byte_equal(corpus, baselines,
                                                        routes, tmp_path):
    """prob=1 with no max at dispatch.ani: galah_tpu demotes the site to
    its per-pair fallback and finishes; the port raises the last error
    naming the site (after GALAH_RETRY's three attempts), leaves no
    output, and a --resume with GALAH_FI cleared writes the TSV."""
    _arm(routes, "site=dispatch.ani;kind=raise;prob=1")
    jtsv, jrep = tmp_path / "jax.tsv", tmp_path / "jax.json"
    assert _run("jax", _argv(corpus, "finch", jtsv, jrep)) == 0
    assert jtsv.read_bytes() == baselines["finch"]
    jres = _resilience(jrep)
    assert [d["site"] for d in jres["demotions"]] == ["dispatch.ani"]

    ck = tmp_path / "ck"
    tsv, rep = tmp_path / "port.tsv", tmp_path / "port.json"
    argv = _argv(corpus, "finch", tsv, rep, "--checkpoint-dir", str(ck))
    with pytest.raises(TransientDispatchError) as info:
        _run("port", argv)
    assert "dispatch.ani: gave up after 3 attempt(s)" in \
        info.value.__notes__
    assert "injected transient fault at dispatch.ani" in str(info.value)
    res = _resilience(rep)  # the report is written however the run ends
    assert res["retries"] == {"dispatch.ani": 2}
    assert res["demotions"] == []
    assert not tsv.exists() or tsv.read_bytes() == b""

    _arm(routes)
    assert _run("port", [*argv, "--resume"]) == 0
    assert tsv.read_bytes() == baselines["finch"]
    res = _resilience(rep)
    assert res["retries"] == {} and res["demotions"] == []


@pytest.mark.parametrize("pin,threads,want", [(None, 1, 2), (None, 6, 6),
                                              ("3", 8, 3), ("0", 4, 1)])
def test_ingest_depth_pin_is_galah_tpus(monkeypatch, pin, threads, want):
    from galah_tpu.ops import sketch_stream as jstream
    from galah_tpu_torch.io import prefetch

    if pin is None:
        monkeypatch.delenv("GALAH_TPU_INGEST_DEPTH", raising=False)
    else:
        monkeypatch.setenv("GALAH_TPU_INGEST_DEPTH", pin)
    assert prefetch.ingest_depth(threads) == want == \
        jstream.ingest_depth(threads)


def test_slow_io_at_io_ingest_under_a_pinned_depth(corpus, baselines,
                                                   routes, tmp_path):
    """GALAH_FI's slow-io fires before each FASTA read of the finch
    stream, at io.ingest[<path>], while GALAH_TPU_INGEST_DEPTH=1 bounds
    the reads in flight to one; the TSV is unchanged."""
    from galah_tpu_torch.ops import sketch_stream

    depths = []
    orig = sketch_stream.iter_prefetched

    def recording(paths, fn, depth):
        depths.append(depth)
        return orig(paths, fn, depth=depth)

    routes.setattr(sketch_stream, "iter_prefetched", recording)
    routes.setenv("GALAH_TPU_INGEST_DEPTH", "1")
    _arm(routes)
    inj = tfaults.FaultInjector(tfaults.parse_spec(
        "site=io.ingest[;kind=slow-io;hang=0.01"))
    tfaults.install(inj)
    tsv, rep = tmp_path / "port.tsv", tmp_path / "port.json"
    assert _run("port", _argv(corpus, "finch", tsv, rep,
                              "--threads", "4")) == 0
    assert tsv.read_bytes() == baselines["finch"]
    assert depths and set(depths) == {1}
    assert inj.fired() == len(corpus)
