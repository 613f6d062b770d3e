"""The port's durable-write layer, fault injector, preemption flag, IO
retry and checkpoint object against galah_tpu's.

Tolerance: none. Framed lines, log files, fingerprints, npz arrays and
parsed records are compared for equality.
"""

import errno
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

from galah_tpu.cluster import cache as jcache
from galah_tpu.cluster import checkpoint as jckpt
from galah_tpu.io import atomic as jatomic
from galah_tpu.resilience import faults as jfaults
from galah_tpu_torch.cluster import cache as tcache
from galah_tpu_torch.cluster import checkpoint as tckpt
from galah_tpu_torch.io import atomic as tatomic
from galah_tpu_torch.resilience import faults as tfaults
from galah_tpu_torch.resilience import interrupt as tinterrupt
from galah_tpu_torch.resilience import policy as tpolicy

pytestmark = pytest.mark.fault_injection

ATOMIC = {"jax": jatomic, "port": tatomic}

json_values = hst.recursive(
    hst.none() | hst.booleans() | hst.integers(-2**53, 2**53)
    | hst.floats(allow_nan=False, allow_infinity=False)
    | hst.text(max_size=20),
    lambda inner: hst.lists(inner, max_size=4)
    | hst.dictionaries(hst.text(max_size=8), inner, max_size=4),
    max_leaves=20)


@given(json_values)
@settings(max_examples=200, deadline=None)
def test_frame_line_bytes_equal(obj):
    assert tatomic.frame_line(obj) == jatomic.frame_line(obj)


def _damaged_log(path, writer):
    """A log by `writer`: two framed records, a legacy unframed line, a
    record with a flipped crc digit, another framed record and a torn
    tail (half of a frame, no newline)."""
    mod = ATOMIC[writer]
    mod.append_jsonl(path, {"a": 1, "pairs": [[0, 1, 0.97]]})
    mod.append_jsonl(path, {"b": None})
    with open(path, "a") as fh:
        fh.write(json.dumps({"legacy": True}) + "\n")
    line = mod.frame_line({"c": "x"})
    flipped = line[:-2] + ("0" if line[-2] != "0" else "1") + "\n"
    with open(path, "a") as fh:
        fh.write(flipped)
    mod.append_jsonl(path, {"d": [1.5, -2]})
    torn = mod.frame_line({"e": 3})
    with open(path, "a") as fh:
        fh.write(torn[:len(torn) // 2])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_jsonl_reads_either_packages_log(tmp_path, writer):
    path = str(tmp_path / "log.jsonl")
    _damaged_log(path, writer)
    want = ([{"a": 1, "pairs": [[0, 1, 0.97]]}, {"b": None},
             {"legacy": True}, {"d": [1.5, -2]}], 2)
    assert jatomic.read_jsonl(path) == want
    assert tatomic.read_jsonl(path) == want
    assert tatomic.read_jsonl(str(tmp_path / "none.jsonl")) == ([], 0)


def test_append_after_torn_tail_same_bytes(tmp_path):
    files = {}
    for name, mod in ATOMIC.items():
        path = str(tmp_path / f"{name}.jsonl")
        _damaged_log(path, "jax")
        mod.append_jsonl(path, {"after": "tear"})
        files[name] = open(path, "rb").read()
        records, bad = mod.read_jsonl(path)
        assert records[-1] == {"after": "tear"} and bad == 2
    assert files["port"] == files["jax"]


def test_whole_file_writes_same_bytes(tmp_path):
    obj = {"fingerprint": "ab", "fields": {"genomes": ["/x"], "ani": 0.95}}
    for indent in (None, 2):
        tatomic.write_json(str(tmp_path / "t.json"), obj, indent=indent)
        jatomic.write_json(str(tmp_path / "j.json"), obj, indent=indent)
        assert (tmp_path / "t.json").read_bytes() == \
            (tmp_path / "j.json").read_bytes()
    tatomic.write_text(str(tmp_path / "t.txt"), "é\n")
    assert (tmp_path / "t.txt").read_bytes() == "é\n".encode()


# -- the fault injector ------------------------------------------------


def test_parse_spec_matches_galah_tpu():
    text = ("site=io.atomic.append[ckpt.greedy];kind=kill;prob=0.5;"
            "seed=3;max=1| site=io.atomic.write ; kind=slow-io;hang=0.25"
            "|kind=torn-write|site=;kind=enospc;prob=1|kind=eio;max=2")
    got = [vars(s) for s in tfaults.parse_spec(text)]
    assert got == [vars(s) for s in jfaults.parse_spec(text)]


@pytest.mark.parametrize("kind", ["raise", "device-lost", "hang",
                                  "garbage"])
def test_dispatch_kinds_are_refused_by_name(kind):
    with pytest.raises(ValueError, match=kind):
        tfaults.parse_spec(f"site=dispatch.ani;kind={kind}")


@pytest.mark.parametrize("spec", ["kind=nope", "site=x;kind=eio;prob=2",
                                  "kind=eio;colour=red", "kind"])
def test_bad_specs_raise(spec):
    with pytest.raises(ValueError):
        tfaults.parse_spec(spec)


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_fault_schedule_matches_galah_tpu(seed):
    """The same spec fires on the same calls in both packages."""
    text = f"site=io.atomic.append;kind=slow-io;hang=0;prob=0.3;seed={seed}"
    sites = ["io.atomic.append[ckpt.greedy]", "io.atomic.write[x]",
             "io.atomic.append[ckpt.clusters]"] * 20

    def schedule(mod):
        inj = mod.FaultInjector(mod.parse_spec(text), sleep=lambda s: None)
        out = []
        for site in sites:
            before = inj.fired()
            inj.filesystem(site)
            out.append(inj.fired() - before)
        return out

    got = schedule(tfaults)
    assert got == schedule(jfaults) and 0 < sum(got) < 40


def test_env_injector_install_and_reset(monkeypatch):
    monkeypatch.setenv("GALAH_FI", "site=io.atomic.write;kind=eio")
    tfaults.reset()
    try:
        inj = tfaults.get_injector()
        assert inj is not None and tfaults.get_injector() is inj
        tfaults.install(None)
        assert tfaults.get_injector() is None
    finally:
        tfaults.reset()
    monkeypatch.delenv("GALAH_FI")
    assert tfaults.get_injector() is None
    tfaults.reset()


@pytest.mark.parametrize("kind,err", [("enospc", errno.ENOSPC),
                                      ("eio", errno.EIO)])
def test_injected_write_error_leaves_target_untouched(tmp_path, kind, err):
    target = tmp_path / "ck.npz"
    tatomic.write_npz(str(target), {"a": np.arange(3)})
    before = target.read_bytes()
    tfaults.install(tfaults.FaultInjector(tfaults.parse_spec(
        f"site=io.atomic.write[ckpt.distances];kind={kind}")))
    try:
        with pytest.raises(OSError) as e:
            tatomic.write_npz(str(target), {"a": np.arange(5)},
                              site="io.atomic.write[ckpt.distances]")
        assert e.value.errno == err
    finally:
        tfaults.reset()
    assert target.read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]


def test_torn_write_leaves_debris_for_the_sweep(tmp_path):
    target = tmp_path / "f.json"
    tfaults.install(tfaults.FaultInjector(
        tfaults.parse_spec("kind=torn-write;max=1")))
    try:
        with pytest.raises(OSError):
            tatomic.write_json(str(target), {"x": 1})
        tatomic.write_json(str(target), {"x": 2})  # max=1: this one lands
    finally:
        tfaults.reset()
    assert json.loads(target.read_text()) == {"x": 2}
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".tmp")]) == 1
    assert tatomic.sweep_tmp(str(tmp_path)) == 1
    assert os.listdir(tmp_path) == ["f.json"]


def test_torn_append_is_dropped_and_healed(tmp_path):
    path = str(tmp_path / "log.jsonl")
    tatomic.append_jsonl(path, {"n": 0})
    tfaults.install(tfaults.FaultInjector(
        tfaults.parse_spec("site=io.atomic.append;kind=torn-write;max=1")))
    try:
        with pytest.raises(OSError):
            tatomic.append_jsonl(path, {"n": 1})
        tatomic.append_jsonl(path, {"n": 2})
    finally:
        tfaults.reset()
    assert tatomic.read_jsonl(path) == ([{"n": 0}, {"n": 2}], 1)
    assert jatomic.read_jsonl(path) == ([{"n": 0}, {"n": 2}], 1)


# -- interruption, retry -------------------------------------------------


def test_interrupt_flag_boundary_and_snapshot():
    tinterrupt.reset()
    try:
        tinterrupt.check("distances-saved")  # nothing pending: no-op
        tinterrupt.request_stop("SIGTERM")
        with pytest.raises(tinterrupt.PreemptionRequested) as e:
            tinterrupt.check("greedy-round-saved")
        assert (e.value.boundary, e.value.signame) == (
            "greedy-round-saved", "SIGTERM")
        with pytest.raises(tinterrupt.PreemptionRequested):
            tinterrupt.check("precluster-saved")
        tinterrupt.note_resume("/ck", 2)
        assert tinterrupt.snapshot() == {
            "stop_requested": True, "signals": ["SIGTERM"],
            "boundary": "greedy-round-saved", "resumed_from": "/ck",
            "prior_interruptions": 2}
    finally:
        tinterrupt.reset()
    assert not tinterrupt.snapshot()["stop_requested"]
    assert tinterrupt.EXIT_PREEMPTED == 75


def test_io_retry_retries_transient_errors_only():
    slept = []
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError(errno.EIO, "flake")
        return "ok"

    pol = tpolicy.RetryPolicy(max_attempts=3, base_delay=0.1, seed=1)
    assert tpolicy.call_with_retry(flaky, pol, "s",
                                   classify=lambda e: isinstance(e, OSError),
                                   sleep=slept.append) == "ok"
    assert len(calls) == 3 and len(slept) == 2
    assert slept == [pol.delay(0, "s"), pol.delay(1, "s")]

    def missing():
        calls.append(1)
        raise FileNotFoundError("gone")

    calls.clear()
    with pytest.raises(FileNotFoundError):
        tpolicy.call_with_retry(missing, pol, "s",
                                classify=lambda e: not isinstance(
                                    e, FileNotFoundError),
                                sleep=slept.append)
    assert len(calls) == 1


def test_io_retry_policy_from_env(monkeypatch):
    monkeypatch.setenv("GALAH_IO_RETRY_MAX_ATTEMPTS", "5")
    monkeypatch.setenv("GALAH_IO_RETRY_SEED", "9")
    pol = tpolicy.RetryPolicy.from_env(
        "GALAH_IO_RETRY", defaults=dict(max_attempts=3, base_delay=0.1))
    assert (pol.max_attempts, pol.base_delay, pol.seed) == (5, 0.1, 9)
    with pytest.raises(ValueError):
        tpolicy.RetryPolicy(max_attempts=0)


# -- the fingerprint -----------------------------------------------------


def _jax_backend_params(algo, fraglen):
    """galah_tpu/api.py's backend_params (default --ani-subsample)."""
    from galah_tpu.backends.fragment_backend import ANI_KMER
    from galah_tpu.backends import SkaniPreclusterer
    from galah_tpu.config import Defaults
    from galah_tpu.ops.hll import DEFAULT_P

    return {
        "minhash": {"sketch_size": Defaults.MINHASH_SKETCH_SIZE,
                    "k": Defaults.MINHASH_KMER, "seed": 0, "algo": algo},
        "hll": {"p": DEFAULT_P, "k": Defaults.MINHASH_KMER, "seed": 0,
                "algo": algo},
        "fragment": {"k": ANI_KMER, "fraglen": fraglen,
                     "screen_identity": SkaniPreclusterer.SCREEN_IDENTITY},
    }


def _port_backend_params(algo, fraglen):
    """The backend_params of the port's library API for these values."""
    from galah_tpu_torch.api import generate_galah_clusterer

    return generate_galah_clusterer(
        ["a.fna"], {"ani": 95.0, "precluster_ani": 90.0,
                    "min_aligned_fraction": 15.0, "fragment_length": fraglen,
                    "precluster_method": "skani", "cluster_method": "skani",
                    "hash_algorithm": algo}, device="cpu").backend_params


@pytest.mark.parametrize("route", ["skani", "finch", "dashing"])
@pytest.mark.parametrize("algo", ["murmur3", "tpufast"])
def test_fingerprint_equals_galah_tpu(tmp_path, monkeypatch, route, algo):
    """Same fields and digest for each route's settings, with the paths
    spelled relative, dotted and absolute (and through a symlink)."""
    (tmp_path / "data").mkdir()
    names = ["a.fna", "b.fna"]
    for n in names:
        (tmp_path / "data" / n).write_text(">c\nACGT\n")
    os.symlink(tmp_path / "data", tmp_path / "link")
    monkeypatch.chdir(tmp_path)
    spellings = [[f"data/{n}" for n in names],
                 [f"./data/{n}" for n in names],
                 [str(tmp_path / "link" / n) for n in names]]
    params = _port_backend_params(algo, 3000)
    assert params == _jax_backend_params(algo, 3000)
    digests = set()
    for genomes in spellings:
        args = (genomes, route, "skani", 0.95, 0.9)
        kw = dict(min_aligned_fraction=0.15, fragment_length=3000,
                  backend_params=params)
        got = tckpt.fingerprint_fields(*args, **kw)
        assert got == jckpt.fingerprint_fields(*args, **kw)
        assert got["genomes"] == [str(tmp_path / "data" / n) for n in names]
        assert tckpt.fields_digest(got) == jckpt.fields_digest(got)
        assert tckpt.run_fingerprint(*args, **kw) == \
            jckpt.run_fingerprint(*args, **kw)
        digests.add(tckpt.fields_digest(got))
    assert len(digests) == 1
    other = tckpt.run_fingerprint(spellings[0], route, "skani", 0.95, 0.9,
                                  0.15, 3000, _port_backend_params(algo, 2000))
    assert other not in digests


# -- the checkpoint object -------------------------------------------------


def test_checkpoint_files_readable_by_both_packages(tmp_path):
    fields = tckpt.fingerprint_fields(["g1", "g2"], "finch", "skani",
                                      0.95, 0.9)
    fp = tckpt.fields_digest(fields)
    tc = tckpt.ClusterCheckpoint(str(tmp_path / "ck"), fp, fields)
    cache = tcache.PairDistanceCache()
    cache.insert((0, 1), 0.97)
    cache.insert((2, 1), None)
    cache.insert((3, 5), 0.9123456789)
    tc.save_distances(cache)
    tc.save_greedy_round("d1", [(0, 1, 0.97), (1, 2, None)])
    tc.save_greedy_round("d2", [(4, 5, 0.5)])
    tc.save_precluster(0, [[0, 1], [2]])
    tc.record_interruption({"signal": "SIGTERM", "boundary": "b"})

    jc = jckpt.ClusterCheckpoint(str(tmp_path / "ck"), fp, fields,
                                 require_match=True)
    assert jc.matched_existing
    jd = jc.load_distances()
    assert dict(jd.items()) == dict(cache.items())
    assert isinstance(jd, jcache.PairDistanceCache)
    assert jc.load_greedy_rounds("d1") == [(0, 1, 0.97), (1, 2, None)]
    assert jc.load_completed() == {0: [[0, 1], [2]]}
    assert jc.load_interruptions() == [{"signal": "SIGTERM",
                                        "boundary": "b"}]
    # and back: galah_tpu's writes, read by the port
    jc.save_greedy_round("d2", [(6, 7, 0.25)])
    jc.save_precluster(3, [[9]])
    tc2 = tckpt.ClusterCheckpoint(str(tmp_path / "ck"), fp, fields,
                                  require_match=True)
    assert tc2.load_greedy_rounds("d2") == [(4, 5, 0.5), (6, 7, 0.25)]
    assert tc2.load_completed() == {0: [[0, 1], [2]], 3: [[9]]}
    assert dict(tc2.load_distances().items()) == dict(cache.items())
    tc2.clear_greedy_rounds()
    assert tc2.load_greedy_rounds("d1") == []


def test_checkpoint_mismatch_names_fields_and_starts_fresh(tmp_path,
                                                           caplog):
    path = str(tmp_path / "ck")
    f1 = tckpt.fingerprint_fields(["a"], "finch", "skani", 0.95, 0.9)
    c1 = tckpt.ClusterCheckpoint(path, tckpt.fields_digest(f1), f1)
    c = tcache.PairDistanceCache()
    c.insert((0, 1), 0.99)
    c1.save_distances(c)
    with open(os.path.join(path, "x.npz.1234.tmp"), "wb") as fh:
        fh.write(b"debris")
    f2 = dict(f1, ani=0.99)
    with pytest.raises(ValueError, match="different run configuration"):
        tckpt.ClusterCheckpoint(path, tckpt.fields_digest(f2), f2,
                                require_match=True)
    assert "ani" in caplog.text
    assert not any(n.endswith(".tmp") for n in os.listdir(path))
    # without require_match the stale state is dropped
    c2 = tckpt.ClusterCheckpoint(path, tckpt.fields_digest(f2), f2)
    assert not c2.matched_existing and c2.load_distances() is None
    with open(os.path.join(path, "fingerprint.json")) as fh:
        assert json.load(fh)["fields"] == f2
    with pytest.raises(ValueError, match="no checkpoint fingerprint"):
        tckpt.ClusterCheckpoint(str(tmp_path / "empty"), "x",
                                require_match=True)
    off = tckpt.ClusterCheckpoint(None, "x")
    assert not off.enabled and off.load_distances() is None
    off.save_precluster(0, [[0]])
    assert off.load_completed() == {} and off.load_interruptions() == []
