"""Checkpoint and resume on the port's engine and command line against
galah_tpu's: checkpointed runs, stops at safe boundaries, greedy-round
replay, resumes across the two packages, SIGTERM, an injected kill and
failed checkpoint writes.

Tolerance: none. Cluster lists, TSV bytes, npz arrays and decoded
records are compared for equality.
"""

import json
import os
import subprocess
import sys
from typing import List, Sequence

import numpy as np
import pytest
import torch

from galah_tpu.backends.base import ClusterBackend, PreclusterBackend
from galah_tpu.cli import main as jmain
from galah_tpu.cluster import cache as jcache
from galah_tpu.cluster import checkpoint as jckpt
from galah_tpu.cluster import cluster as jcluster
from galah_tpu.ops import collision
from galah_tpu.resilience import interrupt as jinterrupt
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.cluster import cache as tcache
from galah_tpu_torch.cluster import checkpoint as tckpt
from galah_tpu_torch.cluster import engine as tengine
from galah_tpu_torch.io import atomic as tatomic
from galah_tpu_torch.resilience import faults as tfaults
from galah_tpu_torch.resilience import interrupt as tinterrupt

pytestmark = pytest.mark.fault_injection

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakePre(PreclusterBackend):
    """Integer 'paths': genomes of one decade are preclustered (a copy
    of tests/test_checkpoint.py's fake, building the given package's
    pair cache)."""

    def __init__(self, cache_cls):
        self.cache_cls = cache_cls
        self.calls = 0

    def method_name(self):
        return "fake"

    def distances(self, paths: Sequence[str]):
        self.calls += 1
        cache = self.cache_cls()
        vals = [int(p) for p in paths]
        for i in range(len(vals)):
            for j in range(i + 1, len(vals)):
                if vals[i] // 10 == vals[j] // 10:
                    cache.insert((i, j), 0.95)
        return cache


class FakeCl(ClusterBackend):
    """ANI = 1 - |a - b| / 100 over integer 'paths'."""

    def __init__(self, threshold: float):
        self._thr = threshold
        self.pairs_computed: List = []

    def method_name(self):
        return "fakecl"

    @property
    def ani_threshold(self):
        return self._thr

    def calculate_ani_batch(self, pairs):
        self.pairs_computed.extend(pairs)
        return [1.0 - abs(int(a) - int(b)) / 100.0 for a, b in pairs]


GENOMES = ["1", "3", "9", "11", "19", "40", "42", "77", "12", "14", "15",
           "21", "22", "29", "30", "33", "36", "38", "44", "47", "49",
           "70", "75", "79"]

SIDES = {
    "jax": (jckpt, jinterrupt, jcache.PairDistanceCache,
            lambda g, pre, cl, **kw: jcluster(g, pre, cl, **kw)),
    "port": (tckpt, tinterrupt, tcache.PairDistanceCache,
             lambda g, pre, cl, **kw: tengine.cluster(g, pre, cl, CPU,
                                                      **kw)),
}


def _checkpoint(side, path, stop_after=None):
    """`side`'s checkpoint at `path`; with `stop_after`, one that
    requests a stop once that many greedy rounds are saved."""
    ck_mod, intr, _, _ = SIDES[side]
    fp = ck_mod.run_fingerprint(GENOMES, "fake", "fakecl", 0.95, 0.9)
    if stop_after is None:
        return ck_mod.ClusterCheckpoint(str(path), fp)

    class Stopping(ck_mod.ClusterCheckpoint):
        saved = 0

        def save_greedy_round(self, digest, pairs):
            super().save_greedy_round(digest, pairs)
            Stopping.saved += 1
            if Stopping.saved == stop_after:
                intr.request_stop()

    return Stopping(str(path), fp)


def _run(side, ck=None, rep_rounds=None, cl=None, pre=None):
    _, intr, cache_cls, run = SIDES[side]
    intr.reset()
    try:
        return run(GENOMES, pre or FakePre(cache_cls), cl or FakeCl(0.95),
                   checkpoint=ck, rep_rounds=rep_rounds)
    finally:
        intr.reset()


def _log(path):
    return tatomic.read_jsonl(str(path))


def _npz(path):
    with np.load(path) as z:
        return {n: z[n] for n in z.files}


@pytest.mark.parametrize("rep_rounds", [1, 3, None])
def test_checkpointed_engine_equals_galah_tpu(tmp_path, rep_rounds):
    plain = _run("port", rep_rounds=rep_rounds)
    got = {}
    for side in SIDES:
        got[side] = _run(side, _checkpoint(side, tmp_path / side),
                         rep_rounds)
    assert got["port"] == got["jax"] == plain
    jd, td = tmp_path / "jax", tmp_path / "port"
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd)) == [
        "clusters.jsonl", "fingerprint.json", "precluster_distances.npz"]
    for name in ("fingerprint.json", "clusters.jsonl"):
        assert (td / name).read_bytes() == (jd / name).read_bytes()
    tz, jz = _npz(td / "precluster_distances.npz"), \
        _npz(jd / "precluster_distances.npz")
    assert sorted(tz) == sorted(jz) == ["has_val", "ii", "jj", "vals"]
    for n in tz:
        assert tz[n].dtype == jz[n].dtype and np.array_equal(tz[n], jz[n])
    records, bad = _log(td / "clusters.jsonl")
    assert bad == 0
    assert [c for r in records for c in r["clusters"]] == plain


def test_resume_skips_distance_pass_and_done_preclusters(tmp_path):
    ref = _run("port", _checkpoint("port", tmp_path / "ck"))
    pre, cl = FakePre(tcache.PairDistanceCache), FakeCl(0.95)
    out = _run("port", _checkpoint("port", tmp_path / "ck"), cl=cl,
               pre=pre)
    assert out == ref
    assert pre.calls == 0 and cl.pairs_computed == []


@pytest.mark.parametrize("rep_rounds", [1, 3, None])
def test_stop_at_first_round_then_replay(tmp_path, rep_rounds):
    """A stop requested as the first round is saved ends the run at
    greedy-round-saved, with the same round log in both packages; the
    resume replays it, sends none of its pairs to the backend, and
    gives the uninterrupted clusters."""
    plain_cl = FakeCl(0.95)
    plain = _run("port", rep_rounds=rep_rounds, cl=plain_cl)
    logs = {}
    for side, (_, intr, _, _) in SIDES.items():
        with pytest.raises(intr.PreemptionRequested) as e:
            _run(side, _checkpoint(side, tmp_path / side, stop_after=1),
                 rep_rounds)
        assert e.value.boundary == "greedy-round-saved"
        logs[side] = _log(tmp_path / side / "greedy_rounds.jsonl")
        assert not (tmp_path / side / "clusters.jsonl").exists()
    assert logs["port"] == logs["jax"]
    records, bad = logs["port"]
    assert len(records) == 1 and bad == 0
    logged = {tuple(sorted(p[:2])) for p in records[0]["pairs"]}
    cl = FakeCl(0.95)
    pre = FakePre(tcache.PairDistanceCache)
    out = _run("port", _checkpoint("port", tmp_path / "port"), rep_rounds,
               cl=cl, pre=pre)
    assert out == plain and pre.calls == 0
    sent = {tuple(sorted((int(a), int(b)))) for a, b in cl.pairs_computed}
    by_index = {tuple(sorted((int(GENOMES[i]), int(GENOMES[j]))))
                for i, j in logged}
    assert not sent & by_index
    assert len(cl.pairs_computed) + len(logged) == \
        len(plain_cl.pairs_computed)
    assert not (tmp_path / "port" / "greedy_rounds.jsonl").exists()


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_resume_across_packages(tmp_path, writer, reader):
    """A run stopped after its second round by one package is resumed
    by the other to the uninterrupted clusters, replaying the log."""
    plain = _run("port", rep_rounds=3)
    intr = SIDES[writer][1]
    with pytest.raises(intr.PreemptionRequested):
        _run(writer, _checkpoint(writer, tmp_path, stop_after=2), 3)
    records, _ = _log(tmp_path / "greedy_rounds.jsonl")
    assert len(records) == 2
    logged = {tuple(sorted((int(GENOMES[i]), int(GENOMES[j]))))
              for rec in records for i, j, _ in rec["pairs"]}
    cl = FakeCl(0.95)
    pre = FakePre(SIDES[reader][2])
    assert _run(reader, _checkpoint(reader, tmp_path), 3, cl=cl,
                pre=pre) == plain
    assert pre.calls == 0
    sent = {tuple(sorted((int(a), int(b)))) for a, b in cl.pairs_computed}
    assert logged and not sent & logged


# -- the command line, on a real corpus ----------------------------------


def _corpus(root, n_fam=4, size=3, length=30_000, seed=5):
    rng = np.random.default_rng(seed)
    paths = []
    for fam in range(n_fam):
        base = rng.integers(0, 4, size=length)
        for m in range(size):
            codes = base.copy()
            sites = rng.random(length) < 0.01
            codes[sites] = (codes[sites] + 1) % 4
            p = root / f"fam{fam}_m{m}.fna"
            p.write_text(">c\n" + "".join("ACGT"[c] for c in codes) + "\n")
            paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("resume_corpus"))


@pytest.fixture
def no_dense_mesh(monkeypatch):
    """galah_tpu's exact collision screen instead of its 8-device CPU
    mesh: the same pair list, seconds faster."""
    monkeypatch.setattr(collision, "SPARSE_SCREEN_MIN_N", 0)


def _argv(paths, out, *extra):
    """fastani after a skani precluster: the greedy rounds compute
    ANIs, so they leave round records."""
    return ["cluster", "-f", *paths, "--cluster-method", "fastani",
            "--precluster-ani", "90", "--ani", "95", "--rep-rounds", "3",
            "--output-cluster-definition", str(out), *extra]


def _tmain(argv):
    return tcli.main([*argv, "--device", "cpu"])


def test_cli_checkpoint_equals_plain_and_galah_tpu(corpus, tmp_path,
                                                   no_dense_mesh):
    plain = tmp_path / "plain.tsv"
    assert _tmain(_argv(corpus, plain)) == 0
    outs = {}
    for side, run in (("port", _tmain), ("jax", jmain)):
        outs[side] = tmp_path / f"{side}.tsv"
        assert run(_argv(corpus, outs[side], "--checkpoint-dir",
                         str(tmp_path / f"ck_{side}"))) == 0
    assert outs["port"].read_bytes() == plain.read_bytes() == \
        outs["jax"].read_bytes()
    tdir, jdir = tmp_path / "ck_port", tmp_path / "ck_jax"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in ("fingerprint.json", "clusters.jsonl"):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    tz = _npz(tdir / "precluster_distances.npz")
    jz = _npz(jdir / "precluster_distances.npz")
    for n in ("ii", "jj", "vals", "has_val"):
        assert np.array_equal(tz[n], jz[n])
    # a second run resumes everything and writes the same bytes again
    again = tmp_path / "again.tsv"
    assert _tmain(_argv(corpus, again, "--checkpoint-dir", str(tdir),
                        "--resume")) == 0
    assert again.read_bytes() == plain.read_bytes()


def test_cli_resume_errors(corpus, tmp_path):
    out = tmp_path / "o.tsv"
    assert _tmain(_argv(corpus, out, "--resume")) == 1
    assert _tmain(_argv(corpus, out, "--checkpoint-dir",
                        str(tmp_path / "none"), "--resume")) == 1
    ck = str(tmp_path / "ck")
    assert _tmain(_argv(corpus[:6], out, "--checkpoint-dir", ck)) == 0
    # another --ani is another configuration
    assert _tmain([*_argv(corpus[:6], out, "--checkpoint-dir", ck,
                          "--resume"), "--ani", "97"]) == 1
    assert _tmain(_argv(corpus[:6], out, "--rep-rounds", "0")) == 1


def test_cli_stop_exits_75_then_resumes(corpus, tmp_path, monkeypatch,
                                        no_dense_mesh):
    plain = tmp_path / "plain.tsv"
    assert _tmain(_argv(corpus, plain)) == 0
    ck = tmp_path / "ck"
    save = tckpt.ClusterCheckpoint.save_greedy_round

    def save_then_stop(self, digest, pairs):
        save(self, digest, pairs)
        tinterrupt.request_stop("SIGTERM")

    monkeypatch.setattr(tckpt.ClusterCheckpoint, "save_greedy_round",
                        save_then_stop)
    out = tmp_path / "stopped.tsv"
    assert _tmain(_argv(corpus, out, "--checkpoint-dir", str(ck))) == 75
    monkeypatch.setattr(tckpt.ClusterCheckpoint, "save_greedy_round", save)
    records, bad = _log(ck / "interruptions.jsonl")
    assert bad == 0 and len(records) == 1
    assert (records[0]["signal"], records[0]["boundary"]) == (
        "SIGTERM", "greedy-round-saved")
    assert out.read_bytes() == b""  # opened before compute, never written
    assert len(_log(ck / "greedy_rounds.jsonl")[0]) == 1
    # galah_tpu resumes the port's stopped run to the same TSV
    jout = tmp_path / "jax.tsv"
    assert jmain(_argv(corpus, jout, "--checkpoint-dir", str(ck),
                       "--resume")) == 0
    assert jout.read_bytes() == plain.read_bytes()


_SUBPROCESS = r"""
import os, signal, sys, threading, time
from galah_tpu_torch.cli import main

ck, argv, watch = sys.argv[1], sys.argv[2:], os.environ.get("WATCH")

def send_sigterm():
    log = os.path.join(ck, "greedy_rounds.jsonl")
    while not os.path.exists(log):
        time.sleep(0.002)
    os.kill(os.getpid(), signal.SIGTERM)

if watch:
    threading.Thread(target=send_sigterm, daemon=True).start()
rc = main([*argv, "--checkpoint-dir", ck, "--device", "cpu"])
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "galah_tpu")]
new = [m for m in ("cluster.checkpoint", "resilience.interrupt",
                   "resilience.faults", "resilience.policy",
                   "resilience.quarantine")
       if "galah_tpu_torch." + m not in sys.modules]
print("LOADED", bad, "MISSING", new)
sys.exit(rc)
"""


def _subprocess(ck, argv, **env):
    full = {k: v for k, v in os.environ.items() if k != "GALAH_FI"}
    full.update(env)
    return subprocess.run(
        [sys.executable, "-c", _SUBPROCESS, str(ck), *argv], cwd=REPO,
        env=full, capture_output=True, text=True, timeout=300)


GREEDY_SITE = "site=io.atomic.append[ckpt.greedy]"


def test_sigterm_in_a_subprocess_exits_75(corpus, tmp_path):
    """SIGTERM while a round runs stops at its boundary: exit 75, one
    interruption record. The second round's append sleeps a second
    (slow-io) so the signal lands inside the run, not after it."""
    ck = tmp_path / "ck"
    proc = _subprocess(
        ck, _argv(corpus, tmp_path / "o.tsv", "--on-bad-genome", "skip"),
        WATCH="1",
        GALAH_FI=f"{GREEDY_SITE};kind=slow-io;hang=0;max=1|"
                 f"{GREEDY_SITE};kind=slow-io;hang=1;max=1")
    assert proc.returncode == 75, proc.stdout + proc.stderr
    assert "LOADED [] MISSING []" in proc.stdout
    records, _ = _log(ck / "interruptions.jsonl")
    assert [(r["signal"], r["boundary"]) for r in records] == [
        ("SIGTERM", "greedy-round-saved")]


def test_kill_at_the_greedy_append_then_resume(corpus, tmp_path, capfd):
    """An injected kill at the second round's append ends the process
    with 137 before the record is written; with a torn half-record
    appended, as a kill inside the write leaves it, the resume drops it
    and writes the uninterrupted TSV."""
    plain = tmp_path / "plain.tsv"
    assert _tmain(_argv(corpus, plain)) == 0
    ck = tmp_path / "ck"
    proc = _subprocess(
        ck, _argv(corpus, tmp_path / "o.tsv"),
        GALAH_FI=f"{GREEDY_SITE};kind=slow-io;hang=0;max=1|"
                 f"{GREEDY_SITE};kind=kill")
    assert proc.returncode == tfaults.KILL_EXIT_CODE, proc.stderr
    assert "LOADED" not in proc.stdout  # died before main returned
    log = ck / "greedy_rounds.jsonl"
    assert len(_log(log)[0]) == 1
    frame = tatomic.frame_line({"digest": "x", "pairs": [[0, 1, 0.9]]})
    with open(log, "a") as fh:
        fh.write(frame[:len(frame) // 2])
    out = tmp_path / "resumed.tsv"
    capfd.readouterr()
    assert _tmain(_argv(corpus, out, "--checkpoint-dir", str(ck),
                        "--resume")) == 0
    assert out.read_bytes() == plain.read_bytes()
    # main logs to stderr through its own root handler
    assert "Dropped 1 torn/corrupt greedy-round record" in \
        capfd.readouterr().err
    assert not [n for n in os.listdir(ck) if n.endswith(".tmp")]


@pytest.mark.parametrize("kind", ["enospc", "eio", "torn-write"])
def test_failed_distance_write_fails_the_run(corpus, tmp_path, kind):
    ck = tmp_path / "ck"
    tfaults.install(tfaults.FaultInjector(tfaults.parse_spec(
        f"site=io.atomic.write[ckpt.distances];kind={kind}")))
    try:
        assert _tmain(_argv(corpus[:6], tmp_path / "o.tsv",
                            "--checkpoint-dir", str(ck))) == 1
    finally:
        tfaults.reset()
    names = os.listdir(ck)
    assert "precluster_distances.npz" not in names
    assert "fingerprint.json" in names
    # a torn write leaves its tmp, which the next open sweeps
    assert len([n for n in names if n.endswith(".tmp")]) == (
        kind == "torn-write")
    tckpt.ClusterCheckpoint(str(ck), "x")
    assert not [n for n in os.listdir(ck) if n.endswith(".tmp")]
    with open(ck / "fingerprint.json") as fh:
        assert json.load(fh)["fingerprint"] == "x"
