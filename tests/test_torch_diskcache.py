"""The persistent sketch/profile cache against galah_tpu's: entries of
all three kinds interchangeable (same names, same arrays, checksum
verified) in both directions, warm runs equal to cold ones and free of
sketch and profile work, corrupt entries repaired, ``.tmp`` debris
swept past the age gate only, a failed write raised.

Tolerance: none — entry names, arrays and TSV bytes equal.
"""

import os
import time

import numpy as np
import pytest
import torch

from galah_tpu.backends import HLLPreclusterer as JHLLPre
from galah_tpu.backends import ProfileStore as JProfileStore
from galah_tpu.backends.minhash_backend import SketchStore as JSketchStore
from galah_tpu.io import diskcache as jdiskcache
from galah_tpu.io import read_genome as jread
from galah_tpu_torch import cli as tcli
from galah_tpu_torch.backends import HLLStore, ProfileStore, SketchStore
from galah_tpu_torch.io import atomic
from galah_tpu_torch.io import diskcache as tdiskcache
from galah_tpu_torch.ops.sketch_stream import iter_path_sketches
from galah_tpu_torch.ops.u64 import from_biased
from galah_tpu_torch.timing import StageClock

from test_torch_cluster import _families

# several pytest workers share the host: one torch thread a worker (as
# tests/test_torch_hll.py sets for the whole run)
torch.set_num_threads(1)

CPU = torch.device("cpu")
KINDS = ("profile", "minhash", "hll")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """2 families x 3 members, 30 kb, ~1% divergence."""
    return _families(tmp_path_factory.mktemp("dc"), 5, 2, 3, 30_000, 0.01)


def _jax_fill(kind, cache_dir, paths):
    """galah_tpu's store of `kind` over `paths`, writing `cache_dir`;
    returns its cache."""
    c = jdiskcache.CacheDir(str(cache_dir))
    if kind == "profile":
        JProfileStore(k=15, cache=c).get_many(paths)
    elif kind == "minhash":
        store = JSketchStore(1000, 21, cache=c)
        for p in paths:
            if store.get_cached(p) is None:
                store.put_from_genome(p, jread(p))
    else:
        JHLLPre(0.9, cache=c)._sketch_paths(paths)
    return c


def _port_fill(kind, cache_dir, paths):
    """The port's store of `kind` over `paths` on the CPU, with its
    disk cache at `cache_dir`; returns (the values as numpy dicts, the
    run's clock)."""
    clock = StageClock(CPU)
    c = tdiskcache.CacheDir(str(cache_dir), clock)
    if kind == "profile":
        profs = ProfileStore(CPU, clock=clock, cache=c).get_many(paths)
        return [{"flat_hashes": from_biased(p.flat_hashes),
                 "ref_set": from_biased(p.ref_set),
                 "markers": from_biased(p.markers)} for p in profs], clock
    store = (SketchStore(CPU, clock=clock, cache=c) if kind == "minhash"
             else HLLStore(CPU, clock=clock, cache=c))
    got = dict(iter_path_sketches(paths, store))
    if kind == "minhash":
        return [{"hashes": got[p].hashes} for p in paths], clock
    return [{"regs": got[p].numpy()} for p in paths], clock


def _entries(cache_dir):
    out = {}
    for name in sorted(os.listdir(cache_dir)):
        with np.load(os.path.join(cache_dir, name)) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


def _assert_same_entries(a, b):
    assert sorted(a) == sorted(b) and a
    for name in a:
        assert sorted(a[name]) == sorted(b[name])
        for k in a[name]:
            assert a[name][k].dtype == b[name][k].dtype, (name, k)
            np.testing.assert_array_equal(a[name][k], b[name][k])


@pytest.mark.parametrize("kind", KINDS)
def test_entries_interchangeable_with_galah_tpu(corpus, tmp_path, kind):
    """An entry galah_tpu's CacheDir wrote is found by the port under
    the same name, with equal arrays, and the port computes nothing;
    the entries the port writes are galah_tpu's, name for name and
    array for array (checksum included), and galah_tpu loads them all
    as hits."""
    paths, _ = corpus
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    _jax_fill(kind, jdir, paths)
    cold, cold_clock = _port_fill(kind, tdir, paths)
    assert cold_clock.counts["cache-misses"] == len(paths)
    assert cold_clock.counts["cache-bytes-written"] > 0
    _assert_same_entries(_entries(tdir), _entries(jdir))

    warm, clock = _port_fill(kind, jdir, paths)
    assert clock.counts["cache-hits"] == len(paths)
    assert clock.counts["cache-misses"] == 0
    assert clock.counts["genomes-read"] == 0
    assert clock.counts["cache-bytes-read"] == sum(
        os.path.getsize(jdir / n) for n in os.listdir(jdir))
    for a, b in zip(warm, cold):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    jc = _jax_fill(kind, tdir, paths)
    assert (jc.hits, jc.misses) == (len(paths), 0)


def _run(argv):
    res = tcli.run_cluster(tcli.parse_args(argv))
    return res.clock.counts


@pytest.mark.parametrize("method", ["skani", "finch", "dashing"])
def test_warm_run_equals_cold(corpus, tmp_path, method):
    """A --sketch-cache run gives the cold run's TSV warm, reading no
    genome and building no sketch, register row or profile."""
    paths, _ = corpus
    cache = str(tmp_path / "cache")
    tsvs = {}
    counts = {}
    for run in ("cold", "warm"):
        tsvs[run] = tmp_path / f"{run}.tsv"
        counts[run] = _run(
            ["cluster", "-f", *paths, "--device", "cpu",
             "--precluster-method", method, "--sketch-cache", cache,
             "--output-cluster-definition", str(tsvs[run])])
    assert tsvs["warm"].read_bytes() == tsvs["cold"].read_bytes()
    assert counts["cold"]["cache-misses"] > 0
    assert counts["warm"]["cache-misses"] == 0
    assert counts["warm"]["cache-hits"] == (len(paths) if method == "skani"
                                            else 2 * len(paths))
    for name in ("genomes-read", "profile-groups", "sketch-fused-launches",
                 "hll-launch-groups"):
        assert counts["warm"][name] == 0, name
    assert counts["cold"]["profile-groups"] > 0


def test_dist_warm_equals_cold(corpus, tmp_path):
    """dist shares finch's minhash entries: warm, the same TSV."""
    paths, _ = corpus
    cache = str(tmp_path / "cache")
    outs = []
    for run in ("cold", "warm"):
        args = tcli.parse_args(["dist", "-f", *paths, "--device", "cpu",
                                "--sketch-cache", cache, "--output",
                                str(tmp_path / f"{run}.tsv")])
        res = tcli.run_dist(args)
        outs.append((tmp_path / f"{run}.tsv").read_bytes())
    assert outs[0] == outs[1] and outs[0]
    assert res.clock.counts["cache-misses"] == 0
    assert res.clock.counts["genomes-read"] == 0


def _flip_byte(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


def _truncate(path):
    path.write_bytes(path.read_bytes()[: os.path.getsize(path) // 3])


def _stale_checksum(path):
    """A well-formed entry whose arrays no longer match its __check__."""
    with np.load(path) as z:
        arrays = {k: z[k].copy() for k in z.files}
    name = next(k for k in arrays if k != "__check__")
    arrays[name].reshape(-1)[0] ^= arrays[name].dtype.type(1)
    np.savez(path, **arrays)


def test_corrupt_entries_are_repaired(corpus, tmp_path):
    """A flipped byte, a truncated entry and a stale checksum are each
    dropped, counted as a miss and a repair, recomputed and stored
    again; the TSV is unchanged."""
    paths, _ = corpus
    cache = tmp_path / "cache"
    argv = ["cluster", "-f", *paths, "--device", "cpu",
            "--precluster-method", "finch", "--sketch-cache", str(cache),
            "--output-cluster-definition"]
    _run([*argv, str(tmp_path / "cold.tsv")])
    names = sorted(os.listdir(cache))
    profiles = [n for n in names if n.startswith("profile-")]
    sketches = [n for n in names if n.startswith("minhash-")]
    _flip_byte(cache / profiles[0])
    _truncate(cache / sketches[0])
    _stale_checksum(cache / profiles[1])
    counts = _run([*argv, str(tmp_path / "repaired.tsv")])
    assert (counts["cache-repaired"], counts["cache-misses"]) == (3, 3)
    assert counts["genomes-read"] == 3
    assert ((tmp_path / "repaired.tsv").read_bytes()
            == (tmp_path / "cold.tsv").read_bytes())
    assert sorted(os.listdir(cache)) == names
    counts = _run([*argv, str(tmp_path / "warm.tsv")])
    assert counts["cache-misses"] == 0 and counts["cache-repaired"] == 0


@pytest.mark.parametrize("side", ["jax", "port"])
def test_tmp_debris_swept_past_the_age_gate(tmp_path, side):
    """Opening a cache removes .tmp files older than
    SHARED_TMP_MAX_AGE_S and leaves younger ones (a live writer's)."""
    cache = tmp_path / "cache"
    cache.mkdir()
    old, young, entry = (cache / "a.npz.x1.tmp", cache / "b.npz.x2.tmp",
                         cache / "c.npz")
    for p in (old, young, entry):
        p.write_bytes(b"x")
    past = time.time() - atomic.SHARED_TMP_MAX_AGE_S - 60
    os.utime(old, (past, past))
    if side == "jax":
        jdiskcache.CacheDir(str(cache))
    else:
        tdiskcache.CacheDir(str(cache))
    assert sorted(os.listdir(cache)) == ["b.npz.x2.tmp", "c.npz"]
    assert atomic.sweep_tmp(str(cache)) == 1
    assert os.listdir(cache) == ["c.npz"]


def test_failed_store_raises_and_leaves_no_debris(corpus, tmp_path):
    """A cache entry that cannot be written raises, as galah_tpu's
    atomic write does; the entry is not skipped and no .tmp is left."""
    paths, _ = corpus
    cache = tmp_path / "cache"
    c = tdiskcache.CacheDir(str(cache))
    params = {"sketch_size": 1000, "k": 21, "seed": 0, "algo": "murmur3"}
    os.makedirs(c.entry_path(paths[0], "minhash", params))
    with pytest.raises(OSError):
        c.store(paths[0], "minhash", params,
                {"hashes": np.arange(3, dtype=np.uint64)})
    assert not [n for n in os.listdir(cache) if n.endswith(".tmp")]
    with pytest.raises(ValueError, match="__check__"):
        c.store(paths[0], "minhash", params,
                {"__check__": np.zeros(1, np.uint64)})
    target = tmp_path / "t.bin"
    atomic.write_bytes(str(target), b"old")
    atomic.write_bytes(str(target), b"new")
    assert target.read_bytes() == b"new"
    assert sorted(os.listdir(tmp_path)) == ["cache", "t.bin"]
