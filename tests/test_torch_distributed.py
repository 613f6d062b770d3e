"""The port's multi-process runs (galah_tpu_torch/parallel/distributed.py)
on the CPU.

One pair of gloo ranks (tests/_torch_dist_worker.py, 127.0.0.1, a free
port, a 30 s collective timeout, a 180 s subprocess timeout) runs every
two-rank case: `cluster` with the skani, finch and dashing preclusters
over 8 planted-family genomes, whose rank 0 TSV must be byte-identical
to the single-process port's and to galah_tpu's while rank 1 writes
none; the quality order from the exchanged contig stats alone; a
failure on one rank raising on both; uneven per-rank checkpoints reset
on both; the exchange helpers; and the sharded passes over rank meshes.
A three-rank group runs one `cluster` with an uneven stride; a rank
whose peer never comes must fail within its timeout, and an exchange
whose peer has left must raise. In one process
the helpers are no-ops equal to galah_tpu's.

Tolerance: none. TSV bytes, orders, pair lists and dicts are equal.
"""

import json
import logging
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from galah_tpu import outputs as joutputs
from galah_tpu.cli import main as jmain
from galah_tpu.cluster.cache import PairDistanceCache as JPairDistanceCache
from galah_tpu.cluster.checkpoint import ClusterCheckpoint as JCheckpoint
from galah_tpu.ops import collision as jcollision
from galah_tpu.ops import hll as jhll
from galah_tpu.parallel import distributed as jdist
from galah_tpu_torch import cli as tcli
from galah_tpu_torch import outputs as toutputs
from galah_tpu_torch import quality as tquality
from galah_tpu_torch.cluster.cache import PairDistanceCache
from galah_tpu_torch.cluster.checkpoint import ClusterCheckpoint
from galah_tpu_torch.obs import report as treport
from galah_tpu_torch.ops import pairwise as tpair
from galah_tpu_torch.ops import sparse_device as tsparse
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.tile_stats import tile_stats
from galah_tpu_torch.ops.u64 import to_biased
from galah_tpu_torch.parallel import distributed as tdist

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_dist_worker.py"
ACGT = np.array(list("ACGT"))
METHODS = {"skani": [], "finch": ["--precluster-method", "finch"],
           "dashing": ["--precluster-method", "dashing", "--genome-info"]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_genome(path, codes, n_contigs, n_run):
    """`codes` as `n_contigs` contigs, with a run of `n_run` Ns."""
    seq = "".join(ACGT[codes])
    if n_run:
        seq = seq[:1000] + "N" * n_run + seq[1000 + n_run:]
    cuts = np.linspace(0, len(seq), n_contigs + 1).astype(int)
    with open(path, "w") as f:
        for c in range(n_contigs):
            f.write(f">contig{c}\n{seq[cuts[c]:cuts[c + 1]]}\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 genomes: 2 families x 4 members, 40 kb, ~1% divergence, 1-3
    contigs and 0-40 Ns apiece, and a genome-info file that gives every
    genome the same quality, so that contigs and Ns alone order them."""
    root = tmp_path_factory.mktemp("dist_corpus")
    rng = np.random.default_rng(17)
    names = []
    for fam in range(2):
        base = rng.integers(0, 4, size=40_000)
        for m in range(4):
            codes = base.copy()
            if m:
                sites = rng.random(codes.shape[0]) < 0.01
                codes[sites] = (codes[sites] + 1) % 4
            name = f"g{fam}{m}"
            _write_genome(root / f"{name}.fna", codes, 1 + (fam + m) % 3,
                          10 * ((3 * fam + m) % 5))
            names.append(name)
    with open(root / "info.csv", "w") as f:
        f.write("genome,completeness,contamination\n")
        for name in names:
            f.write(f"{name},95.0,1.0\n")
    paths = sorted(str(p) for p in root.glob("*.fna"))
    return root, paths


@pytest.fixture(scope="module")
def single_process(corpus, tmp_path_factory):
    """Each method's TSV from one port process and from galah_tpu (its
    exact collision screen and its single-device HLL pass, off
    conftest's 8-device mesh). Both mains replace the root logger's
    handlers and level, which are put back after."""
    root, paths = corpus
    out = tmp_path_factory.mktemp("dist_single")
    log_root = logging.getLogger()
    handlers, level = log_root.handlers[:], log_root.level
    mp = pytest.MonkeyPatch()
    mp.setattr(jcollision, "SPARSE_SCREEN_MIN_N", 0)
    orig = jhll.hll_threshold_pairs
    mp.setattr(jhll, "hll_threshold_pairs",
               lambda regs, k, min_ani, **kw: orig(
                   regs, k=k, min_ani=min_ani, use_pallas=False, **kw))
    tsvs = {}
    try:
        for name, extra in METHODS.items():
            if name == "dashing":
                extra = [*extra, str(root / "info.csv")]
            common = ["cluster", "-f", *paths, "-q", *extra]
            port, ref = out / f"{name}_port.tsv", out / f"{name}_jax.tsv"
            assert tcli.main([*common, "--device", "cpu",
                              "--output-cluster-definition",
                              str(port)]) == 0
            assert jmain([*common, "--output-cluster-definition",
                          str(ref)]) == 0
            tsvs[name] = (port.read_bytes(), ref.read_bytes())
    finally:
        mp.undo()
        log_root.handlers[:] = handlers
        log_root.setLevel(level)
    return tsvs


def _run_group(world, corpus_dir, out_dir, mode, timeout_s=30.0,
               ranks=None):
    """The worker as ranks `ranks` (default all) of a `world`-rank group;
    {rank: {case: result}} and the exit codes."""
    port = str(_free_port())
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        env.pop(name, None)
    procs = {r: subprocess.Popen(
        [sys.executable, str(WORKER), port, str(world), str(r),
         str(corpus_dir), str(out_dir), mode, str(timeout_s)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(REPO))
        for r in (range(world) if ranks is None else ranks)}
    results, rcs = {}, {}
    try:
        for r, p in procs.items():
            out, err = p.communicate(timeout=180)
            rcs[r] = p.returncode
            results[r] = {}
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    row = json.loads(line[len("RESULT "):])
                    results[r][row.pop("case")] = row
            results[r]["stderr"] = err[-3000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return results, rcs


@pytest.fixture(scope="module")
def two_ranks(corpus, tmp_path_factory):
    root, _ = corpus
    out = tmp_path_factory.mktemp("dist_two")
    results, rcs = _run_group(2, root, out, "full")
    assert rcs == {0: 0, 1: 0}, results
    return results, out


@pytest.mark.parametrize("method", list(METHODS))
def test_two_ranks_cluster_byte_identical(two_ranks, single_process,
                                          method):
    results, out = two_ranks
    port, ref = single_process[method]
    assert port == ref
    assert (out / f"{method}_rank0.tsv").read_bytes() == port
    assert results[0][method] == {"rc": 0, "wrote": True}
    assert results[1][method] == {"rc": 0, "wrote": False}


def test_two_ranks_quality_order_from_exchanged_stats(two_ranks, corpus):
    """Every rank reads the stats of its strided shard only, and both
    order the genomes as one process does, by contigs and Ns alone."""
    results, _ = two_ranks
    root, paths = corpus
    want = [os.path.basename(p) for p in tquality.filter_and_order_genomes(
        paths, tquality.read_genome_info_file(str(root / "info.csv")),
        formula="Parks2020_reduced")]
    assert want != sorted(want)
    for rank in (0, 1):
        got = results[rank]["quality"]
        assert got["order"] == want
        assert got["read"] == sorted(os.path.basename(p)
                                     for p in paths[rank::2])


def test_two_ranks_failure_raises_on_every_rank(two_ranks):
    results, _ = two_ranks
    assert results[0]["failure"] == {"raised": True, "planted": False}
    assert results[1]["failure"] == {"raised": True, "planted": True}


def test_two_ranks_uneven_checkpoints_reset_on_both(two_ranks,
                                                    single_process):
    results, out = two_ranks
    for rank in (0, 1):
        assert results[rank]["uneven"] == {
            "had_distances": True, "resets": [f"proc_{rank}"]}
        assert results[rank]["resume"]["rc"] == 0
    assert (out / "ck" / "proc_0").is_dir()
    assert (out / "ck" / "proc_1" / "precluster_distances.npz").exists()
    assert (out / "resume_rank0.tsv").read_bytes() == \
        single_process["skani"][0]
    assert not (out / "resume_rank1.tsv").exists()


def test_two_ranks_exchange_helpers(two_ranks):
    results, _ = two_ranks
    for rank in (0, 1):
        got = results[rank]["helpers"]
        assert got["shard"] == list(range(rank, 10, 2))
        assert got["round_trip"] is True
        assert got["same"] is True and got["differ"] is False
        assert got["ragged"] == [[[0, 0], [-7, -7]], [[1, -7], [1, -7]]]


def test_two_ranks_sharded_passes_match_one_process(two_ranks):
    """The passes over the 2-rank mesh (one slot a rank) and over a
    4-slot mesh whose slots alternate between the ranks give one
    process's results on both ranks."""
    import hashlib

    results, _ = two_ranks
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 1 << 62, size=(90, 64), dtype=np.uint64)
    mat[10] = mat[4]
    mat[60, :40] = mat[61, :40]
    mat.sort(axis=1)
    t = to_biased(mat, "cpu")
    pi = rng.integers(0, 45, size=300)
    pj = rng.integers(45, 90, size=300)
    cols = torch.cat([t[64:90], t[:38]])
    pad = torch.full((64, 64), SENTINEL_BIASED, dtype=torch.int64)

    def digest(*arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    pairs = tpair.threshold_pairs(t, 21, 0.9)
    want = {"pairs": sorted([a, b, v] for (a, b), v in pairs.items()),
            "screen": [list(p) for p in
                       tpair.screen_pairs(t, np.full(90, 64), 0.3)],
            "pairlist": digest(*tsparse.pair_stats_for_pairs(t, pi, pj,
                                                              64)),
            "stripe": digest(*(x.numpy() for x in tile_stats(
                torch.cat([t[:64], pad]), cols, 64)))}
    assert (4, 10) in pairs and (60, 61) in pairs
    for rank in (0, 1):
        got = results[rank]["mesh"]
        assert got["auto"]["shape"] == [2]
        assert got["shared"]["shape"] == [4]
        for name in ("auto", "shared"):
            got[name].pop("shape")
            assert got[name] == want, (rank, name)


def test_two_ranks_load_no_jax(two_ranks):
    results, _ = two_ranks
    for rank in (0, 1):
        assert results[rank]["init"] == {"ok": True, "count": 2,
                                         "index": rank}
        assert results[rank]["modules"] == {
            "foreign": [],
            "parallel": ["galah_tpu_torch.parallel.mesh",
                         "galah_tpu_torch.parallel.distributed"]}


def test_three_ranks_uneven_stride(corpus, single_process, tmp_path):
    """8 genomes over 3 ranks (3, 3 and 2 a rank): rank 0's TSV is one
    process's, and ranks 1 and 2 write none."""
    root, _ = corpus
    results, rcs = _run_group(3, root, tmp_path, "cluster")
    assert rcs == {0: 0, 1: 0, 2: 0}, results
    assert (tmp_path / "skani_rank0.tsv").read_bytes() == \
        single_process["skani"][0]
    for rank in (1, 2):
        assert results[rank]["skani"] == {"rc": 0, "wrote": False}
        assert results[rank]["init"]["count"] == 3


def test_missing_peer_fails_within_the_timeout(corpus, tmp_path):
    root, _ = corpus
    results, rcs = _run_group(2, root, tmp_path, "full", timeout_s=3.0,
                              ranks=[0])
    assert rcs == {0: 3}, results
    assert results[0]["init"]["ok"] is False
    assert results[0]["init"]["seconds"] < 30


def test_failed_collective_raises(corpus, tmp_path):
    """A peer that leaves makes the next exchange raise, named by its
    site, within the timeout; nothing retries or falls back."""
    root, _ = corpus
    results, rcs = _run_group(2, root, tmp_path, "abandon", timeout_s=5.0)
    assert rcs == {0: 0, 1: 0}, results
    got = results[0]["abandon"]
    assert got["raised"] is True and got["site"] is True, results
    assert got["seconds"] < 30


# -- one process ----------------------------------------------------------


def test_single_process_helpers_are_no_ops_like_galah_tpu(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    tdist.initialize()
    jdist.initialize()
    monkeypatch.setenv("WORLD_SIZE", "1")
    tdist.initialize(timeout_s=1.0)
    assert not tdist.is_initialized()
    assert (tdist.process_count(), tdist.process_index()) == (
        jdist.process_count(), jdist.process_index()) == (1, 0)
    items = list(range(10))
    assert tdist.host_shard(items) == jdist.host_shard(items) == items
    rows = np.arange(12, dtype=np.uint64).reshape(4, 3)
    np.testing.assert_array_equal(
        tdist.allgather_host_rows(4, rows, fill=np.uint64(0)),
        jdist.allgather_host_rows(4, rows, fill=np.uint64(0)))
    assert tdist.tokens_agree(b"x") == jdist.tokens_agree(b"x") is True
    np.testing.assert_array_equal(tdist.exchange("t", rows), rows[None])

    def compute(idxs):
        return [None if k % 3 == 0 else k / 2 for k in idxs]

    assert tdist.sharded_optional_floats(7, compute) == \
        jdist.sharded_optional_floats(7, compute)
    tdist.raise_if_any_host_failed(None)
    for mod in (tdist, jdist):
        with pytest.raises(KeyError, match="mine"):
            mod.raise_if_any_host_failed(KeyError("mine"))
    topo = treport.device_topology(torch.device("cpu"))
    assert (topo["process_index"], topo["process_count"]) == (0, 1)


def test_local_rank_without_a_device_raises(monkeypatch):
    """A rank never wraps round onto another's card, and asking for
    cuda with none raises before any rendezvous."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no device"):
        tdist.initialize(device=torch.device("cuda"), world_size=2, rank=1,
                         local_rank=1, master_port=1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 0 has no device"):
        tdist.initialize(device="cuda", world_size=2, rank=0, local_rank=0,
                         master_port=1)
    assert not tdist.is_initialized()


def test_checkpoint_state_token_and_reset(tmp_path):
    """The token moves with each piece of resumable state, as
    galah_tpu's does, and a reset drops the state but keeps the
    fingerprint."""
    tokens = {}
    for name, cls, cache in (("port", ClusterCheckpoint, PairDistanceCache),
                             ("ref", JCheckpoint, JPairDistanceCache)):
        ck = cls(str(tmp_path / name), "fp")
        steps = [ck.state_token()]
        c = cache()
        c.insert((0, 1), 0.99)
        ck.save_distances(c)
        steps.append(ck.state_token())
        ck.save_precluster(0, [[0, 1]])
        steps.append(ck.state_token())
        ck.reset_state()
        steps.append(ck.state_token())
        assert ck.load_distances() is None and ck.load_completed() == {}
        assert (tmp_path / name / "fingerprint.json").exists()
        tokens[name] = steps
    for steps in tokens.values():
        assert len(set(steps[:3])) == 3 and steps[3] == steps[0]
    assert tokens["port"][0] == tokens["ref"][0]
    assert ClusterCheckpoint(None, "fp").state_token() == \
        JCheckpoint(None, "fp").state_token()


def test_validate_output_paths_matches_galah_tpu(tmp_path):
    (tmp_path / "full").mkdir()
    (tmp_path / "full" / "x").write_text("x")
    (tmp_path / "afile").write_text("x")
    cases = [
        {"cluster_definition": str(tmp_path / "ok.tsv"),
         "representative_list": str(tmp_path / "reps.txt"),
         "representative_fasta_directory": str(tmp_path / "new" / "d")},
        {"cluster_definition": str(tmp_path)},
        {"cluster_definition": str(tmp_path / "missing" / "c.tsv")},
        {"representative_fasta_directory": str(tmp_path / "full")},
        {"representative_fasta_directory_copy": str(tmp_path / "afile")},
    ]
    for kw in cases:
        outcome = []
        for mod in (toutputs, joutputs):
            try:
                mod.validate_output_paths(**kw)
                outcome.append(None)
            except (OSError, ValueError) as e:
                outcome.append((type(e), str(e)))
        assert outcome[0] == outcome[1], kw
    assert not (tmp_path / "new").exists()
    assert not (tmp_path / "ok.tsv").exists()
