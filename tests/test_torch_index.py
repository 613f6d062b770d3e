"""The port's persistent sketch index against galah_tpu's, on the same
files: build, insert, query, remove, fsck, the parameter refusals, the
stopped and resumed CLI insert, and the insert pair pass against
galah_tpu's host merge statistics.

Tolerance: none. Committed index bytes (every file but
interruptions.jsonl), query TSVs, fsck reports, error messages, pair
integers and ANI floats are equal.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from galah_tpu import manpage as jmanpage
from galah_tpu.cli import build_parser as jbuild_parser
from galah_tpu.cli import main as jmain
from galah_tpu.index import incremental as jinc
from galah_tpu.index.store import IndexStore as JStore
from galah_tpu.index.store import fsck as jfsck
from galah_tpu_torch import cli as tcli
from galah_tpu_torch import manpage as tmanpage
from galah_tpu_torch.backends import MinHashPreclusterer, SketchStore
from galah_tpu_torch.cluster.engine import cluster as tcluster
from galah_tpu_torch.index import incremental as tinc
from galah_tpu_torch.index.store import IndexStore as TStore
from galah_tpu_torch.index.store import fsck as tfsck
from galah_tpu_torch.io import diskcache
from galah_tpu_torch.ops.minhash import sketch_rows
from galah_tpu_torch.ops.pairwise import ani_to_jaccard
from galah_tpu_torch.ops.sparse_device import pair_stats_for_pairs
from galah_tpu_torch.resilience import interrupt as tinterrupt
from galah_tpu_torch.timing import StageClock

# several pytest workers share the host: one torch thread a worker
torch.set_num_threads(1)

CPU = torch.device("cpu")
BASES = np.array(list("ACGT"))


def _write(path, codes, line=70):
    seq = "".join(BASES[codes])
    with open(path, "w") as f:
        f.write(">contig1\n")
        for i in range(0, len(seq), line):
            f.write(seq[i:i + line] + "\n")


def _dir_bytes(path):
    """Committed bytes by file name (interruptions.jsonl records the
    run's stops, so it is left out)."""
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))
            if name != "interruptions.jsonl"}


def _copy(src, root, name):
    d = str(root / name)
    shutil.copytree(src, d)
    return d


@pytest.fixture
def root_logger():
    """main() replaces the root handlers; put them back after."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield root
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_index.py's corpus: 4 planted families x 3 members
    (~0.5% divergence), 10 kbp, and three unrelated singletons; plus a
    600 bp genome whose sketch is shorter than the sketch size."""
    root = tmp_path_factory.mktemp("tindex_corpus")
    rng = np.random.default_rng(17)
    length = 10_000
    fams = []
    for fam in range(4):
        base = rng.integers(0, 4, size=length)
        members = []
        for m in range(3):
            codes = base.copy()
            if m:
                sites = rng.random(length) < 0.005
                codes[sites] = (codes[sites] + rng.integers(
                    1, 4, size=int(sites.sum()))) % 4
            p = str(root / f"fam{fam}_m{m}.fna")
            _write(p, codes)
            members.append(p)
        fams.append(members)
    extras = []
    for i in range(3):
        p = str(root / f"solo{i}.fna")
        _write(p, rng.integers(0, 4, size=length))
        extras.append(p)
    short = str(root / "short.fna")
    _write(short, rng.integers(0, 4, size=600))
    return fams, extras, short


@pytest.fixture(scope="module")
def grown(corpus, tmp_path_factory):
    """Both packages build over the same 8 genomes and insert the same
    4 (a family joiner and a whole new family); galah_tpu's build is
    the module's one finch distance pass on conftest's mesh."""
    fams, _, _ = corpus
    root = tmp_path_factory.mktemp("tindex_grown")
    base = fams[0][:2] + fams[1] + fams[2]
    inserted = [fams[0][2]] + fams[3]
    out = {"base": base, "inserted": inserted, "full": base + inserted,
           "jcache": str(root / "jcache"), "tcache": str(root / "tcache")}
    for side in ("j", "t"):
        out[f"{side}_built"] = str(root / f"{side}_built")
    jinc.build(out["j_built"], base, ani=0.95, precluster_ani=0.90,
               cache_dir=out["jcache"], threads=2)
    tinc.build(out["t_built"], base, ani=0.95, precluster_ani=0.90,
               device=CPU, cache_dir=out["tcache"], threads=2)
    out["j_grown"] = _copy(out["j_built"], root, "j_grown")
    out["t_grown"] = _copy(out["t_built"], root, "t_grown")
    info = jinc.insert(JStore(out["j_grown"]), inserted,
                       cache_dir=out["jcache"])
    assert info["inserted"] == 4 and info["generation"] == 2
    info = tinc.insert(TStore(out["t_grown"]), inserted, device=CPU,
                       cache_dir=out["tcache"])
    assert info["inserted"] == 4 and info["generation"] == 2
    return out


def test_build_bytes_equal_galah_tpu(grown):
    got, want = _dir_bytes(grown["t_built"]), _dir_bytes(grown["j_built"])
    assert sorted(got) == ["MANIFEST.json", "fingerprint.json",
                           "gen-000001.json", "genomes.jsonl",
                           "pairs.jsonl", "sketches.jsonl"]
    assert got == want
    assert json.loads(got["gen-000001.json"])["n_pairs"] > 0


def test_grown_bytes_equal_galah_tpu(grown):
    assert _dir_bytes(grown["t_grown"]) == _dir_bytes(grown["j_grown"])


def test_grown_equals_port_scratch_build(grown, tmp_path):
    """A port-grown index holds a port from-scratch build's bytes, but
    for the generation files and the pointer."""
    scratch = str(tmp_path / "scratch")
    tinc.build(scratch, grown["full"], ani=0.95, precluster_ani=0.90,
               device=CPU, cache_dir=grown["tcache"])
    got, want = _dir_bytes(grown["t_grown"]), _dir_bytes(scratch)
    del got["MANIFEST.json"], want["MANIFEST.json"]
    gen2 = json.loads(got.pop("gen-000002.json"))
    assert json.loads(got.pop("gen-000001.json"))["n_genomes"] == len(
        grown["base"])
    gen1 = json.loads(want.pop("gen-000001.json"))
    assert got == want
    del gen2["generation"], gen1["generation"]
    assert gen2 == gen1 and gen1["n_genomes"] == len(grown["full"])


@pytest.mark.parametrize("writer", ["galah_tpu", "port"])
def test_cross_writes(grown, corpus, tmp_path, writer):
    """One package builds, the other inserts: the bytes of either
    package growing its own index. Then galah_tpu queries and fscks the
    port-grown index, and the port the galah_tpu-grown one."""
    _, extras, short = corpus
    if writer == "galah_tpu":
        d = _copy(grown["j_built"], tmp_path, "idx")
        tinc.insert(TStore(d), grown["inserted"], device=CPU,
                    cache_dir=grown["tcache"])
    else:
        d = _copy(grown["t_built"], tmp_path, "idx")
        jinc.insert(JStore(d), grown["inserted"], cache_dir=grown["jcache"])
    assert _dir_bytes(d) == _dir_bytes(grown["j_grown"])
    probes = [grown["inserted"][0], extras[0], short]
    if writer == "galah_tpu":
        want = jinc.query(JStore(d), probes, cache_dir=grown["jcache"])
        got = tinc.query(TStore(d), probes, device=CPU)
        audit = tfsck(d)
    else:
        got = jinc.query(JStore(d), probes, cache_dir=grown["jcache"])
        want = tinc.query(TStore(d), probes, device=CPU)
        audit = jfsck(d)
    assert got == want
    assert [r["decision"] for r in got] == ["member", "novel", "novel"]
    assert audit["ok"], audit["problems"]
    assert audit["genomes"] == len(grown["full"])


def test_short_and_singleton_inserts_across_packages(grown, corpus,
                                                      tmp_path):
    """The 600 bp genome's short sketch is stored unpadded; inserting
    it with two singletons writes galah_tpu's bytes from either side's
    grown index, batch by batch."""
    _, extras, short = corpus
    new = [extras[1], short, extras[2]]
    dj = _copy(grown["j_grown"], tmp_path, "j")
    dt = _copy(grown["j_grown"], tmp_path, "t")
    jinc.insert(JStore(dj), new, cache_dir=grown["jcache"], batch=2)
    info = tinc.insert(TStore(dt), new, device=CPU,
                       cache_dir=grown["tcache"], batch=2)
    assert info["inserted"] == 3 and info["new_reps"] == 3
    assert _dir_bytes(dt) == _dir_bytes(dj)
    state = TStore(dt).load()
    g = state.genomes.index(os.path.abspath(short))
    assert 0 < state.sketches[g].shape[0] < 1000


def test_query_tsv_matches_galah_tpu(grown, corpus, tmp_path, root_logger):
    _, extras, _ = corpus
    probes = [grown["inserted"][0], extras[2], grown["base"][0]]
    outs = {}
    for side, main, extra in (("j", jmain, []),
                              ("t", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{side}.tsv")
        argv = ["index", "--index-dir", grown[f"{side}_grown"], "-q",
                *extra, "query", "-f", *probes, "--output", out]
        assert main(argv) == 0
        with open(out, "rb") as fh:
            outs[side] = fh.read()
    assert outs["t"] == outs["j"]
    lines = outs["t"].decode().splitlines()
    assert lines[0] == "query\tdecision\trepresentative\tani"
    assert [ln.split("\t")[1] for ln in lines[1:]] == ["member", "novel",
                                                       "member"]
    # read-only
    assert TStore(grown["t_grown"]).generation() == 2


def test_remove_and_reelection_match_galah_tpu(grown, tmp_path):
    """A representative with two members, then one of its members, then
    a refused second removal: the same bytes and summaries."""
    dirs = {s: _copy(grown["j_grown"], tmp_path, s) for s in "jt"}
    state = TStore(dirs["t"]).load()
    rep = next(r for r in state.reps
               if sum(1 for v in state.membership.values() if v == r) >= 2)
    members = sorted(g for g, v in state.membership.items() if v == rep)
    for target, reelected in ((rep, members[0]), (members[1], None)):
        path = state.genomes[target]
        want = jinc.remove(JStore(dirs["j"]), path)
        got = tinc.remove(TStore(dirs["t"]), path)
        assert got == want
        assert got["removed"] == target and got["reelected"] == reelected
        assert _dir_bytes(dirs["t"]) == _dir_bytes(dirs["j"])
    after = TStore(dirs["t"]).load()
    assert rep in after.tombstones and members[0] in after.reps
    for g in members[2:]:
        assert after.membership[g] == members[0]
    with pytest.raises(ValueError, match="not a live genome"):
        tinc.remove(TStore(dirs["t"]), state.genomes[rep])
    audit = tfsck(dirs["t"])
    assert audit == jfsck(dirs["t"])
    assert audit["ok"] and audit["tombstones"] == 2


def _tail(d):
    with open(os.path.join(d, "pairs.jsonl"), "ab") as f:
        f.write(b'{"i": 0, "j": 99, "ani": 0.99}|deadbeef\n')


def _truncate(d):
    fn = os.path.join(d, "sketches.jsonl")
    size = os.path.getsize(fn)
    with open(fn, "rb+") as f:
        f.truncate(size // 2)


def _flip(d):
    fn = os.path.join(d, "genomes.jsonl")
    with open(fn, "rb") as f:
        raw = bytearray(f.read())
    raw[raw.index(b'"path"') + 10] ^= 0xFF
    with open(fn, "wb") as f:
        f.write(raw)


def _no_manifest(d):
    os.unlink(os.path.join(d, "gen-000002.json"))


@pytest.mark.parametrize("damage,ok,where", [
    (_tail, True, "pairs.jsonl"), (_truncate, False, "sketches.jsonl"),
    (_flip, False, "genomes.jsonl"), (_no_manifest, False, "gen-000002")])
def test_fsck_matches_galah_tpu(grown, tmp_path, damage, ok, where):
    """A torn tail past the commit point warns; a truncated or
    bit-flipped committed record, or a missing generation manifest, is a
    problem: the same report from both packages."""
    d = _copy(grown["t_grown"], tmp_path, "idx")
    damage(d)
    got = tfsck(d)
    assert got == jfsck(d)
    assert got["ok"] is ok
    found = got["warnings"] if ok else got["problems"]
    assert any(where in m for m in found), found


def test_fsck_cli_exit_codes(grown, tmp_path, capsys, root_logger):
    d = _copy(grown["t_grown"], tmp_path, "idx")
    assert tcli.main(["index", "--index-dir", d, "fsck"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "fsck: OK"
    _flip(d)
    assert tcli.main(["index", "--index-dir", d, "fsck"]) == 1
    assert capsys.readouterr().out.splitlines()[-1] == "fsck: FAILED"


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["already built", "different parameters",
                                  "no index at"])
def test_param_drift_refusals_match_galah_tpu(grown, tmp_path, case):
    d = grown["t_grown"]
    if case == "already built":
        calls = [lambda b: b(d, grown["base"], ani=0.95,
                             precluster_ani=0.90)]
    elif case == "different parameters":
        calls = [lambda b: b(d, grown["base"], ani=0.97,
                             precluster_ani=0.90)]
    else:
        calls = []
    if calls:
        want = _refusal(lambda: calls[0](jinc.build))
        got = _refusal(lambda: calls[0](
            lambda *a, **kw: tinc.build(*a, device=CPU, **kw)))
    else:
        nothing = str(tmp_path / "nothing")
        want = _refusal(lambda: JStore(nothing))
        got = _refusal(lambda: TStore(nothing))
    assert got == want and case in got
    assert _dir_bytes(d) == _dir_bytes(grown["j_grown"])


def test_insert_resketches_only_new_genomes(grown, corpus, tmp_path):
    """With a cold cache, only the genomes new to the index are read and
    sketched; replaying the insert commits nothing."""
    _, extras, _ = corpus
    dj = _copy(grown["j_grown"], tmp_path, "j")
    dt = _copy(grown["j_grown"], tmp_path, "t")
    new = [grown["inserted"][0], extras[0], extras[1]]
    clock = StageClock(CPU)
    info = tinc.insert(TStore(dt), new, device=CPU,
                       cache_dir=str(tmp_path / "cold"), clock=clock)
    assert (info["skipped"], info["inserted"]) == (1, 2)
    assert clock.counts["genomes-read"] == 2
    assert clock.counts["sketch-fused-jobs"] == 2
    jinc.insert(JStore(dj), new, cache_dir=grown["jcache"])
    assert _dir_bytes(dt) == _dir_bytes(dj)
    clock = StageClock(CPU)
    info = tinc.insert(TStore(dt), new, device=CPU,
                       cache_dir=str(tmp_path / "cold"), clock=clock)
    assert (info["skipped"], info["inserted"]) == (3, 0)
    assert info["generation"] == 3 and clock.counts["genomes-read"] == 0


def test_cli_insert_stop_exits_75_then_resume_converges(
        grown, corpus, tmp_path, monkeypatch, root_logger):
    """A stop requested mid-insert: exit 75 at index-batch-saved, the
    index loadable at the prior generation with an uncommitted tail;
    --resume writes the bytes of an uninterrupted insert (galah_tpu's
    own, too)."""
    _, extras, _ = corpus
    d = _copy(grown["t_grown"], tmp_path, "idx")
    ref = _copy(grown["j_grown"], tmp_path, "ref")
    jinc.insert(JStore(ref), extras[:2], cache_dir=grown["jcache"])
    orig = tinc.iter_path_sketches

    def tripping(paths, store, threads=1):
        for p, sk in orig(paths, store, threads):
            yield p, sk
            tinterrupt.request_stop("TEST")

    argv = ["index", "--index-dir", d, "--device", "cpu", "insert",
            "-f", extras[0], extras[1], "--sketch-cache",
            grown["tcache"], "--batch", "1"]
    monkeypatch.setattr(tinc, "iter_path_sketches", tripping)
    try:
        rc = tcli.main(argv)
    finally:
        tinterrupt.reset()
    assert rc == tinterrupt.EXIT_PREEMPTED
    idx = TStore(d)
    assert idx.generation() == 2
    chain = idx.load_interruptions()
    assert [(c["signal"], c["boundary"]) for c in chain] == [
        ("TEST", "index-batch-saved")]
    audit = tfsck(d)
    assert audit["ok"], audit["problems"]
    assert any("uncommitted tail" in w for w in audit["warnings"])
    monkeypatch.setattr(tinc, "iter_path_sketches", orig)
    try:
        rc = tcli.main(argv + ["--resume"])
    finally:
        tinterrupt.reset()
    assert rc == 0 and TStore(d).generation() == 3
    assert _dir_bytes(d) == _dir_bytes(ref)


def test_galah_tpu_resumes_a_port_stopped_insert(grown, corpus, tmp_path,
                                                 monkeypatch):
    """The port stops after its first batch; galah_tpu's insert on the
    same directory drops the tail and writes the uninterrupted bytes."""
    _, extras, _ = corpus
    d = _copy(grown["t_grown"], tmp_path, "idx")
    ref = _copy(grown["j_grown"], tmp_path, "ref")
    jinc.insert(JStore(ref), extras[:2], cache_dir=grown["jcache"])
    monkeypatch.setattr(tinterrupt, "check", _stop_at)
    with pytest.raises(tinterrupt.PreemptionRequested):
        tinc.insert(TStore(d), extras[:2], device=CPU, batch=1)
    assert TStore(d).generation() == 2
    assert len(TStore(d).begin_mutation().genomes) == 12
    jinc.insert(JStore(d), extras[:2], cache_dir=grown["jcache"])
    assert _dir_bytes(d) == _dir_bytes(ref)


def _stop_at(boundary):
    raise tinterrupt.PreemptionRequested(boundary, "TEST")


def test_clusters_from_state_match_port_engine(grown):
    """The persisted decisions re-derive the port's cluster engine
    output, order included, with the finch shim clusterer."""
    state = TStore(grown["t_grown"]).load()
    pre = MinHashPreclusterer(
        0.90, SketchStore(CPU, cache=diskcache.get_cache(grown["tcache"])))
    engine = tcluster(grown["full"], pre, tinc.SketchANIClusterer(0.95),
                      CPU)
    got = tinc.clusters_from_state(state)
    assert got == [list(c) for c in engine]
    assert got == jinc.clusters_from_state(JStore(grown["j_grown"]).load())
    assert len(got) == 4


# -- the insert pair pass against galah_tpu's host merge statistics ----


def _rows(rng, n, pool=None):
    """n sorted distinct uint64 values over the whole u64 range (or
    drawn from `pool`)."""
    if pool is not None:
        return np.sort(rng.choice(pool, size=n, replace=False))
    return np.unique(rng.integers(0, 2 ** 64 - 1, size=n + 64,
                                  dtype=np.uint64))[:n]


def _case_pairs(case, k, rng):
    """(a, b) sketch pairs of one edge case at sketch size k."""
    short = max(1, k // 3)
    full = _rows(rng, k)
    if case == "empty":
        return [(full[:0], full), (full, full[:0]), (full[:0], full[:0])]
    if case == "short":
        other = _rows(rng, k)
        return [(full[:short], full), (full, full[:short]),
                (full[:short], other[:short]),
                (np.union1d(full[:short], other[:2]), other[:short])]
    if case == "identical":
        return [(full, full.copy()), (full[:short], full[:short].copy())]
    if case == "disjoint":
        other = _rows(rng, k)
        other = other[~np.isin(other, full)]
        return [(full, other), (full[:short], other[:short])]
    # "threshold": pairs whose common straddles the keep rule's floor at
    # 90% ANI: c shared values, at random ranks, and k - c own values on
    # each side
    pairs = []
    for c in range(max(1, k // 10), max(2, k // 6)):
        pool = rng.permutation(_rows(rng, 2 * k))
        shared, own = pool[:c], pool[c:]
        pairs.append((np.sort(np.concatenate([shared, own[:k - c]])),
                      np.sort(np.concatenate([shared, own[k - c:2 * (k - c)]]))))
    return pairs


@pytest.mark.parametrize("k", [1000, 7])
@pytest.mark.parametrize("case", ["empty", "short", "identical",
                                  "disjoint", "threshold"])
def test_insert_pair_pass_equals_merge_stats(case, k):
    """The port's insert pair pass (plain version on the CPU) gives
    galah_tpu's merge_stats integers, and its kept pairs and ANI floats
    are pair_ani's (the port's host copies equal galah_tpu's), on rows
    shorter than the sketch size, empty rows, identical and disjoint
    rows, and pairs at the keep rule's floor."""
    rng = np.random.default_rng(1000 * k + len(case))
    pairs = _case_pairs(case, k, rng)
    flat = [s for ab in pairs for s in ab]
    mat = sketch_rows(flat, k, CPU)
    pi = np.arange(0, len(flat), 2, dtype=np.int64)
    pj = pi + 1
    common, total = pair_stats_for_pairs(mat, pi, pj, k)
    want = [jinc.merge_stats(a, b, k) for a, b in pairs]
    assert [tinc.merge_stats(a, b, k) for a, b in pairs] == want
    assert list(zip(common.tolist(), total.tolist())) == want
    # symmetric: insert and query list the new genome first
    swapped = pair_stats_for_pairs(mat, pj, pi, k)
    assert list(zip(*(t.tolist() for t in swapped))) == want
    j_thr = ani_to_jaccard(0.90, 21)
    ki, kj, anis = tinc.kept_pairs(mat, pi, pj, k, 21, j_thr,
                                   StageClock(CPU))
    got = dict(zip(ki.tolist(), anis.tolist()))
    want_ani = {2 * n: tinc.pair_ani(a, b, k, 21, j_thr)
                for n, (a, b) in enumerate(pairs)}
    assert list(want_ani.values()) == [jinc.pair_ani(a, b, k, 21, j_thr)
                                       for a, b in pairs]
    assert got == {n: v for n, v in want_ani.items() if v is not None}
    assert (kj == ki + 1).all()
    if case == "threshold" and k == 1000:
        assert 0 < len(got) < len(pairs)  # the floor falls inside


def test_pairs_below_skips_tombstones():
    live = np.array([0, 2, 3, 5, 6, 7], dtype=np.int64)
    pg, pu = tinc.pairs_below(live, 5, 8)
    assert pg.tolist() == [5] * 3 + [6] * 4 + [7] * 5
    assert pu.tolist() == [0, 2, 3, 0, 2, 3, 5, 0, 2, 3, 5, 6]


# -- the command line -----------------------------------------------------


def _split_env(text, env):
    head, tail = text.split(env, 1)
    return head, tail


def _split_model(text):
    """(page without the INDEX MODEL section's first paragraph, that
    paragraph)"""
    head, tail = text.split("INDEX MODEL\n", 1)
    para, rest = tail.split("\n\n", 1)
    return head + rest, para


@pytest.mark.parametrize("side", ["jax", "port"])
def test_index_full_help_matches_galah_tpu(side, monkeypatch, capsys):
    """On the same `index` parser, the port's text page equals
    galah_tpu's outside the ENVIRONMENT section, which names
    GALAH_TPU_INDEX_DIR, and the INDEX MODEL's first paragraph, which
    says that insert and query take their pairs on the device;
    `index --full-help` prints it with no card."""
    parser = (jbuild_parser()._subcommand_parsers["index"] if side == "jax"
              else tcli.build_parser().subcommand_parsers["index"])
    want, j_model = _split_model(jmanpage.render_full_help(parser, "index"))
    got, t_model = _split_model(tmanpage.render_full_help(parser, "index"))
    t_env = tmanpage.render_environment_section()
    assert "GALAH_TPU_INDEX_DIR" in t_env
    assert _split_env(got, t_env) == _split_env(
        want, jmanpage.render_environment_section())
    assert "host math" in j_model and "host math" not in t_model
    assert t_model.count("one device pass") == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["index", "--full-help"]) == 0
    assert capsys.readouterr().out == tmanpage.render_full_help(
        tcli.build_parser().subcommand_parsers["index"], "index")


@pytest.mark.parametrize("action", ["build", "insert", "query"])
def test_index_on_cuda_without_a_card_raises(grown, corpus, tmp_path,
                                             monkeypatch, action,
                                             root_logger):
    """build, insert and query run on the card unless asked for the CPU;
    without one they raise and the index is untouched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, extras, _ = corpus
    d = (str(tmp_path / "new") if action == "build"
         else _copy(grown["t_grown"], tmp_path, "idx"))
    before = _dir_bytes(d) if action != "build" else None
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["index", "--index-dir", d, action, "-f", extras[0]])
    if before is not None:
        assert _dir_bytes(d) == before
    else:
        assert not os.path.exists(d)


def test_build_without_quality_input_warns(corpus, tmp_path, caplog):
    """With no quality input, genomes enter in input order under the
    index's own warning (once a process, as galah_tpu warns it),
    counted as index-quality-fallback."""
    from galah_tpu_torch.obs.events import reset_warn_once

    reset_warn_once()
    fams, _, _ = corpus
    args = tcli.parse_args(["index", "--index-dir", str(tmp_path / "idx"),
                            "--device", "cpu", "build", "-f",
                            *fams[1][::-1]])
    with caplog.at_level(logging.WARNING):
        res = tcli.run_index(args)
    assert "genomes enter the index in input order" in caplog.text
    assert res.clock.counts["index-quality-fallback"] == 1
    assert TStore(str(tmp_path / "idx")).load().genomes == [
        os.path.abspath(p) for p in fams[1][::-1]]
    assert res.info["clusters"] == 1


def test_index_cli_user_errors(grown, tmp_path, monkeypatch, root_logger,
                               capsys):
    """No action, no directory, an unsupported flag: galah_tpu's exit
    codes; GALAH_TPU_INDEX_DIR stands in for --index-dir."""
    monkeypatch.delenv("GALAH_TPU_INDEX_DIR", raising=False)
    assert tcli.main(["index", "--index-dir", grown["t_grown"]]) == 1
    assert tcli.main(["index", "fsck"]) == 1
    monkeypatch.setenv("GALAH_TPU_INDEX_DIR", grown["t_grown"])
    assert tcli.main(["index", "fsck"]) == 0
    assert "fsck: OK" in capsys.readouterr().out
    assert tcli.main(["index", "--index-dir", str(tmp_path / "none"),
                      "--device", "cpu", "remove", "-f",
                      grown["base"][0]]) == 1
    # --trace-events and --run-report parse now
    # (test_torch_cluster.test_cli_accepts_observability_flag), and so
    # does --platform, before the action as in galah_tpu
    assert tcli.parse_args(["index", "--index-dir", "d", "--platform=cpu",
                            "fsck"]).platform == "cpu"
    assert tcli.main(["index", "--platform=cpu", "fsck"]) == 0
    assert "fsck: OK" in capsys.readouterr().out
