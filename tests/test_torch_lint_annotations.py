"""The lint's annotation families against ``galah-tpu lint``'s: GL8xx
concurrency, GL9xx determinism, GL10xx pipeline and GL704 flow
discipline, on the fixtures of tests/data/lint_fixtures (read only,
loaded under a galah_tpu/ path for galah_tpu's checker and the
matching galah_tpu_torch/ path for the port's); torch's idioms of
GL901, GL903, GL904, GL1002 and GL1006 on fixtures written here; and
the port's own annotations (the 15 threaded modules, the 7 strategy
modules, the 3 stage modules), each family clean on the tree.

Tolerance: none. Findings equal as (code, severity, line, message)
once galah_tpu's messages have the package name mapped, GL804's
adoption API named as the port's (``timing.stage_token()`` ->
``obs/flow.token()``, ``timing.adopt`` -> ``obs/flow.adopt``) and
GL901's history note dropped.
"""

import ast
import json
import pathlib
import re

import pytest

from galah_tpu.analysis import concurrency_check as jconc
from galah_tpu.analysis import core as jcore
from galah_tpu.analysis import determinism_check as jdet
from galah_tpu.analysis import pipeline_check as jpipe
from galah_tpu.analysis.obs_check import check_obs_file as jcheck_obs
from galah_tpu_torch.analysis import (CHECK_NAMES, DEFAULT_BASELINE,
                                      load_sources, repo_root, run_checks,
                                      run_lint)
from galah_tpu_torch.analysis import concurrency_check as conc
from galah_tpu_torch.analysis import core
from galah_tpu_torch.analysis import determinism_check as det
from galah_tpu_torch.analysis import pipeline_check as pipe
from galah_tpu_torch.analysis.concurrency_check import harvest_literal
from galah_tpu_torch.analysis.core import Severity, SourceFile
from galah_tpu_torch.analysis.obs_check import check_obs_file

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "data" / "lint_fixtures"


def _load(loader, name, path):
    src = loader.load(str(FIXTURES / name))
    src.path = path
    return src


def _mapped(message):
    out = re.sub(r"galah[_-]tpu(?!_torch)", "galah_tpu_torch", message)
    out = out.replace("timing.stage_token()", "obs/flow.token()")
    out = out.replace("timing.adopt(token)", "obs/flow.adopt(token)")
    return re.sub(r" \(the [A-Z]+ \d+ class\)", "", out)


def _key(findings, mapped=False):
    return sorted((f.code, str(f.severity), f.line,
                   _mapped(f.message) if mapped else f.message,
                   f.suppressed) for f in findings)


def _by_code(findings):
    out = {}
    for f in findings:
        out.setdefault(f.code, []).append(f.line)
    return {c: sorted(v) for c, v in out.items()}


def _text(path, text):
    return SourceFile(path=path, text=text, tree=ast.parse(text))


# ---------------------------------------------------------------------------
# galah_tpu's fixtures through both checkers
# ---------------------------------------------------------------------------


def _concurrency(loader, check, name, path):
    src = _load(loader, name, path)
    return check({src.path: src})


def _per_file(loader, check, name, path):
    return check(_load(loader, name, path))


# case -> (fixture, galah_tpu's path, the port's path, runner, galah_tpu's
# checker, the port's checker, galah_tpu's expected {code: lines})
CASES = {
    "bad_concurrency": (
        "bad_concurrency.py", "fixtures/bad_concurrency.py",
        "fixtures/bad_concurrency.py", _concurrency,
        jconc.check_concurrency, conc.check_concurrency,
        {"GL801": [28, 31, 35], "GL802": [40], "GL803": [46],
         "GL804": [55, 56]}),
    "clean_concurrency": (
        "clean_concurrency.py", "fixtures/clean_concurrency.py",
        "fixtures/clean_concurrency.py", _concurrency,
        jconc.check_concurrency, conc.check_concurrency, {}),
    "bad_determinism": (
        "bad_determinism.py", "fixtures/bad_determinism.py",
        "fixtures/bad_determinism.py", _per_file,
        jdet.check_determinism_file, det.check_determinism_file,
        {"GL902": [22, 23, 25], "GL903": [15, 16], "GL904": [30, 31],
         "GL905": [1]}),
    "bad_masked_sum": (
        "bad_masked_sum.py", "fixtures/bad_masked_sum.py",
        "fixtures/bad_masked_sum.py", _per_file,
        jdet.check_determinism_file, det.check_determinism_file,
        {"GL901": [21, 25, 30]}),
    "missing_contract": (
        "missing_contract.py", jdet.STRATEGY_MODULES[0],
        det.STRATEGY_MODULES[0], _per_file,
        jdet.check_determinism_file, det.check_determinism_file,
        {"GL905": [1]}),
    "bad_pipeline": (
        "bad_pipeline.py", "galah_tpu/ops/bad_pipeline.py",
        "galah_tpu_torch/ops/bad_pipeline.py", _per_file,
        jpipe.check_pipeline_file, pipe.check_pipeline_file,
        {"GL1001": [36, 38, 50], "GL1002": [27], "GL1003": [43, 44, 45],
         "GL1004": [14], "GL1005": [14, 14]}),
    "clean_pipeline": (
        "clean_pipeline.py", "galah_tpu/ops/clean_pipeline.py",
        "galah_tpu_torch/ops/clean_pipeline.py", _per_file,
        jpipe.check_pipeline_file, pipe.check_pipeline_file, {}),
    "bad_megakernel": (
        "bad_megakernel.py", "galah_tpu/ops/bad_megakernel.py",
        "galah_tpu_torch/ops/bad_megakernel.py", _per_file,
        jpipe.check_pipeline_file, pipe.check_pipeline_file,
        {"GL1005": [7], "GL1006": [13, 14, 15, 16]}),
    "bad_flow": (
        "bad_flow.py", "galah_tpu/ops/bad_flow.py",
        "galah_tpu_torch/ops/bad_flow.py", _per_file,
        jcheck_obs, check_obs_file, {"GL704": [8, 19, 24, 27]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixture_findings_match_galah_tpu(case):
    """Code for code, line for line, message for message, with the
    inline suppressions applied the same way; galah_tpu's findings are
    those its own tests pin."""
    name, jpath, tpath, run, jcheck, tcheck, lines = CASES[case]
    want = run(jcore.SourceFile, jcheck, name, jpath)
    got = run(SourceFile, tcheck, name, tpath)
    for findings, mod, path in ((want, jcore, jpath), (got, core, tpath)):
        src = _load(mod.SourceFile, name, path)
        mod.apply_suppressions(findings, {src.path: src}, {})
    assert _by_code(want) == lines
    assert _key(got) == _key(want, mapped=True)


def test_paged_fixture_lexical_arm_matches_galah_tpu(monkeypatch):
    """GL1007's lexical arm on paged_bad.py as the port's
    ops/bucketing.py, whose band walk both registries name."""
    path = "galah_tpu_torch/ops/bucketing.py"
    assert pipe.PAGED_MODULES[path] == \
        jpipe.PAGED_MODULES["galah_tpu/ops/bucketing.py"]
    want = jpipe.check_pipeline_file(
        _load(jcore.SourceFile, "paged_bad.py", "galah_tpu/ops/bucketing.py"))
    got = pipe.check_pipeline_file(_load(SourceFile, "paged_bad.py", path))
    assert [(f.code, f.line) for f in want] == [("GL1007", 31),
                                                ("GL1007", 34)]
    assert _key(got) == _key(want, mapped=True)
    assert all(f.symbol == "bucketed_threshold_pairs" for f in got)
    # outside the registry the rule stays dark
    assert pipe.check_pipeline_file(_load(
        SourceFile, "paged_bad.py", "galah_tpu_torch/ops/other.py")) == []


def test_threaded_module_without_annotations_fires_gl805():
    text = "import threading\n_L = threading.Lock()\n"
    found = conc.check_concurrency(
        {"galah_tpu_torch/obs/metrics.py":
         _text("galah_tpu_torch/obs/metrics.py", text)})
    assert [f.code for f in found] == ["GL805"]
    assert "GUARDED_BY" in found[0].message


@pytest.mark.parametrize("text, code", [
    ("GUARDED_BY = {'C._x': 'C._lock'}\nclass C:\n    pass\n", "GL805"),
    ("LOCK_ORDER = ['_NOPE']\n", "GL805"),
    ("GUARDED_BY = {}\nLOCK_ORDER = []\nimport threading\n"
     "_L = threading.RLock()\n"
     "def f():\n    with _L:\n        with _L:\n            pass\n", None),
])
def test_concurrency_hygiene_and_reentrant_locks(text, code):
    """A stale entry and an unknown lock are GL805; re-entering an
    RLock is not GL803 (both packages agree)."""
    got = conc.check_concurrency({"m.py": _text("m.py", text)})
    jsrc = jcore.SourceFile(path="m.py", text=text, tree=ast.parse(text))
    assert _key(got) == _key(jconc.check_concurrency({"m.py": jsrc}),
                             mapped=True)
    assert [f.code for f in got] == ([code] if code else [])


def test_gl804_accepts_the_port_adoption_idioms():
    """A Thread target or pool callable run under obs/flow.adopt,
    directly or through a wrapper that adopts
    (io/prefetch._adopting), is clean; a bare one is not."""
    text = (
        "import threading\n"
        "from galah_tpu_torch.obs import flow as obs_flow\n"
        "GUARDED_BY = {}\nLOCK_ORDER = []\n"
        "def _adopting(fn):\n"
        "    token = obs_flow.token()\n"
        "    def wrapped(*a):\n"
        "        with obs_flow.adopt(token):\n"
        "            return fn(*a)\n"
        "    return wrapped\n"
        "def read(p):\n    return p\n"
        "def spawn(pool):\n"
        "    pool.submit(_adopting(read), 'a')\n"
        "    threading.Thread(target=_adopting(read)).start()\n"
        "    pool.submit(read, 'b')\n")
    found = conc.check_concurrency({"m.py": _text("m.py", text)})
    assert [(f.code, f.line) for f in found] == [("GL804", 16)]
    assert "obs/flow.adopt(token)" in found[0].message


# ---------------------------------------------------------------------------
# torch's idioms
# ---------------------------------------------------------------------------

TORCH_DETERMINISM = '''\
import torch

DETERMINISM_CONTRACT = {
    "family": "fragment",
    "dtype": "float64",
    "functions": ["bad_sums", "bad_narrowing", "good_sums",
                  "good_wide"],
}


def bad_sums(x, ok, idx, out):
    filled = torch.where(ok, x, 0)
    a = filled.sum()
    b = torch.sum(torch.where(ok, x, 0.0))
    out.index_add_(0, idx, filled)
    out.scatter_add_(0, idx, torch.where(ok, x, 0))
    return a, b, out.index_add(0, idx, source=filled)


def bad_narrowing(x):
    y = x.float()
    z = x.to(torch.float32)
    w = torch.zeros(4, dtype=torch.float32)
    v = x.to(x.device, torch.float)
    return y, z, w, v


def good_sums(x, ok, idx, out):
    kept = x[ok]
    out.index_add_(0, idx[ok], kept)
    return kept.sum(), torch.sum(kept), torch.where(ok, x, 1.0).sum()


def good_wide(x):
    return x.double(), x.to(torch.float64), float(x.sum())
'''

TORCH_RNG = '''\
import torch


def bad_rng(n, dev):
    torch.manual_seed(0)
    a = torch.rand(n)
    b = torch.randint(0, 4, (n,))
    c = torch.randperm(n, device=dev)
    d = torch.normal(0.0, 1.0, (n,))
    gen = torch.Generator()
    return a, b, c, d, torch.randn(n, generator=gen)


def good_rng(n, seed):
    g = torch.Generator()
    g.manual_seed(seed)
    h = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.rand(n, generator=g),
            torch.randint(0, 4, (n,), generator=h),
            torch.randperm(n, generator=g))
'''

TORCH_PIPELINE = '''\
import torch

from galah_tpu_torch.device import synchronize
from galah_tpu_torch.obs import metrics

PIPELINE_STAGE = {
    "streaming": ["iter_rows"],
    "occupancy_gauge": "workload.pipeline_occupancy",
    "device_round": ["_fold_body"],
}


def iter_rows(blocks, dev, ev, stream):
    for b in blocks:
        torch.cuda.synchronize(dev)
        synchronize(dev)
        ev.synchronize()
        stream.synchronize()
        yield b


def _fold_body(x, count):
    n = count.item()
    xs = x.tolist()
    h = x.cpu()
    a = x.numpy()
    return n, xs, h, a


def host_wrapper(x, dev):
    torch.cuda.synchronize(dev)
    metrics.pipeline_occupancy(0.5, stage="rows")
    return x.cpu().numpy(), x.item(), x.tolist()
'''


def test_torch_determinism_idioms_fire_and_stay_clean():
    """GL901 over torch.where fills summed by .sum(), torch.sum,
    index_add(_) and scatter_add_; GL903 over .float(),
    .to(torch.float32 / torch.float) and dtype=torch.float32; the
    compressed and widening forms are clean."""
    found = det.check_determinism_file(_text("fixtures/t_det.py",
                                             TORCH_DETERMINISM))
    assert _by_code(found) == {"GL901": [13, 14, 15, 16, 17],
                               "GL903": [21, 22, 23, 24]}
    assert all(f.symbol.startswith("bad_") for f in found)
    assert {f.severity for f in found if f.code == "GL901"} == {
        Severity.ERROR}


def test_torch_rng_idioms_fire_and_stay_clean():
    """GL904: the global seed, sampling without generator=, and a
    Generator never seeded; seeded generators pass."""
    found = det.check_determinism_file(_text(
        "galah_tpu_torch/ops/t_rng.py", TORCH_RNG))
    assert _by_code(found) == {"GL904": [5, 6, 7, 8, 9, 10]}
    msgs = {f.line: f.message for f in found}
    assert "process-global torch generator" in msgs[5]
    assert "without generator=" in msgs[6]
    assert "never seeded" in msgs[10]
    # outside the pipeline-module scope with no contract: silent
    assert det.check_determinism_file(_text("tests/t_rng.py",
                                            TORCH_RNG)) == []


def test_torch_sync_idioms_fire_in_stages_only():
    """GL1002 over torch.cuda.synchronize, device.synchronize and an
    Event's or Stream's .synchronize() in a streaming stage; GL1006
    over .item(), .tolist(), .cpu() and .numpy() in a device-round
    body; the same calls in an undeclared wrapper are silent."""
    found = pipe.check_pipeline_file(_text(
        "galah_tpu_torch/ops/t_pipe.py", TORCH_PIPELINE))
    assert _by_code(found) == {"GL1002": [15, 16, 17, 18],
                               "GL1006": [23, 24, 25, 26]}
    assert {f.symbol for f in found} == {"iter_rows", "_fold_body"}


def test_galah_tpu_fixtures_keep_their_findings_under_torch_sets():
    """The torch names added to the sync sets leave galah_tpu's names
    in place, so its fixtures give its findings (above) and its sets
    are subsets of the port's."""
    assert jpipe.SYNC_CALLS <= pipe.SYNC_CALLS
    assert jpipe.DEVICE_ROUND_SYNC_CALLS <= pipe.DEVICE_ROUND_SYNC_CALLS
    assert jdet._WHERE_CALLS <= det._WHERE_CALLS
    assert jdet._SUM_CALLS <= det._SUM_CALLS


# ---------------------------------------------------------------------------
# the port's own annotations
# ---------------------------------------------------------------------------


def _port_source(rel):
    return SourceFile.load(str(REPO / rel), rel_to=str(REPO))


def test_registries_name_the_ports_modules():
    # galah_tpu's 15 less resilience/dispatch.py (not ported), and the
    # port's C parser, C collision counter and page store
    assert len(jconc.THREADED_MODULES) == 15
    assert len(conc.THREADED_MODULES) == 17
    # the eight strategy families (bucketing's among them), and
    # ops/megakernel.py and ops/device_queue.py
    assert len(det.STRATEGY_MODULES) == 10
    for rel in conc.THREADED_MODULES + det.STRATEGY_MODULES:
        assert (REPO / rel).is_file(), rel
        assert rel.startswith("galah_tpu_torch/")


@pytest.mark.parametrize("rel", sorted(conc.THREADED_MODULES))
def test_threaded_module_declares_its_locks(rel):
    """GUARDED_BY and LOCK_ORDER are literals; every lock the module
    constructs is declared, and every declared lock is one it makes."""
    src = _port_source(rel)
    guarded = harvest_literal(src.tree, "GUARDED_BY")
    order = harvest_literal(src.tree, "LOCK_ORDER")
    assert isinstance(guarded, dict) and isinstance(order, list)
    declared = set(guarded.values()) | set(order)
    made = set()
    for node in src.walk():
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and core.dotted_name(node.value.func).endswith("Lock")):
            for t in node.targets:
                name = core.dotted_name(t)
                if name.startswith("self."):
                    cls = next(c.name for c in src.tree.body
                               if isinstance(c, ast.ClassDef)
                               and c.lineno <= node.lineno <= c.end_lineno)
                    name = f"{cls}.{name[5:]}"
                made.add(name)
    # a cross-module entry ("path.py:NAME", a lock taken while one of
    # this module's is held) names a lock its own module declares
    for entry in sorted(d for d in declared if ":" in d):
        other, name = entry.split(":", 1)
        assert other in conc.THREADED_MODULES, (rel, entry)
        osrc = _port_source(other)
        assert name in (set(harvest_literal(osrc.tree, "GUARDED_BY")
                            .values())
                        | set(harvest_literal(osrc.tree, "LOCK_ORDER"))), \
            (rel, entry)
    declared = {d for d in declared if ":" not in d}
    # metrics' per-metric `_lock or threading.Lock()` is a BoolOp, and
    # each metric is declared by its class
    assert declared <= made | {f"{c}._lock" for c in
                               ("Counter", "Gauge", "Histogram")}, rel
    assert made <= declared, rel


@pytest.mark.parametrize("rel", sorted(det.STRATEGY_MODULES))
def test_strategy_module_contract_names_its_functions(rel):
    src = _port_source(rel)
    contract = harvest_literal(src.tree, "DETERMINISM_CONTRACT")
    assert contract["dtype"] in ("int32", "float64", "uint64")
    defs = {n.name for n in src.walk()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert set(contract["functions"]) <= defs


@pytest.mark.parametrize("rel, streaming, gauge", [
    ("galah_tpu_torch/ops/sketch_stream.py",
     ["iter_path_sketches", "iter_sketch_row_blocks"],
     "workload.pipeline_occupancy"),
    ("galah_tpu_torch/ops/pairwise.py",
     ["iter_threshold_pairs_streamed", "threshold_pairs_streamed"],
     "workload.pipeline_occupancy"),
    ("galah_tpu_torch/index/incremental.py", ["iter_insert_sketches"],
     None),
    ("galah_tpu_torch/cluster/engine.py", ["_cluster_overlapped"],
     "workload.pipeline_occupancy"),
])
def test_stage_modules_declare_their_streams(rel, streaming, gauge):
    stage = harvest_literal(_port_source(rel).tree, "PIPELINE_STAGE")
    assert stage["streaming"] == streaming
    assert stage.get("occupancy_gauge") == gauge
    assert "device_round" not in stage


def test_check_names_and_empty_baseline():
    for name in ("concurrency", "determinism", "pipeline", "effects"):
        assert name in CHECK_NAMES
    with open(DEFAULT_BASELINE) as fh:
        assert json.load(fh)["findings"] == []


@pytest.mark.parametrize("family", ["concurrency", "determinism",
                                    "pipeline", "obs", "effects"])
def test_port_tree_is_clean_per_family(family):
    """Each family over the port's tree, with its inline suppressions
    (each carries its reason) and the empty baseline."""
    found = run_lint(checks=(family,))
    bad = [f for f in found if not f.suppressed]
    assert not bad, [(f.path, f.line, f.message) for f in bad]
    for f in found:
        lines = _port_source(f.path).text.splitlines()
        at = f.line - 1 if f"ignore[{f.code}" in lines[f.line - 1] \
            else f.line - 2
        after = lines[at].split("]", 1)[1].strip()
        above = lines[at - 1].strip()
        # the reason follows the marker, or is the comment above it
        assert after or above.startswith("#"), (f.path, f.line)


def test_family_timings_are_reported():
    timings = {}
    run_checks(load_sources(repo_root()), ("concurrency", "determinism",
                                           "pipeline"), timings=timings)
    assert set(timings) == {"concurrency", "determinism", "pipeline"}
