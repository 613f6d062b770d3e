"""The lint's GL11xx effects family and its GalahIR against
``galah-tpu lint``'s: galah_tpu's effects fixtures (tests/data/
lint_fixtures, read only) through both packages' ``check_effects``;
name resolution and effect propagation on the texts of galah_tpu's own
IR tests; torch's sinks (``.cpu()`` / ``.tolist()`` / ``.numpy()``,
``lib.<name>_launch``, torch's RNG) and the build installers; the IR
cache, cold and warm, corrupt, disabled and shared with galah_tpu's;
and ``lint --ir-cache-dir`` / ``GALAH_TPU_IR_CACHE`` end to end.

Tolerance: none. Findings equal as (code, severity, line, symbol,
message) once galah_tpu's messages have the package name mapped and
GL1105's adoption API named as the port's (``obs.timing.adopt`` ->
``obs/flow.adopt(token)``); effects equal as their rendered witness
chains, paths mapped.
"""

import ast
import json
import os
import pathlib
import re
import textwrap

import pytest

from galah_tpu.analysis import core as jcore
from galah_tpu.analysis import effects_check as jeff
from galah_tpu.analysis import ir as jir
from galah_tpu.analysis import pipeline_check as jpipe
from galah_tpu_torch.analysis import load_sources, main, repo_root
from galah_tpu_torch.analysis import effects_check as eff
from galah_tpu_torch.analysis import core, fs_check
from galah_tpu_torch.analysis import ir
from galah_tpu_torch.analysis import pipeline_check as pipe
from galah_tpu_torch.analysis.core import CudaFile, Severity, SourceFile

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "data" / "lint_fixtures"


def _port_text(text):
    """galah_tpu's text or path as the port would hold it: the package
    named the port."""
    return re.sub(r"\bgalah_tpu(?!_torch)\b", "galah_tpu_torch", text)


def _mapped(message):
    out = re.sub(r"galah[_-]tpu(?!_torch)", "galah_tpu_torch", message)
    return out.replace("(obs.timing.adopt)", "(obs/flow.adopt(token))")


def _src(mod, path, text):
    return mod.SourceFile(path=path, text=text, tree=ast.parse(text))


def _pair(path, text):
    """The same text as galah_tpu's SourceFile at `path` and as the
    port's at the mapped path, with mapped imports."""
    text = textwrap.dedent(text)
    return (_src(jcore, path, text),
            _src(core, _port_text(path), _port_text(text)))


def _key(findings, mapped=False):
    return sorted((f.code, str(f.severity), f.line, f.symbol,
                   _mapped(f.message) if mapped else f.message)
                  for f in findings)


# ---------------------------------------------------------------------------
# galah_tpu's fixtures through both checkers
# ---------------------------------------------------------------------------

# case -> (fixture, galah_tpu's path, galah_tpu's findings as its tests
# pin them: (code, line, symbol))
FIXTURE_CASES = {
    "bad_megakernel_indirect": (
        "bad_megakernel_indirect.py", "galah_tpu/ops/mk_indirect.py",
        [("GL1101", 22, "_fold_round")]),
    "bad_effects_durable": (
        "bad_effects_durable.py", "galah_tpu/obs/ledger.py",
        [("GL1102", 26, "append_record"), ("GL1104", 30, "rotate"),
         ("GL1105", 42, "_flush_cb")]),
    "bad_effects_stream": (
        "bad_effects_stream.py", "galah_tpu/fleet/stage.py",
        [("GL1103", 17, "iter_windows")]),
    "clean_effects": (
        "clean_effects.py", "galah_tpu/index/store.py", []),
    "paged_bad": (
        "paged_bad.py", "galah_tpu/ops/bucketing.py",
        [("GL1007", 33, "gather")]),
}


def _fixture_pair(name, jpath):
    text = (FIXTURES / name).read_text()
    jsrc = jcore.SourceFile(path=jpath, text=text, tree=ast.parse(text))
    tpath, ttext = _port_text(jpath), _port_text(text)
    tsrc = SourceFile(path=tpath, text=ttext, tree=ast.parse(ttext))
    return jsrc, tsrc


@pytest.mark.parametrize("case", sorted(FIXTURE_CASES))
def test_fixture_findings_match_galah_tpu(case, monkeypatch):
    """Code for code, line for line, symbol for symbol, message for
    message; galah_tpu's findings are those its own tests pin. The
    paged fixture runs as the port's ops/bucketing.py, whose band walk
    the port's PAGED_MODULES names as galah_tpu's does."""
    name, jpath, pinned = FIXTURE_CASES[case]
    jsrc, tsrc = _fixture_pair(name, jpath)
    if case == "paged_bad":
        assert pipe.PAGED_MODULES[tsrc.path] == \
            jpipe.PAGED_MODULES[jsrc.path] == ["bucketed_threshold_pairs"]
    want = jeff.check_effects({jsrc.path: jsrc})
    got = eff.check_effects({tsrc.path: tsrc})
    assert sorted((f.code, f.line, f.symbol) for f in want) == \
        sorted(pinned)
    assert _key(got) == _key(want, mapped=True)
    assert all(f.severity is Severity.WARNING for f in got)


def test_gl1105_names_the_ports_adoption_api():
    _, tsrc = _fixture_pair("bad_effects_durable.py",
                            "galah_tpu/obs/ledger.py")
    found = {f.code: f for f in eff.check_effects({tsrc.path: tsrc})}
    assert "obs/flow.adopt(token)" in found["GL1105"].message
    assert "timing" not in found["GL1105"].message
    assert "append_record -> _dump" in found["GL1102"].message
    assert "galah_tpu_torch/obs/ledger.py:21" in found["GL1102"].message


def test_fixture_paths_are_in_the_ports_scopes():
    assert "galah_tpu_torch/obs/ledger.py" in fs_check.DURABLE_MODULES
    assert "galah_tpu_torch/index/store.py" in fs_check.DURABLE_MODULES
    assert pipe.in_scope("galah_tpu_torch/fleet/stage.py")
    assert not pipe.in_scope("galah_tpu_torch/obs/stage.py")
    # out of GL1103's scope, the stream fixture is silent in both
    jsrc, tsrc = _fixture_pair("bad_effects_stream.py",
                               "galah_tpu/obs/stage.py")
    assert jeff.check_effects({jsrc.path: jsrc}) == []
    assert eff.check_effects({tsrc.path: tsrc}) == []


# ---------------------------------------------------------------------------
# name resolution and propagation: galah_tpu's IR test texts
# ---------------------------------------------------------------------------

_SINK = ("galah_tpu/pkg/sink.py", '''
    def pull(v):
        return v.item()
''')

RESOLUTION_CASES = {
    "plain_import": [_SINK, ("galah_tpu/pkg/user.py", '''
        import galah_tpu.pkg.sink
        def f(v):
            return galah_tpu.pkg.sink.pull(v)
    ''')],
    "import_as": [_SINK, ("galah_tpu/pkg/user.py", '''
        import galah_tpu.pkg.sink as sk
        def f(v):
            return sk.pull(v)
    ''')],
    "from_import_as": [_SINK, ("galah_tpu/pkg/user.py", '''
        from galah_tpu.pkg.sink import pull as grab
        def f(v):
            return grab(v)
    ''')],
    "module_alias": [_SINK, ("galah_tpu/pkg/user.py", '''
        from galah_tpu.pkg.sink import pull
        fetch = pull
        def f(v):
            return fetch(v)
    ''')],
    "decorators": [("galah_tpu/pkg/deco.py", '''
        import functools
        import jax

        def profiled(fn):
            return fn

        @profiled
        def sync_inner(v):
            return v.item()

        @functools.partial(jax.jit, static_argnums=0)
        def fold(n, v):
            return v + n

        def caller(v):
            return sync_inner(v)
    ''')],
    "partial_ref_submit": [("galah_tpu/pkg/cb.py", '''
        import functools

        def sink(v):
            return v.item()

        def via_partial(run, v):
            return run(functools.partial(sink, v))

        def via_while_loop(lax, cond, v):
            return lax.while_loop(cond, sink, v)

        def via_submit(pool, v):
            return pool.submit(sink, v)
    ''')],
    "cycle": [("galah_tpu/pkg/cyc.py", '''
        def a(v, n):
            if n:
                return b(v, n - 1)
            return 0

        def b(v, n):
            v.item()
            return a(v, n)
    ''')],
    "nested_and_methods": [("galah_tpu/pkg/nest.py", '''
        class Folder:
            def pull(self, v):
                return v.item()

            def round(self, v):
                return self.pull(v)

        def outer(v):
            def inner(x):
                return x.item()
            return inner(v)
    ''')],
    "sanctioned_writer": [("galah_tpu/io/atomic.py", '''
        def write_json(path, obj):
            with open(path, "w") as fh:
                fh.write(obj)
    '''), ("galah_tpu/obs/ledger.py", '''
        from galah_tpu.io.atomic import write_json
        def save(path, rec):
            write_json(path, rec)
    ''')],
}

# what galah_tpu's tests assert of each case, as (path, function,
# effect, present)
RESOLUTION_EXPECT = {
    "plain_import": [("galah_tpu/pkg/user.py", "f", "host_sync", True)],
    "import_as": [("galah_tpu/pkg/user.py", "f", "host_sync", True)],
    "from_import_as": [("galah_tpu/pkg/user.py", "f", "host_sync", True)],
    "module_alias": [("galah_tpu/pkg/user.py", "f", "host_sync", True)],
    "decorators": [("galah_tpu/pkg/deco.py", "caller", "host_sync", True)],
    "partial_ref_submit": [
        ("galah_tpu/pkg/cb.py", "via_partial", "host_sync", True),
        ("galah_tpu/pkg/cb.py", "via_while_loop", "host_sync", True),
        ("galah_tpu/pkg/cb.py", "via_submit", "host_sync", False)],
    "cycle": [("galah_tpu/pkg/cyc.py", "a", "host_sync", True),
              ("galah_tpu/pkg/cyc.py", "b", "host_sync", True)],
    "nested_and_methods": [
        ("galah_tpu/pkg/nest.py", "Folder.round", "host_sync", True),
        ("galah_tpu/pkg/nest.py", "outer", "host_sync", True)],
    "sanctioned_writer": [
        ("galah_tpu/io/atomic.py", "write_json", "fs_write", True),
        ("galah_tpu/obs/ledger.py", "save", "fs_write", False)],
}


def _programs(case):
    jsrcs, tsrcs = {}, {}
    for path, text in RESOLUTION_CASES[case]:
        jsrc, tsrc = _pair(path, text)
        jsrcs[jsrc.path], tsrcs[tsrc.path] = jsrc, tsrc
    return jir.build_program_ir(jsrcs), ir.build_program_ir(tsrcs)


def _chains(prog, mapped):
    out = {}
    for key in prog.functions:
        path = _port_text(key[0]) if mapped else key[0]
        for effect, wit in prog.effects_of(key).items():
            if mapped and effect == "device_dispatch" \
                    and wit.detail == "jit-decorated body":
                continue  # JAX's dispatch; the port has no jit
            chain = prog.render_chain(key, effect)
            out[(path, key[1], effect)] = (_mapped(chain) if mapped
                                           else chain)
        out[(path, key[1], "adopts")] = prog.adopts(key)
    return out


@pytest.mark.parametrize("case", sorted(RESOLUTION_CASES))
def test_resolution_and_chains_match_galah_tpu(case):
    """Every function's effects and witness chains equal galah_tpu's on
    the same text (paths and imports mapped), and galah_tpu's own
    assertions on the case hold for both."""
    jprog, tprog = _programs(case)
    assert _chains(tprog, False) == _chains(jprog, True)
    for path, fn, effect, present in RESOLUTION_EXPECT[case]:
        assert (effect in jprog.effects_of((path, fn))) is present
        assert (effect in tprog.effects_of(
            (_port_text(path), fn))) is present
    if case == "decorators":
        assert "device_dispatch" in jprog.effects_of(
            ("galah_tpu/pkg/deco.py", "fold"))
        assert tprog.effects_of(("galah_tpu_torch/pkg/deco.py",
                                 "fold")) == {}
        assert tprog.functions[("galah_tpu_torch/pkg/deco.py",
                                "sync_inner")].decorators == ["profiled"]
    if case == "partial_ref_submit":
        fn = tprog.functions[("galah_tpu_torch/pkg/cb.py", "via_submit")]
        assert [e.kind for e in fn.calls if e.name == "sink"] == ["submit"]
    if case == "cycle":
        chain = tprog.witness_chain(("galah_tpu_torch/pkg/cyc.py", "a"),
                                    "host_sync")
        assert chain[-1][1].direct
    if case == "sanctioned_writer":
        assert ir.SANCTIONED_WRITER == "galah_tpu_torch/io/atomic.py"


# ---------------------------------------------------------------------------
# torch's sinks
# ---------------------------------------------------------------------------

MK_TORCH = '''\
PIPELINE_STAGE = {{
    "device_round": ["_fold_round"],
}}


def _pull(count):
    return count.{call}()


def _fold_round(qi, count):
    n = _pull(count)
    return qi, n
'''


@pytest.mark.parametrize("call", ["cpu", "tolist", "numpy"])
def test_gl1101_sees_torch_host_syncs_behind_a_helper(call):
    """A device_round body calling a helper that does .cpu() /
    .tolist() / .numpy() fires GL1101 with the chain; the lexical
    GL1006 stays silent (galah_tpu's sets see none of the three)."""
    path = "galah_tpu_torch/ops/mk_torch.py"
    text = MK_TORCH.format(call=call)
    src = SourceFile(path=path, text=text, tree=ast.parse(text))
    assert pipe.check_pipeline_file(src) == []
    found = eff.check_effects({path: src})
    assert [(f.code, f.line, f.symbol) for f in found] == \
        [("GL1101", 11, "_fold_round")]
    assert (f"_fold_round -> _pull: count.{call}() at {path}:7"
            in found[0].message)
    jsrc = jcore.SourceFile(path="galah_tpu/ops/mk_torch.py", text=text,
                            tree=ast.parse(text))
    assert jeff.check_effects({jsrc.path: jsrc}) == []
    assert ir.HOST_SYNC_LASTS is pipe.DEVICE_ROUND_SYNC_CALLS
    assert jir.HOST_SYNC_LASTS <= ir.HOST_SYNC_LASTS


LAUNCH_TEXT = '''\
import torch

from galah_tpu_torch.kernels import build
from galah_tpu_torch.ops import hll_union


def run_launch(x):
    lib = build.load("pairlist")
    return lib.pairlist_launch(x.data_ptr())


def kernel_caller(x):
    return run_launch(x)


def module_call(x):
    return hll_union.run_launch(x)


class Plan:
    def plan_launch(self):
        return 1

    def use(self):
        return self.plan_launch()
'''


def test_launch_calls_are_device_dispatch():
    """``lib.<name>_launch(...)`` is a dispatch and its caller inherits
    it; a call of an imported module's ``*_launch`` function or of a
    method on ``self`` is a call edge, not a dispatch."""
    path = "galah_tpu_torch/ops/x.py"
    src = SourceFile(path=path, text=LAUNCH_TEXT,
                     tree=ast.parse(LAUNCH_TEXT))
    prog = ir.build_program_ir({path: src})
    assert prog.effects_of((path, "run_launch"))["device_dispatch"].line \
        == 9
    assert prog.render_chain((path, "kernel_caller"), "device_dispatch") \
        == f"kernel_caller -> run_launch: lib.pairlist_launch() at {path}:9"
    assert prog.effects_of((path, "module_call")) == {}
    assert prog.effects_of((path, "Plan.use")) == {}


TORCH_RNG = '''\
import torch


def bad(n):
    return torch.rand(n)


def bad_seed():
    torch.manual_seed(0)


def bad_gen():
    return torch.Generator()


def good(n, seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return torch.rand(n, generator=g)
'''


def test_torch_rng_is_unseeded_rng():
    path = "galah_tpu_torch/ops/rng.py"
    src = SourceFile(path=path, text=TORCH_RNG, tree=ast.parse(TORCH_RNG))
    prog = ir.build_program_ir({path: src})
    details = {fn: prog.effects_of((path, fn)).get("unseeded_rng")
               for fn in ("bad", "bad_seed", "bad_gen", "good")}
    assert details["bad"].detail == "torch.rand()"
    assert details["bad_seed"].detail == "torch.manual_seed()"
    assert details["bad_gen"].detail == "torch.Generator() unseeded"
    assert details["good"] is None


def _tree_sources():
    return {p: s for p, s in load_sources(repo_root()).items()
            if not isinstance(s, CudaFile)}


def test_build_installers_stop_fs_write(monkeypatch):
    """On the port's tree, durable modules reach the two build
    installers (the nvcc kernel build and the C parser build) and stay
    silent; without the boundary those are five GL1102 findings."""
    sources = _tree_sources()
    assert ir.BUILD_ARTIFACT_WRITERS <= set(
        ir.build_program_ir(sources).functions)
    assert [f for f in eff.check_effects(sources)
            if f.code == "GL1102"] == []
    monkeypatch.setattr(ir, "BUILD_ARTIFACT_WRITERS", frozenset())
    found = [f for f in eff.check_effects(sources) if f.code == "GL1102"]
    assert sorted((f.path, f.symbol) for f in found) == [
        ("galah_tpu_torch/index/incremental.py", "insert"),
        ("galah_tpu_torch/index/incremental.py", "iter_insert_sketches"),
        ("galah_tpu_torch/index/incremental.py", "kept_pairs"),
        ("galah_tpu_torch/index/incremental.py", "query"),
        ("galah_tpu_torch/resilience/quarantine.py", "validate_genome")]
    assert all(": os.replace() at galah_tpu_torch/" in f.message
               for f in found)


DURABLE_HELPER = {
    "galah_tpu_torch/kernels/build.py": '''
        import os

        def build(names):
            os.replace("a.tmp", "a.so")

        def load(name):
            build([name])
    ''',
    "galah_tpu_torch/io/scratch.py": '''
        def save(path, text):
            with open(path, "w") as fh:
                fh.write(text)
    ''',
    "galah_tpu_torch/index/store.py": '''
        from galah_tpu_torch.io import scratch
        from galah_tpu_torch.kernels import build

        def warm(name):
            build.load(name)

        def dump(path, text):
            scratch.save(path, text)
    ''',
}


def test_durable_module_reaching_a_non_atomic_helper_fires():
    """The build installer is silent; a plain helper that opens for
    writing is GL1102, with the chain to its open()."""
    sources = {p: SourceFile(path=p, text=textwrap.dedent(t),
                             tree=ast.parse(textwrap.dedent(t)))
               for p, t in DURABLE_HELPER.items()}
    found = eff.check_effects(sources)
    assert [(f.code, f.path, f.line, f.symbol) for f in found] == [
        ("GL1102", "galah_tpu_torch/index/store.py", 9, "dump")]
    assert ("dump -> save: write-mode open() at "
            "galah_tpu_torch/io/scratch.py:3") in found[0].message


# ---------------------------------------------------------------------------
# the IR cache
# ---------------------------------------------------------------------------


def test_cache_cold_then_warm_over_the_ports_tree(tmp_path):
    sources = _tree_sources()
    cold = ir.IRCache(str(tmp_path))
    want = eff.check_effects(sources, cache=cold)
    assert (cold.hits, cold.misses) == (0, len(sources))
    entries = sorted(os.listdir(tmp_path))
    assert len(entries) == len(sources)
    assert all(e.startswith("ir-") and e.endswith(".json")
               for e in entries)
    stamps = {e: os.stat(tmp_path / e).st_mtime_ns for e in entries}
    warm = ir.IRCache(str(tmp_path))
    got = eff.check_effects(sources, cache=warm)
    assert (warm.hits, warm.misses) == (len(sources), 0)
    assert _key(got) == _key(want)
    assert {e: os.stat(tmp_path / e).st_mtime_ns
            for e in os.listdir(tmp_path)} == stamps


def test_corrupt_entry_is_dropped_and_rebuilt(tmp_path):
    text = "def f(v):\n    return v.cpu()\n"
    path = "galah_tpu_torch/pkg/cached.py"
    src = SourceFile(path=path, text=text, tree=ast.parse(text))
    ir.build_program_ir({path: src}, cache=ir.IRCache(str(tmp_path)))
    entry = pathlib.Path(ir.IRCache(str(tmp_path))._entry_path(
        path, src.content_hash()))
    entry.write_text("{not json")
    repaired = ir.IRCache(str(tmp_path))
    prog = ir.build_program_ir({path: src}, cache=repaired)
    assert (repaired.hits, repaired.misses) == (0, 1)
    assert "host_sync" in prog.effects_of((path, "f"))
    raw = json.loads(entry.read_text())
    assert (raw["ir_version"], raw["package"]) == (ir.IR_VERSION,
                                                   "galah_tpu_torch")


def test_disabled_cache_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cache = ir.IRCache(None)
    assert not cache.enabled
    text = "def f(v):\n    return v\n"
    src = SourceFile(path="galah_tpu_torch/pkg/n.py", text=text,
                     tree=ast.parse(text))
    ir.build_program_ir({src.path: src}, cache=cache)
    assert (cache.hits, cache.misses) == (0, 0)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("first", ["galah_tpu", "galah_tpu_torch"])
def test_entries_never_cross_packages(tmp_path, first):
    """Both packages lint tests/test_torch_*.py and read
    GALAH_TPU_IR_CACHE: an entry one writes for a path and text is a
    miss for the other, and each then serves its own IR, built with its
    own sinks."""
    path = "tests/test_torch_shared.py"
    text = "def f(v):\n    return v.cpu()\n"
    jsrc = jcore.SourceFile(path=path, text=text, tree=ast.parse(text))
    tsrc = SourceFile(path=path, text=text, tree=ast.parse(text))
    assert jsrc.content_hash() == tsrc.content_hash()
    order = [(jir, jsrc), (ir, tsrc)]
    if first == "galah_tpu_torch":
        order.reverse()
    for mod, src in order:
        cache = mod.IRCache(str(tmp_path))
        mod.build_program_ir({path: src}, cache=cache)
        assert (cache.hits, cache.misses) == (0, 1)
    assert len(os.listdir(tmp_path)) == 2
    for mod, src in order:
        cache = mod.IRCache(str(tmp_path))
        prog = mod.build_program_ir({path: src}, cache=cache)
        assert (cache.hits, cache.misses) == (1, 0)
        assert ("host_sync" in prog.effects_of((path, "f"))) is (mod is ir)


def test_a_foreign_entry_under_the_ports_name_is_rejected(tmp_path):
    """Even at the port's file name, an entry galah_tpu wrote is
    dropped and rebuilt (its package field is not the port's)."""
    path = "galah_tpu_torch/pkg/c.py"
    text = "def f(v):\n    return v.numpy()\n"
    jsrc = jcore.SourceFile(path=path, text=text, tree=ast.parse(text))
    tsrc = SourceFile(path=path, text=text, tree=ast.parse(text))
    jcache = jir.IRCache(str(tmp_path))
    jir.build_program_ir({path: jsrc}, cache=jcache)
    (foreign,) = os.listdir(tmp_path)
    tcache = ir.IRCache(str(tmp_path))
    os.replace(tmp_path / foreign,
               tcache._entry_path(path, tsrc.content_hash()))
    prog = ir.build_program_ir({path: tsrc}, cache=tcache)
    assert (tcache.hits, tcache.misses) == (0, 1)
    assert "host_sync" in prog.effects_of((path, "f"))


# ---------------------------------------------------------------------------
# the lint itself
# ---------------------------------------------------------------------------


def _lint_json(capsys, argv):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


def _findings(report):
    return sorted((f["code"], f["path"], f["line"], f["suppressed"])
                  for f in report["findings"])


def test_lint_ir_cache_dir_cold_then_warm(tmp_path, capsys, monkeypatch):
    """`lint --check effects --ir-cache-dir DIR` twice: equal findings,
    one entry a Python file after the cold run, and the warm run adds
    and rewrites nothing."""
    monkeypatch.delenv("GALAH_TPU_IR_CACHE", raising=False)
    argv = ["--check", "effects", "--json", "--ir-cache-dir",
            str(tmp_path)]
    rc, cold = _lint_json(capsys, argv)
    assert rc == 0
    n_python = cold["scanned"]["files"] - cold["scanned"]["cuda_files"]
    stamps = {e: os.stat(tmp_path / e).st_mtime_ns
              for e in os.listdir(tmp_path)}
    assert len(stamps) == n_python
    assert all(e.startswith("ir-") for e in stamps)
    rc, warm = _lint_json(capsys, argv)
    assert rc == 0
    assert _findings(warm) == _findings(cold)
    assert {e: os.stat(tmp_path / e).st_mtime_ns
            for e in os.listdir(tmp_path)} == stamps
    assert set(warm["scanned"]["families_s"]) == {"effects"}


def test_lint_reads_the_ir_cache_flag(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("GALAH_TPU_IR_CACHE", str(tmp_path / "env"))
    rc, report = _lint_json(capsys, ["--check", "effects", "--json"])
    assert rc == 0
    n_python = report["scanned"]["files"] - report["scanned"]["cuda_files"]
    assert len(os.listdir(tmp_path / "env")) == n_python
    # the flag wins over the environment
    rc, _ = _lint_json(capsys, ["--check", "effects", "--json",
                                "--ir-cache-dir", str(tmp_path / "arg")])
    assert rc == 0
    assert len(os.listdir(tmp_path / "arg")) == n_python
