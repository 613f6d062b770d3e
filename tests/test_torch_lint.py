"""``galah_tpu_torch lint`` against ``galah-tpu lint``: each ported
family on the same fixtures of tests/data/lint_fixtures (read only,
loaded under a galah_tpu/ path for galah_tpu's checker and under the
matching galah_tpu_torch/ path for the port's), the suppression,
expiry and baseline mechanics, the --json and run-report contracts,
--changed-only's git view; then the kernel-contract family on fixture
trees written here, and the port's own tree.

Tolerance: none. Findings equal as (code, severity, line, message)
once galah_tpu's messages have the package name mapped (galah_tpu ->
galah_tpu_torch, galah-tpu -> galah_tpu_torch) and GL701's sanctioned
timer named as the port's (utils/timing -> timing.py).
"""

import ast
import json
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

from galah_tpu.analysis import changed_files as jchanged_files
from galah_tpu.analysis import core as jcore
from galah_tpu.analysis.flags_check import \
    check_flag_references as jcheck_flags
from galah_tpu.analysis.fs_check import DURABLE_MODULES as JDURABLE
from galah_tpu.analysis.fs_check import check_fs_file as jcheck_fs
from galah_tpu.analysis.markers_check import \
    check_markers_file as jcheck_markers
from galah_tpu.analysis.obs_check import check_obs_file as jcheck_obs
from galah_tpu.config import FLAGS as JFLAGS
from galah_tpu_torch.analysis import (CHECK_NAMES, DEFAULT_BASELINE,
                                      changed_files, load_sources,
                                      repo_root, run_lint)
from galah_tpu_torch.analysis import core
from galah_tpu_torch.analysis import kernels_check
from galah_tpu_torch.analysis.core import Severity, SourceFile
from galah_tpu_torch.analysis.flags_check import check_flag_references
from galah_tpu_torch.analysis.fs_check import (DURABLE_MODULES, SANCTIONED,
                                               check_fs_file)
from galah_tpu_torch.analysis.markers_check import (check_markers_file,
                                                    is_hardware_module)
from galah_tpu_torch.analysis.obs_check import check_obs_file, in_scope

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "data" / "lint_fixtures"
# the marker is split across literals, so that neither lint indexes
# these strings as suppressions of this file
MARK = "# galah-li" "nt: ign" "ore"


def _load(loader, name, path):
    src = loader.load(str(FIXTURES / name))
    src.path = path
    return src


def _mapped(message):
    return re.sub(r"galah[_-]tpu(?!_torch)", "galah_tpu_torch",
                  message).replace("utils/timing", "timing.py")


def _key(findings, mapped=False):
    return sorted((f.code, str(f.severity), f.line,
                   _mapped(f.message) if mapped else f.message,
                   f.suppressed) for f in findings)


# the ported per-file families on galah_tpu's fixtures:
# (fixture, galah_tpu's path, the port's path, galah_tpu's checker,
#  the port's checker)
CASES = {
    "bad_timing": ("bad_timing.py", "galah_tpu/ops/bad_timing.py",
                   "galah_tpu_torch/ops/bad_timing.py", jcheck_obs,
                   check_obs_file),
    "bad_device_cost": ("bad_device_cost.py",
                        "galah_tpu/ops/bad_device_cost.py",
                        "galah_tpu_torch/ops/bad_device_cost.py",
                        jcheck_obs, check_obs_file),
    "bad_durable_write": ("bad_durable_write.py", JDURABLE[0],
                          DURABLE_MODULES[0], jcheck_fs, check_fs_file),
    "hw_unmarked_case": ("hw_unmarked_case.py",
                         "tests/test_tpu_hw_seeded.py",
                         "tests/test_torch_hw_seeded.py", jcheck_markers,
                         check_markers_file),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixture_findings_match_galah_tpu(case):
    """Code for code, line for line, message for message, with the
    inline suppressions applied the same way."""
    name, jpath, tpath, jcheck, tcheck = CASES[case]
    jsrc = _load(jcore.SourceFile, name, jpath)
    tsrc = _load(SourceFile, name, tpath)
    want, got = jcheck(jsrc), tcheck(tsrc)
    jcore.apply_suppressions(want, {jsrc.path: jsrc}, {})
    core.apply_suppressions(got, {tsrc.path: tsrc}, {})
    assert want, case
    assert _key(got) == _key(want, mapped=True)
    assert {f.path for f in got} == {tpath}


def test_flag_fixture_matches_galah_tpu():
    """bad_flags.py against galah_tpu's registry in both checkers (the
    fixture names galah_tpu's flags): GL401 and GL402 at its lines."""
    want = [f for f in jcheck_flags([_load(jcore.SourceFile, "bad_flags.py",
                                           "bad_flags.py")], dict(JFLAGS))
            if f.path == "bad_flags.py"]
    got = [f for f in check_flag_references(
        [_load(SourceFile, "bad_flags.py", "bad_flags.py")], dict(JFLAGS))
        if f.path == "bad_flags.py"]
    assert sorted(f.code for f in want) == ["GL401", "GL402"]
    assert _key(got) == _key(want, mapped=True)
    # under the port's own registry the typo and GALAH_TPU_PAIRLIST_BLOCK
    # (no counterpart in the port) are unregistered; GALAH_TPU_SPARSE_MIN_N
    # is registered with galah_tpu's default, so its read is clean
    own = [f for f in check_flag_references(
        [_load(SourceFile, "bad_flags.py", "bad_flags.py")])
        if f.path == "bad_flags.py"]
    assert sorted((f.code, f.line) for f in own) == [
        ("GL401", 6), ("GL401", 9)]


def test_clean_fixture_is_clean_in_both():
    src = _load(SourceFile, "clean_case.py", "clean_case.py")
    jsrc = _load(jcore.SourceFile, "clean_case.py", "clean_case.py")
    assert [f for f in jcheck_flags([jsrc], dict(JFLAGS))
            if f.path == jsrc.path] == []
    assert [f for f in check_flag_references([src], dict(JFLAGS))
            if f.path == src.path] == []
    assert check_markers_file(src) == jcheck_markers(jsrc) == []
    for path in ("galah_tpu_torch/ops/clean_case.py", DURABLE_MODULES[0]):
        src.path = path
        assert check_obs_file(src) == check_fs_file(src) == []
        assert kernels_check.check_u64(src) == []


def test_hardware_module_signals():
    """By name (test_torch_hw*), or by importing kernels.build and
    calling its load; importing it to drive build() with a stand-in
    nvcc keeps a module a CPU test."""
    src = _load(SourceFile, "hw_unmarked_case.py",
                "tests/test_torch_hw_seeded.py")
    assert is_hardware_module(src)
    assert {f.symbol for f in check_markers_file(src)} == {
        "test_kernel_on_hardware", "test_kernel_cases"}

    def module(text):
        s = SourceFile(path="tests/test_torch_seeded.py", text=text,
                       tree=ast.parse(text))
        return is_hardware_module(s)

    assert module("from galah_tpu_torch.kernels import build\n"
                  "def test_a():\n    build.load('pairlist')\n")
    assert module("import galah_tpu_torch.kernels.build as b\n"
                  "def test_a():\n    b.load('pairlist')\n")
    assert module("from galah_tpu_torch.kernels.build import load\n"
                  "def test_a():\n    load('pairlist')\n")
    assert not module("from galah_tpu_torch.kernels import build\n"
                      "def test_a():\n    build.build(['pairlist'])\n")
    marked = ("import pytest\npytestmark = pytest.mark.slow\n"
              "from galah_tpu_torch.kernels import build\n"
              "def test_a():\n    build.load('pairlist')\n")
    src = SourceFile(path="tests/test_torch_seeded.py", text=marked,
                     tree=ast.parse(marked))
    assert check_markers_file(src) == []


def test_obs_scope():
    for path in ("galah_tpu_torch/timing.py", "galah_tpu_torch/obs/flow.py",
                 "galah_tpu_torch/analysis/core.py",
                 "galah_tpu_torch/kernels/rehearse_pairlist.py",
                 "chip_smoke.py", "tests/test_torch_obs.py"):
        assert not in_scope(path)
        assert check_obs_file(_load(SourceFile, "bad_timing.py", path)) == []
    assert in_scope("galah_tpu_torch/kernels/build.py")
    assert in_scope("galah_tpu_torch/ops/pairwise.py")
    for path in (SANCTIONED, "galah_tpu_torch/cli.py"):
        assert check_fs_file(_load(SourceFile, "bad_durable_write.py",
                                   path)) == []


# ---------------------------------------------------------------------------
# Suppressions, expiry, baseline
# ---------------------------------------------------------------------------


def _text_source(pkg_core, text):
    src = pkg_core.SourceFile(path="x.py", text=text, tree=ast.parse(text))
    src._index_suppressions()
    return src


@pytest.mark.parametrize("side", ["jax", "port"])
def test_inline_suppression_and_wildcard(side):
    pkg_core, check = ((jcore, jcheck_flags) if side == "jax"
                       else (core, check_flag_references))
    text = ("import os\n"
            f"a = os.environ.get('GALAH_BOGUS')  {MARK}[GL401]\n"
            f"{MARK}[*]\n"
            "b = os.environ.get('GALAH_BOGUS2')\n")
    src = _text_source(pkg_core, text)
    found = [f for f in check([src]) if f.path == "x.py"]
    pkg_core.apply_suppressions(found, {"x.py": src}, {})
    assert len(found) == 2
    assert all(f.suppressed and f.suppression == "inline" for f in found)


def test_suppression_expiry_matches_galah_tpu():
    text = ("import os\n"
            f"a = os.environ.get('GALAH_BOGUS')  {MARK}[GL401] "
            "expires=2999-01-01\n"
            "\n"
            f"b = os.environ.get('GALAH_BOGUS2')  {MARK}[GL401] "
            "expires=2001-01-01\n"
            "\n"
            f"c = os.environ.get('GALAH_BOGUS3')  {MARK}[GL401] "
            "expires=not-a-date\n")
    out = {}
    for side, pkg_core, check in (("jax", jcore, jcheck_flags),
                                  ("port", core, check_flag_references)):
        src = _text_source(pkg_core, text)
        found = [f for f in check([src]) if f.path == "x.py"]
        pkg_core.apply_suppressions(found, {"x.py": src}, {})
        expiry = pkg_core.check_suppression_expiry(src)
        out[side] = (_key(found, mapped=side == "jax"), _key(expiry))
    assert out["port"] == out["jax"]
    found, expiry = out["port"]
    assert [(line, sup) for _, _, line, _, sup in found] == [
        (2, True), (4, False), (6, False)]
    assert [(code, line) for code, _, line, _, _ in expiry] == [
        ("GL001", 4), ("GL001", 6)]
    assert "expired" in expiry[0][3] and "unparseable" in expiry[1][3]


def test_suppression_valid_on_its_expiry_date():
    import datetime

    text = ("import os\n"
            f"a = os.environ.get('GALAH_BOGUS')  {MARK}[GL401] "
            "expires=2030-06-01\n")
    on_date, after = datetime.date(2030, 6, 1), datetime.date(2030, 6, 2)
    for pkg_core in (jcore, core):
        src = _text_source(pkg_core, text)
        assert src.is_ignored("GL401", 2, today=on_date)
        assert not src.is_ignored("GL401", 2, today=after)
        assert pkg_core.check_suppression_expiry(src, today=on_date) == []
        assert pkg_core.check_suppression_expiry(src, today=after) != []


def test_cuda_suppression_takes_a_line_comment():
    text = ("extern \"C\" int a_launch(void* s);\n"
            "// galah-li" "nt: ignore[GL112] expires=2001-01-01\n"
            "extern \"C\" int b_launch(void* s);\n"
            "/" "/ galah-li" "nt: ignore[GL111]\n")
    src = core.CudaFile(path="k.cu", text=text, tree=ast.Module(
        body=[], type_ignores=[]))
    src._index_suppressions()
    assert src.is_ignored("GL111", 5) and src.is_ignored("GL111", 4)
    assert not src.is_ignored("GL112", 3)  # expired
    assert [f.line for f in core.check_suppression_expiry(src)] == [2]


def test_baseline_suppresses_by_fingerprint(tmp_path):
    for pkg_core, check, load in (
            (jcore, jcheck_flags, jcore.SourceFile),
            (core, check_flag_references, SourceFile)):
        src = _load(load, "bad_flags.py", "bad_flags.py")
        found = [f for f in check([src]) if f.path == "bad_flags.py"]
        assert found
        bl = tmp_path / f"baseline_{pkg_core.__name__}.json"
        pkg_core.write_baseline(str(bl), found)
        baseline = pkg_core.load_baseline(str(bl))
        fresh = [f for f in check([src]) if f.path == "bad_flags.py"]
        pkg_core.apply_suppressions(fresh, {}, baseline)
        assert all(f.suppressed and f.suppression == "baseline"
                   for f in fresh)
        # either package reads the other's baseline file
        assert jcore.load_baseline(str(bl)) == core.load_baseline(str(bl))


def test_lint_summary_counts_by_family():
    assert core.family_of("GL111") == "GL1xx"
    assert core.family_of("GL806") == "GL8xx"
    src = _load(SourceFile, "bad_timing.py",
                "galah_tpu_torch/ops/bad_timing.py")
    found = check_obs_file(src)
    jfound = jcheck_obs(_load(jcore.SourceFile, "bad_timing.py",
                              "galah_tpu/ops/bad_timing.py"))
    assert core.lint_summary(found) == jcore.lint_summary(jfound)
    found[0].suppressed = True
    summary = core.lint_summary(found)
    assert summary["suppressed"] == 1
    assert summary["by_family"] == {"GL7xx": len(found) - 1}


# ---------------------------------------------------------------------------
# --json, --run-report, report --diff, --sarif, --changed-only
# ---------------------------------------------------------------------------


def _lint_process(*argv):
    return subprocess.run([sys.executable, "-m", "galah_tpu_torch.analysis",
                           *argv], cwd=str(REPO), capture_output=True,
                          text=True, timeout=120)


def test_lint_cli_json_contract():
    """galah_tpu's JSON schema (test_analysis.py), with the port's
    `scanned` block: the kernel family reads the eleven C functions."""
    proc = _lint_process("--json", "--check", "kernels", "--check",
                         "markers", "--check", "flags")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["version"] == 1
    assert set(report["summary"]) == {"errors", "warnings", "notes",
                                      "suppressed", "by_family"}
    assert report["summary"]["errors"] == 0
    assert report["scanned"]["c_entries"] == 11


def test_lint_run_report_carries_summary(tmp_path):
    """--run-report writes a report both packages validate, with the
    lint section `report --diff` reads."""
    from galah_tpu.obs import report as jreport
    from galah_tpu_torch.obs import report as treport

    report_path = tmp_path / "lint_report.json"
    proc = _lint_process("--check", "suppressions", "--run-report",
                         str(report_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(report_path.read_text())
    assert report["version"] == 10
    assert report["run"]["subcommand"] == "lint"
    assert set(report["lint"]) == {"errors", "warnings", "notes",
                                   "suppressed", "by_family",
                                   "timings_s"}
    assert set(report["lint"]["timings_s"]) == {"suppressions"}
    assert treport.validate(report) == []
    assert jreport.validate(report) == []
    assert "lint:" in treport.render(report)


def test_report_diff_shows_lint_drift():
    from galah_tpu.obs import report as jreport
    from galah_tpu_torch.obs import report as treport

    def rep(errors, fams):
        return {"run": {"duration_s": 1.0},
                "lint": {"errors": errors, "warnings": 0, "notes": 0,
                         "suppressed": 0, "by_family": fams}}

    def drift(text):
        lines = text.splitlines()
        return lines[lines.index("lint drift:"):]

    got = treport.diff(rep(0, {}), rep(2, {"GL1xx": 2}))
    want = jreport.diff(rep(0, {}), rep(2, {"GL1xx": 2}))
    assert drift(got) == drift(want)
    assert "  errors: 0 -> 2 (+2)" in drift(got)


def test_sarif_and_update_snapshots(tmp_path, capsys):
    from galah_tpu_torch.analysis import main

    sarif = tmp_path / "lint.sarif"
    assert main(["--check", "kernels", "--sarif", str(sarif)]) == 0
    log = json.loads(sarif.read_text())
    assert log["version"] == "2.1.0"
    assert log["runs"][0]["tool"]["driver"]["name"] == \
        "galah_tpu_torch lint"
    before = sorted(p.name for p in tmp_path.iterdir())
    assert main(["--update-snapshots"]) == 0
    assert "no GL5xx" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == before


def test_changed_files_tracks_git_state(tmp_path):
    """The same answers as galah_tpu's at each step."""
    root = str(tmp_path)
    git = ["git", "-C", root, "-c", "user.name=t",
           "-c", "user.email=t@t"]

    def both():
        got = changed_files(root)
        assert got == jchanged_files(root)
        return got

    subprocess.run(["git", "init", "-q", root], check=True)
    assert both() is None
    (tmp_path / "tracked.py").write_text("x = 1\n")
    subprocess.run(git + ["add", "tracked.py"], check=True)
    subprocess.run(git + ["commit", "-q", "-m", "init"], check=True)
    assert both() == set()
    (tmp_path / "tracked.py").write_text("x = 2\n")
    (tmp_path / "untracked.py").write_text("y = 1\n")
    assert both() == {"tracked.py", "untracked.py"}
    subprocess.run(git + ["add", "-A"], check=True)
    subprocess.run(git + ["commit", "-q", "-m", "more"], check=True)
    subprocess.run(git + ["mv", "tracked.py", "renamed.py"], check=True)
    subprocess.run(git + ["rm", "-q", "untracked.py"], check=True)
    assert both() == {"renamed.py"}


# ---------------------------------------------------------------------------
# The kernel-contract family on fixture trees
# ---------------------------------------------------------------------------

BUILD = '''\
import ctypes

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

SIGNATURES = {
    "alpha": ("alpha_launch", [_P, _I, _L, _P]),
    "beta": ("beta_launch", [_P, _P, _I, _P]),
}

MORE_SIGNATURES = {
    "beta": [("beta_tile", [])],
}
'''

ALPHA_CU = '''\
#include <cuda_runtime.h>

__global__ void alpha_kernel(const long long* in, int n) {}

// the launch: one block a tile
extern "C" int alpha_launch(const void* in, int n, long long total,
                            void* stream) {
  return 0;
}
'''

BETA_CU = '''\
extern "C" int beta_launch(const void* a, void* b, int n, void* stream) {
  return 0;
}

extern "C" int beta_tile() { return 8192; }
'''

OPS = '''\
import torch

from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.obs.profile import profiled

PROFILE = profiled("alpha")


def launch(x, n):
    from galah_tpu_torch.kernels import build

    lib = build.load("alpha")
    with PROFILE.launch(x.device, ("int64", n), lambda: None):
        err = lib.alpha_launch(x.data_ptr(), n, n, None)
        build.check("alpha", err)
    LAUNCHES["alpha"] += 1


def tile():
    from galah_tpu_torch.kernels import build

    return build.load("beta").beta_tile()
'''

KDIR = "galah_tpu_torch/kernels"


def _tree(tmp_path, edits=()):
    """A clean package of two kernels, then `edits`: (relative path,
    old text, new text), old None for a new file."""
    files = {f"{KDIR}/build.py": BUILD, f"{KDIR}/alpha.cu": ALPHA_CU,
             f"{KDIR}/beta.cu": BETA_CU, "galah_tpu_torch/ops/alpha.py": OPS}
    for path, old, new in edits:
        if old is None:
            files[path] = new
        else:
            assert old in files[path], (path, old)
            files[path] = files[path].replace(old, new)
    for path, text in files.items():
        p = tmp_path / path
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return [(f.code, f.path, f.line) for f in run_lint(
        root=str(tmp_path), checks=("kernels",),
        baseline_path=str(tmp_path / "none.json")) if not f.suppressed]


def test_kernel_fixture_tree_is_clean(tmp_path):
    assert _tree(tmp_path) == []
    sources = load_sources(str(tmp_path))
    assert kernels_check.entry_count(sources) == 3


OPS_FILE = "galah_tpu_torch/ops/alpha.py"
# a second launch function of alpha's library whose wrapper counts
# LAUNCHES["alpha_wide"]: right only where kernels/__init__.py names
# alpha_wide in ENTRIES
_COUNTED_APART = [
    (f"{KDIR}/build.py", '    "beta": [("beta_tile", [])],\n',
     '    "beta": [("beta_tile", [])],\n'
     '    "alpha": [("alpha_wide_launch", [_P, _I, _L, _P])],\n'),
    (f"{KDIR}/alpha.cu", 'extern "C" int alpha_launch(',
     'extern "C" int alpha_wide_launch(const void* in, int n, '
     'long long total, void* stream) {\n  return 0;\n}\n\n'
     'extern "C" int alpha_launch('),
    (OPS_FILE, "err = lib.alpha_launch(", "err = lib.alpha_wide_launch("),
    (OPS_FILE, 'LAUNCHES["alpha"]', 'LAUNCHES["alpha_wide"]'),
]
KERNEL_CASES = {
    "prototype one argument short": (
        [(f"{KDIR}/alpha.cu", "long long total,\n", "\n")],
        [("GL111", f"{KDIR}/build.py", 8)]),
    "long long bound as c_int": (
        [(f"{KDIR}/build.py", "[_P, _I, _L, _P]", "[_P, _I, _I, _P]")],
        [("GL111", f"{KDIR}/build.py", 8)]),
    "bound function without a prototype": (
        [(f"{KDIR}/beta.cu", "int beta_tile()", "int beta_tiles()")],
        [("GL111", f"{KDIR}/build.py", 13)]),
    ".cu without an entry": (
        [(f"{KDIR}/gamma.cu", None,
          "// gamma\n\nextern \"C\" int gamma_launch(void* stream) {\n"
          "  return 0;\n}\n")],
        [("GL112", f"{KDIR}/gamma.cu", 3)]),
    "entry without a .cu": (
        [(f"{KDIR}/build.py", '    "beta": ("beta_launch"',
          '    "delta": ("delta_launch", [_P]),\n'
          '    "beta": ("beta_launch"')],
        [("GL112", f"{KDIR}/build.py", 9)]),
    "launch outside PROFILE.launch": (
        [(OPS_FILE, "    with PROFILE.launch(x.device, (\"int64\", n), "
          "lambda: None):\n        err",
          "    err = lib.alpha_launch(x.data_ptr(), n, n, None)\n"
          "    with PROFILE.launch(x.device, (\"int64\", n), "
          "lambda: None):\n        _ = x\n        err"),
         (OPS_FILE, "        err = lib.alpha_launch(x.data_ptr(), n, n, "
          "None)\n", "")],
        [("GL113", OPS_FILE, 13)]),
    "launch without build.check": (
        [(OPS_FILE, "        build.check(\"alpha\", err)\n",
          "        del err\n")],
        [("GL113", OPS_FILE, 14)]),
    "launch without LAUNCHES": (
        [(OPS_FILE, "    LAUNCHES[\"alpha\"] += 1\n", "")],
        [("GL113", OPS_FILE, 14)]),
    "launch counted under its own name, not an entry apart": (
        _COUNTED_APART,
        [("GL113", OPS_FILE, 14)]),
    "entry apart counted under its own name": (
        _COUNTED_APART + [(f"{KDIR}/__init__.py", None,
                           'ENTRIES = ("alpha_wide",)\n')],
        []),
    "assert beside a launch": (
        [(OPS_FILE, "    lib = build.load(\"alpha\")\n",
          "    lib = build.load(\"alpha\")\n    assert n > 0\n")],
        [("GL114", OPS_FILE, 13)]),
    "torch.uint64": (
        [(OPS_FILE, "PROFILE = profiled(\"alpha\")\n",
          "PROFILE = profiled(\"alpha\")\nU64 = torch.uint64\n")],
        [("GL115", OPS_FILE, 7)]),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_family_fires_at_its_line(tmp_path, case):
    edits, want = KERNEL_CASES[case]
    assert _tree(tmp_path, edits) == want


def test_kernel_finding_in_a_cu_takes_a_line_comment(tmp_path):
    cu = ("// gamma\n"
          "/" "/ galah-li" "nt: ignore[GL112] a staging copy, built by hand\n"
          "extern \"C\" int gamma_launch(void* stream) {\n"
          "  return 0;\n}\n")
    assert _tree(tmp_path, [(f"{KDIR}/gamma.cu", None, cu)]) == []


def test_kernel_messages_name_both_sides(tmp_path):
    _tree(tmp_path, [(f"{KDIR}/build.py", "[_P, _I, _L, _P]",
                      "[_P, _I, _I, _P]")])
    found = run_lint(root=str(tmp_path), checks=("kernels",),
                     baseline_path=str(tmp_path / "none.json"))
    assert [f.message for f in found] == [
        "alpha_launch: argument 3 is bound as int but declared long long "
        f"at {KDIR}/alpha.cu:6"]
    assert all(f.severity is Severity.ERROR for f in found)


# ---------------------------------------------------------------------------
# The port's own tree
# ---------------------------------------------------------------------------


def test_port_lints_clean():
    """Zero unsuppressed findings at WARNING or above across every
    family, with the committed (empty) baseline."""
    findings = run_lint()
    bad = core.failing(findings, Severity.WARNING)
    assert bad == [], "\n" + core.render_human(bad)


def test_lint_subcommand_exits_0_on_the_repo():
    proc = subprocess.run([sys.executable, "-m", "galah_tpu_torch", "lint"],
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 error(s), 0 warning(s)" in proc.stdout
    assert "checked 11 bound C functions" in proc.stdout


def test_kernel_family_reads_the_nine_c_functions():
    sources = load_sources(repo_root())
    entries = kernels_check.bound_entries(
        sources[kernels_check.BUILD])
    assert sorted(e.function for e in entries) == sorted([
        "window_hits_launch", "tile_stats_launch", "fused_sketch_launch",
        "pairlist_launch", "hll_union_launch", "murmur3_k21_launch",
        "positional_hashes_launch", "positional_hashes_group_launch",
        "positional_hashes_tile", "slab_fold_launch",
        "tile_stats_gather_launch"])
    assert kernels_check.entry_count(sources) == 11
    from galah_tpu_torch.kernels import KERNELS

    assert {e.library for e in entries} == set(KERNELS)


def test_baseline_file_is_committed_and_empty():
    assert core.load_baseline(DEFAULT_BASELINE) == {}
    assert pathlib.Path(DEFAULT_BASELINE).is_file()


def test_scan_covers_the_port_and_skips_fixtures():
    sources = load_sources(repo_root())
    assert not [p for p in sources if "lint_fixtures" in p]
    assert "chip_smoke.py" in sources
    assert "tests/test_torch_lint.py" in sources
    assert "tests/test_analysis.py" not in sources
    assert f"{KDIR}/positional_hashes.cu" in sources
    assert f"{KDIR}/merge_walk.cuh" in sources
    assert not [p for p in sources if p.startswith("galah_tpu/")]
    assert set(CHECK_NAMES) == {"kernels", "flags", "markers", "obs",
                                "concurrency", "fs", "determinism",
                                "pipeline", "effects", "suppressions"}


def test_analysis_imports_neither_torch_nor_jax():
    code = textwrap.dedent("""\
        import sys
        from galah_tpu_torch.analysis import run_lint
        run_lint()
        print(sorted({m.split('.')[0] for m in sys.modules}
                     & {'torch', 'jax', 'jaxlib', 'galah_tpu'}))
        """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_lint_subcommand_in_process(capsys):
    """`main(["lint", ...])` dispatches before logging and the device."""
    from galah_tpu_torch import cli as tcli

    assert tcli.main(["lint", "--check", "kernels", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["summary"]["errors"] == 0
