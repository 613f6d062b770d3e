"""galah_tpu_torch lint: static analysis of the PyTorch/CUDA port.

Run as ``python -m galah_tpu_torch.analysis`` or ``python -m
galah_tpu_torch lint``. Exit status is 1 iff any unsuppressed finding
at WARNING or above remains (INFO notes never fail the run). It scans
``galah_tpu_torch/`` (with ``kernels/*.cu`` and ``*.cuh``),
``tests/test_torch_*.py`` and ``chip_smoke.py``; ``galah-tpu lint``
scans the rest of the repo. Pure ``ast`` and text work: it imports
neither torch nor jax, and needs no ``nvcc`` and no card.

Checker families (``--check`` names in brackets)
  GL0xx  suppression hygiene: expired ``expires=`` dates
         [suppressions]
  GL11x  CUDA kernel contracts, in place of galah-tpu's GL1xx (Pallas):
         ctypes signatures against their ``extern "C"`` prototypes
         (GL111), kernels without a binding and bindings without a
         kernel (GL112), launches that are not profiled, checked and
         counted (GL113), asserted launch preconditions (GL114),
         ``torch.uint64`` (GL115) [kernels]
  GL4xx  GALAH_* config-flag registry consistency [flags]
  GL6xx  hardware-test marker audit [markers]
  GL7xx  observability discipline: ad-hoc timing and device-cost
         reads outside timing.py and obs/ (GL701-703), flow discipline
         of ``PIPELINE_STAGE`` modules (GL704) [obs]
  GL8xx  concurrency discipline: ``GUARDED_BY``/``LOCK_ORDER``
         annotations of the threaded modules, lock order, cycles,
         flow adoption of worker threads (GL801-805) [concurrency];
         the runtime complement is the GalahSan sanitizer
         (``analysis/sanitizer.py``, ``GALAH_SAN=1``)
  GL806  durable-write discipline: durable artifacts are written only
         through io/atomic.py [fs]
  GL9xx  numeric determinism: ``DETERMINISM_CONTRACT`` annotations of
         the strategy modules, masked zero-filled sums, f64->f32
         narrowing, set-order iteration, unseeded RNG (numpy's and
         torch's) [determinism]
  GL10xx pipeline discipline: ``PIPELINE_STAGE`` annotations,
         materialized streams, host syncs in streaming stages and
         device-round bodies, unbounded queues/pools, the occupancy
         gauge, paged-band retention [pipeline]

No counterpart in the port: GL103-105 and GL107 (Pallas tiling quanta
and the VMEM budget: CUDA blocks have no lane quanta, and registers and
shared memory are ptxas's to report, through ``python -m
galah_tpu_torch.kernels.build --ptxas``); GL2xx, GL3xx and GL5xx (JAX
tracing and abstract-eval shapes).

Not yet in the port: GL11xx, the effects family over galah-tpu's
GalahIR (``ir.py``, ``effects_check.py``), and with it a real
``--ir-cache-dir`` (accepted and unused).

Suppression: ``# galah-lint: ignore[GL701]`` on the flagged line or
the line above (``// galah-lint: ignore[GL111]`` in a CUDA source;
optionally ``... expires=YYYY-MM-DD``; past the date the comment stops
suppressing and GL001 flags it), or an entry in the committed baseline
(``galah_tpu_torch/analysis/baseline.json``, regenerated with
``--update-baseline``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Set

from galah_tpu_torch.analysis import core
from galah_tpu_torch.analysis.core import (CudaFile, Finding, Severity,
                                           SourceFile)

CHECK_NAMES = ("kernels", "flags", "markers", "obs", "concurrency", "fs",
               "determinism", "pipeline", "suppressions")
DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "baseline.json")


def repo_root() -> str:
    """The directory holding the galah_tpu_torch package (repo
    checkout)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def load_sources(root: str) -> Dict[str, SourceFile]:
    """Every scanned file, parsed once: the Python sources, then the
    CUDA sources (as ``CudaFile``)."""
    sources: Dict[str, SourceFile] = {}
    for path in core.iter_python_files(root):
        try:
            src = SourceFile.load(path, rel_to=root)
        except SyntaxError:
            continue  # not lintable; the test suite will catch it
        sources[src.path] = src
    for path in core.iter_cuda_files(root):
        src = CudaFile.load(path, rel_to=root)
        sources[src.path] = src
    return sources


def run_checks(sources: Dict[str, SourceFile],
               checks: Sequence[str] = CHECK_NAMES,
               timings: Optional[Dict[str, float]] = None
               ) -> List[Finding]:
    """All requested checkers over the loaded tree (no suppression
    applied yet). The parse is shared: every family reads the same
    ``SourceFile`` objects. ``timings``, when passed, is filled with
    per-family wall seconds."""
    findings: List[Finding] = []
    python = [s for s in sources.values() if not isinstance(s, CudaFile)]

    def timed(name: str, produce) -> None:
        t0 = time.monotonic()
        findings.extend(produce())
        if timings is not None:
            timings[name] = time.monotonic() - t0

    def per_file(check_file, files=python):
        return lambda: [f for src in files for f in check_file(src)]

    if "kernels" in checks:
        from galah_tpu_torch.analysis.kernels_check import check_kernels
        timed("kernels", lambda: check_kernels(sources))
    if "flags" in checks:
        from galah_tpu_torch.analysis.flags_check import \
            check_flag_references
        timed("flags", lambda: check_flag_references(python))
    if "markers" in checks:
        from galah_tpu_torch.analysis.markers_check import \
            check_markers_file
        timed("markers", per_file(check_markers_file))
    if "obs" in checks:
        from galah_tpu_torch.analysis.obs_check import check_obs_file
        timed("obs", per_file(check_obs_file))
    if "concurrency" in checks:
        from galah_tpu_torch.analysis.concurrency_check import \
            check_concurrency
        timed("concurrency", lambda: check_concurrency(
            {s.path: s for s in python}))
    if "fs" in checks:
        from galah_tpu_torch.analysis.fs_check import check_fs_file
        timed("fs", per_file(check_fs_file))
    if "determinism" in checks:
        from galah_tpu_torch.analysis.determinism_check import \
            check_determinism_file
        timed("determinism", per_file(check_determinism_file))
    if "pipeline" in checks:
        from galah_tpu_torch.analysis.pipeline_check import \
            check_pipeline_file
        timed("pipeline", per_file(check_pipeline_file))
    if "suppressions" in checks:
        timed("suppressions", per_file(core.check_suppression_expiry,
                                       list(sources.values())))
    return findings


def run_lint(root: Optional[str] = None,
             checks: Sequence[str] = CHECK_NAMES,
             baseline_path: Optional[str] = None) -> List[Finding]:
    """Full lint pass with suppressions applied; the library entry
    point used by tests and the CLI."""
    root = root or repo_root()
    sources = load_sources(root)
    findings = run_checks(sources, checks)
    baseline = core.load_baseline(baseline_path or DEFAULT_BASELINE)
    core.apply_suppressions(findings, sources, baseline)
    return findings


def changed_files(root: str) -> Optional[Set[str]]:
    """Repo-relative paths git considers changed (staged + unstaged vs
    HEAD, plus untracked), or None when git can't answer: the caller
    falls back to a full scan rather than silently linting nothing.

    Deleted and renamed-away paths are skipped (``--diff-filter=d``
    plus an existence check for the rename source in the staged half):
    they have no content to lint."""
    paths: Set[str] = set()
    for cmd in (["git", "diff", "--name-only", "--diff-filter=d",
                 "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(cmd, cwd=root, capture_output=True,
                                  text=True, timeout=30)
        except (OSError, subprocess.SubprocessError):
            return None
        if proc.returncode != 0:
            return None
        paths.update(line.strip().replace("\\", "/")
                     for line in proc.stdout.splitlines()
                     if line.strip())
    # --diff-filter=d keeps a rename's old path when git reports it as
    # an unpaired modify; only paths that still exist are lintable.
    return {p for p in paths
            if os.path.isfile(os.path.join(root, p))}


def add_lint_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--json", action="store_true",
                        help="machine-readable JSON report on stdout")
    parser.add_argument("--root", default=None,
                        help="repo root to scan (default: the checkout "
                             "containing this package)")
    parser.add_argument("--check", action="append", default=None,
                        choices=CHECK_NAMES, dest="checks",
                        metavar="NAME",
                        help="run only the named checker family "
                             "(repeatable; default: all of "
                             + ", ".join(CHECK_NAMES) + ")")
    parser.add_argument("--baseline", default=None,
                        help="baseline file of accepted findings "
                             "(default: galah_tpu_torch/analysis/"
                             "baseline.json)")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline to accept every "
                             "current finding, then exit 0")
    parser.add_argument("--update-snapshots", action="store_true",
                        help="galah-tpu's shape-contract snapshot; the "
                             "port has no GL5xx shapes family, so this "
                             "says so and exits 0, writing nothing")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="include suppressed findings in the "
                             "human report")
    parser.add_argument("--changed-only", action="store_true",
                        help="report only findings in files git "
                             "considers changed (staged, unstaged, or "
                             "untracked), the pre-commit gate mode; "
                             "checkers still see the whole tree so "
                             "cross-module rules stay sound")
    parser.add_argument("--run-report", default=None,
                        help="write run_report.json with the lint "
                             "summary attached (per-family counts, "
                             "suppressed count, per-family timings) "
                             "so `galah_tpu_torch report --diff` shows "
                             "lint drift between runs. Env equivalent: "
                             "GALAH_OBS_REPORT")
    parser.add_argument("--sarif", default=None, metavar="PATH",
                        help="additionally write the findings as a "
                             "SARIF 2.1.0 log to PATH so CI systems "
                             "can annotate them inline (suppressed "
                             "findings are carried with SARIF "
                             "suppressions rather than dropped)")
    parser.add_argument("--ir-cache-dir", default=None, metavar="DIR",
                        help="galah-tpu's content-hash cache for the "
                             "GL11xx effects family's IR; accepted and "
                             "unused until the port has that family")


def main(argv: Optional[Sequence[str]] = None,
         args: Optional[argparse.Namespace] = None) -> int:
    if args is None:
        parser = argparse.ArgumentParser(
            prog="galah_tpu_torch lint",
            description=__doc__,
            formatter_class=argparse.RawDescriptionHelpFormatter)
        add_lint_arguments(parser)
        args = parser.parse_args(argv)

    t0 = time.monotonic()
    # wall-clock stamp for the run-report header, not a measurement
    started_at = time.time()  # galah-lint: ignore[GL701]
    if args.update_snapshots:
        print("galah_tpu_torch lint: no shape-contract snapshot to "
              "update (the port has no GL5xx shapes family); nothing "
              "written")
        return 0

    root = args.root or repo_root()
    checks = tuple(args.checks) if args.checks else CHECK_NAMES
    changed: Optional[Set[str]] = None
    if getattr(args, "changed_only", False):
        changed = changed_files(root)
        if changed is None:
            sys.stderr.write("galah_tpu_torch lint: --changed-only needs "
                             "a git checkout; scanning everything\n")
    sources = load_sources(root)
    timings: Dict[str, float] = {}
    findings = run_checks(sources, checks, timings=timings)
    baseline_path = args.baseline or DEFAULT_BASELINE

    if args.update_baseline:
        # inline suppressions still apply; the baseline absorbs the rest
        core.apply_suppressions(findings, sources, {})
        remaining = [f for f in findings if not f.suppressed]
        core.write_baseline(baseline_path, remaining)
        print(f"baselined {len(remaining)} finding(s) to "
              f"{baseline_path}")
        return 0

    baseline = core.load_baseline(baseline_path)
    core.apply_suppressions(findings, sources, baseline)
    if changed is not None:
        findings = [f for f in findings if f.path in changed]
    bad = core.failing(findings)

    report_path = (getattr(args, "run_report", None)
                   or os.environ.get("GALAH_OBS_REPORT"))
    if report_path:
        from galah_tpu_torch import obs
        obs.finalize("lint", report_path=report_path,
                     started_at=started_at,
                     lint=core.lint_summary(findings, timings=timings))

    sarif_path = getattr(args, "sarif", None)
    if sarif_path:
        import json as _json

        from galah_tpu_torch import __version__
        with open(sarif_path, "w", encoding="utf-8") as fh:
            _json.dump(core.render_sarif(findings,
                                         tool_version=__version__),
                       fh, indent=1, sort_keys=True)
            fh.write("\n")

    n_cuda = sum(isinstance(s, CudaFile) for s in sources.values())
    scanned = {"files": len(sources), "cuda_files": n_cuda}
    if "kernels" in checks:
        from galah_tpu_torch.analysis.kernels_check import entry_count
        scanned["c_entries"] = entry_count(sources)
    dt = time.monotonic() - t0
    scanned["wall_s"] = round(dt, 3)
    scanned["families_s"] = {k: round(v, 3) for k, v in timings.items()}
    if args.json:
        print(core.render_json(findings, extra={"scanned": scanned}))
    else:
        print(core.render_human(
            findings, show_suppressed=args.show_suppressed))
        slowest = sorted(timings.items(), key=lambda kv: -kv[1])[:3]
        per_family = " ".join(f"{k}={v:.1f}s" for k, v in slowest)
        print(f"scanned {len(sources)} files ({n_cuda} CUDA) with "
              f"{len(checks)} checker families in {dt:.1f}s"
              + (f" (slowest: {per_family})" if per_family else ""))
        if "c_entries" in scanned:
            print(f"checked {scanned['c_entries']} bound C functions "
                  f"against their extern \"C\" prototypes")
    return 1 if bad else 0
