"""Lint framework: findings, severities, suppressions, baseline, reports.

The port's copy of ``galah_tpu/analysis/core.py``. Every checker in
this package produces :class:`Finding` objects; this module owns
everything around them: the severity lattice, inline suppression
comments (``# galah-lint: ignore[GL701]`` on the flagged line or the
line above, and ``// galah-lint: ignore[GL111]`` in a CUDA source), the
committed baseline file (fingerprints of accepted findings, stable
across unrelated line moves), and the human / JSON / SARIF renderings.

Every checker is static: AST over Python source, text over CUDA
source. Nothing here imports torch or jax, builds or runs a kernel.
"""

from __future__ import annotations

import ast
import dataclasses
import datetime
import enum
import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # noqa: D105 - render as lowercase word
        return self.name.lower()


@dataclasses.dataclass
class Finding:
    """One lint finding, anchored to a file/line."""

    code: str              # e.g. "GL111"
    severity: Severity
    path: str              # repo-relative
    line: int              # 1-based; 0 for file-level findings
    message: str
    symbol: str = ""       # enclosing function/class, "" at module level
    suppressed: bool = False
    suppression: str = ""  # "inline" | "baseline" | ""

    def fingerprint(self) -> str:
        """Line-number-independent identity for the baseline file:
        unrelated edits above a finding must not invalidate its
        baseline entry, so the line is excluded on purpose."""
        ident = f"{self.code}|{self.path}|{self.symbol}|{self.message}"
        return hashlib.sha256(ident.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "severity": str(self.severity),
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "suppressed": self.suppressed,
            "suppression": self.suppression,
            "fingerprint": self.fingerprint(),
        }


# ---------------------------------------------------------------------------
# Source files
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SourceFile:
    """A parsed python source plus the per-line suppression index."""

    path: str          # as given (repo-relative when scanning the repo)
    text: str
    tree: ast.Module
    # line -> (codes, expiry date or None, raw expires= text). An
    # expired (or unparseable-date) entry no longer suppresses;
    # check_suppression_expiry turns it into a GL001 finding.
    _ignores: Dict[int, Tuple[frozenset, Optional[datetime.date],
                              str]] = \
        dataclasses.field(default_factory=dict)
    # the preorder node list shared by every checker family (walk()),
    # computed once per parse
    _walk_cache: Optional[list] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def load(cls, path: str, rel_to: Optional[str] = None) -> "SourceFile":
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            text = fh.read()
        rel = os.path.relpath(path, rel_to) if rel_to else path
        src = cls(path=rel.replace("\\", "/"), text=text,
                  tree=cls._parse(text, rel))
        src._index_suppressions()
        return src

    @staticmethod
    def _parse(text: str, filename: str) -> ast.Module:
        return ast.parse(text, filename=filename)

    def walk(self) -> list:
        """Preorder list of every AST node, computed once per parse.
        Callers must not mutate the returned list."""
        if self._walk_cache is None:
            self._walk_cache = list(ast.walk(self.tree))
        return self._walk_cache

    _IGNORE_RE = re.compile(
        r"#\s*galah-lint:\s*ignore\[([A-Z0-9,\s*]+)\]"
        r"(?:\s+expires=(\S+))?")

    def _index_suppressions(self) -> None:
        for lineno, line in enumerate(self.text.splitlines(), start=1):
            m = self._IGNORE_RE.search(line)
            if not m:
                continue
            codes = frozenset(
                c.strip() for c in m.group(1).split(",") if c.strip())
            raw = m.group(2) or ""
            expiry: Optional[datetime.date] = None
            if raw:
                try:
                    expiry = datetime.date.fromisoformat(raw)
                except ValueError:
                    # unparseable dates never suppress;
                    # check_suppression_expiry reports them as GL001
                    expiry = datetime.date.min
            self._ignores[lineno] = (codes, expiry, raw)

    def is_ignored(self, code: str, line: int,
                   today: Optional[datetime.date] = None) -> bool:
        """Inline suppression: a matching ignore comment on the flagged
        line or the line directly above it (``*`` matches any code).
        A comment whose ``expires=YYYY-MM-DD`` date has passed no
        longer suppresses anything."""
        today = today or datetime.date.today()
        for ln in (line, line - 1):
            entry = self._ignores.get(ln)
            if entry is None:
                continue
            codes, expiry, _ = entry
            if expiry is not None and expiry < today:
                continue
            if code in codes or "*" in codes:
                return True
        return False


class CudaFile(SourceFile):
    """A CUDA source (``.cu``/``.cuh``): its text, an empty AST, and the
    suppression index of its ``// galah-lint: ignore[...]`` comments."""

    @staticmethod
    def _parse(text: str, filename: str) -> ast.Module:
        return ast.Module(body=[], type_ignores=[])

    _IGNORE_RE = re.compile(
        r"//\s*galah-lint:\s*ignore\[([A-Z0-9,\s*]+)\]"
        r"(?:\s+expires=(\S+))?")


def check_suppression_expiry(src: SourceFile,
                             today: Optional[datetime.date] = None) -> \
        List[Finding]:
    """GL001: suppression comments whose ``expires=`` date has passed.

    An expired comment has already stopped suppressing (is_ignored
    skips it), so the original finding resurfaces on its own; this
    finding additionally points at the stale comment itself so it gets
    cleaned up or re-justified rather than silently ignored forever.
    """
    today = today or datetime.date.today()
    out: List[Finding] = []
    for lineno in sorted(src._ignores):
        codes, expiry, raw = src._ignores[lineno]
        if expiry is None:
            continue
        if expiry == datetime.date.min and raw != expiry.isoformat():
            msg = (f"suppression for {', '.join(sorted(codes))} has "
                   f"unparseable expires={raw!r} (want YYYY-MM-DD); "
                   "it no longer suppresses anything")
        elif expiry < today:
            msg = (f"suppression for {', '.join(sorted(codes))} "
                   f"expired on {expiry.isoformat()}; remove the "
                   "comment or re-justify with a new date")
        else:
            continue
        out.append(Finding(
            code="GL001", severity=Severity.WARNING, path=src.path,
            line=lineno, message=msg))
    return out


def iter_python_files(root: str,
                      subdirs: Sequence[str] = ("galah_tpu_torch",),
                      test_prefix: str = "test_torch_",
                      extra_files: Sequence[str] = ("chip_smoke.py",)) -> \
        List[str]:
    """Absolute paths of the port's python sources: the package, its
    tests (``tests/test_torch_*.py``) and ``chip_smoke.py``. Data
    directories (``tests/data/``'s lint fixtures) are never scanned."""
    out: List[str] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", "data"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        for fn in sorted(os.listdir(tests)):
            if fn.startswith(test_prefix) and fn.endswith(".py"):
                out.append(os.path.join(tests, fn))
    for fn in extra_files:
        p = os.path.join(root, fn)
        if os.path.isfile(p):
            out.append(p)
    return out


#: where the port's CUDA sources live, relative to the repo root
KERNEL_DIR = "galah_tpu_torch/kernels"


def iter_cuda_files(root: str) -> List[str]:
    """Absolute paths of the port's CUDA sources: ``kernels/*.cu`` and
    ``*.cuh``."""
    base = os.path.join(root, KERNEL_DIR)
    if not os.path.isdir(base):
        return []
    return [os.path.join(base, fn) for fn in sorted(os.listdir(base))
            if fn.endswith((".cu", ".cuh"))]


# ---------------------------------------------------------------------------
# AST helpers shared by checkers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str:
    """'torch.cuda.current_stream' for a Name/Attribute chain, '' for
    anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def enclosing_functions(tree: ast.Module) -> Dict[ast.AST, ast.AST]:
    """Map every node to its innermost enclosing FunctionDef (or None)."""
    owner: Dict[ast.AST, ast.AST] = {}

    def walk(node: ast.AST, fn: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            nfn = child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            owner[child] = fn
            walk(child, nfn)

    owner[tree] = None
    walk(tree, None)
    return owner


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> Dict[str, dict]:
    """fingerprint -> entry from a committed baseline file (empty when
    the file is absent)."""
    if not os.path.isfile(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    entries = [
        {
            "fingerprint": f.fingerprint(),
            "code": f.code,
            "path": f.path,
            "symbol": f.symbol,
            "message": f.message,
        }
        for f in findings if not f.suppressed
    ]
    entries.sort(key=lambda e: (e["path"], e["code"], e["message"]))
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "findings": entries}, fh, indent=1,
                  sort_keys=True)
        fh.write("\n")


def apply_suppressions(findings: List[Finding],
                       sources: Dict[str, SourceFile],
                       baseline: Dict[str, dict]) -> None:
    """Mark findings covered by inline comments or the baseline."""
    for f in findings:
        src = sources.get(f.path)
        if src is not None and f.line and src.is_ignored(f.code, f.line):
            f.suppressed, f.suppression = True, "inline"
        elif f.fingerprint() in baseline:
            f.suppressed, f.suppression = True, "baseline"


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------


def render_human(findings: Sequence[Finding],
                 show_suppressed: bool = False) -> str:
    lines: List[str] = []
    shown = [f for f in findings if show_suppressed or not f.suppressed]
    for f in sorted(shown, key=lambda f: (f.path, f.line, f.code)):
        sup = f" (suppressed: {f.suppression})" if f.suppressed else ""
        sym = f" [{f.symbol}]" if f.symbol else ""
        lines.append(f"{f.path}:{f.line}: {f.severity} {f.code} "
                     f"{f.message}{sym}{sup}")
    active = [f for f in findings if not f.suppressed]
    n_err = sum(1 for f in active if f.severity == Severity.ERROR)
    n_warn = sum(1 for f in active if f.severity == Severity.WARNING)
    n_info = sum(1 for f in active if f.severity == Severity.INFO)
    n_sup = sum(1 for f in findings if f.suppressed)
    lines.append(f"{n_err} error(s), {n_warn} warning(s), "
                 f"{n_info} note(s), {n_sup} suppressed")
    return "\n".join(lines)


def family_of(code: str) -> str:
    """'GL111' -> 'GL1xx'; four-digit codes group by their leading two
    digits ('GL1001' -> 'GL10xx')."""
    if (len(code) == 6 and code[:2] == "GL"
            and code[2:].isdigit()):
        return f"GL{code[2:4]}xx"
    if len(code) >= 3 and code[:2] == "GL":
        return f"GL{code[2]}xx"
    return code


def lint_summary(findings: Sequence[Finding],
                 timings: Optional[Dict[str, float]] = None) -> dict:
    """Counts block shared by --json output and run_report.json.
    ``timings`` (checker family -> wall seconds) rides along when the
    caller measured it, so run-report diffs expose lint-stage drift."""
    active = [f for f in findings if not f.suppressed]
    by_family: Dict[str, int] = {}
    for f in active:
        fam = family_of(f.code)
        by_family[fam] = by_family.get(fam, 0) + 1
    out = {
        "errors": sum(1 for f in active
                      if f.severity == Severity.ERROR),
        "warnings": sum(1 for f in active
                        if f.severity == Severity.WARNING),
        "notes": sum(1 for f in active
                     if f.severity == Severity.INFO),
        "suppressed": sum(1 for f in findings if f.suppressed),
        "by_family": dict(sorted(by_family.items())),
    }
    if timings is not None:
        out["timings_s"] = {k: round(v, 3)
                            for k, v in sorted(timings.items())}
    return out


def render_json(findings: Sequence[Finding],
                extra: Optional[dict] = None) -> str:
    """The findings and their summary as JSON; `extra` adds top-level
    keys (the port's ``scanned`` block)."""
    return json.dumps({
        "version": 1,
        "findings": [f.to_dict() for f in findings],
        "summary": lint_summary(findings),
        **(extra or {}),
    }, indent=1, sort_keys=True)


#: SARIF 2.1.0 constants for --sarif output (consumed by CI annotators).
SARIF_VERSION = "2.1.0"
SARIF_SCHEMA_URI = ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")

_SARIF_LEVEL = {Severity.ERROR: "error", Severity.WARNING: "warning",
                Severity.INFO: "note"}


def render_sarif(findings: Sequence[Finding],
                 tool_version: str = "0") -> dict:
    """The findings as a SARIF 2.1.0 log dict (one run, one result per
    finding). Suppressed findings are carried with a populated SARIF
    ``suppressions`` array rather than dropped, so CI systems show them
    greyed out instead of losing the paper trail; ``line`` 0
    (file-level findings) maps to startLine 1, the smallest region
    SARIF allows."""
    rules: Dict[str, dict] = {}
    results: List[dict] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.code)):
        rules.setdefault(f.code, {
            "id": f.code,
            "name": f.code,
            "shortDescription": {"text": f"galah_tpu_torch lint {f.code} "
                                         f"({family_of(f.code)} family)"},
        })
        result = {
            "ruleId": f.code,
            "level": _SARIF_LEVEL[f.severity],
            "message": {"text": (f"{f.message} [{f.symbol}]"
                                 if f.symbol else f.message)},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace("\\", "/"),
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {"startLine": max(f.line, 1)},
                },
            }],
            "partialFingerprints": {
                "galahLintFingerprint/v1": f.fingerprint(),
            },
        }
        if f.suppressed:
            result["suppressions"] = [{
                "kind": ("inSource" if f.suppression == "inline"
                         else "external"),
            }]
        results.append(result)
    return {
        "$schema": SARIF_SCHEMA_URI,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "galah_tpu_torch lint",
                "informationUri":
                    "galah_tpu_torch/analysis/__init__.py",
                "version": tool_version,
                "rules": [rules[c] for c in sorted(rules)],
            }},
            "columnKind": "utf16CodeUnits",
            "results": results,
        }],
    }


def failing(findings: Sequence[Finding],
            threshold: Severity = Severity.WARNING) -> List[Finding]:
    """Unsuppressed findings at or above the failure threshold."""
    return [f for f in findings
            if not f.suppressed and f.severity >= threshold]
