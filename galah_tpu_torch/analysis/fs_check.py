"""Durable-write discipline (GL806): io/atomic.py is the only writer.
The port's copy of ``galah_tpu/analysis/fs_check.py``.

The port writes its durable artifacts (diskcache entries, the
quarantine manifest, checkpoint files, run reports, the perf-ledger
append, the index, the fleet plan and events) through the single
crash-consistent primitive in ``galah_tpu_torch/io/atomic.py``: tmp +
fsync + rename + dir-fsync for files, O_APPEND checksum-framed single
writes for JSONL. A new ``open(path, "w")`` in a durable-artifact
module silently reopens the old failure class (torn files, lost
renames) without failing any test until a real preemption eats a
checkpoint.

The rule scopes to the modules that own durable artifacts
(``DURABLE_MODULES``) and flags, outside io/atomic.py:

  GL806  a write-mode ``open()`` / ``os.fdopen()`` call, or one of the
         hand-rolled-idiom fingerprints ``os.replace`` / ``os.rename``
         / ``tempfile.mkstemp`` / ``tempfile.NamedTemporaryFile``:
         durable artifacts must be written through io/atomic.py.

Read-mode opens are fine (recovery code reads everything), and
``os.unlink`` is fine (deleting is atomic already). Legitimate
exceptions carry the usual inline suppression with a justification:

    os.replace(a, b)  # galah-lint: ignore[GL806] why this is safe
"""

from __future__ import annotations

import ast
from typing import List, Optional

from galah_tpu_torch.analysis.core import (Finding, Severity, SourceFile,
                                           dotted_name)

#: Modules that own durable artifacts: the GL806 scope. Everything
#: else may open files however it likes (outputs, logs, test scratch).
DURABLE_MODULES = (
    "galah_tpu_torch/io/diskcache.py",
    "galah_tpu_torch/cluster/checkpoint.py",
    "galah_tpu_torch/obs/report.py",
    "galah_tpu_torch/obs/ledger.py",
    "galah_tpu_torch/resilience/quarantine.py",
    "galah_tpu_torch/index/store.py",
    "galah_tpu_torch/index/incremental.py",
    "galah_tpu_torch/fleet/plan.py",
    "galah_tpu_torch/fleet/scheduler.py",
    "galah_tpu_torch/fleet/merge.py",
)

#: The one sanctioned writer.
SANCTIONED = "galah_tpu_torch/io/atomic.py"

#: Call fingerprints of a hand-rolled durable-write idiom.
IDIOM_CALLS = frozenset({
    "os.replace",
    "os.rename",
    "tempfile.mkstemp",
    "tempfile.NamedTemporaryFile",
})

_WRITE_MODE_CHARS = frozenset("wax+")


def in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return p in DURABLE_MODULES and p != SANCTIONED


def literal_mode(node: ast.Call) -> Optional[str]:
    """The mode argument of an open()/os.fdopen() call when it is a
    string literal (positional arg 1 or mode=...); None otherwise."""
    mode_node: Optional[ast.AST] = None
    if len(node.args) >= 2:
        mode_node = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if (isinstance(mode_node, ast.Constant)
            and isinstance(mode_node.value, str)):
        return mode_node.value
    return None


def is_write_mode(mode: Optional[str]) -> bool:
    # no literal mode at all on an open() in a durable module is
    # treated as read-mode ("r" is the default)
    return mode is not None and any(c in _WRITE_MODE_CHARS
                                    for c in mode)


def check_fs_file(src: SourceFile) -> List[Finding]:
    """GL806 over one source file (no-op outside DURABLE_MODULES)."""
    if not in_scope(src.path):
        return []
    findings: List[Finding] = []
    for node in src.walk():
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        offender = None
        if name in IDIOM_CALLS:
            offender = f"{name}()"
        elif name in ("open", "os.fdopen") and is_write_mode(
                literal_mode(node)):
            offender = f"write-mode {name}()"
        if offender is None:
            continue
        findings.append(Finding(
            "GL806", Severity.WARNING, src.path, node.lineno,
            f"{offender} in a durable-artifact module — write through "
            "galah_tpu_torch/io/atomic.py (write_json/write_npz/"
            "append_jsonl/...) so the artifact stays crash-consistent "
            "(tmp + fsync + rename + dir-fsync) and the GALAH_FI "
            "filesystem faults can reach it"))
    return findings
