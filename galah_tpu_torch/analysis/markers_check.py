"""Hardware-test marker audit (GL6xx), the port's copy of
``galah_tpu/analysis/markers_check.py``.

Tests that only pass (or only mean anything) on the card must never
run in the default CPU tier-1 selection: the repo's convention is a
``slow`` or ``hardware`` pytest marker, which conftest.py
default-skips. Two signals identify a hardware-only port test module:

  * its filename matches ``test_torch_hw*``, or
  * it imports ``galah_tpu_torch.kernels.build`` and calls its
    ``load``, which needs ``nvcc`` and a card (the CPU tests reach the
    kernels' plain versions through the ops wrappers; a test that
    imports the module to drive ``build()`` with a stand-in ``nvcc``
    stays a CPU test).

Every test function in such a module (including parametrized ones)
must carry the marker, either per-test (``@pytest.mark.slow``) or
module-wide (``pytestmark = pytest.mark.slow`` / a list containing
it):

  GL601  hardware-only test without a slow/hardware marker
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Set

from galah_tpu_torch.analysis.core import (Finding, Severity, SourceFile,
                                           dotted_name)

HW_MARKERS = {"slow", "hardware"}
_HARDWARE_MODULE = "galah_tpu_torch.kernels.build"
_HARDWARE_CALL = "load"


def _marker_names(node: ast.AST) -> Set[str]:
    """Marker names in a decorator / pytestmark expression: handles
    pytest.mark.slow, pytest.mark.parametrize(...), and lists."""
    names: Set[str] = set()
    work = [node]
    while work:
        cur = work.pop()
        if isinstance(cur, (ast.List, ast.Tuple)):
            work.extend(cur.elts)
        elif isinstance(cur, ast.Call):
            work.append(cur.func)
        elif isinstance(cur, ast.Attribute):
            name = dotted_name(cur)
            if name.startswith("pytest.mark.") or name.startswith(
                    "mark."):
                names.add(name.split(".")[-1])
    return names


def _module_markers(tree: ast.Module) -> Set[str]:
    names: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            targets = [t.id for t in stmt.targets
                       if isinstance(t, ast.Name)]
            if "pytestmark" in targets:
                names |= _marker_names(stmt.value)
    return names


def _calls_hardware(tree: ast.Module) -> bool:
    """Whether the module imports the build module and calls its
    ``load``, under whatever name it imported."""
    calls = set()  # dotted names that reach build.load
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _HARDWARE_MODULE:
                    calls.add(f"{a.asname or a.name}.{_HARDWARE_CALL}")
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if f"{node.module}.{a.name}" == _HARDWARE_MODULE:
                    # `from galah_tpu_torch.kernels import build`
                    calls.add(f"{a.asname or a.name}.{_HARDWARE_CALL}")
                elif node.module == _HARDWARE_MODULE \
                        and a.name == _HARDWARE_CALL:
                    calls.add(a.asname or a.name)
    return bool(calls) and any(
        isinstance(node, ast.Call) and dotted_name(node.func) in calls
        for node in ast.walk(tree))


def is_hardware_module(src: SourceFile) -> bool:
    base = os.path.basename(src.path)
    if base.startswith("test_torch_hw"):
        return True
    return base.startswith("test_") and _calls_hardware(src.tree)


def check_markers_file(src: SourceFile,
                       force_hardware: Optional[bool] = None) -> \
        List[Finding]:
    """GL601 over one test module. `force_hardware` overrides the
    hardware-module heuristic (used by fixture tests)."""
    hardware = (is_hardware_module(src) if force_hardware is None
                else force_hardware)
    if not hardware:
        return []
    findings: List[Finding] = []
    module_marks = _module_markers(src.tree)
    if module_marks & HW_MARKERS:
        return []
    for node in src.walk():
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
            continue
        if not node.name.startswith("test"):
            continue
        marks: Set[str] = set()
        for dec in node.decorator_list:
            marks |= _marker_names(dec)
        if not marks & HW_MARKERS:
            findings.append(Finding(
                "GL601", Severity.ERROR, src.path, node.lineno,
                f"hardware-only test {node.name!r} has no "
                "slow/hardware marker — it would run (and hang or "
                "fail) in the default CPU tier-1 selection",
                node.name))
    return findings
