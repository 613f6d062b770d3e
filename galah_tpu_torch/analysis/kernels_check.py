"""The kernel-contract family (GL11x): the port's CUDA kernels against
their ctypes bindings and their wrappers.

It stands where ``galah_tpu``'s GL1xx (Pallas contracts) stands. Each
kernel is a ``kernels/<name>.cu`` with a plain C interface, bound by
``kernels/build.py``: ``SIGNATURES`` maps a library to its launch
function and argtypes, ``MORE_SIGNATURES`` to its further C functions.
Each wrapper in ``ops/`` launches through one of those functions. The
family reads ``build.py`` by AST, the ``.cu`` sources as text and the
``ops/`` modules by AST; it builds and runs nothing.

  GL111  a ctypes argtypes list differs from its ``extern "C"``
         prototype in arity or width (``void*`` / ``const void*`` <->
         ``c_void_p``, ``int`` <-> ``c_int``, ``long long`` <->
         ``c_longlong``), or a bound function has no such prototype in
         its library's ``.cu``. A ctypes call through a wrong width
         passes garbage, or reads past the arguments, without an error
  GL112  a ``kernels/*.cu`` without a ``SIGNATURES`` entry, or an entry
         without its ``.cu`` (GL101/GL102's counterparts)
  GL113  a call of a bound launch function (``lib.<name>_launch(...)``)
         in ``ops/`` that does not do all three of: run inside a
         ``with PROFILE.launch(...)`` block (the ``obs/profile.py``
         bracket), pass its return to ``build.check(<library>, err)``,
         and count ``LAUNCHES["<library>"]`` in its function. Together
         they are the invariant chip_smoke phase 4r checks on the card:
         calls = dispatches = trace kernel events
  GL114  an ``assert`` in an ``ops/`` function that calls a bound C
         function: a precondition of the launch that ``python -O``
         drops; raise instead
  GL115  ``torch.uint64`` anywhere in the package (GL106's
         counterpart): hashes are biased int64 (``ops/u64.py``) and
         convert only at the numpy boundary

A finding in a ``.cu`` file takes the usual inline suppression, written
after ``//``.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional

from galah_tpu_torch.analysis.core import (KERNEL_DIR, CudaFile, Finding,
                                           Severity, SourceFile,
                                           dotted_name,
                                           enclosing_functions)

BUILD = f"{KERNEL_DIR}/build.py"
OPS_PREFIX = "galah_tpu_torch/ops/"
PACKAGE_PREFIX = "galah_tpu_torch/"

#: ctypes names and the C widths they pass
CTYPES_WIDTH = {"c_void_p": "void*", "c_int": "int",
                "c_longlong": "long long"}


@dataclasses.dataclass
class Entry:
    """One bound C function of ``build.py``."""

    library: str                 # the .cu's stem, SIGNATURES' key
    function: str
    argtypes: List[str]          # C widths; a ctypes name outside
                                 # CTYPES_WIDTH stays as written
    line: int                    # build.py line of the entry

    @property
    def is_launch(self) -> bool:
        return self.function.endswith("_launch")


@dataclasses.dataclass
class Prototype:
    """One ``extern "C"`` function of a ``.cu``."""

    function: str
    params: List[str]            # C widths, or the declaration as written
    line: int


def _ctypes_aliases(tree: ast.Module) -> Dict[str, str]:
    """Module-level ``_P = ctypes.c_void_p``-style names."""
    out: Dict[str, str] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            name = dotted_name(stmt.value)
            if name.startswith("ctypes."):
                out[stmt.targets[0].id] = name.split(".", 1)[1]
    return out


def _argtypes(node: ast.AST, aliases: Dict[str, str]) -> List[str]:
    out = []
    for elt in getattr(node, "elts", []):
        name = dotted_name(elt)
        ctype = aliases.get(name) or name.rsplit(".", 1)[-1]
        out.append(CTYPES_WIDTH.get(ctype, ctype))
    return out


def _module_dict(tree: ast.Module, name: str) -> Optional[ast.Dict]:
    for stmt in tree.body:
        target = value = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target, value = stmt.targets[0], stmt.value
        elif isinstance(stmt, ast.AnnAssign):
            target, value = stmt.target, stmt.value
        if isinstance(target, ast.Name) and target.id == name \
                and isinstance(value, ast.Dict):
            return value
    return None


def bound_entries(build_src: SourceFile) -> List[Entry]:
    """Every C function ``build.py`` binds: ``SIGNATURES``' launch
    functions, then ``MORE_SIGNATURES``' further functions."""
    tree = build_src.tree
    aliases = _ctypes_aliases(tree)
    entries: List[Entry] = []
    sigs = _module_dict(tree, "SIGNATURES")
    for key, val in zip(sigs.keys, sigs.values) if sigs else ():
        if isinstance(key, ast.Constant) and isinstance(val, ast.Tuple) \
                and len(val.elts) == 2 \
                and isinstance(val.elts[0], ast.Constant):
            entries.append(Entry(key.value, val.elts[0].value,
                                 _argtypes(val.elts[1], aliases),
                                 val.lineno))
    more = _module_dict(tree, "MORE_SIGNATURES")
    for key, val in zip(more.keys, more.values) if more else ():
        if not (isinstance(key, ast.Constant)
                and isinstance(val, (ast.List, ast.Tuple))):
            continue
        for item in val.elts:
            if isinstance(item, ast.Tuple) and len(item.elts) == 2 \
                    and isinstance(item.elts[0], ast.Constant):
                entries.append(Entry(key.value, item.elts[0].value,
                                     _argtypes(item.elts[1], aliases),
                                     item.lineno))
    return entries


_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_PROTO_RE = re.compile(
    r'extern\s+"C"\s+(?:__host__\s+)?[\w\s\*]*?\b(\w+)\s*\(([^)]*)\)')
_PARAM_NAME_RE = re.compile(r"\b\w+\s*$")


def _c_width(param: str) -> str:
    """``void*`` / ``int`` / ``long long`` for one C parameter
    declaration (its name dropped, ``const`` ignored), else the
    declaration as written."""
    decl = " ".join(param.split())
    if "*" in decl:
        return "void*" if re.sub(r"\bconst\b|\s", "", decl).startswith(
            "void*") else decl
    words = [w for w in decl.split() if w != "const"]
    if " ".join(words) in ("int", "long long"):
        return " ".join(words)
    base = " ".join(words[:-1])  # the parameter's name dropped
    return base if base in ("int", "long long") else decl


def prototypes(cu: SourceFile) -> List[Prototype]:
    """The ``extern "C"`` functions of one ``.cu``, comments ignored
    (blanked to spaces, so line numbers hold)."""
    text = _COMMENT_RE.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)),
                           cu.text)
    out = []
    for m in _PROTO_RE.finditer(text):
        raw = m.group(2).strip()
        params = ([] if raw in ("", "void")
                  else [_c_width(p) for p in raw.split(",")])
        out.append(Prototype(m.group(1), params,
                             text.count("\n", 0, m.start(1)) + 1))
    return out


def _library_of(path: str) -> Optional[str]:
    """``pairlist`` for ``galah_tpu_torch/kernels/pairlist.cu``."""
    head, base = os.path.split(path)
    if head == KERNEL_DIR and base.endswith(".cu"):
        return base[:-3]
    return None


def check_signatures(build_src: SourceFile,
                     cuda: Dict[str, SourceFile]) -> List[Finding]:
    """GL111 and GL112 between ``build.py`` and the ``.cu`` sources."""
    findings: List[Finding] = []
    entries = bound_entries(build_src)
    # the first entry of a library is its SIGNATURES entry
    sig_libs: Dict[str, Entry] = {}
    for e in entries:
        sig_libs.setdefault(e.library, e)
    by_lib = {_library_of(p): src for p, src in cuda.items()
              if _library_of(p)}
    for e in entries:
        cu = by_lib.get(e.library)
        if cu is None:
            if sig_libs[e.library] is e:
                findings.append(Finding(
                    "GL112", Severity.ERROR, build_src.path, e.line,
                    f"SIGNATURES entry {e.library!r} has no "
                    f"{KERNEL_DIR}/{e.library}.cu — the build has no "
                    "source to compile", e.library))
            continue
        proto = next((p for p in prototypes(cu)
                      if p.function == e.function), None)
        if proto is None:
            findings.append(Finding(
                "GL111", Severity.ERROR, build_src.path, e.line,
                f"{e.function} is bound but {cu.path} has no "
                f"extern \"C\" prototype of it", e.library))
            continue
        where = f"{cu.path}:{proto.line}"
        if len(proto.params) != len(e.argtypes):
            findings.append(Finding(
                "GL111", Severity.ERROR, build_src.path, e.line,
                f"{e.function}: ctypes binds {len(e.argtypes)} "
                f"argument(s), its extern \"C\" prototype at {where} "
                f"takes {len(proto.params)}", e.library))
            continue
        for i, (got, want) in enumerate(zip(e.argtypes, proto.params)):
            if got != want:
                findings.append(Finding(
                    "GL111", Severity.ERROR, build_src.path, e.line,
                    f"{e.function}: argument {i + 1} is bound as "
                    f"{got} but declared {want} at {where}", e.library))
    for lib, cu in sorted(by_lib.items()):
        if lib not in sig_libs:
            protos = prototypes(cu)
            findings.append(Finding(
                "GL112", Severity.ERROR, cu.path,
                protos[0].line if protos else 1,
                f"{cu.path} has no SIGNATURES entry in {BUILD} — it is "
                "never built or bound", lib))
    return findings


def _profiled_names(tree: ast.Module) -> set:
    """Module-level names bound to ``profiled(...)`` (``PROFILE``)."""
    names = {"PROFILE"}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value,
                                                       ast.Call) \
                and dotted_name(stmt.value.func).endswith("profiled"):
            names |= {t.id for t in stmt.targets
                      if isinstance(t, ast.Name)}
    return names


def _parents(tree: ast.Module) -> Dict[ast.AST, ast.AST]:
    out: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _in_profile_bracket(call: ast.AST, parents, profiled: set) -> bool:
    node = parents.get(call)
    while node is not None and not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        if isinstance(node, ast.With):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and isinstance(
                        expr.func, ast.Attribute) \
                        and expr.func.attr == "launch" \
                        and dotted_name(expr.func.value) in profiled:
                    return True
        node = parents.get(node)
    return False


def _checked(call: ast.Call, fn: ast.AST, parents, library: str) -> bool:
    """The call's return reaches ``build.check(<library>, ...)``: as
    that call's argument, or through a name assigned from it."""
    holder = parents.get(call)
    names = set()
    if isinstance(holder, ast.Assign):
        names = {t.id for t in holder.targets if isinstance(t, ast.Name)}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and dotted_name(node.func).split(".")[-1] == "check"
                and len(node.args) == 2
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == library):
            continue
        arg = node.args[1]
        if arg is call or (isinstance(arg, ast.Name) and arg.id in names):
            return True
    return False


def _counts_launches(fn: ast.AST, library: str) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) and isinstance(
                node.target, ast.Subscript) \
                and dotted_name(node.target.value).endswith("LAUNCHES") \
                and isinstance(node.target.slice, ast.Constant) \
                and node.target.slice.value == library:
            return True
    return False


def check_wrappers(src: SourceFile, entries: List[Entry]) -> List[Finding]:
    """GL113 and GL114 over one ``ops/`` module."""
    if not src.path.startswith(OPS_PREFIX):
        return []
    bound = {e.function: e for e in entries}
    owner = enclosing_functions(src.tree)
    parents = _parents(src.tree)
    profiled = _profiled_names(src.tree)
    findings: List[Finding] = []
    callers: Dict[ast.AST, List[ast.Call]] = {}
    for node in src.walk():
        if not (isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr in bound):
            continue
        fn = owner.get(node)
        callers.setdefault(fn, []).append(node)
        e = bound[node.func.attr]
        if not e.is_launch:
            continue
        symbol = fn.name if fn is not None else ""
        missing = []
        if not _in_profile_bracket(node, parents, profiled):
            missing.append("runs outside a `with PROFILE.launch(...)` "
                           "block")
        if fn is None or not _checked(node, fn, parents, e.library):
            missing.append(f"its return never reaches "
                           f"build.check({e.library!r}, err)")
        if fn is None or not _counts_launches(fn, e.library):
            missing.append(f"its function never counts "
                           f"LAUNCHES[{e.library!r}]")
        for what in missing:
            findings.append(Finding(
                "GL113", Severity.ERROR, src.path, node.lineno,
                f"launch of {e.function} {what} — a launch is profiled, "
                "checked and counted, so that calls, dispatches and "
                "trace kernel events agree", symbol))
    for fn, calls in callers.items():
        if fn is None:
            continue
        names = sorted({c.func.attr for c in calls})
        for node in ast.walk(fn):
            if isinstance(node, ast.Assert):
                findings.append(Finding(
                    "GL114", Severity.WARNING, src.path, node.lineno,
                    f"assert in a function that calls "
                    f"{', '.join(names)} — `python -O` drops it, and the "
                    "C entry cannot check it; raise instead", fn.name))
    return findings


def check_u64(src: SourceFile) -> List[Finding]:
    """GL115 over one package module."""
    if not src.path.startswith(PACKAGE_PREFIX):
        return []
    findings: List[Finding] = []
    for node in src.walk():
        line = None
        if isinstance(node, ast.Attribute) and \
                dotted_name(node) == "torch.uint64":
            line = node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module == "torch" \
                and any(a.name == "uint64" for a in node.names):
            line = node.lineno
        if line is not None:
            findings.append(Finding(
                "GL115", Severity.ERROR, src.path, line,
                "torch.uint64 in the port — hashes are biased int64 "
                "(ops/u64.py) and convert to uint64 only at the numpy "
                "boundary"))
    return findings


def check_kernels(sources: Dict[str, SourceFile]) -> List[Finding]:
    """The whole family over a loaded tree (Python and CUDA sources)."""
    findings: List[Finding] = []
    build_src = sources.get(BUILD)
    cuda = {p: s for p, s in sources.items()
            if isinstance(s, CudaFile) and p.startswith(KERNEL_DIR + "/")}
    entries: List[Entry] = []
    if build_src is not None and not isinstance(build_src, CudaFile):
        entries = bound_entries(build_src)
        findings.extend(check_signatures(build_src, cuda))
    for path, src in sorted(sources.items()):
        if isinstance(src, CudaFile):
            continue
        findings.extend(check_wrappers(src, entries))
        findings.extend(check_u64(src))
    return findings


def entry_count(sources: Dict[str, SourceFile]) -> int:
    """The C functions build.py binds, each held against its prototype
    by GL111, for the lint's summary line."""
    build_src = sources.get(BUILD)
    if build_src is None or isinstance(build_src, CudaFile):
        return 0
    return len(bound_entries(build_src))
