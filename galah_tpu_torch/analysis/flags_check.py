"""Config-flag registry checker (GL4xx), the port's copy of
``galah_tpu/analysis/flags_check.py``.

AST-enumerates every ``GALAH_*`` environment reference in the scanned
tree (``os.environ.get/pop/[...]``, ``os.getenv``, ``config.env_value``,
pytest ``monkeypatch.setenv/delenv``, and ``disable_env=`` keywords)
and cross-checks them against the port's registry,
``galah_tpu_torch.config.FLAGS``:

  GL401  reference to an unregistered GALAH_* flag (typo or a new flag
         that skipped the registry)
  GL402  a read site supplies a literal default conflicting with the
         registry default: the default must be defined exactly once
  GL403  registered flag never referenced anywhere the linter scans
         (stale registration; flags read by C code or through an
         f-string family declare ``external_reader`` instead)
  GL404  registered flag without documentation (empty help)
  GL405  registered flag missing from the manpage's auto-rendered
         ENVIRONMENT section (the render filter dropped it)

A test that sets one of ``galah_tpu``'s own flags for its side of a
comparison suppresses GL401 there, naming the flag's owner.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from galah_tpu_torch.analysis.core import (Finding, Severity, SourceFile,
                                           dotted_name,
                                           enclosing_functions)

_READ_CALLS = {
    "os.environ.get", "environ.get", "os.environ.pop", "environ.pop",
    "os.getenv", "os.environ.setdefault", "environ.setdefault",
}
_REGISTRY_CALLS = {"env_value", "config.env_value"}
_WRITE_CALLS = {"monkeypatch.setenv", "monkeypatch.delenv",
                "m.setenv", "m.delenv"}


def _literal_env_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith("GALAH_"):
        return node.value
    return None


def enumerate_references(src: SourceFile) -> \
        List[Tuple[str, int, str, Optional[ast.AST], str]]:
    """(flag, line, symbol, default_node, via) for every GALAH_*
    reference in one module. `default_node` is the literal second arg
    of a read call when present; `via` names the reference kind."""
    refs: List[Tuple[str, int, str, Optional[ast.AST], str]] = []
    owner = enclosing_functions(src.tree)

    def symbol_of(node: ast.AST) -> str:
        fn = owner.get(node)
        return fn.name if fn is not None else ""

    for node in src.walk():
        if isinstance(node, ast.Call):
            cname = dotted_name(node.func)
            tail = ".".join(cname.split(".")[-2:])
            if cname in _READ_CALLS or tail in _READ_CALLS:
                name = _literal_env_name(node.args[0]) if node.args \
                    else None
                if name:
                    default = node.args[1] if len(node.args) > 1 \
                        else None
                    refs.append((name, node.lineno, symbol_of(node),
                                 default, "read"))
            elif cname in _REGISTRY_CALLS \
                    or cname.split(".")[-1] == "env_value":
                name = _literal_env_name(node.args[0]) if node.args \
                    else None
                if name:
                    refs.append((name, node.lineno, symbol_of(node),
                                 None, "registry"))
            elif tail in _WRITE_CALLS \
                    or cname.split(".")[-1] in ("setenv", "delenv"):
                name = _literal_env_name(node.args[0]) if node.args \
                    else None
                if name:
                    refs.append((name, node.lineno, symbol_of(node),
                                 None, "write"))
            for kw in node.keywords:
                if kw.arg == "disable_env":
                    name = _literal_env_name(kw.value)
                    if name:
                        refs.append((name, kw.value.lineno,
                                     symbol_of(node), None,
                                     "disable_env"))
        elif isinstance(node, ast.Subscript):
            base = dotted_name(node.value)
            if base in ("os.environ", "environ"):
                name = _literal_env_name(node.slice)
                if name:
                    via = ("read" if isinstance(node.ctx, ast.Load)
                           else "write")
                    refs.append((name, node.lineno, symbol_of(node),
                                 None, via))
    return refs


def _default_matches(default_node: Optional[ast.AST],
                     registry_default: Optional[str]) -> bool:
    """Whether a read-site literal default agrees with the registry.

    None, '' and an absent second argument all mean 'unset'. Non-literal
    defaults (module constants) are accepted: the constant is the one
    definition and the registry mirrors it in string form.
    """
    if default_node is None:
        return True  # plain read; registry default applies afterwards
    if not isinstance(default_node, ast.Constant):
        return True  # name/attribute default: not a second literal
    value = default_node.value
    site = None if value in (None, "") else str(value)
    reg = None if registry_default in (None, "") else registry_default
    return site is None or site == reg


def check_flag_references(sources: List[SourceFile],
                          flags: Optional[Dict[str, object]] = None) -> \
        List[Finding]:
    """GL401/GL402 over the scanned tree + GL403/404/405 registry
    health. `flags` defaults to galah_tpu_torch.config.FLAGS."""
    if flags is None:
        from galah_tpu_torch.config import FLAGS
        flags = dict(FLAGS)
    findings: List[Finding] = []
    referenced = set()

    for src in sources:
        for name, line, symbol, default_node, via in \
                enumerate_references(src):
            referenced.add(name)
            flag = flags.get(name)
            if flag is None:
                findings.append(Finding(
                    "GL401", Severity.ERROR, src.path, line,
                    f"{via} of unregistered environment flag {name} — "
                    "declare it in galah_tpu_torch.config.FLAGS", symbol))
                continue
            if via == "read" and not _default_matches(
                    default_node, flag.default):
                findings.append(Finding(
                    "GL402", Severity.ERROR, src.path, line,
                    f"read of {name} supplies a literal default "
                    f"{ast.literal_eval(default_node)!r} conflicting "
                    f"with the registry default {flag.default!r} — "
                    "the default must be defined once, in "
                    "config.FLAGS", symbol))

    rendered_env = None
    try:
        from galah_tpu_torch.manpage import render_environment_section

        rendered_env = render_environment_section()
    except Exception:  # pragma: no cover - import cycle / refactor
        rendered_env = None

    for name, flag in sorted(flags.items()):
        if not getattr(flag, "help", ""):
            findings.append(Finding(
                "GL404", Severity.ERROR, "galah_tpu_torch/config.py", 0,
                f"registered flag {name} has no help text "
                "(undocumented)", "FLAGS"))
        if name not in referenced \
                and not getattr(flag, "external_reader", None):
            findings.append(Finding(
                "GL403", Severity.WARNING, "galah_tpu_torch/config.py", 0,
                f"registered flag {name} is never referenced in the "
                "scanned tree (stale registration? set "
                "external_reader if a C/shell reader owns it)",
                "FLAGS"))
        if rendered_env is not None and name not in rendered_env:
            findings.append(Finding(
                "GL405", Severity.ERROR, "galah_tpu_torch/manpage.py", 0,
                f"registered flag {name} missing from the rendered "
                "ENVIRONMENT section", "render_environment_section"))
    return findings
