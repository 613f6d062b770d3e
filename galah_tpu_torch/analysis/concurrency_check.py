"""Concurrency discipline (GL8xx): lock annotations, order, adoption.
The port's copy of ``galah_tpu/analysis/concurrency_check.py``.

The threaded modules (obs emission, the read-ahead pool, the
resilience layer, the stage clock, the index store, the C parser's
build lock) each guard shared state with explicit locks. This family
makes that discipline *declared* and machine-checked; the runtime
sanitizer (``analysis/sanitizer.py``, ``GALAH_SAN=1``) holds the same
declarations against a real run.

Annotated modules carry two module-level literals (harvested from the
AST via ``ast.literal_eval``, never imported):

    GUARDED_BY = {
        # "ClassName.attr" or "_MODULE_GLOBAL"  ->  the lock that must
        # be held for every MUTATION (reads are a caller's judgment:
        # snapshot methods deliberately tolerate torn reads)
        "StageClock.work_seconds": "StageClock._work_lock",
        "_EVENTS": "_LOCK",
    }
    LOCK_ORDER = ["_WARN_ONCE_LOCK", "_LOCK"]   # outermost first

Checks
  GL801  a ``GUARDED_BY`` target mutated outside a ``with <lock>:``
         block holding its declared lock. Mutation = assignment /
         augmented assignment / deletion of the attribute (through any
         subscript depth) or a mutating method call (append, pop,
         clear, write, ...). ``__init__`` of the owning class and
         module top level are exempt (single-threaded construction).
  GL802  a lock acquired while holding another lock that the merged
         ``LOCK_ORDER`` declarations say must be acquired LATER:
         the classic AB/BA inversion, caught lexically and through
         calls (a function called under lock A that acquires lock B
         creates the same edge).
  GL803  a cycle in the observed acquisition graph, including the
         length-1 cycle of re-acquiring a held non-reentrant Lock
         (self-deadlock). A lock constructed as ``threading.RLock()``
         is reentrant by contract, so its length-1 cycle is exempt;
         longer cycles still report.
  GL804  a thread-pool ``submit`` or ``threading.Thread(target=...)``
         whose callable is not adopt-wrapped: a worker must run under
         ``obs/flow.adopt(token)`` with the token taken in the
         spawning thread (``obs/flow.token()``), directly or through a
         wrapper that does (``io/prefetch._adopting``), or the flow
         spans it emits land on an empty thread-local context.
  GL805  annotation hygiene: a module in the threaded-module registry
         without annotations, a stale ``GUARDED_BY`` entry (class /
         attribute / global that no longer exists), an undeclarable
         lock name, or LOCK_ORDER declarations that contradict each
         other across modules.

The checks run on every module that carries annotations (fixtures
included); the registry below drives the GL805 missing-annotation
finding and the sanitizer's ``install``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from galah_tpu_torch.analysis.core import (Finding, Severity, SourceFile,
                                           dotted_name)

#: Modules that MUST declare GUARDED_BY/LOCK_ORDER (GL805 when absent).
THREADED_MODULES = (
    "galah_tpu_torch/obs/metrics.py",
    "galah_tpu_torch/obs/trace.py",
    "galah_tpu_torch/obs/events.py",
    "galah_tpu_torch/obs/profile.py",
    "galah_tpu_torch/obs/flow.py",
    "galah_tpu_torch/obs/heartbeat.py",
    "galah_tpu_torch/io/prefetch.py",
    "galah_tpu_torch/io/_cingest.py",
    "galah_tpu_torch/io/pagestore.py",
    "galah_tpu_torch/ops/_ccollision.py",
    "galah_tpu_torch/resilience/dispatch.py",
    "galah_tpu_torch/resilience/policy.py",
    "galah_tpu_torch/resilience/faults.py",
    "galah_tpu_torch/timing.py",
    "galah_tpu_torch/ops/sketch_stream.py",
    "galah_tpu_torch/index/store.py",
    "galah_tpu_torch/index/incremental.py",
    "galah_tpu_torch/fleet/scheduler.py",
)

#: Method calls that mutate their receiver in place.
MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "update",
    "setdefault", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "sort", "reverse", "write", "writelines", "flush",
    "close", "truncate",
})

#: (module path, canonical lock name) — the global lock identity.
LockId = Tuple[str, str]


def harvest_literal(tree: ast.Module, name: str):
    """A module-level ``NAME = <literal>`` value, or None (same
    machine-readable-by-construction rule as PALLAS_CONTRACT)."""
    for node in tree.body:
        targets: list = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                try:
                    return ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    return None
    return None


def _dotted_to_path(mod: str) -> str:
    return mod.replace(".", "/") + ".py"


class _Module:
    """Per-module model: annotations, classes, functions, instances,
    galah-internal imports."""

    def __init__(self, src: SourceFile) -> None:
        self.src = src
        self.path = src.path.replace("\\", "/")
        self.guarded = harvest_literal(src.tree, "GUARDED_BY")
        self.lock_order = harvest_literal(src.tree, "LOCK_ORDER")
        self.classes: Dict[str, ast.ClassDef] = {}
        self.functions: Dict[str, ast.FunctionDef] = {}
        self.methods: Dict[str, ast.FunctionDef] = {}  # "Cls.meth"
        self.instances: Dict[str, str] = {}   # global -> class name
        self.globals_assigned: Set[str] = set()
        self.import_mods: Dict[str, str] = {}   # alias -> module path
        self.import_funcs: Dict[str, Tuple[str, str]] = {}
        # lock names bound to threading.RLock() — reentrant, so the
        # GL803 length-1 self-cycle does not apply to them
        self.reentrant_locks: Set[str] = set()
        self._scan()

    @property
    def annotated(self) -> bool:
        return self.guarded is not None or self.lock_order is not None

    def _scan(self) -> None:
        for node in self.src.tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self.methods[f"{node.name}.{item.name}"] = item
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if not isinstance(t, ast.Name):
                        continue
                    self.globals_assigned.add(t.id)
                    v = node.value
                    if (v is not None and isinstance(v, ast.Call)
                            and isinstance(v.func, ast.Name)
                            and v.func.id in self.classes):
                        self.instances[t.id] = v.func.id
        for node in self.src.walk():
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.startswith("galah_tpu_torch"):
                        self.import_mods[a.asname or a.name] = \
                            _dotted_to_path(a.name)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if not mod.startswith("galah_tpu_torch"):
                    continue
                for a in node.names:
                    child = f"{mod}.{a.name}"
                    alias = a.asname or a.name
                    # `from galah_tpu_torch.obs import trace` imports a
                    # MODULE; `from ...policy import call_with_retry`
                    # imports a function — decide by existence later,
                    # record both interpretations.
                    self.import_mods.setdefault(
                        alias, _dotted_to_path(child))
                    self.import_funcs.setdefault(
                        alias, (_dotted_to_path(mod), a.name))
        self._scan_reentrant()

    def _scan_reentrant(self) -> None:
        def is_rlock(value: ast.AST) -> bool:
            return (isinstance(value, ast.Call)
                    and dotted_name(value.func).rsplit(".", 1)[-1]
                    == "RLock")

        for cname, cnode in self.classes.items():
            for n in ast.walk(cnode):
                if not (isinstance(n, ast.Assign)
                        and is_rlock(n.value)):
                    continue
                for t in n.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        self.reentrant_locks.add(f"{cname}.{t.attr}")
        for node in self.src.tree.body:
            if not (isinstance(node, ast.Assign)
                    and is_rlock(node.value)):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.reentrant_locks.add(t.id)

    # -- canonicalization --------------------------------------------

    def canon_lock_decl(self, decl: str) -> Optional[LockId]:
        """'_LOCK' / 'Cls._lock' / 'other/module.py:_LOCK' -> LockId,
        or None when it names nothing in this module."""
        if ":" in decl:
            path, name = decl.split(":", 1)
            return (path, name)
        if "." in decl:
            cls, attr = decl.split(".", 1)
            if cls in self.classes and _class_has_attr(
                    self.classes[cls], attr):
                return (self.path, decl)
            return None
        if decl in self.globals_assigned:
            return (self.path, decl)
        return None

    def lock_of_expr(self, expr: ast.AST,
                     cls: Optional[str]) -> Optional[LockId]:
        """Canonical lock for a ``with`` context expression."""
        name = dotted_name(expr)
        if not name:
            return None
        parts = name.split(".")
        if len(parts) == 1:
            if parts[0] in self.globals_assigned:
                return (self.path, parts[0])
            return None
        if len(parts) == 2:
            if parts[0] == "self" and cls is not None:
                return (self.path, f"{cls}.{parts[1]}")
            if parts[0] in self.instances:
                return (self.path,
                        f"{self.instances[parts[0]]}.{parts[1]}")
        return None


def _class_has_attr(cls_node: ast.ClassDef, attr: str) -> bool:
    for node in ast.walk(cls_node):
        if (isinstance(node, ast.Attribute) and node.attr == attr
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return True
    return False


def _mutation_root(expr: ast.AST, m: _Module,
                   cls: Optional[str]) -> Optional[str]:
    """The GUARDED_BY candidate key a mutation of `expr` touches:
    descends through subscripts/attribute chains (mutating
    ``self._tree[path][0]`` mutates ``self._tree``)."""
    node = expr
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
            continue
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name):
                if base.id == "self" and cls is not None:
                    return f"{cls}.{node.attr}"
                if base.id in m.instances:
                    return f"{m.instances[base.id]}.{node.attr}"
            node = base
            continue
        if isinstance(node, ast.Name):
            return node.id
        return None


class _FuncInfo:
    def __init__(self, module: _Module, qualname: str,
                 node: ast.AST, cls: Optional[str]) -> None:
        self.module = module
        self.qualname = qualname
        self.node = node
        self.cls = cls
        self.direct_acquires: Set[LockId] = set()
        self.calls: List[Tuple[Tuple[str, str], int]] = []
        self.may_acquire: Set[LockId] = set()


def _callee_keys(call: ast.Call, m: _Module, cls: Optional[str],
                 registry: Dict[Tuple[str, str], _FuncInfo]) -> \
        List[Tuple[str, str]]:
    f = call.func
    if isinstance(f, ast.Name):
        n = f.id
        if n in m.functions:
            return [(m.path, n)]
        if n in m.classes and (m.path, f"{n}.__init__") in registry:
            return [(m.path, f"{n}.__init__")]
        if n in m.import_funcs and m.import_funcs[n] in registry:
            return [m.import_funcs[n]]
        return []
    if isinstance(f, ast.Attribute):
        base = dotted_name(f.value)
        meth = f.attr
        if base == "self" and cls is not None:
            key = (m.path, f"{cls}.{meth}")
            return [key] if key in registry else []
        if base in m.instances:
            key = (m.path, f"{m.instances[base]}.{meth}")
            return [key] if key in registry else []
        if base in m.import_mods:
            key = (m.import_mods[base], meth)
            return [key] if key in registry else []
    return []


def _collect_funcinfo(modules: Sequence[_Module]) -> \
        Dict[Tuple[str, str], _FuncInfo]:
    registry: Dict[Tuple[str, str], _FuncInfo] = {}
    for m in modules:
        for name, node in m.functions.items():
            registry[(m.path, name)] = _FuncInfo(m, name, node, None)
        for qual, node in m.methods.items():
            cls = qual.split(".", 1)[0]
            registry[(m.path, qual)] = _FuncInfo(m, qual, node, cls)
    # direct acquisitions + resolvable call sites, then the transitive
    # may-acquire fixpoint (what makes the order check interprocedural)
    for info in registry.values():
        m, cls = info.module, info.cls
        for node in ast.walk(info.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = m.lock_of_expr(item.context_expr, cls)
                    if lock is not None:
                        info.direct_acquires.add(lock)
            elif isinstance(node, ast.Call):
                for key in _callee_keys(node, m, cls, registry):
                    info.calls.append((key, node.lineno))
        info.may_acquire |= info.direct_acquires
    changed = True
    while changed:
        changed = False
        for info in registry.values():
            for key, _ in info.calls:
                callee = registry.get(key)
                if callee is None:
                    continue
                new = callee.may_acquire - info.may_acquire
                if new:
                    info.may_acquire |= new
                    changed = True
    return registry


def _adopting_defs(tree: ast.Module) -> Dict[str, bool]:
    """Every FunctionDef (any nesting) by simple name -> whether its
    body references the flow-adoption API (``adopt``; ``stage_token``
    is galah_tpu's name, kept so its fixtures read the same)."""
    out: Dict[str, bool] = {}
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        adopting = False
        for sub in ast.walk(node):
            name = ""
            if isinstance(sub, ast.Attribute):
                name = sub.attr
            elif isinstance(sub, ast.Name):
                name = sub.id
            if name in ("adopt", "stage_token"):
                adopting = True
                break
        out[node.name] = out.get(node.name, False) or adopting
    return out


def _callable_is_adopting(arg: ast.AST,
                          defs: Dict[str, bool]) -> Optional[bool]:
    """True/False when the submitted callable can be resolved to a
    local def; None when it cannot be resolved at all."""
    if isinstance(arg, ast.Call):
        # wrapper(f) — adopting iff the wrapper's def adopts
        fname = dotted_name(arg.func).split(".")[-1]
        if fname in defs:
            return defs[fname]
        return None
    name = dotted_name(arg)
    if name:
        simple = name.split(".")[-1]
        if simple in defs:
            return defs[simple]
    return None


# ---------------------------------------------------------------------------
# The checker
# ---------------------------------------------------------------------------


def check_concurrency(sources: Dict[str, SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    modules = [_Module(src) for src in sources.values()]
    annotated = [m for m in modules if m.annotated]
    by_path = {m.path: m for m in modules}

    # GL805: registry coverage
    for path in THREADED_MODULES:
        m = by_path.get(path)
        if m is not None and not m.annotated:
            findings.append(Finding(
                "GL805", Severity.WARNING, path, 1,
                "threaded module lacks GUARDED_BY/LOCK_ORDER "
                "annotations (declare them — empty literals are a "
                "valid 'no locked shared state here' statement)"))

    findings.extend(_check_annotations(annotated))

    declared_order, order_findings = _declared_order(annotated)
    findings.extend(order_findings)

    registry = _collect_funcinfo(annotated)

    edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]] = {}
    for info in registry.values():
        findings.extend(_walk_function(info, registry, edges))

    findings.extend(_order_violations(edges, declared_order))
    reentrant = {(m.path, name) for m in annotated
                 for name in m.reentrant_locks}
    findings.extend(_cycles(edges, reentrant))

    for m in annotated:
        findings.extend(_check_adoption(m))
    return findings


def _check_annotations(annotated: Sequence[_Module]) -> List[Finding]:
    out: List[Finding] = []
    for m in annotated:
        if m.guarded is not None and not (
                isinstance(m.guarded, dict)
                and all(isinstance(k, str) and isinstance(v, str)
                        for k, v in m.guarded.items())):
            out.append(Finding(
                "GL805", Severity.WARNING, m.path, 1,
                "GUARDED_BY must be a literal {str: str} dict of "
                "guarded target -> lock"))
            m.guarded = {}
        if m.lock_order is not None and not (
                isinstance(m.lock_order, list)
                and all(isinstance(e, str) for e in m.lock_order)):
            out.append(Finding(
                "GL805", Severity.WARNING, m.path, 1,
                "LOCK_ORDER must be a literal [str, ...] list, "
                "outermost lock first"))
            m.lock_order = []
        for key, lock in (m.guarded or {}).items():
            if "." in key:
                cls, attr = key.split(".", 1)
                if cls not in m.classes:
                    out.append(Finding(
                        "GL805", Severity.WARNING, m.path, 1,
                        f"stale GUARDED_BY entry {key!r}: class "
                        f"{cls!r} does not exist in this module"))
                    continue
                if not _class_has_attr(m.classes[cls], attr):
                    out.append(Finding(
                        "GL805", Severity.WARNING, m.path, 1,
                        f"stale GUARDED_BY entry {key!r}: "
                        f"self.{attr} never appears in class {cls}"))
                    continue
            elif key not in m.globals_assigned:
                out.append(Finding(
                    "GL805", Severity.WARNING, m.path, 1,
                    f"stale GUARDED_BY entry {key!r}: no such "
                    "module-level global"))
                continue
            if m.canon_lock_decl(lock) is None:
                out.append(Finding(
                    "GL805", Severity.WARNING, m.path, 1,
                    f"GUARDED_BY[{key!r}] names unknown lock "
                    f"{lock!r} (want 'ClassName._lock', a module "
                    "global, or 'path.py:NAME')"))
    return out


def _declared_order(annotated: Sequence[_Module]) -> \
        Tuple[Dict[Tuple[LockId, LockId], str], List[Finding]]:
    declared: Dict[Tuple[LockId, LockId], str] = {}
    out: List[Finding] = []
    for m in sorted(annotated, key=lambda m: m.path):
        locks: List[LockId] = []
        for decl in (m.lock_order or []):
            lock = m.canon_lock_decl(decl)
            if lock is None:
                out.append(Finding(
                    "GL805", Severity.WARNING, m.path, 1,
                    f"LOCK_ORDER entry {decl!r} names no lock in "
                    "this module"))
                continue
            locks.append(lock)
        for i, a in enumerate(locks):
            for b in locks[i + 1:]:
                if (b, a) in declared:
                    out.append(Finding(
                        "GL805", Severity.WARNING, m.path, 1,
                        f"LOCK_ORDER conflict: this module declares "
                        f"{a[1]} before {b[1]} but "
                        f"{declared[(b, a)]} declares the reverse"))
                    continue
                declared.setdefault((a, b), m.path)
    return declared, out


def _walk_function(
    info: _FuncInfo,
    registry: Dict[Tuple[str, str], _FuncInfo],
    edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]],
) -> List[Finding]:
    """GL801 mutation discipline + acquisition-edge collection for one
    function, tracking the lexically-held lock set."""
    m, cls = info.module, info.cls
    guarded: Dict[str, str] = m.guarded or {}
    findings: List[Finding] = []
    is_init = info.qualname.endswith(".__init__")

    def required_lock(candidate: str) -> Optional[LockId]:
        decl = guarded.get(candidate)
        return None if decl is None else m.canon_lock_decl(decl)

    def check_mutation(target: ast.AST, lineno: int,
                       held: frozenset, how: str) -> None:
        candidate = _mutation_root(target, m, cls)
        if candidate is None or candidate not in guarded:
            return
        if is_init and cls and candidate.startswith(f"{cls}."):
            return  # construction is single-threaded
        lock = required_lock(candidate)
        if lock is None or lock in held:
            return
        findings.append(Finding(
            "GL801", Severity.ERROR, m.path, lineno,
            f"{how} of {candidate!r} outside its declared lock "
            f"{guarded[candidate]!r} (GUARDED_BY)",
            symbol=info.qualname))

    def visit(node: ast.AST, held: frozenset) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # a nested def runs LATER, not under these locks
            for child in ast.iter_child_nodes(node):
                visit(child, frozenset())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in node.items:
                lock = m.lock_of_expr(item.context_expr, cls)
                if lock is not None:
                    acquired.append((lock, item.context_expr))
            inner = held
            for lock, expr in acquired:
                for h in inner:
                    edges.setdefault(
                        (h, lock),
                        (m.path, node.lineno, info.qualname))
                inner = inner | {lock}
            for item in node.items:
                visit(item.context_expr, held)
                if item.optional_vars is not None:
                    visit(item.optional_vars, held)
            for child in node.body:
                visit(child, inner)
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                check_mutation(t, node.lineno, held, "assignment")
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            check_mutation(node.target, node.lineno, held,
                           "assignment")
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                check_mutation(t, node.lineno, held, "deletion")
        elif isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute)
                    and fn.attr in MUTATORS):
                check_mutation(fn.value, node.lineno, held,
                               f".{fn.attr}() call")
            if held:
                for key in _callee_keys(node, m, cls, registry):
                    callee = registry.get(key)
                    if callee is None:
                        continue
                    for lock in callee.may_acquire:
                        for h in held:
                            edges.setdefault(
                                (h, lock),
                                (m.path, node.lineno,
                                 info.qualname))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for child in ast.iter_child_nodes(info.node):
        visit(child, frozenset())
    return findings


def _order_violations(
    edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]],
    declared: Dict[Tuple[LockId, LockId], str],
) -> List[Finding]:
    out: List[Finding] = []
    for (held, acquired), (path, lineno, symbol) in sorted(
            edges.items(), key=lambda kv: (kv[1][0], kv[1][1])):
        if (acquired, held) in declared:
            out.append(Finding(
                "GL802", Severity.ERROR, path, lineno,
                f"acquires {acquired[1]!r} while holding "
                f"{held[1]!r}, but LOCK_ORDER (declared in "
                f"{declared[(acquired, held)]}) requires "
                f"{acquired[1]!r} to be taken first",
                symbol=symbol))
    return out


def _cycles(
    edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]],
    reentrant: Optional[Set[LockId]] = None,
) -> List[Finding]:
    """DFS cycle detection over the observed acquisition graph; each
    cycle reported once, anchored at its lexically first edge. A
    length-1 cycle on a lock in `reentrant` (threading.RLock) is the
    sanctioned under-lock-helper idiom, not a self-deadlock."""
    reentrant = reentrant or set()
    graph: Dict[LockId, List[LockId]] = {}
    for held, acquired in edges:
        if held == acquired and held in reentrant:
            continue
        graph.setdefault(held, []).append(acquired)
    out: List[Finding] = []
    seen_cycles: Set[Tuple[LockId, ...]] = set()

    def dfs(node: LockId, stack: List[LockId],
            on_stack: Set[LockId]) -> None:
        for nxt in sorted(graph.get(node, [])):
            if nxt in on_stack:
                cycle = tuple(stack[stack.index(nxt):]) + (nxt,)
                key = tuple(sorted(set(cycle)))
                if key in seen_cycles:
                    continue
                seen_cycles.add(key)
                path, lineno, symbol = edges[(node, nxt)]
                chain = " -> ".join(lk[1] for lk in cycle)
                out.append(Finding(
                    "GL803", Severity.ERROR, path, lineno,
                    ("lock re-acquired while already held "
                     f"(self-deadlock for a non-reentrant Lock): "
                     f"{chain}" if len(set(cycle)) == 1 else
                     f"lock acquisition cycle: {chain} — a "
                     "deadlock under the right interleaving"),
                    symbol=symbol))
            elif nxt not in visited:
                visited.add(nxt)
                stack.append(nxt)
                on_stack.add(nxt)
                dfs(nxt, stack, on_stack)
                on_stack.discard(nxt)
                stack.pop()

    visited: Set[LockId] = set()
    for start in sorted(graph):
        if start not in visited:
            visited.add(start)
            dfs(start, [start], {start})
    return out


def _check_adoption(m: _Module) -> List[Finding]:
    """GL804 over one annotated module."""
    out: List[Finding] = []
    defs = _adopting_defs(m.src.tree)
    for node in m.src.walk():
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        target: Optional[ast.AST] = None
        what = ""
        if isinstance(fn, ast.Attribute) and fn.attr == "submit":
            if node.args:
                target, what = node.args[0], "pool.submit() callable"
        elif dotted_name(fn) in ("threading.Thread", "Thread"):
            for kw in node.keywords:
                if kw.arg == "target":
                    target, what = kw.value, "Thread target"
        if target is None:
            continue
        adopting = _callable_is_adopting(target, defs)
        if adopting is True:
            continue
        detail = ("does not capture stage context"
                  if adopting is False else
                  "cannot be verified to capture stage context")
        out.append(Finding(
            "GL804", Severity.WARNING, m.path, node.lineno,
            f"{what} {detail}: capture obs/flow.token() in the "
            "spawning thread and run the worker under "
            "obs/flow.adopt(token), or its telemetry lands on an "
            "empty thread-local stage stack"))
    return out
