"""GalahIR: the whole-program call graph and effect IR of the GL11xx
family. The port's copy of ``galah_tpu/analysis/ir.py``, with torch's
sinks in place of JAX's.

The lexical families (GL1006, GL806, GL1001, GL8xx) read one function
body at a time, so one helper in between hides a violation: a
``device_round`` body that calls a local ``_sync()`` wrapper around
``.item()`` passes GL1006. GalahIR closes that gap with a pass over the
whole package:

  1. **Per-file extraction** (:class:`ModuleIR`): one AST walk per file
     collects every function (methods and nested defs included), its
     *direct effect witnesses*, its outgoing call edges (plain calls,
     ``functools.partial`` targets, function references passed as
     arguments, pool-submitted callbacks), the module's import and
     alias tables, and the annotations the auditors read
     (``PIPELINE_STAGE["device_round"]``, ``GUARDED_BY``).
  2. **Linking** (:class:`ProgramIR`): module-qualified name resolution
     across files (``import x as y``, ``from x import y as z``,
     module-level function aliases, methods of module-level instances);
     a decorated function is resolved by its own name, so a decorator
     never hides its body.
  3. **Effect propagation to a fixpoint** over the call graph, keeping
     one witness chain per (function, effect), so a finding carries the
     ``caller -> helper -> sink file:line`` path.

Inferred effects (:data:`EFFECTS`):

  ``host_sync``        a call named in pipeline_check's
                       ``DEVICE_ROUND_SYNC_CALLS`` (``.item()``,
                       ``.tolist()``, ``.cpu()``, ``.numpy()``,
                       ``np.asarray``, ...): a device-to-host copy
  ``device_dispatch``  a call of a bound launch function,
                       ``lib.<name>_launch(...)`` (GL113's form)
  ``fs_write``         a write-mode ``open()``/``os.fdopen`` or a
                       tmp+rename idiom call (GL806's set); it never
                       propagates out of the sanctioned writer
                       ``io/atomic.py`` or the build installers
                       (:data:`BUILD_ARTIFACT_WRITERS`)
  ``lock_acquire``     a bare ``.acquire()`` call
  ``blocking_io``      ``time.sleep``, ``subprocess.run/check_*``,
                       a Future's ``.result()``
  ``materialize``      ``list``/``sorted``/``tuple`` over a streamed
                       producer (GL1001's set)
  ``unseeded_rng``     global-state ``random.*`` / ``np.random.*``, a
                       no-argument ``Random()``/``default_rng()``, and
                       torch's forms that GL904 knows: sampling without
                       ``generator=``, the global ``torch.manual_seed``,
                       a ``torch.Generator()`` never seeded

Effects propagate across plain call edges and function-reference edges
(the callee runs on the caller's thread); they do not propagate across
pool-submit / Thread-target edges (the callee runs later, elsewhere:
GL1105 audits those).

**Caching**: the per-file IR is keyed by content (the sha256 of the
text, :data:`IR_VERSION`, the path and the package name) and kept under
the sketch cache's discipline (``io/diskcache.py``): one JSON entry a
file written through ``io/atomic.py``, a corrupt entry dropped and
rebuilt, the cache optional (``IRCache(None)`` does nothing). A warm
cache skips the per-file walk; linking and the fixpoint always run.
``galah_tpu``'s lint reads the same ``GALAH_TPU_IR_CACHE`` and both lint
``tests/test_torch_*.py``: the package name in the key keeps each
package's entries, built with its own sink sets, from the other.

**Known limits**: dispatch through ``getattr`` or dicts of callables is
invisible; a method call on a value of unknown class (``obj.meth()``
where ``obj`` is a parameter) does not resolve; the effects of
third-party code (numpy, torch) are modelled only by the sink sets.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from galah_tpu_torch.analysis import determinism_check as _det
from galah_tpu_torch.analysis import fs_check as _fs
from galah_tpu_torch.analysis import pipeline_check as _pipe
from galah_tpu_torch.analysis.concurrency_check import harvest_literal
from galah_tpu_torch.analysis.core import SourceFile, dotted_name

logger = logging.getLogger(__name__)

#: Bump on any change to extraction or the serialized shape: the cache
#: key carries it, so a stale entry misses instead of lying.
IR_VERSION = 1

#: The package whose sink sets built an entry; part of the cache key.
PACKAGE = "galah_tpu_torch"

#: The effect lattice (a powerset over this alphabet; join = union).
EFFECTS = ("host_sync", "device_dispatch", "fs_write", "lock_acquire",
           "blocking_io", "materialize", "unseeded_rng")

# -- effect sink sets -------------------------------------------------------

#: Last-component call names that copy device memory to the host:
#: GL1006's own set, so GL1101 is its exact transitive extension.
HOST_SYNC_LASTS = _pipe.DEVICE_ROUND_SYNC_CALLS

#: The suffix of a bound launch function's name (GL113's form).
LAUNCH_SUFFIX = "_launch"

#: Dotted call names of a hand-rolled durable-write idiom (GL806's set).
FS_IDIOM_CALLS = _fs.IDIOM_CALLS

#: Dotted call names that block the calling thread.
BLOCKING_CALLS = frozenset({
    "time.sleep", "subprocess.run", "subprocess.check_output",
    "subprocess.check_call", "select.select",
})
#: Last-component names that block when called on a future; kept
#: narrow (``.result`` is the pool code's blocking idiom).
BLOCKING_LASTS = frozenset({"result"})

#: Materializers and the streamed-producer shape (GL1001's).
MATERIALIZERS = _pipe.MATERIALIZERS
STREAMING_PREFIX = _pipe.STREAMING_PREFIX
STREAMING_SUFFIX = _pipe.STREAMING_SUFFIX
STREAMING_NAMES = _pipe.STREAMING_NAMES

#: Last-component call names that gather a paged band submatrix, and
#: the receiver methods that retain their argument beyond the call
#: (GL1007's sets, so its interprocedural arm extends the lexical one).
GATHER_LASTS = _pipe.GATHER_NAMES
RETAINER_METHODS = _pipe.RETAINER_METHODS

#: The one sanctioned durable writer: fs_write never propagates out of
#: functions defined here (callers through atomic are crash-consistent
#: by construction, which is GL806's point).
SANCTIONED_WRITER = _fs.SANCTIONED

#: Build installers, whose fs_write does not propagate out either. Each
#: installs a compiled library by rename into the gitignored build
#: directory (``galah_tpu_torch/_build/``); the library is keyed by its
#: sources and rebuilt when it is missing, so it is no artifact of a
#: run and a torn one costs a rebuild, never a wrong result.
BUILD_ARTIFACT_WRITERS = frozenset({
    ("galah_tpu_torch/kernels/build.py", "build"),
    ("galah_tpu_torch/io/_cingest.py", "build"),
})

#: A function key: (repo-relative path, dotted qualname within file).
FuncKey = Tuple[str, str]


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _is_streaming_name(name: str) -> bool:
    n = _last(name)
    return (n.startswith(STREAMING_PREFIX)
            or n.endswith(STREAMING_SUFFIX) or n in STREAMING_NAMES)


def _root_name(node: ast.AST) -> Optional[str]:
    """The base identifier of an attribute/subscript chain
    (``self.cache[k]`` -> ``self``), or None for computed bases."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _stops_fs_write(callee: FuncKey) -> bool:
    return (callee[0] == SANCTIONED_WRITER
            or callee in BUILD_ARTIFACT_WRITERS)


# ---------------------------------------------------------------------------
# Per-function IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CallEdge:
    """One outgoing edge, unresolved (resolution is a link-time step).

    ``kind``: ``call`` (plain invocation), ``ref`` (a function
    reference/partial passed as an argument: runs on this thread,
    effects propagate), ``submit`` (pool.submit / Thread target: runs
    elsewhere, audited by GL1105 instead of propagated)."""

    name: str       # dotted callee expression as written
    line: int
    kind: str = "call"

    def to_list(self) -> list:
        return [self.name, self.line, self.kind]

    @classmethod
    def from_list(cls, raw: list) -> "CallEdge":
        return cls(name=raw[0], line=int(raw[1]), kind=raw[2])


@dataclasses.dataclass
class FuncIR:
    """IR for one function/method/nested def."""

    qualname: str                   # "f", "Cls.meth", "outer.inner"
    line: int
    # effect -> [line, detail] of the first direct witness in this body
    direct: Dict[str, List] = dataclasses.field(default_factory=dict)
    calls: List[CallEdge] = dataclasses.field(default_factory=list)
    params: List[str] = dataclasses.field(default_factory=list)
    # parameter names this body materializes directly (list(p)/...)
    materialized_params: List[str] = \
        dataclasses.field(default_factory=list)
    # [param, callee-name, arg-index, line]: p forwarded as positional
    # arg k of a call, the transitive half of GL1103
    forwarded_params: List[List] = \
        dataclasses.field(default_factory=list)
    # [callee-name, arg-index, line, producer]: a streamed-producer
    # value passed positionally into a call (the GL1103 pass sites)
    stream_args: List[List] = dataclasses.field(default_factory=list)
    # [param, line]: parameters this body stores beyond the call
    # (`self.x = p` / `obj[k] = p` / `acc.append(p)`), the direct half
    # of GL1007's retention query
    retained_params: List[List] = \
        dataclasses.field(default_factory=list)
    # [callee-name, arg-index, line, producer]: a gathered band
    # submatrix passed positionally into a call (the GL1007 pass sites)
    gather_args: List[List] = dataclasses.field(default_factory=list)
    # body references adopt/stage_token (the GL804/GL1105 mark)
    adopts: bool = False
    # decorator dotted names, outermost first
    decorators: List[str] = dataclasses.field(default_factory=list)
    # [line, receiver] of bare .acquire() calls not covered by a
    # try/finally release of the same receiver (the GL1104 witnesses)
    unsafe_acquires: List[List] = \
        dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "qualname": self.qualname,
            "line": self.line,
            "direct": self.direct,
            "calls": [c.to_list() for c in self.calls],
            "params": self.params,
            "materialized_params": self.materialized_params,
            "forwarded_params": self.forwarded_params,
            "stream_args": self.stream_args,
            "retained_params": self.retained_params,
            "gather_args": self.gather_args,
            "adopts": self.adopts,
            "decorators": self.decorators,
            "unsafe_acquires": self.unsafe_acquires,
        }

    @classmethod
    def from_dict(cls, raw: dict) -> "FuncIR":
        return cls(
            qualname=raw["qualname"], line=int(raw["line"]),
            direct={k: list(v) for k, v in raw["direct"].items()},
            calls=[CallEdge.from_list(c) for c in raw["calls"]],
            params=list(raw["params"]),
            materialized_params=list(raw["materialized_params"]),
            forwarded_params=[list(e) for e in raw["forwarded_params"]],
            stream_args=[list(e) for e in raw["stream_args"]],
            retained_params=[list(e) for e in raw["retained_params"]],
            gather_args=[list(e) for e in raw["gather_args"]],
            adopts=bool(raw["adopts"]),
            decorators=list(raw["decorators"]),
            unsafe_acquires=[list(e) for e in raw["unsafe_acquires"]],
        )


# ---------------------------------------------------------------------------
# Per-module IR + extraction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModuleIR:
    """IR for one source file: functions plus the resolution tables."""

    path: str
    content_hash: str
    functions: Dict[str, FuncIR] = dataclasses.field(default_factory=dict)
    # alias -> dotted module ("galah_tpu_torch.ops.minhash") for
    # `import x` and the module interpretation of `from p import x`
    import_mods: Dict[str, str] = dataclasses.field(default_factory=dict)
    # alias -> [dotted module, attr] for `from p import x as y`
    import_attrs: Dict[str, List[str]] = \
        dataclasses.field(default_factory=dict)
    # module-level `name = other` function aliases: name -> dotted RHS
    aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    # module-level instance globals: name -> class name in this module
    instances: Dict[str, str] = dataclasses.field(default_factory=dict)
    classes: List[str] = dataclasses.field(default_factory=list)
    # PIPELINE_STAGE["device_round"] / ["streaming"] lists
    device_round: List[str] = dataclasses.field(default_factory=list)
    streaming: List[str] = dataclasses.field(default_factory=list)
    # declares GUARDED_BY/LOCK_ORDER (the GL804/GL1105 threaded scope)
    annotated: bool = False

    def to_dict(self) -> dict:
        return {
            "package": PACKAGE,
            "ir_version": IR_VERSION,
            "path": self.path,
            "content_hash": self.content_hash,
            "functions": {q: f.to_dict()
                          for q, f in self.functions.items()},
            "import_mods": self.import_mods,
            "import_attrs": self.import_attrs,
            "aliases": self.aliases,
            "instances": self.instances,
            "classes": self.classes,
            "device_round": self.device_round,
            "streaming": self.streaming,
            "annotated": self.annotated,
        }

    @classmethod
    def from_dict(cls, raw: dict) -> "ModuleIR":
        return cls(
            path=raw["path"], content_hash=raw["content_hash"],
            functions={q: FuncIR.from_dict(f)
                       for q, f in raw["functions"].items()},
            import_mods=dict(raw["import_mods"]),
            import_attrs={k: list(v)
                          for k, v in raw["import_attrs"].items()},
            aliases=dict(raw["aliases"]),
            instances=dict(raw["instances"]),
            classes=list(raw["classes"]),
            device_round=list(raw["device_round"]),
            streaming=list(raw["streaming"]),
            annotated=bool(raw["annotated"]),
        )


class _Extractor:
    """One-pass AST -> ModuleIR extraction for a single file."""

    def __init__(self, src: SourceFile) -> None:
        self.src = src
        self.ir = ModuleIR(path=src.path.replace("\\", "/"),
                           content_hash=src.content_hash())
        # torch.Generator(...) calls this file seeds (GL904's rule)
        self.seeded_generators = _det.seeded_generators(src)

    def run(self) -> ModuleIR:
        ir, tree = self.ir, self.src.tree
        for key in ("GUARDED_BY", "LOCK_ORDER"):
            if harvest_literal(tree, key) is not None:
                ir.annotated = True
        stage = harvest_literal(tree, "PIPELINE_STAGE")
        if isinstance(stage, dict):
            for field, dst in (("device_round", ir.device_round),
                               ("streaming", ir.streaming)):
                val = stage.get(field, [])
                if isinstance(val, list):
                    dst.extend(s for s in val if isinstance(s, str))
        self._scan_toplevel(tree)
        # every function def, at any nesting, under its dotted qualname
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._extract_function(node, prefix="")
            elif isinstance(node, ast.ClassDef):
                ir.classes.append(node.name)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._extract_function(
                            item, prefix=node.name + ".")
        return ir

    def _scan_toplevel(self, tree: ast.Module) -> None:
        ir = self.ir
        class_names = {n.name for n in tree.body
                       if isinstance(n, ast.ClassDef)}
        func_names = {n.name for n in tree.body
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
        for node in self.src.walk():
            if isinstance(node, ast.Import):
                for a in node.names:
                    ir.import_mods[a.asname or a.name] = a.name
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue  # no relative imports in this tree
                mod = node.module or ""
                for a in node.names:
                    alias = a.asname or a.name
                    # `from galah_tpu_torch.obs import flow` imports a
                    # MODULE; `from ...policy import f` a function:
                    # record both, the linker decides by existence
                    ir.import_mods.setdefault(alias, f"{mod}.{a.name}")
                    ir.import_attrs.setdefault(alias, [mod, a.name])
        for node in tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                v = node.value
                if (isinstance(v, ast.Call)
                        and isinstance(v.func, ast.Name)
                        and v.func.id in class_names):
                    ir.instances[t.id] = v.func.id
                else:
                    rhs = dotted_name(v)
                    if rhs and (rhs in func_names or "." in rhs
                                or rhs in ir.import_mods
                                or rhs in ir.import_attrs):
                        # `fetch = pull` style alias
                        ir.aliases[t.id] = rhs

    # -- one function ------------------------------------------------

    def _extract_function(self, node: ast.AST, prefix: str) -> None:
        qual = prefix + node.name
        fn = FuncIR(qualname=qual, line=node.lineno,
                    params=[a.arg for a in (node.args.posonlyargs
                                            + node.args.args)])
        for dec in node.decorator_list:
            dn = dotted_name(dec if not isinstance(dec, ast.Call)
                             else dec.func)
            if dn:
                fn.decorators.append(dn)
        self.ir.functions[qual] = fn
        self._walk_body(node, fn)

    def _walk_body(self, node: ast.AST, fn: FuncIR) -> None:
        # names bound to a streamed producer / a band gather inside
        # this body
        bound_streams: Set[str] = set()
        bound_gathers: Set[str] = set()
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Assign)
                    and isinstance(sub.value, ast.Call)):
                continue
            cname = dotted_name(sub.value.func)
            if _is_streaming_name(cname):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        bound_streams.add(t.id)
            if _last(cname) in GATHER_LASTS:
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        bound_gathers.add(t.id)
        # names bound in THIS body (nested defs excluded): a store
        # into a container rooted at one of these dies with the call,
        # so it is not retention
        local_stores: Set[str] = set()

        def collect_stores(n: ast.AST) -> None:
            if isinstance(n, (ast.FunctionDef,
                              ast.AsyncFunctionDef)) and n is not node:
                return
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                local_stores.add(n.id)
            for child in ast.iter_child_nodes(n):
                collect_stores(child)

        collect_stores(node)

        def escapes(root: Optional[str]) -> bool:
            """The container outlives the call: self, a parameter, or
            a name this body never binds (a global/closure)."""
            return (root is not None
                    and (root == "self" or root in fn.params
                         or root not in local_stores))

        def visit(n: ast.AST) -> None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and n is not node:
                # nested def: its own FuncIR; the enclosing function
                # only reaches it through an explicit edge
                self._extract_function(n, prefix=fn.qualname + ".")
                return
            if isinstance(n, (ast.Attribute, ast.Name)):
                ident = n.attr if isinstance(n, ast.Attribute) else n.id
                if ident in ("adopt", "stage_token"):
                    fn.adopts = True
            if isinstance(n, ast.Assign):
                # `self.x = p` / `GLOBAL[k] = p`: the parameter's
                # value outlives the call (GL1007's direct retention
                # half); a store into a body-local container does not
                v = n.value
                if (isinstance(v, ast.Name) and v.id in fn.params
                        and any(isinstance(t, (ast.Attribute,
                                               ast.Subscript))
                                and escapes(_root_name(t))
                                for t in n.targets)):
                    fn.retained_params.append([v.id, n.lineno])
            if isinstance(n, ast.Call):
                self._extract_call(n, fn, bound_streams,
                                   bound_gathers, escapes)
            for child in ast.iter_child_nodes(n):
                visit(child)

        # body statements only: decorator expressions are def-time
        # machinery, not body effects
        for child in node.body:
            visit(child)
        self._find_unsafe_acquires(node, fn)

    def _effect(self, fn: FuncIR, effect: str, line: int,
                detail: str) -> None:
        fn.direct.setdefault(effect, [line, detail])

    def _is_launch(self, call: ast.Call) -> bool:
        """``lib.<name>_launch(...)``: an attribute call on a bound
        library, not on a module this file imports or on ``self``."""
        func = call.func
        if not (isinstance(func, ast.Attribute)
                and func.attr.endswith(LAUNCH_SUFFIX)
                and len(func.attr) > len(LAUNCH_SUFFIX)):
            return False
        root = _root_name(func.value)
        return (root is not None and root not in ("self", "cls")
                and root not in self.ir.import_mods)

    def _extract_call(self, call: ast.Call, fn: FuncIR,
                      bound_streams: Set[str],
                      bound_gathers: Set[str], escapes) -> None:
        name = dotted_name(call.func)
        last = _last(name)
        line = call.lineno

        # ---- direct effects ----
        if last in HOST_SYNC_LASTS:
            self._effect(fn, "host_sync", line, f"{name}()")
        if self._is_launch(call):
            self._effect(fn, "device_dispatch", line, f"{name}()")
        if name in FS_IDIOM_CALLS:
            self._effect(fn, "fs_write", line, f"{name}()")
        elif name in ("open", "os.fdopen") and _fs.is_write_mode(
                _fs.literal_mode(call)):
            self._effect(fn, "fs_write", line, f"write-mode {name}()")
        if last == "acquire" and "." in name:
            self._effect(fn, "lock_acquire", line, f"{name}()")
        if name in BLOCKING_CALLS or (last in BLOCKING_LASTS
                                      and "." in name):
            self._effect(fn, "blocking_io", line, f"{name}()")
        self._extract_rng(call, fn, name, last, line)

        # ---- materialization (direct + param forms) ----
        if (isinstance(call.func, ast.Name)
                and call.func.id in MATERIALIZERS and call.args):
            arg = call.args[0]
            if (isinstance(arg, ast.Call)
                    and _is_streaming_name(dotted_name(arg.func))):
                self._effect(
                    fn, "materialize", line,
                    f"{call.func.id}() over "
                    f"{_last(dotted_name(arg.func))}()")
            elif isinstance(arg, ast.Name):
                if arg.id in bound_streams:
                    self._effect(
                        fn, "materialize", line,
                        f"{call.func.id}() over streamed {arg.id}")
                if arg.id in fn.params and \
                        arg.id not in fn.materialized_params:
                    fn.materialized_params.append(arg.id)

        # ---- retention (GL1007's direct half) ----
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in RETAINER_METHODS and call.args
                and escapes(_root_name(call.func.value))):
            for arg in call.args:
                if isinstance(arg, ast.Name) and arg.id in fn.params:
                    fn.retained_params.append([arg.id, line])

        # ---- call edges ----
        if name:
            fn.calls.append(CallEdge(name=name, line=line))
        is_submit = (isinstance(call.func, ast.Attribute)
                     and call.func.attr == "submit")
        thread_target: Optional[ast.AST] = None
        if name in ("threading.Thread", "Thread"):
            for kw in call.keywords:
                if kw.arg == "target":
                    thread_target = kw.value
        arg_exprs = list(call.args) + [kw.value for kw in call.keywords]
        for idx, arg in enumerate(call.args):
            # a parameter forwarded positionally: the GL1103 half-edge
            if isinstance(arg, ast.Name) and arg.id in fn.params \
                    and name:
                fn.forwarded_params.append([arg.id, name, idx, line])
            if not name or call.func is arg:
                continue
            # a streamed producer passed into a call: GL1103 pass site
            if (isinstance(arg, ast.Call)
                    and _is_streaming_name(dotted_name(arg.func))):
                fn.stream_args.append(
                    [name, idx, line, _last(dotted_name(arg.func))])
            elif isinstance(arg, ast.Name) and arg.id in bound_streams:
                fn.stream_args.append([name, idx, line, arg.id])
            # a gathered band submatrix passed into a call: GL1007
            # pass site
            if (isinstance(arg, ast.Call)
                    and _last(dotted_name(arg.func)) in GATHER_LASTS):
                fn.gather_args.append(
                    [name, idx, line, _last(dotted_name(arg.func))])
            elif isinstance(arg, ast.Name) and arg.id in bound_gathers:
                fn.gather_args.append([name, idx, line, arg.id])
        for arg in arg_exprs:
            target = arg
            kind = "ref"
            if (isinstance(arg, ast.Call)
                    and _last(dotted_name(arg.func)) == "partial"
                    and arg.args):
                target = arg.args[0]   # functools.partial(f, ...) -> f
            ref = dotted_name(target)
            if not ref or ref in ("self", "None", "True", "False"):
                continue
            if is_submit and arg is (call.args[0] if call.args
                                     else None):
                kind = "submit"
            elif thread_target is not None and arg is thread_target:
                kind = "submit"
            fn.calls.append(CallEdge(name=ref, line=getattr(
                arg, "lineno", line), kind=kind))
        # pool.submit(wrapper(f), x): the wrapper call is the callable
        if is_submit and call.args and isinstance(call.args[0],
                                                  ast.Call):
            wname = dotted_name(call.args[0].func)
            if wname:
                fn.calls.append(CallEdge(name=wname,
                                         line=call.args[0].lineno,
                                         kind="submit"))

    def _extract_rng(self, call: ast.Call, fn: FuncIR, name: str,
                     last: str, line: int) -> None:
        parts = name.split(".")
        if len(parts) == 2 and parts[0] == "random" \
                and parts[1] in _det.RANDOM_GLOBAL_FNS:
            self._effect(fn, "unseeded_rng", line, f"{name}()")
        elif len(parts) >= 2 and parts[-2] == "random" \
                and parts[0] in ("np", "numpy") \
                and parts[-1] in _det.NP_RANDOM_GLOBAL_FNS:
            self._effect(fn, "unseeded_rng", line, f"{name}()")
        elif last in ("Random", "RandomState", "default_rng") \
                and not call.args and not call.keywords:
            self._effect(fn, "unseeded_rng", line, f"{name}() unseeded")
        elif name in _det.TORCH_GLOBAL_SEED:
            self._effect(fn, "unseeded_rng", line, f"{name}()")
        elif len(parts) == 2 and parts[0] == "torch" \
                and parts[1] in _det.TORCH_RANDOM_FNS \
                and not any(kw.arg == "generator"
                            for kw in call.keywords):
            self._effect(fn, "unseeded_rng", line, f"{name}()")
        elif name == "torch.Generator" \
                and id(call) not in self.seeded_generators:
            self._effect(fn, "unseeded_rng", line, f"{name}() unseeded")

    # -- GL1104 witnesses --------------------------------------------

    def _find_unsafe_acquires(self, node: ast.AST, fn: FuncIR) -> None:
        """Bare ``X.acquire()`` statements not covered by a
        try/finally that releases the same receiver. Sanctioned
        shapes::

            lock.acquire()                 try:
            try:                               lock.acquire()
                ...                            ...
            finally:                       finally:
                lock.release()                 lock.release()

        A ``return self.acquire()`` passthrough (context-manager
        delegation) is exempt: the caller owns the release."""

        simple = (ast.Expr, ast.Assign, ast.AnnAssign, ast.AugAssign,
                  ast.Return, ast.Assert, ast.Raise)

        def acquires_in(n: ast.AST) -> List[Tuple[int, str]]:
            found: List[Tuple[int, str]] = []
            for c in ast.walk(n):
                if (isinstance(c, ast.Call)
                        and isinstance(c.func, ast.Attribute)
                        and c.func.attr == "acquire"):
                    recv = dotted_name(c.func.value)
                    if recv:
                        found.append((c.lineno, recv))
            return found

        def releases(try_node: ast.Try, receiver: str) -> bool:
            for sub in try_node.finalbody:
                for c in ast.walk(sub):
                    if (isinstance(c, ast.Call)
                            and isinstance(c.func, ast.Attribute)
                            and c.func.attr == "release"
                            and dotted_name(c.func.value) == receiver):
                        return True
            return False

        def scan(body: List[ast.stmt],
                 guard: Optional[ast.Try] = None) -> None:
            """guard: the enclosing Try whose finally may release an
            acquire made directly inside its body."""
            for i, stmt in enumerate(body):
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue  # nested defs have their own FuncIR
                if isinstance(stmt, ast.Try):
                    scan(stmt.body, guard=stmt)
                    for h in stmt.handlers:
                        scan(h.body, guard=guard)
                    scan(stmt.orelse, guard=stmt)
                    scan(stmt.finalbody, guard=guard)
                    continue
                if isinstance(stmt, simple):
                    if isinstance(stmt, ast.Return):
                        continue  # passthrough delegation
                    for line, recv in acquires_in(stmt):
                        if guard is not None and releases(guard, recv):
                            continue
                        nxt = (body[i + 1]
                               if i + 1 < len(body) else None)
                        if isinstance(nxt, ast.Try) \
                                and releases(nxt, recv):
                            continue
                        fn.unsafe_acquires.append([line, recv])
                    continue
                # compound (If/For/While/With): expression parts are
                # never a sanctioned acquire position; recurse bodies
                for field in ("test", "iter"):
                    sub = getattr(stmt, field, None)
                    if sub is not None:
                        for line, recv in acquires_in(sub):
                            fn.unsafe_acquires.append([line, recv])
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if isinstance(sub, list):
                        scan(sub, guard=guard)

        scan(getattr(node, "body", []))


def extract_module_ir(src: SourceFile) -> ModuleIR:
    """Per-file IR from an already-parsed SourceFile (no caching)."""
    return _Extractor(src).run()


# ---------------------------------------------------------------------------
# IR cache (content-hash keyed, diskcache discipline)
# ---------------------------------------------------------------------------


class IRCache:
    """Per-file IR entries under ``path``; ``IRCache(None)`` disables.

    Entries are keyed by content (the sha256 of the source text,
    IR_VERSION, the path and the package), written through
    io/atomic.py so lint runs sharing a directory never see a torn
    entry, and an unreadable or mismatched entry is a miss that is
    rebuilt: a corrupt cache costs a rebuild, never a wrong IR."""

    def __init__(self, path: Optional[str]) -> None:
        self.path = path
        self.hits = 0
        self.misses = 0
        if path:
            os.makedirs(path, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def _entry_path(self, path: str, content_hash: str) -> str:
        # the key covers the repo-relative path (identical texts at two
        # paths, empty __init__.py files, must not share an entry: the
        # IR records its path) and the package (galah_tpu's lint shares
        # the directory and scans tests/test_torch_*.py with its own
        # sink sets)
        key = hashlib.sha256(
            f"ir-torch|v{IR_VERSION}|{path}|{content_hash}".encode()
        ).hexdigest()[:32]
        return os.path.join(self.path, f"ir-{key}.json")

    def load(self, path: str, content_hash: str) -> Optional[ModuleIR]:
        if not self.enabled:
            return None
        entry = self._entry_path(path, content_hash)
        try:
            with open(entry, "r", encoding="utf-8") as fh:
                raw = json.load(fh)
            if raw.get("package") != PACKAGE \
                    or raw.get("ir_version") != IR_VERSION \
                    or raw.get("content_hash") != content_hash \
                    or raw.get("path") != path:
                raise ValueError("key mismatch")
            ir = ModuleIR.from_dict(raw)
        except FileNotFoundError:
            self.misses += 1
            return None
        except Exception as exc:  # corrupt entry: miss and rebuild
            logger.warning("Dropping corrupt IR cache entry %s (%s)",
                           entry, exc)
            try:
                os.unlink(entry)
            except OSError:
                pass
            self.misses += 1
            return None
        self.hits += 1
        return ir

    def store(self, ir: ModuleIR) -> None:
        if not self.enabled:
            return
        from galah_tpu_torch.io import atomic

        atomic.write_json(self._entry_path(ir.path, ir.content_hash),
                          ir.to_dict(), site="io.atomic.write[ir-cache]")


def default_cache_dir() -> Optional[str]:
    """The cache directory from the GALAH_TPU_IR_CACHE flag, or None
    (disabled). Name and default live once, in config.FLAGS."""
    from galah_tpu_torch.config import env_value

    return env_value("GALAH_TPU_IR_CACHE") or None


# ---------------------------------------------------------------------------
# Linking + effect fixpoint
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Witness:
    """Provenance of one (function, effect): either a direct sink in
    this body, or a call edge whose callee carries the effect."""

    line: int                       # line IN the owning function
    detail: str                     # sink description for direct
    callee: Optional[FuncKey] = None   # next hop, None when direct

    @property
    def direct(self) -> bool:
        return self.callee is None


def _module_path_to_dotted(path: str) -> Optional[str]:
    p = path.replace("\\", "/")
    if not p.endswith(".py"):
        return None
    p = p[:-3]
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


class ProgramIR:
    """All ModuleIRs linked: resolved call graph + effect fixpoint."""

    def __init__(self, modules: Sequence[ModuleIR]) -> None:
        self.modules: Dict[str, ModuleIR] = {
            m.path: m for m in modules}
        # dotted module name -> path (galah_tpu_torch.ops.x -> file)
        self.by_dotted: Dict[str, str] = {}
        for m in modules:
            dotted = _module_path_to_dotted(m.path)
            if dotted:
                self.by_dotted[dotted] = m.path
        self.functions: Dict[FuncKey, FuncIR] = {}
        for m in modules:
            for qual, fn in m.functions.items():
                self.functions[(m.path, qual)] = fn
        self._resolved: Dict[FuncKey,
                             List[Tuple[FuncKey, int, str]]] = {}
        self._effects: Dict[FuncKey, Dict[str, Witness]] = {}
        self._adopts: Dict[FuncKey, bool] = {}
        self._mat_params: Dict[FuncKey, Dict[str, Witness]] = {}
        self._ret_params: Dict[FuncKey, Dict[str, Witness]] = {}
        self._link()
        self._fixpoint()

    # -- name resolution ---------------------------------------------

    def resolve(self, mod: ModuleIR, caller_qual: str,
                name: str) -> Optional[FuncKey]:
        """(path, qualname) for a dotted callee expression, or None.

        Resolution order: nested defs of the caller (innermost-out),
        module functions/classes, module-level aliases, imports (module
        and from-import interpretations), instance-method dispatch,
        absolute ``galah_tpu_torch.x.y.f`` chains. ``self.meth``
        resolves within the caller's class."""
        if not name:
            return None
        parts = name.split(".")
        # self.meth inside a method
        if parts[0] == "self" and len(parts) == 2 \
                and "." in caller_qual:
            cls = caller_qual.split(".", 1)[0]
            key = (mod.path, f"{cls}.{parts[1]}")
            return key if key in self.functions else None
        if len(parts) == 1:
            n = parts[0]
            # nested def lookup, innermost enclosing scope outwards
            scope = caller_qual
            while scope:
                key = (mod.path, f"{scope}.{n}")
                if key in self.functions:
                    return key
                scope = scope.rsplit(".", 1)[0] if "." in scope else ""
            if (mod.path, n) in self.functions:
                return (mod.path, n)
            if n in mod.classes:
                key = (mod.path, f"{n}.__init__")
                return key if key in self.functions else None
            if n in mod.aliases and mod.aliases[n] != n:
                return self.resolve(mod, caller_qual, mod.aliases[n])
            if n in mod.import_attrs:
                dmod, attr = mod.import_attrs[n]
                target = self.by_dotted.get(dmod)
                if target and (target, attr) in self.functions:
                    return (target, attr)
                if target and attr in self.modules[target].classes:
                    key = (target, f"{attr}.__init__")
                    return key if key in self.functions else None
            # a bare imported module is not callable
            return None
        # dotted: resolve the base, then the attribute
        base, rest = parts[0], parts[1:]
        if base in mod.instances and len(rest) == 1:
            key = (mod.path, f"{mod.instances[base]}.{rest[0]}")
            return key if key in self.functions else None
        # longest-prefix module match over the import table and
        # absolute dotted paths
        for cut in range(len(parts) - 1, 0, -1):
            prefix = ".".join(parts[:cut])
            dmod: Optional[str] = None
            if cut == 1 and base in mod.import_mods:
                dmod = mod.import_mods[base]
            elif prefix in self.by_dotted:
                dmod = prefix
            if dmod is None:
                continue
            target = self.by_dotted.get(dmod)
            if target is None:
                continue
            attr = ".".join(parts[cut:])
            tmod = self.modules[target]
            if (target, attr) in self.functions:
                return (target, attr)
            if attr in tmod.classes:
                key = (target, f"{attr}.__init__")
                return key if key in self.functions else None
            if attr.split(".")[0] in tmod.aliases:
                return self.resolve(tmod, "", attr)
        return None

    def _link(self) -> None:
        for (path, qual), fn in self.functions.items():
            mod = self.modules[path]
            out: List[Tuple[FuncKey, int, str]] = []
            seen: Set[Tuple[FuncKey, str]] = set()
            for edge in fn.calls:
                key = self.resolve(mod, qual, edge.name)
                if key is None or key == (path, qual):
                    continue
                if (key, edge.kind) in seen:
                    continue
                seen.add((key, edge.kind))
                out.append((key, edge.line, edge.kind))
            self._resolved[(path, qual)] = out

    # -- fixpoint ------------------------------------------------------

    def _fixpoint(self) -> None:
        for key, fn in self.functions.items():
            self._effects[key] = {
                eff: Witness(line=w[0], detail=w[1])
                for eff, w in fn.direct.items()}
            self._adopts[key] = fn.adopts
            self._mat_params[key] = {
                p: Witness(line=fn.line, detail="materialized here")
                for p in fn.materialized_params}
            # direct retention witnesses carry the storing line; the
            # transitive links below carry the callee's param name in
            # `detail` so render_retention_chain can keep walking
            self._ret_params[key] = {
                p: Witness(line=line, detail="")
                for p, line in fn.retained_params}
        keys = sorted(self.functions)
        changed = True
        while changed:
            changed = False
            for key in keys:
                mine = self._effects[key]
                for callee, line, kind in self._resolved[key]:
                    if kind == "submit":
                        continue  # runs elsewhere; GL1105's business
                    for eff in self._effects[callee]:
                        if eff in mine:
                            continue
                        if eff == "fs_write" and _stops_fs_write(callee):
                            continue  # sanctioned boundary
                        mine[eff] = Witness(line=line, detail="",
                                            callee=callee)
                        changed = True
                    if not self._adopts[key] \
                            and self._adopts[callee] and kind == "call":
                        self._adopts[key] = True
                        changed = True
                # transitive materialized params: p forwarded as
                # positional arg k of a callee whose k-th param
                # materializes
                fn = self.functions[key]
                for p, cname, idx, line in fn.forwarded_params:
                    callee = self.resolve(self.modules[key[0]],
                                          key[1], cname)
                    if callee is None:
                        continue
                    cfn = self.functions[callee]
                    if idx >= len(cfn.params):
                        continue
                    if (p not in self._mat_params[key]
                            and cfn.params[idx]
                            in self._mat_params[callee]):
                        self._mat_params[key][p] = Witness(
                            line=line, detail="", callee=callee)
                        changed = True
                    # transitive retention, same walk: p forwarded as
                    # arg k of a callee whose k-th param is retained
                    if (p not in self._ret_params[key]
                            and cfn.params[idx]
                            in self._ret_params[callee]):
                        self._ret_params[key][p] = Witness(
                            line=line, detail=cfn.params[idx],
                            callee=callee)
                        changed = True

    # -- queries -------------------------------------------------------

    def effects_of(self, key: FuncKey) -> Dict[str, Witness]:
        return self._effects.get(key, {})

    def adopts(self, key: FuncKey) -> bool:
        return self._adopts.get(key, False)

    def materializing_param(self, key: FuncKey,
                            index: int) -> Optional[str]:
        """The name of callee param `index` when it is materialized
        (directly or transitively), else None."""
        fn = self.functions.get(key)
        if fn is None or index >= len(fn.params):
            return None
        p = fn.params[index]
        return p if p in self._mat_params.get(key, {}) else None

    def retaining_param(self, key: FuncKey,
                        index: int) -> Optional[str]:
        """The name of callee param `index` when its value is stored
        beyond the call (directly or transitively), else None."""
        fn = self.functions.get(key)
        if fn is None or index >= len(fn.params):
            return None
        p = fn.params[index]
        return p if p in self._ret_params.get(key, {}) else None

    def render_retention_chain(self, key: FuncKey, param: str) -> str:
        """'g -> h: parameter 'q' retained at path.py:30' for GL1007
        messages: the walk from the function handed the gathered value
        down to the storing statement."""
        parts: List[str] = []
        seen: Set[Tuple[FuncKey, str]] = set()
        cur, p = key, param
        while (cur, p) not in seen:
            seen.add((cur, p))
            parts.append(cur[1])
            wit = self._ret_params.get(cur, {}).get(p)
            if wit is None:
                break
            if wit.callee is None:
                return (f"{' -> '.join(parts)}: parameter {p!r} "
                        f"retained at {cur[0]}:{wit.line}")
            cur, p = wit.callee, wit.detail
        return f"{' -> '.join(parts)}: parameter {p!r} retained"

    def witness_chain(self, key: FuncKey,
                      effect: str) -> List[Tuple[FuncKey, Witness]]:
        """The provenance path [(owner, witness), ...] from `key` down
        to the direct sink (bounded by the function count, so a cycle
        cannot loop forever)."""
        out: List[Tuple[FuncKey, Witness]] = []
        seen: Set[FuncKey] = set()
        cur: Optional[FuncKey] = key
        while cur is not None and cur not in seen:
            seen.add(cur)
            wit = self._effects.get(cur, {}).get(effect)
            if wit is None:
                break
            out.append((cur, wit))
            cur = wit.callee
        return out

    def render_chain(self, key: FuncKey, effect: str) -> str:
        """'f -> g -> h: x.cpu() at path.py:42' for messages."""
        chain = self.witness_chain(key, effect)
        if not chain:
            return ""
        names = " -> ".join(k[1] for k, _ in chain)
        owner, sink = chain[-1]
        return (f"{names}: {sink.detail or effect} at "
                f"{owner[0]}:{sink.line}")


# ---------------------------------------------------------------------------
# Build: sources (+ optional cache) -> ProgramIR
# ---------------------------------------------------------------------------


def build_program_ir(sources: Dict[str, SourceFile],
                     cache: Optional[IRCache] = None) -> ProgramIR:
    """ProgramIR over the loaded tree. With a cache, per-file
    extraction is skipped for content-hash hits; linking and the
    effect fixpoint always run fresh (cross-file, cheap)."""
    cache = cache or IRCache(None)
    modules: List[ModuleIR] = []
    for src in sources.values():
        path = src.path.replace("\\", "/")
        ir = cache.load(path, src.content_hash())
        if ir is None:
            ir = extract_module_ir(src)
            cache.store(ir)
        modules.append(ir)
    return ProgramIR(modules)
