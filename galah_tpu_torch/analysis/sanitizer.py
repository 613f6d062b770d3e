"""GalahSan: runtime concurrency sanitizer for the port's threaded
modules. The port's copy of ``galah_tpu/analysis/sanitizer.py``.

The GL8xx auditors (``analysis/concurrency_check.py``) check lock
discipline *lexically*: GUARDED_BY and LOCK_ORDER annotations are
validated against the source text, so an annotation that drifts from
runtime behavior passes silently. GalahSan closes that gap by
instrumenting the declared locks themselves and validating the
contracts under the real workload:

  * every declared lock (module globals and per-instance ``Cls._lock``
    attributes) is wrapped in a :class:`SanLock` proxy that records the
    observed acquisition graph per thread: which lock was held when
    which other lock was taken, with the first call site;
  * undeclared module-level locks in the same modules are wrapped too,
    so a nested acquisition involving a lock the annotations never
    mention is caught ("undeclared acquisition");
  * GUARDED_BY-annotated attributes get mutation checks: container
    values (dict/list/set) are replaced with instrumented subclasses
    and attribute REbinding goes through a ``__setattr__`` shim on the
    annotated classes, so a mutation without the declared lock held is
    a race finding unless the object is still single-owner.

At report time the observed graph is diffed against the declared order:

  * ``undeclared_edge``: a nested acquisition of two *declared* locks
    whose pair appears in no LOCK_ORDER (error);
  * ``inversion``: the observed edge contradicts a declared pair, the
    canonical deadlock precursor (error);
  * ``undeclared_acquisition``: a nested acquisition involving a lock
    absent from every annotation (error);
  * ``race``: a guarded mutation without its lock (error);
  * ``unexercised``: a declared pair never observed under the
    workload (info: coverage, not a bug).

It instruments only ``galah_tpu_torch`` modules (``THREADED_MODULES``);
``galah_tpu``'s sanitizer is a separate instance over its own modules.
Enable with ``GALAH_SAN=1``: ``cli.main`` then arms the process-wide
:data:`GLOBAL` before it runs a subcommand, ``obs/report.assemble``
adds its summary as the run report's ``sanitizer`` section, and with
``GALAH_SAN_REPORT`` set the CLI also writes the full report (lock
graph and findings) there when the run ends.

Known limitations, by design (all covered lexically by GL8xx):
rebinding a module *global* from inside its own module bypasses module
``__setattr__`` (STORE_GLOBAL writes the dict directly), so scalar
latches are checked lexically only; mutations of *nested* containers
(a dict inside a guarded dict) and of container types other than
dict/list/set (a ``defaultdict``) are out of reach of the instrumented
containers; and a module-level guarded container that is re-*bound*
(rather than mutated) sheds its instrumentation until the next
install().
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import sys
import threading
import types
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_LOCK_TYPES = (type(threading.Lock()),)

#: Where the standalone report goes when GALAH_SAN_REPORT is unset.
DEFAULT_REPORT = "sanitizer_report.json"

#: Cap on per-lock thread-id sets and per-edge site lists.
_MAX_THREADS_TRACKED = 64

_THIS_FILE = os.path.abspath(__file__)


def _caller_site() -> str:
    """file:line of the nearest frame outside the sanitizer itself."""
    try:
        f = sys._getframe(1)
    except ValueError:  # pragma: no cover - no frames
        return "?"
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.abspath(fn) != _THIS_FILE:
            try:
                rel = os.path.relpath(fn)
            except ValueError:  # pragma: no cover - windows drives
                rel = fn
            if not rel.startswith(".."):
                fn = rel.replace(os.sep, "/")
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "?"  # pragma: no cover - sanitizer-internal call


class SanLock:
    """Proxy around a ``threading.Lock`` that reports to a Sanitizer.

    Supports the context-manager protocol plus acquire/release/locked,
    which covers every lock idiom in the repo (GL8xx bans the rest).
    """

    __slots__ = ("_inner", "name", "declared", "_san", "_threads",
                 "acquisitions")

    def __init__(self, inner, name: str, san: "Sanitizer",
                 declared: bool) -> None:
        self._inner = inner
        self.name = name
        self.declared = declared
        self._san = san
        self._threads: set = set()
        self.acquisitions = 0

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        self._san._note_attempt(self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._san._held().append(self)
        return got

    def release(self) -> None:
        held = self._san._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<SanLock {self.name} declared={self.declared}>"


class _GuardMeta:
    """How one guarded container resolves its lock and owner."""

    __slots__ = ("san", "target", "get_lock", "get_owner")

    def __init__(self, san: "Sanitizer", target: str,
                 get_lock: Callable[[], Optional[SanLock]],
                 get_owner: Callable[[], Optional[int]]) -> None:
        self.san = san
        self.target = target
        self.get_lock = get_lock
        self.get_owner = get_owner


def _mutator(name):
    def method(self, *a, **kw):
        m = self._san_meta
        if m is not None:
            m.san._check_guarded(m.target, m.get_lock(), m.get_owner(),
                                 how=name)
        return getattr(self._san_base, name)(self, *a, **kw)
    method.__name__ = name
    return method


def _instrumented(base, mutators):
    ns = {"_san_meta": None, "_san_base": base}
    ns.update({m: _mutator(m) for m in mutators})
    cls = type(f"San{base.__name__.capitalize()}", (base,), ns)
    return cls


SanDict = _instrumented(dict, (
    "__setitem__", "__delitem__", "clear", "pop", "popitem",
    "setdefault", "update"))
SanList = _instrumented(list, (
    "__setitem__", "__delitem__", "__iadd__", "__imul__", "append",
    "extend", "insert", "pop", "remove", "clear", "sort", "reverse"))
SanSet = _instrumented(set, (
    "add", "discard", "remove", "pop", "clear", "update",
    "difference_update", "intersection_update",
    "symmetric_difference_update", "__ior__", "__iand__", "__isub__",
    "__ixor__"))

_CONTAINER_MAP = {dict: SanDict, list: SanList, set: SanSet}


class _ClassMeta:
    """Instrumentation plan for one annotated class."""

    __slots__ = ("cls", "modpath", "lock_attrs", "guarded")

    def __init__(self, cls: type, modpath: str) -> None:
        self.cls = cls
        self.modpath = modpath
        #: lock-valued attrs to wrap at construction, attr -> canon name
        self.lock_attrs: Dict[str, str] = {}
        #: guarded attrs, attr -> (("attr", lock attr) |
        #: ("name", canonical lock name), canonical target)
        self.guarded: Dict[str, Tuple[Tuple[str, str], str]] = {}


class Sanitizer:
    """Observed-vs-declared lock-graph recorder. One per process
    (:data:`GLOBAL`); tests build isolated instances over synthetic
    modules via :meth:`install_module`."""

    def __init__(self) -> None:
        # Internal lock. Invariant: no user (San-wrapped) lock is ever
        # acquired while _lock is held, so instrumentation can never
        # add an edge — or a deadlock — to the graph it audits.
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.installed = False
        self.modules: List[str] = []
        #: canonical name -> first SanLock wrapped under that name
        self._lock_objs: Dict[str, SanLock] = {}
        #: id(inner) -> SanLock, so shared lock objects wrap once
        self._by_id: Dict[int, SanLock] = {}
        #: (held name, acquired name) -> {"count", "where"}
        self.edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        #: (outer name, inner name) -> declaring module path
        self.declared_pairs: Dict[Tuple[str, str], str] = {}
        self.declared_locks: set = set()
        self.races: List[Dict[str, Any]] = []
        self._race_keys: set = set()
        self._class_meta: Dict[type, _ClassMeta] = {}

    # -- thread-local held stack ------------------------------------

    def _held(self) -> List[SanLock]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    # -- recording ---------------------------------------------------

    def _note_attempt(self, lock: SanLock) -> None:
        held = self._held()
        tid = threading.get_ident()
        with self._lock:
            lock.acquisitions += 1
            if (tid not in lock._threads
                    and len(lock._threads) < _MAX_THREADS_TRACKED):
                lock._threads.add(tid)
            for h in held:
                if h is lock or h.name == lock.name:
                    continue
                key = (h.name, lock.name)
                edge = self.edges.get(key)
                if edge is None:
                    self.edges[key] = {"count": 1,
                                       "where": _caller_site()}
                else:
                    edge["count"] += 1

    def _check_guarded(self, target: str, lock: Optional[SanLock],
                       owner: Optional[int], how: str) -> None:
        if not isinstance(lock, SanLock):
            return  # lock not instrumented: can't judge, stay silent
        held = self._held()
        for h in held:
            if h is lock:
                return
        tid = threading.get_ident()
        if tid == owner:
            # single-owner phase: the constructing thread may mutate
            # freely until any OTHER thread has touched the lock
            with self._lock:
                foreign = any(t != owner for t in lock._threads)
            if not foreign:
                return
        where = _caller_site()
        key = (target, where, how)
        with self._lock:
            if key in self._race_keys:
                return
            self._race_keys.add(key)
            self.races.append({
                "target": target,
                "lock": lock.name,
                "thread": tid,
                "where": where,
                "how": how,
            })

    # -- wrapping ----------------------------------------------------

    def _wrap_lock(self, obj, name: str, declared: bool) -> SanLock:
        if isinstance(obj, SanLock):
            if declared and not obj.declared:
                obj.declared = True
                self.declared_locks.add(obj.name)
            return obj
        with self._lock:
            got = self._by_id.get(id(obj))
            if got is not None:
                if declared and not got.declared:
                    got.declared = True
                    self.declared_locks.add(got.name)
                return got
            lock = SanLock(obj, name, self, declared)
            self._by_id[id(obj)] = lock
            self._lock_objs.setdefault(name, lock)
            if declared:
                self.declared_locks.add(name)
            return lock

    def _wrap_container(self, val, meta: _GuardMeta):
        cls = _CONTAINER_MAP.get(type(val))
        if cls is None:
            return val
        wrapped = cls(val)
        wrapped._san_meta = meta
        return wrapped

    def _resolve_lockref(self, inst,
                         lockref: Tuple[str, str]) -> Optional[SanLock]:
        kind, key = lockref
        if kind == "attr":  # the instance's own lock attribute
            lock = inst.__dict__.get(key)
        else:  # canonical name of a module-global (possibly remote)
            lock = self._lock_objs.get(key)
        return lock if isinstance(lock, SanLock) else None

    def _prepare_instance(self, inst, meta: _ClassMeta) -> None:
        for attr, canon in meta.lock_attrs.items():
            cur = inst.__dict__.get(attr)
            if cur is not None:
                object.__setattr__(
                    inst, attr, self._wrap_lock(cur, canon,
                                                declared=True))
        object.__setattr__(inst, "_san_owner", threading.get_ident())
        for attr, (lockref, target) in meta.guarded.items():
            val = inst.__dict__.get(attr)
            if type(val) in _CONTAINER_MAP:
                gmeta = _GuardMeta(
                    self, target,
                    lambda i=inst, r=lockref:
                        self._resolve_lockref(i, r),
                    lambda i=inst: i.__dict__.get("_san_owner"))
                object.__setattr__(
                    inst, attr, self._wrap_container(val, gmeta))
        object.__setattr__(inst, "_san_ctor", False)

    def _patch_class(self, cls: type, modpath: str) -> _ClassMeta:
        meta = self._class_meta.get(cls)
        if meta is not None:
            return meta
        meta = _ClassMeta(cls, modpath)
        self._class_meta[cls] = meta
        san = self
        orig_init = cls.__init__
        orig_setattr = cls.__setattr__

        def san_init(inst, *a, **kw):
            object.__setattr__(inst, "_san_ctor", True)
            try:
                orig_init(inst, *a, **kw)
            finally:
                san._prepare_instance(inst, meta)

        def san_setattr(inst, name, value):
            info = meta.guarded.get(name)
            if info is not None:
                d = inst.__dict__
                if name in d and not d.get("_san_ctor", True):
                    lockref, target = info
                    san._check_guarded(
                        target,
                        san._resolve_lockref(inst, lockref),
                        d.get("_san_owner"),
                        how=f"{name} rebind")
            orig_setattr(inst, name, value)

        san_init.__name__ = "__init__"
        san_init.__qualname__ = f"{cls.__qualname__}.__init__"
        san_init.__wrapped__ = orig_init
        cls.__init__ = san_init
        cls.__setattr__ = san_setattr
        return meta

    # -- installation ------------------------------------------------

    @staticmethod
    def _canon(decl: str, modpath: str) -> str:
        return decl if ":" in decl else f"{modpath}:{decl}"

    @staticmethod
    def _lockref(lockdecl: str, modpath: str) -> Tuple[str, str]:
        """("attr", attrname) for an instance lock, else
        ("name", canonical) for a module-global (possibly
        cross-module "path.py:NAME")."""
        if ":" in lockdecl:
            return ("name", lockdecl)
        if "." in lockdecl:
            return ("attr", lockdecl.split(".", 1)[1])
        return ("name", f"{modpath}:{lockdecl}")

    def install_module(self, mod: types.ModuleType,
                       modpath: Optional[str] = None) -> None:
        """Instrument one module's declared locks and guarded state.

        ``mod`` may be a real galah_tpu_torch module or a synthetic
        ``types.ModuleType`` built by a test reproducer.
        """
        if modpath is None:
            modpath = (getattr(mod, "__name__", "mod")
                       .replace(".", "/") + ".py")
        gb: Dict[str, str] = dict(getattr(mod, "GUARDED_BY", None)
                                  or {})
        lo: List[str] = list(getattr(mod, "LOCK_ORDER", None) or [])
        decls = set(gb.values()) | set(lo)

        # Declared order: every (earlier, later) pair, like the lexical
        # checker's _declared_order.
        for i in range(len(lo)):
            for j in range(i + 1, len(lo)):
                pair = (self._canon(lo[i], modpath),
                        self._canon(lo[j], modpath))
                self.declared_pairs.setdefault(pair, modpath)

        # Classes named by any "Cls.attr" declaration.
        for decl in sorted(decls | set(gb)):
            if ":" in decl or "." not in decl:
                continue
            clsname, attr = decl.split(".", 1)
            cls = getattr(mod, clsname, None)
            if not isinstance(cls, type):
                continue
            meta = self._patch_class(cls, modpath)
            if decl in decls:  # it's a lock attribute
                meta.lock_attrs[attr] = self._canon(decl, modpath)
        for target, lockdecl in gb.items():
            if ":" in target or "." not in target:
                continue
            clsname, attr = target.split(".", 1)
            cls = getattr(mod, clsname, None)
            if not isinstance(cls, type):
                continue
            meta = self._patch_class(cls, modpath)
            meta.guarded[attr] = (self._lockref(lockdecl, modpath),
                                  self._canon(target, modpath))

        # Module-global locks: declared ones by name, then any other
        # module-level Lock (undeclared — visible to edge detection).
        for decl in sorted(decls):
            if ":" in decl or "." in decl:
                continue
            obj = getattr(mod, decl, None)
            if isinstance(obj, _LOCK_TYPES):
                setattr(mod, decl,
                        self._wrap_lock(obj, self._canon(decl, modpath),
                                        declared=True))
        for name, obj in sorted(vars(mod).items()):
            if isinstance(obj, _LOCK_TYPES):
                setattr(mod, name,
                        self._wrap_lock(obj, self._canon(name, modpath),
                                        declared=False))

        # Module-global guarded containers.
        owner_tid = threading.get_ident()
        for target, lockdecl in gb.items():
            if ":" in target or "." in target:
                continue
            val = getattr(mod, target, None)
            lockref = self._lockref(lockdecl, modpath)
            if lockref[0] != "name":
                continue
            gmeta = _GuardMeta(
                self, self._canon(target, modpath),
                lambda n=lockref[1]: self._lock_objs.get(n),
                lambda t=owner_tid: t)
            wrapped = self._wrap_container(val, gmeta)
            if wrapped is not val:
                setattr(mod, target, wrapped)

        # Pre-existing instances of the patched classes: module globals,
        # plus one container level down (profile._REGISTRY list,
        # metrics.GLOBAL._metrics dict).
        patched = tuple(self._class_meta)
        if patched:
            for inst in self._iter_instances(mod, patched):
                if "_san_ctor" not in inst.__dict__:
                    meta = self._class_meta.get(type(inst))
                    if meta is not None:
                        self._prepare_instance(inst, meta)

        self.modules.append(modpath)

    @staticmethod
    def _iter_instances(mod: types.ModuleType, patched: tuple):
        def scan(val, depth: int):
            if isinstance(val, patched):
                yield val
                val = getattr(val, "__dict__", None)
                if not isinstance(val, dict):
                    return
            if depth <= 0:
                return
            if isinstance(val, dict):
                items: Sequence = list(val.values())
            elif isinstance(val, (list, tuple)):
                items = list(val)
            else:
                return
            for item in items:
                yield from scan(item, depth - 1)

        for val in list(vars(mod).values()):
            yield from scan(val, 2)

    def install(self,
                modules: Optional[Sequence[str]] = None) -> None:
        """Instrument the port's THREADED_MODULES (idempotent)."""
        if self.installed:
            return
        if modules is None:
            from galah_tpu_torch.analysis.concurrency_check import \
                THREADED_MODULES
            modules = THREADED_MODULES
        for modpath in modules:
            modname = modpath[:-3].replace("/", ".")
            self.install_module(importlib.import_module(modname),
                                modpath)
        self.installed = True

    # -- reporting ---------------------------------------------------

    def findings(self) -> List[Dict[str, Any]]:
        """Diff observed graph vs declarations. Race findings included."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            edges = {k: dict(v) for k, v in self.edges.items()}
            races = [dict(r) for r in self.races]
        exercised = set()
        for (a, b), edge in sorted(edges.items()):
            locks = [a, b]
            if (a, b) in self.declared_pairs:
                exercised.add((a, b))
                continue
            a_decl = a in self.declared_locks
            b_decl = b in self.declared_locks
            if a_decl and b_decl:
                kind = ("inversion" if (b, a) in self.declared_pairs
                        else "undeclared_edge")
                detail = (f"acquired {b} while holding {a}, but "
                          f"LOCK_ORDER declares {b} before {a}"
                          if kind == "inversion" else
                          f"acquired {b} while holding {a}; no "
                          f"LOCK_ORDER declares this pair")
            else:
                kind = "undeclared_acquisition"
                undecl = [n for n, d in ((a, a_decl), (b, b_decl))
                          if not d]
                detail = (f"nested acquisition {a} -> {b} involves "
                          f"lock(s) absent from every annotation: "
                          + ", ".join(undecl))
            out.append({"kind": kind, "severity": "error",
                        "locks": locks, "count": edge["count"],
                        "where": edge["where"], "detail": detail})
        for race in races:
            out.append({
                "kind": "race", "severity": "error",
                "locks": [race["lock"]], "where": race["where"],
                "detail": (f"{race['target']} mutated "
                           f"({race['how']}) without holding "
                           f"{race['lock']} (thread "
                           f"{race['thread']})")})
        for (a, b), modpath in sorted(self.declared_pairs.items()):
            if (a, b) not in exercised:
                out.append({
                    "kind": "unexercised", "severity": "info",
                    "locks": [a, b], "where": modpath,
                    "detail": (f"declared order {a} -> {b} never "
                               f"exercised under this workload")})
        return out

    def summary(self) -> Dict[str, Any]:
        """Small dict for run_report.json / terminal summaries."""
        findings = self.findings()
        counts: Dict[str, int] = {}
        for f in findings:
            counts[f["kind"]] = counts.get(f["kind"], 0) + 1
        with self._lock:
            acquisitions = sum(l.acquisitions
                               for l in self._lock_objs.values())
            n_locks = len(self._lock_objs)
        return {
            "enabled": True,
            "modules": len(self.modules),
            "locks": n_locks,
            "declared_locks": len(self.declared_locks),
            "acquisitions": acquisitions,
            "edges_observed": len(self.edges),
            "edges_declared": len(self.declared_pairs),
            "undeclared_acquisitions":
                counts.get("undeclared_acquisition", 0),
            "undeclared_edges": counts.get("undeclared_edge", 0),
            "inversions": counts.get("inversion", 0),
            "races": counts.get("race", 0),
            "unexercised": counts.get("unexercised", 0),
        }

    def errors(self) -> List[Dict[str, Any]]:
        """Only the error-severity findings (the must-be-zero set)."""
        return [f for f in self.findings()
                if f["severity"] == "error"]

    def report(self) -> Dict[str, Any]:
        with self._lock:
            locks = {
                name: {"declared": l.declared,
                       "acquisitions": l.acquisitions,
                       "threads": len(l._threads)}
                for name, l in sorted(self._lock_objs.items())}
            edges = [{"held": a, "acquired": b,
                      "count": e["count"], "where": e["where"]}
                     for (a, b), e in sorted(self.edges.items())]
        return {
            "version": 1,
            "summary": self.summary(),
            "modules": list(self.modules),
            "locks": locks,
            "edges": edges,
            "declared_order": [
                {"outer": a, "inner": b, "module": m}
                for (a, b), m in sorted(self.declared_pairs.items())],
            "findings": self.findings(),
        }

    def write_report(self, path: Optional[str] = None) -> str:
        path = path or os.environ.get("GALAH_SAN_REPORT",
                                      DEFAULT_REPORT)
        from galah_tpu_torch.io import atomic
        atomic.write_json(path, self.report(), indent=1,
                          site="io.atomic.write[sanitizer]")
        return path

    def reset_observations(self) -> None:
        """Drop observed edges/races (instrumentation stays armed)."""
        with self._lock:
            self.edges.clear()
            self.races.clear()
            self._race_keys.clear()
            for lock in self._lock_objs.values():
                lock.acquisitions = 0
                lock._threads.clear()


GLOBAL = Sanitizer()


def enabled() -> bool:
    """True when GALAH_SAN asks for the sanitizer (see config.FLAGS)."""
    return os.environ.get("GALAH_SAN", "") not in ("", "0")


def maybe_install() -> bool:
    """Install the process-wide sanitizer iff GALAH_SAN is set."""
    if not enabled():
        return False
    GLOBAL.install()
    return True


def write_report_if_asked() -> Optional[str]:
    """Write the GLOBAL report to ``GALAH_SAN_REPORT`` when it is set
    (the CLI calls this as a run armed by GALAH_SAN ends); returns the
    path, or None. A failed write only logs: the run's own outputs
    stand."""
    path = os.environ.get("GALAH_SAN_REPORT", "")
    if not path or not GLOBAL.installed:
        return None
    try:
        return GLOBAL.write_report(path)
    except OSError as e:
        logger.warning("sanitizer report %s not written: %s", path, e)
        return None


def summary_if_enabled() -> Optional[Dict[str, Any]]:
    """The GLOBAL summary when installed, else None (for obs.report)."""
    if not GLOBAL.installed:
        return None
    return GLOBAL.summary()


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m galah_tpu_torch.analysis.sanitizer``: install, import
    the threaded modules, exercise nothing, dump the (empty) report: a
    wiring smoke test; real coverage comes from CLI runs under
    GALAH_SAN=1."""
    GLOBAL.install()
    path = GLOBAL.write_report()
    print(json.dumps(GLOBAL.summary(), indent=1))
    print(f"wrote {path}")
    return 1 if GLOBAL.errors() else 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
