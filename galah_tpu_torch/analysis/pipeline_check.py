"""Pipeline discipline (GL10xx): keep the dataflow actually streaming.
The port's copy of ``galah_tpu/analysis/pipeline_check.py``, with
torch's host synchronizations beside JAX's.

The streamed passes (the sketch stream, the streamed finch pair pass,
the index insert's sketch stage) overlap host reads with device work
only while their stages stay streamed. These auditors flag the
antipatterns that reintroduce draining, plus the telemetry contract
that proves a pipeline is overlapped (``workload.pipeline_occupancy``,
``obs.metrics.PIPELINE_OCCUPANCY_GAUGE``).

Annotation: a pipeline module opts in with a module-level literal

    PIPELINE_STAGE = {
        "streaming": ["iter_path_sketches"],          # generator stages
        "occupancy_gauge": "workload.pipeline_occupancy",
        "device_round": ["_fold_body"],               # sync-free bodies
    }

``streaming`` names this module's generator stages (GL1002 scope);
``occupancy_gauge`` contracts the module to emit that gauge (GL1004);
``device_round`` names functions that must stay device-resident
(GL1006 scope): the slab fold's launch wrapper
(``ops/megakernel.run_launch``), as ``galah_tpu``'s megakernel bodies.
``PAGED_MODULES`` (GL1007) names the band walks over the paged sketch
store: ``ops/bucketing.py``, the finch backend and the index load.

Checks
  GL1001  full materialization of a streaming iterator:
          ``list(...)`` / ``sorted(...)`` / ``tuple(...)`` over a call
          to a streamed API (``iter_*`` / ``*_streamed`` /
          ``process_stream``) or a variable bound to one in the same
          function: the whole stream is buffered, so the stage drains
          before the next begins. Scope: pipeline modules
          (``galah_tpu_torch/`` minus ``timing.py``, ``obs/``,
          ``analysis/``).
  GL1002  host synchronization inside a declared streaming stage:
          ``block_until_ready`` / ``jax.device_get`` /
          ``torch.cuda.synchronize`` / ``device.synchronize`` / an
          Event's or Stream's ``.synchronize()`` in a function listed
          in ``PIPELINE_STAGE["streaming"]`` serializes device and
          host work the stage exists to overlap.
  GL1003  unbounded queue/pool construction in a threaded module
          (one declaring GUARDED_BY/LOCK_ORDER): ``queue.Queue()``
          without a positive ``maxsize``, ``ThreadPoolExecutor()``
          without ``max_workers``. An unbounded handoff hides a
          stalled consumer until memory runs out.
  GL1004  the module declares ``occupancy_gauge`` but never emits it:
          no call carries the declared gauge name (string literal, the
          ``PIPELINE_OCCUPANCY_GAUGE`` constant, or the
          ``obs.metrics.pipeline_occupancy()`` helper).
  GL1005  malformed ``PIPELINE_STAGE`` annotation: not a dict literal,
          unknown keys, a ``streaming`` / ``device_round`` entry that
          is not a function defined in the module, or a non-string
          gauge name.
  GL1006  host synchronization inside a declared device-round body:
          ``np.asarray`` / ``.item()`` / ``.tolist()`` / ``.cpu()`` /
          ``.numpy()`` / ``jax.device_get`` / ``block_until_ready`` in
          a function listed in ``PIPELINE_STAGE["device_round"]``: a
          host round-trip there splits the persistent round back into
          per-window launches. Convert at the wrapper boundary.
  GL1007  a paged band-walk function holds a gathered sketch
          submatrix across band boundaries: in a function registered
          in ``PAGED_MODULES``, a value produced by ``gather()`` /
          ``band_gather()`` inside the band loop is either appended
          to a collection or referenced after the loop ends, so its
          pages can never evict. (The lexical arm; ``galah_tpu``'s
          interprocedural arm runs over its IR, not ported.)

Suppression: the usual inline comment with a justification:

    pairs = list(iter_pairs(...))  # galah-lint: ignore[GL1001] tiny

Legitimate cases: materializing a bounded slice for a batch launch,
or a terminal collection the caller genuinely needs in memory.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from galah_tpu_torch.analysis.concurrency_check import harvest_literal
from galah_tpu_torch.analysis.core import (Finding, Severity, SourceFile,
                                           dotted_name)

#: Call names treated as streamed-API producers by GL1001.
STREAMING_SUFFIX = "_streamed"
STREAMING_PREFIX = "iter_"
STREAMING_NAMES = frozenset({"process_stream"})

#: The materializers GL1001 bans over a streamed producer.
MATERIALIZERS = frozenset({"list", "sorted", "tuple"})

#: Host-sync calls GL1002 bans inside declared streaming stages, by
#: their last name: JAX's, and torch's (``torch.cuda.synchronize``,
#: the port's ``device.synchronize``, ``Event``/``Stream``
#: ``.synchronize()``).
SYNC_CALLS = frozenset({"block_until_ready", "device_get",
                        "synchronize"})

#: Host-sync calls GL1006 bans inside declared device-round bodies.
#: ``asarray`` covers the np.asarray(device_array) idiom and ``item``
#: the scalar pull; ``tolist``, ``cpu`` and ``numpy`` are torch's
#: device-to-host copies.
DEVICE_ROUND_SYNC_CALLS = frozenset({
    "asarray", "item", "device_get", "block_until_ready", "tolist",
    "cpu", "numpy"})

#: The one registered occupancy gauge (obs/metrics.py re-exports it).
OCCUPANCY_GAUGE = "workload.pipeline_occupancy"

_ANNOTATION_KEYS = frozenset({"streaming", "occupancy_gauge",
                              "device_round"})

_EXEMPT_PREFIXES = ("galah_tpu_torch/obs/",
                    "galah_tpu_torch/analysis/")
_EXEMPT_FILES = ("galah_tpu_torch/timing.py",)

#: GL1007 scope: module -> the band-walk functions that consume the
#: paged sketch store (``io/pagestore.py``) and must release each
#: band's gathered submatrix before the next band pages in, as
#: ``galah_tpu``'s registry. A module joins when it grows a path that
#: drives ``gather()`` / ``band_gather()`` over a paged view.
PAGED_MODULES: Dict[str, List[str]] = {
    "galah_tpu_torch/ops/bucketing.py": ["bucketed_threshold_pairs"],
    "galah_tpu_torch/backends/minhash_backend.py": [
        "distances", "_bucketed_pairs", "_paged_sketch_rows"],
    "galah_tpu_torch/index/store.py": ["_load_generation"],
}

#: The calls whose results GL1007 tracks (``galah_tpu``'s names).
GATHER_NAMES = frozenset({"gather", "band_gather"})

#: Receiver methods that accumulate a gathered band in place.
RETAINER_METHODS = frozenset({"append", "add", "extend",
                              "appendleft", "setdefault"})


def in_scope(path: str) -> bool:
    """GL1001 scope: pipeline modules, same carve-out as GL7xx."""
    p = path.replace("\\", "/")
    if not p.startswith("galah_tpu_torch/"):
        return False
    return not p.startswith(_EXEMPT_PREFIXES) and p not in _EXEMPT_FILES


def _is_streaming_call(node: ast.AST) -> bool:
    """True when `node` is a call to a streamed-API producer."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func).rsplit(".", 1)[-1]
    return (name.startswith(STREAMING_PREFIX)
            or name.endswith(STREAMING_SUFFIX)
            or name in STREAMING_NAMES)


def _producer_name(node: ast.Call) -> str:
    return dotted_name(node.func).rsplit(".", 1)[-1]


def _check_materialization(src: SourceFile) -> List[Finding]:
    """GL1001 over one file: direct ``list(iter_*(...))`` plus the
    two-step ``s = iter_*(...); list(s)`` (name binding resolved over
    the whole file — good enough for a lint heuristic)."""
    out: List[Finding] = []
    # names bound to a streamed producer anywhere in the file
    bound: Dict[str, str] = {}
    for node in src.walk():
        if (isinstance(node, ast.Assign)
                and _is_streaming_call(node.value)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    bound[t.id] = _producer_name(node.value)
    for node in src.walk():
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in MATERIALIZERS
                and node.args):
            continue
        arg = node.args[0]
        producer: Optional[str] = None
        if _is_streaming_call(arg):
            producer = _producer_name(arg)
        elif isinstance(arg, ast.Name) and arg.id in bound:
            producer = bound[arg.id]
        if producer is not None:
            out.append(Finding(
                code="GL1001", severity=Severity.WARNING,
                path=src.path, line=node.lineno,
                message=(f"{node.func.id}() materializes the "
                         f"streamed iterator {producer}(): the stage "
                         "drains instead of overlapping; consume "
                         "incrementally or bound the buffer"),
                symbol=producer))
    return out


def _function_defs(tree: ast.Module) -> Dict[str, ast.AST]:
    defs: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    return defs


def _check_streaming_sync(src: SourceFile, streaming: List[str],
                          defs: Dict[str, ast.AST]) -> List[Finding]:
    """GL1002: host sync inside a declared streaming stage."""
    out: List[Finding] = []
    for name in streaming:
        fn = defs.get(name)
        if fn is None:
            continue  # GL1005 reports the dangling annotation
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            called = dotted_name(node.func).rsplit(".", 1)[-1]
            if called in SYNC_CALLS:
                out.append(Finding(
                    code="GL1002", severity=Severity.WARNING,
                    path=src.path, line=node.lineno,
                    message=(f"{called}() inside streaming stage "
                             f"{name}(): a host sync serializes the "
                             "device/host overlap the stage is "
                             "declared to provide"),
                    symbol=name))
    return out


def _check_device_round_sync(src: SourceFile, device_round: List[str],
                             defs: Dict[str, ast.AST]) -> List[Finding]:
    """GL1006: host sync inside a declared device-round body."""
    out: List[Finding] = []
    for name in device_round:
        fn = defs.get(name)
        if fn is None:
            continue  # GL1005 reports the dangling annotation
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            called = dotted_name(node.func).rsplit(".", 1)[-1]
            if called in DEVICE_ROUND_SYNC_CALLS:
                out.append(Finding(
                    code="GL1006", severity=Severity.WARNING,
                    path=src.path, line=node.lineno,
                    message=(f"{called}() inside device-round body "
                             f"{name}(): a host round-trip here splits "
                             "the persistent round program back into "
                             "per-window dispatches; convert at the "
                             "wrapper boundary instead"),
                    symbol=name))
    return out


def _check_paged_retention(src: SourceFile) -> List[Finding]:
    """GL1007 (lexical arm) over one registered module: gathered band
    submatrices accumulated inside, or referenced after, a band loop
    in a ``PAGED_MODULES`` band-walk function."""
    names = PAGED_MODULES.get(src.path.replace("\\", "/"))
    if not names:
        return []
    defs = _function_defs(src.tree)
    hits: Dict[tuple, Finding] = {}
    for fname in names:
        fn = defs.get(fname)
        if fn is None:
            continue
        for loop in [n for n in ast.walk(fn)
                     if isinstance(n, (ast.For, ast.While))]:
            # names bound to a gather inside this loop
            bound: Dict[str, int] = {}
            for n in ast.walk(loop):
                if (isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Call)
                        and dotted_name(n.value.func).rsplit(".", 1)[-1]
                        in GATHER_NAMES):
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            bound[t.id] = n.lineno
            # arm 1: the gathered band lands in an accumulator that
            # outlives the iteration
            for n in ast.walk(loop):
                if not (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr in RETAINER_METHODS
                        and n.args):
                    continue
                for a in n.args:
                    kept: Optional[str] = None
                    if (isinstance(a, ast.Call)
                            and dotted_name(a.func).rsplit(".", 1)[-1]
                            in GATHER_NAMES):
                        kept = dotted_name(a.func).rsplit(".", 1)[-1]
                    elif isinstance(a, ast.Name) and a.id in bound:
                        kept = a.id
                    if kept is None:
                        continue
                    hits[(n.lineno, kept)] = Finding(
                        code="GL1007", severity=Severity.WARNING,
                        path=src.path, line=n.lineno,
                        message=(f".{n.func.attr}() accumulates the "
                                 f"gathered band submatrix {kept} "
                                 f"inside {fname}()'s band loop: "
                                 "every band stays referenced, the "
                                 "backing pages can never evict and "
                                 "the paging schedule degrades to "
                                 "all-resident; reduce the band to "
                                 "its result before accumulating"),
                        symbol=fname)
            # arm 2: a gather-bound name survives past the loop
            end = getattr(loop, "end_lineno", loop.lineno)
            for n in ast.walk(fn):
                if (isinstance(n, ast.Name)
                        and isinstance(n.ctx, ast.Load)
                        and n.id in bound
                        and n.lineno > end):
                    hits[(n.lineno, n.id)] = Finding(
                        code="GL1007", severity=Severity.WARNING,
                        path=src.path, line=n.lineno,
                        message=(f"gathered band submatrix {n.id} is "
                                 f"referenced after {fname}()'s band "
                                 "loop ends: the reference pins its "
                                 "pages across band boundaries "
                                 "(docs/memory.md allows at most two "
                                 "resident bands); copy the needed "
                                 "rows out or re-gather inside the "
                                 "loop"),
                        symbol=fname)
    return [hits[k] for k in sorted(hits)]


def _is_threaded(src: SourceFile) -> bool:
    """GL1003 scope: the module declares concurrency annotations."""
    return (harvest_literal(src.tree, "GUARDED_BY") is not None
            or harvest_literal(src.tree, "LOCK_ORDER") is not None)


def _kw(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _check_unbounded(src: SourceFile) -> List[Finding]:
    """GL1003: queue/pool constructions without a depth bound."""
    out: List[Finding] = []
    for node in src.walk():
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func).rsplit(".", 1)[-1]
        if name in ("Queue", "LifoQueue", "PriorityQueue",
                    "SimpleQueue"):
            bound = node.args[0] if node.args else _kw(node, "maxsize")
            unbounded = (
                bound is None
                or (isinstance(bound, ast.Constant)
                    and isinstance(bound.value, int)
                    and bound.value <= 0)
                or name == "SimpleQueue")
            if unbounded:
                out.append(Finding(
                    code="GL1003", severity=Severity.WARNING,
                    path=src.path, line=node.lineno,
                    message=(f"{name}() without a positive maxsize "
                             "in a threaded module: an unbounded "
                             "handoff hides a stalled consumer until "
                             "memory runs out; bound the depth"),
                    symbol=name))
        elif name in ("ThreadPoolExecutor", "ProcessPoolExecutor"):
            if not node.args and _kw(node, "max_workers") is None:
                out.append(Finding(
                    code="GL1003", severity=Severity.WARNING,
                    path=src.path, line=node.lineno,
                    message=(f"{name}() without max_workers in a "
                             "threaded module: the pool size defaults "
                             "to the host's CPU count, unbounded by "
                             "the pipeline's declared depth"),
                    symbol=name))
    return out


def _gauge_emitted(src: SourceFile, gauge: str) -> bool:
    """Any call in the file carrying the gauge name — as a string
    literal, via the PIPELINE_OCCUPANCY_GAUGE constant, or through
    the ``obs.metrics.pipeline_occupancy()`` helper."""
    for node in src.walk():
        if not isinstance(node, ast.Call):
            continue
        if (gauge == OCCUPANCY_GAUGE
                and dotted_name(node.func).rsplit(".", 1)[-1]
                == "pipeline_occupancy"):
            return True
        for arg in list(node.args) + [kw.value
                                      for kw in node.keywords]:
            if (isinstance(arg, ast.Constant)
                    and arg.value == gauge):
                return True
            ref = dotted_name(arg)
            if (gauge == OCCUPANCY_GAUGE and ref.rsplit(".", 1)[-1]
                    == "PIPELINE_OCCUPANCY_GAUGE"):
                return True
    return False


def _annotation_line(src: SourceFile) -> int:
    for node in src.tree.body:
        targets: list = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "PIPELINE_STAGE":
                return node.lineno
    return 1


def check_pipeline_file(src: SourceFile) -> List[Finding]:
    """All GL10xx checks over one source file."""
    out: List[Finding] = []
    if in_scope(src.path):
        out.extend(_check_materialization(src))
    if _is_threaded(src):
        out.extend(_check_unbounded(src))
    out.extend(_check_paged_retention(src))

    stage = harvest_literal(src.tree, "PIPELINE_STAGE")
    has_decl = any(
        isinstance(t, ast.Name) and t.id == "PIPELINE_STAGE"
        for node in src.tree.body
        for t in (node.targets if isinstance(node, ast.Assign)
                  else [node.target]
                  if isinstance(node, ast.AnnAssign) else []))
    if not has_decl:
        return out
    line = _annotation_line(src)
    if not isinstance(stage, dict):
        out.append(Finding(
            code="GL1005", severity=Severity.WARNING, path=src.path,
            line=line,
            message="PIPELINE_STAGE must be a machine-readable dict "
                    "literal (module docstring has the shape)",
            symbol="PIPELINE_STAGE"))
        return out

    defs = _function_defs(src.tree)
    unknown = sorted(set(stage) - _ANNOTATION_KEYS)
    if unknown:
        out.append(Finding(
            code="GL1005", severity=Severity.WARNING, path=src.path,
            line=line,
            message=("unknown PIPELINE_STAGE key(s): "
                     + ", ".join(unknown)
                     + f" (known: {', '.join(sorted(_ANNOTATION_KEYS))})"),
            symbol="PIPELINE_STAGE"))

    streaming = stage.get("streaming", [])
    if (not isinstance(streaming, list)
            or not all(isinstance(s, str) for s in streaming)):
        out.append(Finding(
            code="GL1005", severity=Severity.WARNING, path=src.path,
            line=line,
            message="PIPELINE_STAGE['streaming'] must be a list of "
                    "function names",
            symbol="PIPELINE_STAGE"))
        streaming = []
    for name in streaming:
        if name not in defs:
            out.append(Finding(
                code="GL1005", severity=Severity.WARNING,
                path=src.path, line=line,
                message=(f"PIPELINE_STAGE['streaming'] names "
                         f"{name}(), which is not defined in this "
                         "module"),
                symbol=name))
    out.extend(_check_streaming_sync(src, streaming, defs))

    device_round = stage.get("device_round", [])
    if (not isinstance(device_round, list)
            or not all(isinstance(s, str) for s in device_round)):
        out.append(Finding(
            code="GL1005", severity=Severity.WARNING, path=src.path,
            line=line,
            message="PIPELINE_STAGE['device_round'] must be a list of "
                    "function names",
            symbol="PIPELINE_STAGE"))
        device_round = []
    for name in device_round:
        if name not in defs:
            out.append(Finding(
                code="GL1005", severity=Severity.WARNING,
                path=src.path, line=line,
                message=(f"PIPELINE_STAGE['device_round'] names "
                         f"{name}(), which is not defined in this "
                         "module"),
                symbol=name))
    out.extend(_check_device_round_sync(src, device_round, defs))

    gauge = stage.get("occupancy_gauge")
    if gauge is not None:
        if not isinstance(gauge, str):
            out.append(Finding(
                code="GL1005", severity=Severity.WARNING,
                path=src.path, line=line,
                message="PIPELINE_STAGE['occupancy_gauge'] must be a "
                        "gauge name string",
                symbol="PIPELINE_STAGE"))
        elif not _gauge_emitted(src, gauge):
            out.append(Finding(
                code="GL1004", severity=Severity.WARNING,
                path=src.path, line=line,
                message=(f"module is contracted to feed the "
                         f"{gauge!r} gauge but never emits it; "
                         "emit it (obs.metrics."
                         "PIPELINE_OCCUPANCY_GAUGE) or drop the "
                         "contract"),
                symbol=gauge))
    return out
