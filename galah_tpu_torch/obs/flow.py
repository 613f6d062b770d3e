"""Flow-level pipeline observability: who waited on whom, and why. The
port's copy of ``galah_tpu/obs/flow.py``.

A **flow id** marks each pipeline item (a genome batch, a sketch row
block, an edge stripe); each stage records its **service** time and its
**blocked** time with a reason (upstream-empty, downstream-full,
device-dispatch, host, lock) into bounded per-stage histograms, and
each hand-off is a Chrome-trace ``s``/``t``/``f`` flow arrow through
``obs/trace.emit_flow``. The port's producers: ``io/prefetch``
(a genome batch leaves ``ingest``; the read threads adopt the flow
context of the thread that submitted them), ``ops/sketch_stream`` (the
``sketch`` stage's waits on the reads, its service, a row block handed
on), ``ops/pairwise.threshold_pairs_streamed`` (the ``pairs`` stage:
its wait on the sketch stream, a ``device-dispatch`` bracket around each
``tile_stats`` stripe launch and its download, an edge stripe out) and
``index/incremental`` (the insert's wait on the sketch stream).
``galah_tpu``'s fragment and greedy producers live in its overlapped
engine, which the port does not have.

On top of the recorded graph, :func:`critical_path` decomposes the
end-to-end wall into per-stage **blame shares that sum to the wall**:
a stage's upstream-empty wait is blamed on its dominant producer
(recursively), everything else on the stage itself. That is the answer
behind ``flow analyze`` and the run report's ``flow`` section; the
per-stage ``flow.<stage>.blame_s`` scalars feed the perf ledger
(``obs/ledger.py``). ``critical_path`` and ``render_critical_path`` are
``galah_tpu``'s, line for line: either package analyzes the other's
reports.

  * **Bounded memory.** No per-item log: durations land in fixed
    log2-bucket histograms; boundary queues are capped deques
    (:data:`BOUNDARY_CAP`) whose evictions are counted, never grown.
  * **Cheap when off.** ``GALAH_OBS_FLOW=0`` turns every record call
    into a no-op; :func:`blocked` still measures (its ``.seconds`` is
    the caller's). No flow call touches the device.
  * **One lock.** All mutable state is guarded by the recorder's lock;
    trace and metrics, which take their own, are called outside it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import (Deque, Dict, Iterable, Iterator, List, Optional, Tuple,
                    TypeVar)

T = TypeVar("T")

#: Flow-item kinds, one per pipeline boundary object.
FLOW_KINDS = ("genome_batch", "sketch_block", "edge_stripe",
              "fragment_batch", "greedy_round")

#: The blocked-on attribution vocabulary. `upstream-empty` is the only
#: reason that propagates blame to the producer in critical_path();
#: everything else is the stage's own problem.
BLOCKED_REASONS = ("upstream-empty", "downstream-full",
                   "device-dispatch", "host", "lock")

#: Per-boundary in-flight cap: beyond this the oldest pending flow id
#: is evicted (and counted as dropped) rather than growing the deque —
#: the bounded-memory gate for 1M-genome streams.
BOUNDARY_CAP = 4096

# Histogram buckets: log2 edges from 1 µs to ~1000 s. Fixed size, so
# a 10k-item stream and a 1M-item stream cost the same memory.
_BUCKET_EDGES = tuple(2.0 ** e for e in range(-20, 11))

# Concurrency contract (GL8xx lint and the GALAH_SAN sanitizer): every
# FlowRecorder field is touched only under its _lock (the _Hist and
# _StageAgg values inside them too). The module global GLOBAL is not
# guarded: reset() runs in the single-threaded run lifecycle and every
# helper takes a local snapshot (`rec = GLOBAL`), the same idiom as
# trace.RECORDER.
GUARDED_BY = {
    "FlowRecorder._next_id": "FlowRecorder._lock",
    "FlowRecorder._kinds": "FlowRecorder._lock",
    "FlowRecorder._created": "FlowRecorder._lock",
    "FlowRecorder._completed": "FlowRecorder._lock",
    "FlowRecorder._dropped": "FlowRecorder._lock",
    "FlowRecorder._stages": "FlowRecorder._lock",
    "FlowRecorder._edges": "FlowRecorder._lock",
    "FlowRecorder._boundaries": "FlowRecorder._lock",
}
LOCK_ORDER = ["FlowRecorder._lock"]


class _Hist:
    """Fixed-bucket log2 duration histogram (seconds). Not
    thread-safe on its own: every instance lives inside a
    FlowRecorder and is only touched under its lock."""

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.buckets = [0] * (len(_BUCKET_EDGES) + 1)

    def observe(self, seconds: float) -> None:
        s = max(0.0, float(seconds))
        self.count += 1
        self.sum += s
        self.min = min(self.min, s)
        self.max = max(self.max, s)
        lo, hi = 0, len(_BUCKET_EDGES)
        while lo < hi:  # first edge >= s (bisect; no imports needed)
            mid = (lo + hi) // 2
            if _BUCKET_EDGES[mid] < s:
                lo = mid + 1
            else:
                hi = mid
        self.buckets[lo] += 1

    def snapshot(self) -> dict:
        out = {"count": self.count, "sum_s": round(self.sum, 6)}
        if self.count:
            out["min_s"] = round(self.min, 6)
            out["max_s"] = round(self.max, 6)
            out["mean_s"] = round(self.sum / self.count, 6)
            # sparse: only non-empty buckets, keyed by upper edge
            nz = {}
            for i, n in enumerate(self.buckets):
                if n:
                    le = (_BUCKET_EDGES[i] if i < len(_BUCKET_EDGES)
                          else float("inf"))
                    nz[f"{le:.6g}"] = n
            out["le_s"] = nz
        return out


class _StageAgg:
    """Per-stage aggregates: item count, service histogram, one wait
    histogram per blocked reason. Lock discipline as _Hist."""

    __slots__ = ("items", "service", "waits")

    def __init__(self) -> None:
        self.items = 0
        self.service = _Hist()
        self.waits: Dict[str, _Hist] = {}

    def wait_hist(self, reason: str) -> _Hist:
        h = self.waits.get(reason)
        if h is None:
            h = self.waits[reason] = _Hist()
        return h


class _FlowContext(threading.local):
    """Thread-local (stage, flow_id) context stack, adoptable across
    pool workers like timing.StageTimer's stage tokens."""

    def __init__(self) -> None:
        self.stack: List[Tuple[Optional[str], Optional[int]]] = []


class _Blocked:
    """Result object of :func:`blocked`: carries the measured wall so
    call sites can keep their occupancy accounting (`wait_s +=
    b.seconds`) without a raw clock pair of their own."""

    __slots__ = ("seconds",)

    def __init__(self) -> None:
        self.seconds = 0.0


class FlowRecorder:
    """Process-wide flow graph accumulator (one per run; see reset())."""

    def __init__(self, enabled: Optional[bool] = None) -> None:
        if enabled is None:
            enabled = _env_enabled()
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._tls = _FlowContext()
        self._next_id = 0
        self._kinds: Dict[str, int] = {}
        self._created = 0
        self._completed = 0
        self._dropped = 0
        self._stages: Dict[str, _StageAgg] = {}
        # (from_stage, to_stage) -> handoff count + queue-latency hist
        self._edges: Dict[Tuple[str, str], List] = {}
        # producing stage -> FIFO of (flow_id, enqueue_perf_t)
        self._boundaries: Dict[str, Deque[Tuple[int, float]]] = {}

    # -- flow ids ----------------------------------------------------

    def begin(self, kind: str) -> int:
        """Mint a flow id for a new pipeline item."""
        if not self.enabled:
            return 0
        with self._lock:
            self._next_id += 1
            fid = self._next_id
            self._created += 1
            self._kinds[kind] = self._kinds.get(kind, 0) + 1
        return fid

    def emit(self, stage: str, fid: int) -> None:
        """Producer side of a boundary: `stage` enqueues item `fid`
        for whatever consumes it next."""
        if not self.enabled or not fid:
            return
        now = time.perf_counter()
        dropped = False
        with self._lock:
            q = self._boundaries.get(stage)
            if q is None:
                q = self._boundaries[stage] = deque()
            if len(q) >= BOUNDARY_CAP:
                q.popleft()
                self._dropped += 1
                dropped = True
            q.append((fid, now))
        if not dropped:
            from galah_tpu_torch.obs import trace
            trace.emit_flow("s", "flow", fid)

    def absorb(self, from_stage: str, to_stage: str) -> Optional[int]:
        """Consumer side: `to_stage` dequeues the oldest item
        `from_stage` emitted. Records the producer→consumer edge and
        the item's boundary-queue latency; returns the flow id (None
        when the boundary is empty, e.g. flow was disabled upstream)."""
        if not self.enabled:
            return None
        now = time.perf_counter()
        with self._lock:
            q = self._boundaries.get(from_stage)
            if not q:
                return None
            fid, t_enq = q.popleft()
            self._completed += 1
            key = (from_stage, to_stage)
            e = self._edges.get(key)
            if e is None:
                e = self._edges[key] = [0, _Hist()]
            e[0] += 1
            e[1].observe(now - t_enq)
            agg = self._stages.get(to_stage)
            if agg is None:
                agg = self._stages[to_stage] = _StageAgg()
            agg.items += 1
        from galah_tpu_torch.obs import trace
        trace.emit_flow("f", "flow", fid)
        return fid

    def complete(self, fid: int) -> None:
        """Terminal flows (greedy rounds, fragment batches) that no
        downstream stage absorbs."""
        if not self.enabled or not fid:
            return
        with self._lock:
            self._completed += 1

    # -- spans -------------------------------------------------------

    def record_service(self, stage: Optional[str], seconds: float,
                       items: int = 0) -> None:
        """Add a service-time observation. ``items`` credits processed
        items for stages with no upstream boundary (ingest, sketch);
        stages that absorb() are item-counted there and pass 0."""
        if not self.enabled:
            return
        if stage is None:
            stage = self.current()[0]
            if stage is None:
                return
        with self._lock:
            agg = self._stages.get(stage)
            if agg is None:
                agg = self._stages[stage] = _StageAgg()
            agg.service.observe(seconds)
            agg.items += max(0, int(items))

    def record_wait(self, stage: Optional[str], reason: str,
                    seconds: float) -> None:
        if not self.enabled:
            return
        if stage is None:
            stage = self.current()[0]
            if stage is None:
                return
        if reason not in BLOCKED_REASONS:
            reason = "host"
        with self._lock:
            agg = self._stages.get(stage)
            if agg is None:
                agg = self._stages[stage] = _StageAgg()
            agg.wait_hist(reason).observe(seconds)

    @contextmanager
    def blocked(self, stage: str,
                reason: str) -> Iterator[_Blocked]:
        """Measure a blocked region. ALWAYS measures (the returned
        object's ``.seconds`` feeds occupancy math even with flow
        disabled); records + traces only when enabled."""
        b = _Blocked()
        t0 = time.perf_counter()
        try:
            yield b
        finally:
            b.seconds = time.perf_counter() - t0
            if self.enabled:
                self.record_wait(stage, reason, b.seconds)
                from galah_tpu_torch.obs import trace
                trace.emit_complete(f"{stage}:blocked[{reason}]", t0,
                                    b.seconds, cat="flow")

    @contextmanager
    def span(self, stage: Optional[str] = None,
             fid: Optional[int] = None) -> Iterator[None]:
        """A service span, bound into the thread-local flow context so
        nested record_* calls (and adopted workers) attribute here."""
        t0 = time.perf_counter()
        self._tls.stack.append((stage, fid))
        try:
            yield
        finally:
            self._tls.stack.pop()
            dt = time.perf_counter() - t0
            if self.enabled and stage is not None:
                self.record_service(stage, dt)
                from galah_tpu_torch.obs import trace
                trace.emit_complete(f"{stage}:service", t0, dt,
                                    cat="flow")
                if fid:
                    trace.emit_flow("t", "flow", fid)

    # -- thread propagation (mirrors timing.stage_token/adopt) -------

    def token(self) -> Tuple[Optional[str], Optional[int]]:
        """The current (stage, flow_id) context, for handing to a
        worker thread at submit time."""
        return self.current()

    @contextmanager
    def adopt(self, token: Tuple[Optional[str], Optional[int]]
              ) -> Iterator[None]:
        self._tls.stack.append(tuple(token))
        try:
            yield
        finally:
            self._tls.stack.pop()

    def current(self) -> Tuple[Optional[str], Optional[int]]:
        stack = self._tls.stack
        return stack[-1] if stack else (None, None)

    # -- introspection -----------------------------------------------

    def queue_depths(self) -> Dict[str, int]:
        """Current boundary-queue depth per producing stage (the
        heartbeat's live backlog signal)."""
        with self._lock:
            return {s: len(q) for s, q in sorted(self._boundaries.items())
                    if q}

    def snapshot(self) -> dict:
        """JSON-ready flow graph for the run report (bounded size)."""
        with self._lock:
            stages = {}
            for name in sorted(self._stages):
                agg = self._stages[name]
                waits = {r: agg.waits[r].snapshot()
                         for r in sorted(agg.waits)}
                stages[name] = {
                    "items": agg.items,
                    "service": agg.service.snapshot(),
                    "service_s": round(agg.service.sum, 6),
                    "wait": waits,
                    "wait_s": {r: round(agg.waits[r].sum, 6)
                               for r in sorted(agg.waits)},
                }
            edges = [{"from": a, "to": b, "items": e[0],
                      "queue": e[1].snapshot()}
                     for (a, b), e in sorted(self._edges.items())]
            return {
                "enabled": self.enabled,
                "flows": {"created": self._created,
                          "completed": self._completed,
                          "dropped": self._dropped,
                          "kinds": dict(sorted(self._kinds.items()))},
                "stages": stages,
                "edges": edges,
            }


def _env_enabled() -> bool:
    """GALAH_OBS_FLOW gate (default on; '0'/'false' disables)."""
    try:
        from galah_tpu_torch.config import env_value
        raw = (env_value("GALAH_OBS_FLOW") or "1").strip().lower()
    except Exception:  # config unavailable mid-teardown: stay on
        return True
    return raw not in ("0", "false", "no", "off")


# Process-wide recorder backing the module-level helpers (same
# one-per-process idiom as metrics.GLOBAL / timing.GLOBAL).
GLOBAL = FlowRecorder()


def reset() -> None:
    """Fresh recorder (run start / tests); re-reads GALAH_OBS_FLOW."""
    global GLOBAL
    GLOBAL = FlowRecorder()


def enabled() -> bool:
    return GLOBAL.enabled


def begin(kind: str) -> int:
    return GLOBAL.begin(kind)


def emit(stage: str, fid: int) -> None:
    GLOBAL.emit(stage, fid)


def absorb(from_stage: str, to_stage: str) -> Optional[int]:
    return GLOBAL.absorb(from_stage, to_stage)


def complete(fid: int) -> None:
    GLOBAL.complete(fid)


def record_service(stage: Optional[str], seconds: float,
                   items: int = 0) -> None:
    GLOBAL.record_service(stage, seconds, items=items)


def record_wait(stage: Optional[str], reason: str,
                seconds: float) -> None:
    GLOBAL.record_wait(stage, reason, seconds)


def blocked(stage: str, reason: str):
    return GLOBAL.blocked(stage, reason)


class WaitTotal:
    """The seconds a :func:`waited` stream spent blocked, summed (a
    stage's starvation, which its occupancy gauge reads)."""

    __slots__ = ("seconds",)

    def __init__(self) -> None:
        self.seconds = 0.0


_END = object()


def waited(items: Iterable[T], stage: str,
           total: Optional[WaitTotal] = None) -> Iterator[T]:
    """`items`, each wait for the next one bracketed as `stage`'s
    upstream-empty wait (the port's streams pull their producers
    through it); `total`, when given, sums the waits' seconds."""
    it = iter(items)
    while True:
        with blocked(stage, "upstream-empty") as b:
            try:
                item = next(it)
            except StopIteration:
                item = _END
        if total is not None:
            total.seconds += b.seconds
        if item is _END:
            return
        yield item


def span(stage: Optional[str] = None, fid: Optional[int] = None):
    return GLOBAL.span(stage, fid)


def token() -> Tuple[Optional[str], Optional[int]]:
    return GLOBAL.token()


def adopt(tok: Tuple[Optional[str], Optional[int]]):
    return GLOBAL.adopt(tok)


def current() -> Tuple[Optional[str], Optional[int]]:
    return GLOBAL.current()


def queue_depths() -> Dict[str, int]:
    return GLOBAL.queue_depths()


def snapshot() -> dict:
    return GLOBAL.snapshot()


# -- critical path ---------------------------------------------------


def critical_path(snap: dict, e2e_wall_s: float) -> dict:
    """Decompose an e2e wall into per-stage blame shares (sum == wall).

    Pure function over a :func:`snapshot` (or a run report's ``flow``
    section). Walks backward from the terminal stage: each stage's
    observed wall splits into *self time* (service + downstream-full +
    device-dispatch + host + lock waits) blamed on the stage, and
    *upstream-empty* wait forwarded to its dominant producer (the
    incoming edge with the most handoffs), recursively. Conservation
    makes the shares sum to the full wall — the acceptance bar for
    ``flow analyze``.
    """
    wall = float(e2e_wall_s or 0.0)
    stages: Dict[str, dict] = dict(snap.get("stages") or {})
    out = {"e2e_wall_s": round(wall, 6), "bottleneck": None,
           "stages": {}}
    if not stages or wall <= 0:
        return out
    edges = list(snap.get("edges") or [])
    # dominant producer per consumer
    producer: Dict[str, Tuple[str, int]] = {}
    producing = set()
    for e in edges:
        a, b, n = e.get("from"), e.get("to"), int(e.get("items") or 0)
        if a is None or b is None:
            continue
        producing.add(a)
        if b not in producer or n > producer[b][1]:
            producer[b] = (a, n)
    # terminal stage: consumes but never produces; fall back to the
    # stage with the largest observed total when the graph is flat
    def total(s: str) -> float:
        st = stages.get(s) or {}
        return (float(st.get("service_s") or 0.0)
                + sum((st.get("wait_s") or {}).values()))
    terminals = [s for s in stages if s not in producing]
    terminal = (max(terminals, key=total) if terminals
                else max(stages, key=total))
    blame: Dict[str, float] = {s: 0.0 for s in stages}

    def attribute(stage: str, amount: float, visited: frozenset) -> None:
        if amount <= 0:
            return
        st = stages.get(stage)
        if st is None or stage in visited:
            blame[stage] = blame.get(stage, 0.0) + amount
            return
        waits = dict(st.get("wait_s") or {})
        up = float(waits.pop("upstream-empty", 0.0))
        self_time = float(st.get("service_s") or 0.0) + sum(waits.values())
        tot = self_time + up
        if tot <= 0:
            blame[stage] += amount
            return
        blame[stage] += amount * self_time / tot
        up_amount = amount * up / tot
        src = producer.get(stage, (None, 0))[0]
        if src is None or src == stage:
            blame[stage] += up_amount
        else:
            attribute(src, up_amount, visited | {stage})

    attribute(terminal, wall, frozenset())
    for s in sorted(blame):
        st = stages.get(s) or {}
        out["stages"][s] = {
            "blame_s": round(blame[s], 6),
            "share": round(blame[s] / wall, 6),
            "service_s": float(st.get("service_s") or 0.0),
            "wait_s": dict(st.get("wait_s") or {}),
        }
    out["bottleneck"] = max(blame, key=lambda s: blame[s])
    # host decomposition (the megakernel's headline gauge): each
    # stage's blame splits by its busy composition — the
    # device-dispatch wait bracket is device time, everything else
    # (service + host/lock waits) is host orchestration. flow.host.
    # share is the fraction of the e2e wall blamed on host work;
    # driving it down is what collapsing the per-round host
    # round-trips buys (ledger direction: lower-better).
    host_blame = 0.0
    for s, amount in blame.items():
        st = stages.get(s) or {}
        waits = dict(st.get("wait_s") or {})
        waits.pop("upstream-empty", None)
        dev = float(waits.get("device-dispatch", 0.0))
        busy = float(st.get("service_s") or 0.0) + sum(waits.values())
        host_frac = (busy - dev) / busy if busy > 0 else 1.0
        host_blame += amount * host_frac
    out["host"] = {"blame_s": round(host_blame, 6),
                   "share": round(host_blame / wall, 6)}
    return out


def render_critical_path(cp: dict, indent: str = "") -> List[str]:
    """Human lines for `flow analyze` and the report's render
    (``galah_tpu``'s text, so either package prints the same page)."""
    lines: List[str] = []
    st = cp.get("stages") or {}
    wall = cp.get("e2e_wall_s") or 0.0
    lines.append(f"{indent}flow critical path "
                 f"(e2e wall {wall:.2f}s):")
    if not st:
        lines.append(f"{indent}  (no flow data — run with "
                     "GALAH_OBS_FLOW=1)")
        return lines
    bn = cp.get("bottleneck")
    bn_share = (st.get(bn, {}).get("share") or 0.0) if bn else 0.0
    lines.append(f"{indent}  bottleneck: {bn} "
                 f"({100.0 * bn_share:.0f}% of wall)")
    host = cp.get("host") or {}
    if host:
        lines.append(
            f"{indent}  host blame: {host.get('blame_s') or 0.0:.2f}s "
            f"({100.0 * (host.get('share') or 0.0):.0f}% of wall; "
            "the rest sits in device-dispatch brackets)")
    lines.append(f"{indent}  {'stage':<10} {'blame':>8} {'share':>6} "
                 f"{'service':>8}  wait(top reason)")
    covered = 0.0
    for name in sorted(st, key=lambda s: -st[s].get("blame_s", 0.0)):
        ent = st[name]
        covered += ent.get("blame_s") or 0.0
        waits = ent.get("wait_s") or {}
        top = max(waits, key=lambda r: waits[r]) if waits else "-"
        wtxt = (f"{waits[top]:.2f}s {top}" if waits else "-")
        lines.append(
            f"{indent}  {name:<10} {ent.get('blame_s', 0.0):>7.2f}s "
            f"{100.0 * (ent.get('share') or 0.0):>5.0f}% "
            f"{ent.get('service_s', 0.0):>7.2f}s  {wtxt}")
    pct = 100.0 * covered / wall if wall else 0.0
    lines.append(f"{indent}  blame shares cover {pct:.0f}% of the "
                 "e2e wall")
    return lines
