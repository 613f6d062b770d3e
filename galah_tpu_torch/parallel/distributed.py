"""Multi-process runs over ``torch.distributed``: the port of
``galah_tpu/parallel/distributed.py``.

Every rank runs the same program on the same inputs:

* ``initialize()`` joins the process group from the variables that
  ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``); it is a no-op when ``WORLD_SIZE``
  is unset or 1. A rank on the card runs on ``cuda:LOCAL_RANK``;
* each rank reads and sketches only its strided shard of the genome
  list (``host_shard``), and the rows are exchanged into the full
  matrix on every rank (``allgather_host_rows``);
* the pair passes split their slots over the ranks
  (``parallel/mesh.py``: one slot a rank) and exchange the compacted
  candidates, so every rank ends with the same pairs, the same
  clusters, and only rank 0 writes outputs.

Every exchange carries host arrays (sketch and marker rows, statuses,
ANI floats, digests, candidate lists), as ``galah_tpu``'s
``process_allgather`` does, so the process group is gloo over CPU
tensors whatever the device: no NCCL. That is also the route that runs
when several ranks share one card. A collective that fails raises on
the rank; there are no retries and no fallback.

A single process takes the same code path: ``initialize`` does
nothing, ``host_shard`` returns everything and every exchange is the
identity.
"""

from __future__ import annotations

import datetime
import hashlib
import logging
import os
from typing import Callable, List, Optional, Sequence, TypeVar

import numpy as np
import torch

from galah_tpu_torch.obs import metrics as obs_metrics
from galah_tpu_torch.resilience import dispatch as rdispatch
from galah_tpu_torch.timing import Stopwatch

logger = logging.getLogger(__name__)

T = TypeVar("T")

# torch.distributed's own default
DEFAULT_TIMEOUT_S = 1800.0


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def initialize(timeout_s: Optional[float] = None,
               device: Optional[torch.device] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               local_rank: Optional[int] = None,
               master_addr: Optional[str] = None,
               master_port: Optional[int] = None) -> None:
    """Join the gloo process group (a no-op in one process, or when this
    process has joined already).

    The arguments default from ``torchrun``'s variables; explicit
    arguments win. `timeout_s` bounds every collective (tests set a
    few seconds, so that a missing peer fails instead of waiting out
    the default half hour). With a CUDA `device` the rank runs on
    ``cuda:LOCAL_RANK``, which must be below the device count: a rank
    never wraps round onto another's card."""
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE") or 1)
    if world_size <= 1 or is_initialized():
        return
    if rank is None:
        rank = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK") or 0)
    master_addr = master_addr or env.get("MASTER_ADDR") or "127.0.0.1"
    if master_port is None:
        master_port = int(env["MASTER_PORT"])
    if device is not None and torch.device(device).type == "cuda":
        n_cards = torch.cuda.device_count()
        if not 0 <= local_rank < n_cards:
            raise RuntimeError(
                f"LOCAL_RANK {local_rank} has no device: this host sees "
                f"{n_cards} CUDA device(s)")
        torch.cuda.set_device(local_rank)
    timeout = datetime.timedelta(
        seconds=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)
    logger.info("Joining the process group as rank %d/%d via %s:%d",
                rank, world_size, master_addr, master_port)
    _dist().init_process_group(
        "gloo", init_method=f"tcp://{master_addr}:{master_port}",
        world_size=world_size, rank=rank, timeout=timeout)


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def host_shard(items: Sequence[T]) -> List[T]:
    """This rank's strided shard of a global work list.

    Strided rather than contiguous so that quality-ordered genome lists
    spread evenly: genome sizes correlate with quality rank, and a
    contiguous split would put the big genomes on rank 0."""
    return list(items[process_index()::process_count()])


def exchange(tag: str, value: np.ndarray, fill=0) -> np.ndarray:
    """One all-gather of a host array over the process group: (P,
    *shape) with rank p's value at [p]. Values of different shapes are
    padded with `fill` to the largest shape on every axis first.

    Every collective of the port goes through here, a guarded call at
    the dispatch site ``collective.<tag>`` (``resilience/dispatch.py``),
    with no fallback; its seconds and count go to the metrics
    ``distributed.exchange_seconds`` and ``distributed.exchanges``. An
    injected fault fires before this rank enters the collective, so it
    is retried; a failure of the collective itself is not (the peers
    may have left it): it raises on this rank, and the peers'
    collectives fail with it (or at their timeout). In one process the
    value comes back with a leading axis of 1."""
    return rdispatch.run(f"collective.{tag}",
                         lambda: _all_gather(tag, value, fill))


def _all_gather(tag: str, value: np.ndarray, fill) -> np.ndarray:
    """``exchange``'s collective, unguarded; any failure a
    ``RuntimeError`` naming the tag and this rank."""
    value = np.ascontiguousarray(value)
    if process_count() == 1:
        return value[None].copy()
    dist = _dist()
    watch = Stopwatch()
    try:
        shape = torch.tensor([value.ndim, *value.shape], dtype=torch.int64)
        dims = [torch.empty_like(shape) for _ in range(process_count())]
        dist.all_gather(dims, shape)
        if any(int(d[0]) != value.ndim for d in dims):
            raise ValueError(f"ranks disagree on the rank of {tag!r}")
        big = tuple(int(x) for x in torch.stack(dims)[:, 1:].amax(0))
        padded = np.full(big, fill, dtype=value.dtype)
        padded[tuple(slice(0, s) for s in value.shape)] = value
        # one spare byte, so that no rank sends an empty tensor
        raw = padded.reshape(-1).view(np.uint8)
        buf = torch.zeros(raw.shape[0] + 1, dtype=torch.uint8)
        buf[:-1] = torch.from_numpy(raw)
        parts = [torch.empty_like(buf) for _ in range(process_count())]
        dist.all_gather(parts, buf)
    except Exception as e:
        raise RuntimeError(f"collective.{tag} failed on rank "
                           f"{process_index()}: {e}") from e
    finally:
        obs_metrics.counter(
            "distributed.exchange_seconds", unit="seconds",
            help="Seconds spent in process-group exchanges").inc(
            watch.seconds())
        obs_metrics.counter(
            "distributed.exchanges",
            help="Process-group exchanges (all-gathers)").inc()
    return np.stack([p.numpy()[:-1].view(value.dtype).reshape(big)
                     for p in parts])


def allgather_host_rows(n_unique: int, local_rows: np.ndarray,
                        fill=0) -> np.ndarray:
    """The full (n_unique, ...) row matrix on every rank, from each
    rank's rows of ``host_shard(range(n_unique))`` in shard order. The
    reassembly's stride mirrors ``host_shard``'s ``items[rank::count]``,
    so the two live together."""
    n_proc = process_count()
    if n_proc == 1:
        return np.asarray(local_rows)[:n_unique]
    per = -(-n_unique // n_proc)
    padded = np.full((per, *local_rows.shape[1:]), fill,
                     dtype=local_rows.dtype)
    padded[:local_rows.shape[0]] = local_rows
    gathered = exchange("host-rows", padded, fill=fill)
    out = np.empty((n_unique, *local_rows.shape[1:]),
                   dtype=local_rows.dtype)
    for p in range(n_proc):
        idxs = np.arange(p, n_unique, n_proc)
        out[idxs] = gathered[p, :idxs.shape[0]]
    return out


def raise_if_any_host_failed(err: Optional[BaseException]) -> None:
    """A status exchange before a data exchange: every rank reports
    whether its local work failed, and if any did, every rank raises
    (the failing one its own error, the peers a pointer to it), so that
    a lone failure never strands the peers inside the data exchange.
    Every rank must reach this."""
    if process_count() <= 1:
        if err is not None:
            raise err
        return
    status = np.array([1 if err is not None else 0], dtype=np.int64)
    statuses = exchange("host-status", status)
    if err is not None:
        raise err
    if int(statuses.sum()):
        raise RuntimeError(
            "a peer process failed its shard of a distributed pass; "
            "see that process's log for the original error")


def sharded_optional_floats(
        n_total: int,
        compute_mine: Callable[[List[int]], Sequence[Optional[float]]],
        owner: Optional[Callable[[int], int]] = None
) -> List[Optional[float]]:
    """`n_total` Optional[float] computations split over the ranks.

    Every rank calls this with the same `n_total`. `compute_mine(idxs)`
    returns this rank's values for its indices; `owner(k)` names item
    k's rank (modulo the count; default ``k % P``), so that a caller can
    keep a shard's items near the context it already holds. A rank
    whose compute raises makes every rank raise. None travels as NaN
    (no producer emits NaN)."""
    n_proc = process_count()
    if n_proc <= 1:
        return list(compute_mine(list(range(n_total))))
    rank = process_index()
    if owner is None:
        mine = list(range(rank, n_total, n_proc))
    else:
        mine = [k for k in range(n_total) if owner(k) % n_proc == rank]
    err: Optional[BaseException] = None
    vals: List[Optional[float]] = []
    try:
        vals = list(compute_mine(mine))
        if len(vals) != len(mine):
            raise RuntimeError(f"compute_mine returned {len(vals)} values "
                               f"for {len(mine)} indices")
    except Exception as e:  # re-raised on every rank below
        err = e
    raise_if_any_host_failed(err)
    local = np.full((max(len(mine), 1), 2), np.nan, dtype=np.float64)
    local[:, 0] = -1.0  # no item in this row
    for r, (k, v) in enumerate(zip(mine, vals)):
        local[r, 0] = float(k)
        if v is not None:
            local[r, 1] = v
    gathered = exchange("shard-values", local, fill=-1.0)
    out: List[Optional[float]] = [None] * n_total
    for row in gathered.reshape(-1, 2):
        k = int(row[0])
        if k >= 0:
            out[k] = None if np.isnan(row[1]) else float(row[1])
    return out


def tokens_agree(token: bytes) -> bool:
    """True when every rank passed the same token (hashed here to a
    fixed length): what makes a checkpoint resume all-or-nothing."""
    digest = np.frombuffer(hashlib.sha256(token).digest(),
                           dtype=np.uint8).copy()
    if process_count() == 1:
        return True
    gathered = exchange("resume-token", digest)
    return bool((gathered == gathered[0]).all())


def rank_devices(device: torch.device) -> List[str]:
    """Every rank's device, as its name, in rank order (this rank's
    `device`, with a CUDA device named by its index)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    name = str(device).encode()
    buf = np.frombuffer(name, dtype=np.uint8).copy()
    gathered = exchange("rank-devices", buf)
    return [bytes(row).rstrip(b"\0").decode() for row in gathered]
