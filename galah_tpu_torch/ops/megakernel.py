"""The slab fold (the megakernel's fused greedy round): the port of
``galah_tpu/ops/megakernel.py``.

The device greedy rounds (``cluster/engine.py``) decide a window of
genomes with one fold over its intra-window ANI matrix
(``ops/greedy_select.window_select``). A *slab* fuses up to
``SLAB_WINDOWS`` consecutive windows: their hit edges go into the pair
queue on the device (``ops/device_queue.py``, one copy) and one launch
of ``kernels/slab_fold.cu`` applies the same peeling recurrence over
the edge list until nothing changes, so S windows take one enqueue and
one fold instead of S folds.

Why a slab is exact: the rounds are width-invariant (a window of S x w
genomes decides as S windows of w do), and the edge-list recurrence is
the matrix recurrence restricted to the edges that exist. A missing
pair has no entry; an entry whose value fails ``v >= thr`` (NaN
included) never passes. Both folds iterate to a fixpoint, so they
reach the same one. A slab whose edges do not fit the queue never
half-runs: the engine takes the dense path for it
(``megakernel-overflow-spills``), so clusters are exact at any
capacity.

On CUDA tensors ``slab_fold`` launches the kernel; on CPU tensors it
runs ``slab_fold_plain`` beside it (``scatter_reduce_`` amax, a Python
loop to the fixpoint). A CUDA failure raises; nothing falls back.
``GALAH_TPU_MEGAKERNEL`` (auto/0/1) is read by ``resolve_megakernel``;
the engine decides where it engages.

The kernel holds a slab in shared memory: ``fold_plan`` picks, from the
slab's width and the queue's capacity alone, the smallest thread-block
cluster (1, 2, 4 or 8 blocks of 1024 threads) whose per-block state
fits one SM's 227 KB: the block's share of 4 flag bytes a position and
of the records, each kept as a (source, target) pair of 4 bytes (two
uint16, width <= 65,536) or 8, sized as if every record passed. A slab
beyond 8 blocks takes the global-memory tier, the first design. The
tier follows from the sizes only, never from a failed launch.

The whole call (``slab_select``) holds its buffers in the queue: the
records and the ``ext`` flags go up in one copy from one pinned staging
buffer, the kernel writes one packed output (``packed_layout``: rep and
undecided flags, the iterations and the undecided count) into a held
device workspace, and one copy into a held pinned mirror and one event
wait bring it back. The operations of a fold are added to its cost
entry from the iterations read back, so the accounting puts nothing on
the device.
"""

from __future__ import annotations

import logging
import os
import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from galah_tpu_torch.kernels import LAUNCHES, costs
from galah_tpu_torch.obs.profile import on_device, profiled

logger = logging.getLogger(__name__)

#: GALAH_TPU_MEGAKERNEL values: auto (the overlapped engine's rounds),
#: 0 (never), 1 (every device round; failures and ineligibility raise).
MEGAKERNEL_MODES = ("auto", "0", "1")

#: The most consecutive round windows fused into one slab.
SLAB_WINDOWS = 16

#: the kernel's cost entry in the run report (``obs/profile.py``)
PROFILE = profiled("slab_fold")

#: the kernel's block (``kernels/slab_fold.cu``) and one SM's opt-in
#: shared memory a block on the H100 (227 KB)
FOLD_WARPS = 32
SMEM_PER_BLOCK = 232_448
CLUSTER_SIZES = (1, 2, 4, 8)
#: the kernel's shared-memory header: two "changed" words and a count
SMEM_HEAD = 16
#: the widest slab whose positions fit uint16
MAX_U16_WIDTH = 65_536

# Numeric contract (GL9xx): the slab fold picks the representatives the
# dense window fold and the host scan pick; it compares stored float64
# values with one IEEE >= and accumulates nothing.
DETERMINISM_CONTRACT = {
    "family": "megakernel",
    "dtype": "float64",
    "functions": ["slab_select", "slab_fold_plain"],
}

# The launch wrapper is a device-round body (GL1006, GL1101): a host
# sync in it, or in anything it calls, would put back the round trip
# an iteration that the fold exists to remove.
PIPELINE_STAGE = {  # galah-lint: ignore[GL704] the engine owns flow attribution
    "device_round": ["run_launch"],
}


def resolve_megakernel() -> Tuple[str, bool]:
    """(mode, explicit) of GALAH_TPU_MEGAKERNEL: a malformed value
    warns and reads as auto; explicit only for a well-formed value."""
    env = (os.environ.get("GALAH_TPU_MEGAKERNEL") or "").strip().lower()
    if env in MEGAKERNEL_MODES:
        return env, True
    if env:
        logger.warning("ignoring malformed GALAH_TPU_MEGAKERNEL=%r "
                       "(want auto/0/1)", env)
    return "auto", False


class FoldPlan(NamedTuple):
    """How the kernel holds one slab: a cluster of `cluster` blocks (0:
    the global-memory tier), each owning `per_block` positions (a
    multiple of 16) and `per_warp` edge slots a warp of `edge_bytes`,
    in `smem` bytes of shared memory a block."""

    cluster: int
    per_block: int
    per_warp: int
    edge_bytes: int
    smem: int

    @property
    def tier(self) -> str:
        return "global" if self.cluster == 0 else f"cluster {self.cluster}"


#: the global-memory tier (the first design), whatever the slab
GLOBAL_TIER = FoldPlan(0, 0, 0, 0, 0)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def cluster_plan(width: int, cap: int, cluster: int) -> FoldPlan:
    """The shared-memory tier's plan over `cluster` blocks: positions
    in contiguous ranges of a multiple of 16, each block room for its
    share of the `cap` records as edges (every record counted as
    passing), whose chunks of 32 its warps take in turn."""
    edge_bytes = 4 if width <= MAX_U16_WIDTH else 8
    per_block = 16 * _ceil_div(_ceil_div(width, cluster), 16)
    per_warp = 32 * _ceil_div(_ceil_div(cap, cluster), 32 * FOLD_WARPS)
    smem = SMEM_HEAD + 4 * per_block + FOLD_WARPS * per_warp * edge_bytes
    return FoldPlan(cluster, per_block, per_warp, edge_bytes, smem)


def fold_plan(width: int, cap: int) -> FoldPlan:
    """The smallest cluster of ``CLUSTER_SIZES`` whose per-block state
    (``cluster_plan``) fits ``SMEM_PER_BLOCK``; ``GLOBAL_TIER`` when
    none does."""
    for c in CLUSTER_SIZES:
        plan = cluster_plan(width, cap, c)
        if plan.smem <= SMEM_PER_BLOCK:
            return plan
    return GLOBAL_TIER


def packed_layout(width: int) -> Tuple[int, int, int]:
    """(und_off, tail_off, nbytes) of the kernel's packed output: the
    rep flags (a byte a position) at 0, the undecided flags at
    `und_off`, the int32 iterations and int32 undecided count at
    `tail_off`; offsets 16-byte aligned."""
    u = 16 * _ceil_div(width, 16)
    return u, 2 * u, 2 * u + 16


def fold_bytes(width: int) -> int:
    """The fold's device workspace: the packed output, then the
    global-memory tier's 2 x width bytes of scatter flags."""
    und_off, _, nbytes = packed_layout(width)
    return nbytes + 2 * und_off


def unpack(packed: np.ndarray, width: int
           ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(rep, undecided, iterations, undecided count) of a packed output
    on the host (uint8): the flags as bool views of `packed`."""
    und_off, tail_off, _ = packed_layout(width)
    iters, left = packed[tail_off:tail_off + 8].view(np.int32)
    return (packed[:width].view(bool),
            packed[und_off:und_off + width].view(bool), int(iters),
            int(left))


def _check(records: torch.Tensor, count: int, ext: torch.Tensor) -> None:
    if records.dtype != torch.int64 or records.dim() != 2 \
            or records.shape[1] != 2 or not records.is_contiguous():
        raise ValueError("slab_fold takes the queue's contiguous (cap, 2) "
                         f"int64 records; got {records.dtype} "
                         f"{tuple(records.shape)}")
    if not 0 <= count <= records.shape[0]:
        raise ValueError(f"slab_fold count {count} outside the queue's "
                         f"capacity {records.shape[0]}")
    if ext.dtype != torch.bool or ext.dim() != 1 \
            or not ext.is_contiguous() or ext.device != records.device:
        raise ValueError(
            f"slab_fold ext must be contiguous 1-D bool on "
            f"{records.device}; got {ext.dtype} {tuple(ext.shape)} on "
            f"{ext.device}")


def slab_fold(records: torch.Tensor, count: int, ext: torch.Tensor,
              thr: float, max_iters: Optional[int] = None,
              out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rep, undecided, iterations) of the fold over the first `count`
    queue records (``PairQueue.records``) with the slab's
    already-clustered flags `ext`: two bool (width,) tensors and an
    int32 scalar, on the records' device. `max_iters` defaults to the
    slab width. `out`: a uint8 workspace of at least
    ``fold_bytes(width)`` that receives the packed output (the queue's
    held one; allocated when None)."""
    _check(records, count, ext)
    width = ext.shape[0]
    iters = width if max_iters is None else int(max_iters)
    if records.device.type == "cpu":
        rep, und, it = slab_fold_plain(records, count, ext, thr, iters)
        PROFILE.plain_call(("int64", count, width),
                           lambda: (costs.slab_fold_bytes(count, width),
                                    costs.slab_fold_ops(int(it), count,
                                                        width)))
        if out is not None:
            _pack_plain(out, rep, und, int(it))
        return rep, und, it
    if out is None:
        out = torch.empty(fold_bytes(width), dtype=torch.uint8,
                          device=records.device)
    run_launch(records, count, ext, thr, iters, out)
    und_off, tail_off, _ = packed_layout(width)
    return (out[:width].view(torch.bool),
            out[und_off:und_off + width].view(torch.bool),
            out[tail_off:tail_off + 4].view(torch.int32)[0])


def _pack_plain(out: torch.Tensor, rep: torch.Tensor, und: torch.Tensor,
                iters: int) -> None:
    """The plain fold's result in the kernel's packed layout."""
    width = rep.shape[0]
    und_off, tail_off, _ = packed_layout(width)
    if out.numel() < fold_bytes(width):
        raise ValueError(f"slab_fold workspace of {out.numel()} bytes "
                         f"under the {fold_bytes(width)} a width of "
                         f"{width} takes")
    out[:width] = rep.view(torch.uint8)
    out[und_off:und_off + width] = und.view(torch.uint8)
    out[tail_off:tail_off + 8].view(torch.int32)[:] = torch.tensor(
        [iters, int(und.sum())], dtype=torch.int32)


def slab_fold_plain(records: torch.Tensor, count: int, ext: torch.Tensor,
                    thr: float, max_iters: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The torch version (``_slab_fold_jit``'s recurrence), CPU tensors
    only: scatter-max of the passing edges' source flags onto their
    targets, iterated in Python to the fixpoint or `max_iters`."""
    if records.device.type != "cpu":
        raise ValueError("slab_fold_plain takes CPU tensors")
    width = ext.shape[0]
    live = records[:count]
    qi = live.view(torch.int32)[:, 0].to(torch.int64)
    qj = live.view(torch.int32)[:, 1].to(torch.int64)
    qv = live.view(torch.float64)[:, 1]
    passing = qv >= thr  # NaN never passes
    und = ~ext
    rep = torch.zeros_like(und)
    it = 0
    changed = True
    while changed and it < max_iters:
        zeros = torch.zeros(width, dtype=torch.int32)
        und_at = zeros.clone().scatter_reduce_(
            0, qj, (passing & und[qi]).to(torch.int32), "amax") > 0
        rep_at = zeros.scatter_reduce_(
            0, qj, (passing & rep[qi]).to(torch.int32), "amax") > 0
        new_rep = und & ~und_at & ~rep_at
        new_member = und & rep_at
        und2 = und & ~new_rep & ~new_member
        changed = bool((und2 != und).any())
        rep = rep | new_rep
        und = und2
        it += 1
    return rep, und, torch.tensor(it, dtype=torch.int32)


def run_launch(records: torch.Tensor, count: int, ext: torch.Tensor,
               thr: float, max_iters: int, out: torch.Tensor,
               plan: Optional[FoldPlan] = None) -> torch.Tensor:
    """The kernel alone: one launch that writes the packed output
    (``packed_layout``) into `out` (uint8, at least
    ``fold_bytes(width)``, 16-byte aligned, like the records and `ext`)
    and returns it, in the tier `plan` gives (default
    ``fold_plan(width, capacity)``). Reads nothing back from the
    device."""
    from galah_tpu_torch.kernels import build

    width = ext.shape[0]
    cap = records.shape[0]
    if count > cap or out.dtype != torch.uint8 or out.dim() != 1 \
            or out.device != records.device \
            or out.numel() < fold_bytes(width):
        raise ValueError(
            f"slab_fold launch of {count} records over a width of "
            f"{width} does not fit its buffers")
    if (records.data_ptr() | ext.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("slab_fold takes 16-byte aligned records, ext "
                         "and workspace")
    und_off, tail_off, nbytes = packed_layout(width)
    if width == 0:
        out[tail_off:tail_off + 8].zero_()
        return out
    if plan is None:
        plan = fold_plan(width, cap)
    lib = build.load("slab_fold")
    device = records.device
    stream = torch.cuda.current_stream(device).cuda_stream
    thr_bits = struct.unpack("<q", struct.pack("<d", float(thr)))[0]
    args = (records.data_ptr(), int(count), ext.data_ptr(), width,
            thr_bits, int(max_iters), plan.cluster, plan.per_block,
            plan.per_warp, out.data_ptr(), und_off, tail_off,
            out.data_ptr() + nbytes, stream)
    # the operations follow from the iterations, which slab_select
    # reads back with the flags (add_operations); none are counted here
    with PROFILE.launch(device, ("int64", count, width),
                        lambda: (costs.slab_fold_bytes(count, width), 0)):
        # the library launches on the current device: make it the queue's
        with on_device(device):
            err = lib.slab_fold_launch(*args)
        build.check("slab_fold", err)
    LAUNCHES["slab_fold"] += 1
    return out


def slab_select(queue, ei: np.ndarray, ej: np.ndarray, ev: np.ndarray,
                ext: np.ndarray, thr: float, clock=None,
                plan: Optional[FoldPlan] = None
                ) -> Tuple[Optional[np.ndarray], bool]:
    """One fused slab round: enqueue the slab's edges (slab positions
    ``ei < ej``, their float64 ANIs `ev`) and its `ext` flags in one
    copy, fold them in one launch into the queue's held workspace, read
    the packed output back in one copy and one wait, and empty the
    queue. Returns ``(rep_flags, converged)``, or ``(None, False)`` when
    the edges do not fit `queue` (``device_queue.PairQueue``); the
    caller then takes the dense path. `clock` counts
    ``greedy-select-dispatches`` (the enqueue and the fold, as
    ``galah_tpu`` counts them). `plan`: the kernel's tier, by default
    ``fold_plan``'s."""
    w = len(ext)
    n = len(ei)
    if n and (int(np.min(ei)) < 0 or int(np.max(ej)) >= w
              or bool(np.any(np.asarray(ei) >= np.asarray(ej)))):
        raise ValueError(f"slab edges must be positions i < j below the "
                         f"slab width {w}")
    if n > queue.cap:
        queue.reset()
        return None, False
    stored = queue.enqueue(ei, ej, ev, ext=np.ascontiguousarray(ext,
                                                                dtype=bool))
    if clock is not None and n:
        clock.count("greedy-select-dispatches", 1)
    if stored < n:
        queue.reset()
        return None, False
    if clock is not None:
        clock.count("greedy-select-dispatches", 1)
    count = queue.count
    out = queue.workspace(fold_bytes(w))
    if queue.device.type == "cpu":
        slab_fold(queue.records, count, queue.ext, thr, out=out)
    else:
        run_launch(queue.records, count, queue.ext, thr, w, out, plan)
    packed = queue.read_back(out, packed_layout(w)[2])
    rep, _und, iters, left = unpack(packed, w)
    if queue.device.type == "cuda":
        PROFILE.add_operations(costs.slab_fold_ops(iters, count, w))
    rep = rep.copy()
    queue.reset()
    return rep, left == 0
