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
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from galah_tpu_torch.kernels import LAUNCHES, costs
from galah_tpu_torch.obs.profile import profiled

logger = logging.getLogger(__name__)

#: GALAH_TPU_MEGAKERNEL values: auto (the overlapped engine's rounds),
#: 0 (never), 1 (every device round; failures and ineligibility raise).
MEGAKERNEL_MODES = ("auto", "0", "1")

#: The most consecutive round windows fused into one slab.
SLAB_WINDOWS = 16

#: the kernel's cost entry in the run report (``obs/profile.py``)
PROFILE = profiled("slab_fold")

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
              thr: float, max_iters: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rep, undecided, iterations) of the fold over the first `count`
    queue records (``PairQueue.records``) with the slab's
    already-clustered flags `ext`: two bool (width,) tensors and an
    int32 scalar, on the records' device. `max_iters` defaults to the
    slab width."""
    _check(records, count, ext)
    width = ext.shape[0]
    iters = width if max_iters is None else int(max_iters)
    if records.device.type == "cpu":
        out = slab_fold_plain(records, count, ext, thr, iters)
        PROFILE.plain_call(("int64", count, width),
                           lambda: (costs.slab_fold_bytes(count, width),
                                    costs.slab_fold_ops(int(out[2]),
                                                        count, width)))
        return out
    return _launch(records, count, ext, thr, iters)


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


def _launch(records: torch.Tensor, count: int, ext: torch.Tensor,
            thr: float, max_iters: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    width = ext.shape[0]
    rep = torch.empty(width, dtype=torch.bool, device=records.device)
    und = torch.empty_like(rep)
    scratch = torch.empty(2 * width, dtype=torch.uint8,
                          device=records.device)
    iters = torch.zeros((), dtype=torch.int32, device=records.device)
    return run_launch(records, count, ext, thr, max_iters, rep, und,
                      scratch, iters)


def run_launch(records: torch.Tensor, count: int, ext: torch.Tensor,
               thr: float, max_iters: int, rep: torch.Tensor,
               und: torch.Tensor, scratch: torch.Tensor,
               iters: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel alone: one launch that fills the bool (width,) `rep`
    and `und` and the int32 scalar `iters`, with `scratch` (2 x width
    bytes) for the scatter flags. Reads nothing back from the device."""
    from galah_tpu_torch.kernels import build

    width = ext.shape[0]
    if count > records.shape[0] or rep.shape[0] != width \
            or und.shape[0] != width or scratch.numel() < 2 * width:
        raise ValueError(
            f"slab_fold launch of {count} records over a width of "
            f"{width} does not fit its buffers")
    if width == 0:
        return rep, und, iters
    lib = build.load("slab_fold")
    stream = torch.cuda.current_stream(records.device).cuda_stream
    thr_bits = struct.unpack("<q", struct.pack("<d", float(thr)))[0]
    with PROFILE.launch(records.device, ("int64", count, width),
                        lambda: (costs.slab_fold_bytes(count, width),
                                 costs.slab_fold_ops(
                                     iters.to(torch.float64), count,
                                     width))):
        # the library launches on the current device: make it the queue's
        with torch.cuda.device(records.device):
            err = lib.slab_fold_launch(
                records.data_ptr(), int(count), ext.data_ptr(), width,
                thr_bits, int(max_iters), rep.data_ptr(), und.data_ptr(),
                scratch.data_ptr(), iters.data_ptr(), stream)
        build.check("slab_fold", err)
    LAUNCHES["slab_fold"] += 1
    return rep, und, iters


def slab_select(queue, ei: np.ndarray, ej: np.ndarray, ev: np.ndarray,
                ext: np.ndarray, thr: float, clock=None
                ) -> Tuple[Optional[np.ndarray], bool]:
    """One fused slab round: enqueue the slab's edges (slab positions
    ``ei < ej``, their float64 ANIs `ev`), fold them in one launch, and
    empty the queue. Returns ``(rep_flags, converged)``, or ``(None,
    False)`` when the edges do not fit `queue`
    (``device_queue.PairQueue``); the caller then takes the dense
    path. `clock` counts ``greedy-select-dispatches`` (the enqueue and
    the fold, as ``galah_tpu`` counts them)."""
    w = len(ext)
    n = len(ei)
    if n and (int(np.min(ei)) < 0 or int(np.max(ej)) >= w
              or bool(np.any(np.asarray(ei) >= np.asarray(ej)))):
        raise ValueError(f"slab edges must be positions i < j below the "
                         f"slab width {w}")
    if n > queue.cap:
        queue.reset()
        return None, False
    stored = queue.enqueue(ei, ej, ev)
    if clock is not None and n:
        clock.count("greedy-select-dispatches", 1)
    if stored < n:
        queue.reset()
        return None, False
    ext_t = torch.from_numpy(np.ascontiguousarray(ext, dtype=bool)).to(
        queue.device)
    if clock is not None:
        clock.count("greedy-select-dispatches", 1)
    rep, und, _iters = slab_fold(queue.records, queue.count, ext_t, thr)
    queue.reset()
    return rep.cpu().numpy(), not bool(und.any())
