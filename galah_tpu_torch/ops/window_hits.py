"""Window membership flags: the port of ``ops/pallas_fragment.py``.

For many (query, reference) pairs at once, one int32 flag per query
element: 1 iff the element is a member of the pair's sorted distinct
reference set. ``fragment_ani`` folds the flags into per-window matched
counts. On CUDA tensors ``window_element_hits`` launches the
hand-written kernel (``kernels/window_hits.cu``); on CPU tensors it
runs the plain torch version beside it, ``window_element_hits_plain``,
which the CPU tests hold against ``galah_tpu``. A CUDA failure raises;
nothing falls back.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops.constants import SENTINEL_BIASED

Pair = Tuple[torch.Tensor, torch.Tensor]  # (sorted query, sorted ref set)

# merged items (query and reference values) a block of the kernel
# takes: 256 threads x 15 (kernels/window_hits.cu's kSegment)
SEGMENT = 256 * 15


def _check(items: Sequence[Pair], device: torch.device) -> None:
    for q, r in items:
        for t in (q, r):
            if t.device.type != device.type or t.dtype != torch.int64 \
                    or t.dim() != 1 or not t.is_contiguous():
                raise ValueError(
                    "window_hits takes contiguous 1-D int64 tensors on "
                    f"{device}; got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")


def window_element_hits(items: Sequence[Pair],
                        device="cuda") -> torch.Tensor:
    """Concatenated int32 flags, item by item in query order: flag e of
    item i is 1 iff ``q_i[e]`` is in ``r_i``. Queries are biased int64
    hashes (the sentinel never hits), each sorted ascending (duplicates
    allowed); reference sets are sorted and distinct. The CUDA kernel
    merges each query with its reference set, so an unsorted query gives
    wrong flags there (the plain version does not need the order). One
    kernel launch covers all items."""
    device = torch.device(device)
    _check(items, device)
    if device.type == "cpu":
        return window_element_hits_plain(items, device)
    return _launch(items, device)


def window_element_hits_plain(items: Sequence[Pair],
                              device="cuda") -> torch.Tensor:
    """The torch version: ``searchsorted`` plus an equality gather."""
    device = torch.device(device)
    outs = []
    for q, r in items:
        if q.numel() == 0 or r.numel() == 0:
            outs.append(torch.zeros(q.numel(), dtype=torch.int32,
                                    device=device))
            continue
        pos = torch.searchsorted(r, q).clamp_(max=r.numel() - 1)
        outs.append(((r[pos] == q) & (q != SENTINEL_BIASED)).to(
            torch.int32))
    if not outs:
        return torch.zeros(0, dtype=torch.int32, device=device)
    return torch.cat(outs)


class Launch(NamedTuple):
    """One planned launch: the (6, pairs) int64 plan on the card, the
    flags it fills and its block count."""

    plan: torch.Tensor
    hits: torch.Tensor
    n_blocks: int


def block_plan(q_len: np.ndarray, r_len: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(blk_end, out_off) int64 per pair: the running end of the pairs'
    blocks (pair p owns blocks [blk_end[p-1], blk_end[p]), each
    ``SEGMENT`` merged items of its q and r along the merge, the last
    one ragged; a pair with no query value owns none) and the offset of
    its first flag."""
    q_len = np.asarray(q_len, dtype=np.int64)
    r_len = np.asarray(r_len, dtype=np.int64)
    blocks = np.where(q_len > 0, -(-(q_len + r_len) // SEGMENT), 0)
    out_off = np.zeros_like(q_len)
    np.cumsum(q_len[:-1], out=out_off[1:])
    return np.cumsum(blocks), out_off


def plan_launch(items: Sequence[Pair], device: torch.device) -> Launch:
    """The host side of one kernel launch: the O(pairs) plan, copied to
    the card once, and the flags to fill."""
    q_len = np.array([q.numel() for q, _ in items], dtype=np.int64)
    r_len = np.array([r.numel() for _, r in items], dtype=np.int64)
    blk_end, out_off = block_plan(q_len, r_len)
    plan = torch.empty((6, len(items)), dtype=torch.int64, pin_memory=True)
    host = plan.numpy()
    host[0] = [q.data_ptr() for q, _ in items]
    host[1] = q_len
    host[2] = [r.data_ptr() for _, r in items]
    host[3] = r_len
    host[4] = out_off
    host[5] = blk_end
    hits = torch.empty(int(q_len.sum()), dtype=torch.int32, device=device)
    n_blocks = int(blk_end[-1]) if len(items) else 0
    return Launch(plan.to(device, non_blocking=True), hits, n_blocks)


def run_launch(launch: Launch) -> torch.Tensor:
    """The kernel alone, on a planned launch; returns its flags."""
    from galah_tpu_torch.kernels import build

    if launch.n_blocks == 0:
        return launch.hits
    lib = build.load("window_hits")
    stream = torch.cuda.current_stream(launch.hits.device).cuda_stream
    err = lib.window_hits_launch(
        launch.plan.data_ptr(), launch.plan.shape[1], launch.n_blocks,
        SEGMENT, launch.hits.data_ptr(), stream)
    build.check("window_hits", err)
    LAUNCHES["window_hits"] += 1
    return launch.hits


def _launch(items: Sequence[Pair], device: torch.device) -> torch.Tensor:
    return run_launch(plan_launch(items, device))
