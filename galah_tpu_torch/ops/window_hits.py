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

from typing import Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops.constants import SENTINEL_BIASED

Pair = Tuple[torch.Tensor, torch.Tensor]  # (sorted query, sorted ref set)

_THREADS = 256  # elements per block of the kernel


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
    hashes (the sentinel never hits); reference sets are sorted and
    distinct. One kernel launch covers all items."""
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


def _launch(items: Sequence[Pair], device: torch.device) -> torch.Tensor:
    from galah_tpu_torch.kernels import build

    lib = build.load("window_hits")
    q_len = np.array([q.numel() for q, _ in items], dtype=np.int64)
    r_len = np.array([r.numel() for _, r in items], dtype=np.int64)
    q_addr = np.array([q.data_ptr() for q, _ in items], dtype=np.uint64)
    r_addr = np.array([r.data_ptr() for _, r in items], dtype=np.uint64)
    out_off = np.zeros(len(items), dtype=np.int64)
    np.cumsum(q_len[:-1], out=out_off[1:])
    n_total = int(q_len.sum())
    hits = torch.empty(n_total, dtype=torch.int32, device=device)
    if n_total == 0:
        return hits
    per = -(-q_len // _THREADS)
    blk_pair = np.repeat(np.arange(len(items), dtype=np.int32), per)
    first = np.zeros(len(items), dtype=np.int64)
    np.cumsum(per[:-1], out=first[1:])
    blk_start = (np.arange(blk_pair.shape[0], dtype=np.int64)
                 - np.repeat(first, per)) * _THREADS

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    meta = [dev(q_addr.view(np.int64)), dev(q_len),
            dev(r_addr.view(np.int64)), dev(r_len), dev(out_off),
            dev(blk_pair), dev(blk_start)]
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.window_hits_launch(*[t.data_ptr() for t in meta],
                                 hits.data_ptr(), int(blk_pair.shape[0]),
                                 stream)
    build.check("window_hits", err)
    LAUNCHES["window_hits"] += 1
    return hits

