"""Device-resident greedy representative selection: the port of
``galah_tpu/ops/greedy_select.py``.

* :func:`window_select` — the segmented "peeling" fold over one round
  window's intra-window ANI matrix plus the already-clustered flags
  from earlier rounds. Each fold iteration decides every genome whose
  earlier neighbours (by an edge at or above the threshold) are all
  decided: it becomes a rep when none of them is a rep, a member when
  one is. Windows deeper than the iteration budget do not converge and
  are finished by the engine's exact host-order scan.
* :func:`membership_argmax` — per non-rep, the column of its best rep;
  ``torch.argmax`` returns the first maximum, so with columns in
  ascending rep order ties go to the lowest rep, like the host loop's
  strict ``>`` update.

Everything is float64: NaN means no edge, and ``NaN >= thr`` is False
exactly like the host's ``ani is not None`` guard. Shapes pad to
power-of-two buckets, as in ``galah_tpu``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from galah_tpu_torch.device import resolve_device

#: Genomes speculatively taken per selection round.
DEFAULT_ROUND_WIDTH = 1024

#: Fold iterations before a window counts as a conflict window (2x the
#: engine's sub-round budget, cluster/engine.MAX_SUBROUNDS).
FOLD_ITERS = 32

_MIN_BUCKET = 8


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def window_select(ani: np.ndarray, ext: np.ndarray, thr: float,
                  device="cuda") -> Tuple[np.ndarray, bool]:
    """(rep_flags, converged) for one window.

    ``ani``: (W, W) float64, strictly upper-triangular — ``ani[a, b]``
    for a < b is the exact ANI of the window's a-th and b-th genomes
    when they share a precluster hit, NaN otherwise. ``ext``: (W,) bool,
    genome already claimed by a rep of an earlier round.
    """
    device = resolve_device(device)
    w = ani.shape[0]
    b = _bucket(w)
    mat = torch.full((b, b), float("nan"), dtype=torch.float64,
                     device=device)
    mat[:w, :w] = torch.from_numpy(np.ascontiguousarray(ani)).to(device)
    extp = torch.zeros(b, dtype=torch.bool, device=device)
    extp[:w] = torch.from_numpy(np.asarray(ext, dtype=bool)).to(device)
    valid = torch.zeros(b, dtype=torch.bool, device=device)
    valid[:w] = True

    edges = mat >= thr
    undecided = valid & ~extp
    rep = torch.zeros_like(undecided)
    for _ in range(FOLD_ITERS):
        earlier_und = (edges & undecided[:, None]).any(dim=0)
        earlier_rep = (edges & rep[:, None]).any(dim=0)
        new_rep = undecided & ~earlier_und & ~earlier_rep
        new_member = undecided & earlier_rep
        rep = rep | new_rep
        undecided = undecided & ~new_rep & ~new_member
    rep_np = rep[:w].cpu().numpy()
    converged = not bool(undecided[:w].any())
    return rep_np, converged


def membership_argmax(ani: np.ndarray,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """(best, has) per row of the (non-rep x rep) candidate matrix,
    NaN = not a candidate: the first-maximum column, and whether the
    row had any candidate at all."""
    device = resolve_device(device)
    g, r = ani.shape
    gb, rb = _bucket(g), _bucket(r)
    mat = torch.full((gb, rb), float("nan"), dtype=torch.float64,
                     device=device)
    if g and r:
        mat[:g, :r] = torch.from_numpy(
            np.ascontiguousarray(ani)).to(device)
    scored = torch.where(torch.isnan(mat),
                         torch.full_like(mat, float("-inf")), mat)
    best = torch.argmax(scored, dim=1)
    has = torch.isfinite(scored).any(dim=1)
    return best[:g].cpu().numpy(), has[:g].cpu().numpy()
