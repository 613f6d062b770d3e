"""Build and bind the port's collision counter
(``galah_tpu_torch/csrc/collision.c``, a copy of ``csrc/collision.c``):
the port of ``galah_tpu/ops/_ccollision.py``.

``collision_pair_counts_c(mat, lens, big_run)`` is the compiled twin of
``ops/collision._collision_pair_counts_np``: a radix sort of the
(hash, row) multiset and a walk of its runs with a hash map of pair
counts, in place of numpy's argsort, fancy indexing and ``np.unique``
compaction (``galah_tpu`` measured the numpy route at 249 s at
N = 100k). Its triples equal numpy's, in the same order.

The source compiles at first use with ``$CC`` (default ``gcc``) into
``galah_tpu_torch/_build/libcollision-<hash>.so`` through
``io/_cingest.build``. A build or load failure raises with the
compiler's output; nothing drops to numpy. ``GALAH_TPU_NO_CCOLLISION=1``
is the explicit way to ask ``ops/collision.collision_pair_counts`` for
the numpy version.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from galah_tpu_torch.io import _cingest

SOURCE = os.path.join(_cingest._PKG, "csrc", "collision.c")

_LIB = None
_LOCK = threading.Lock()

# Concurrency contract (GL8xx lint and the GALAH_SAN sanitizer): the
# first build and binding happen once, under _LOCK (never held while
# another lock is taken).
GUARDED_BY = {"_LIB": "_LOCK"}
LOCK_ORDER = ["_LOCK"]


def load() -> ctypes.CDLL:
    """The bound counter library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_cingest.build(
                SOURCE, _cingest.BUILD_DIR, stem="collision",
                what="C collision counter"))
            fn = lib.galah_collision_pair_counts
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ]
            _LIB = lib
        return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def collision_pair_counts_c(mat: np.ndarray, lens: np.ndarray,
                            big_run: int):
    """Exact |A ∩ B| for every colliding row pair: (pi, pj, counts),
    int64, pi < pj, ordered by (pi, pj) as numpy's ``np.unique`` keys
    are."""
    fn = load().galah_collision_pair_counts
    mat = np.ascontiguousarray(mat, dtype=np.uint64)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    n, width = mat.shape
    empty = (np.zeros(0, np.int64),) * 3
    if n == 0 or int(lens64.sum()) == 0:
        return empty
    # the first call reports the distinct pairs it found; a second one
    # with that capacity always fits
    cap = max(1 << 20, 16 * n)
    for _ in range(2):
        pi = np.empty(cap, dtype=np.int64)
        pj = np.empty(cap, dtype=np.int64)
        counts = np.empty(cap, dtype=np.int64)
        found = fn(_ptr(mat, ctypes.c_uint64), n, width,
                   _ptr(lens64, ctypes.c_int64), int(big_run),
                   _ptr(pi, ctypes.c_int64), _ptr(pj, ctypes.c_int64),
                   _ptr(counts, ctypes.c_int64), cap)
        if found < 0:
            raise MemoryError("galah_collision_pair_counts: out of memory")
        if found <= cap:
            break
        cap = int(found)
    else:
        raise RuntimeError("collision pair capacity still insufficient")
    if found == 0:
        return empty
    pi, pj, counts = pi[:found], pj[:found], counts[:found]
    order = np.argsort(pi * n + pj)
    return pi[order], pj[order], counts[order]
