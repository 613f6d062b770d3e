"""Shared numeric constants.

``galah_tpu``'s sentinel ("no hash here", padding or an invalid k-mer)
is the u64 ``0xFFFFFFFFFFFFFFFF``; in the port's biased-int64 hash
domain (``ops/u64.py``) it is INT64_MAX, so it still sorts after every
real hash.
"""

import numpy as np

SENTINEL_BIASED = (1 << 63) - 1

# the same sentinel in galah_tpu's form, for the numpy side (sketches,
# the host collision screen)
SENTINEL_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)

# FracMinHash compression of the screening markers
# (reference: src/skani.rs:158 "let m = 1000")
MARKER_C = 1000
