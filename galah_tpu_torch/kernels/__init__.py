"""Hand-written CUDA kernels of the port and their launch counts.

Each kernel's source sits beside ``build.py``, which compiles it with
``nvcc`` for ``sm_90a`` at its first CUDA use (never at import, and
never on the CPU). Each wrapper in ``ops/`` adds one to its kernel's
entry in ``LAUNCHES`` where it launches the kernel and nowhere else,
so a run can show that its main path went through the kernels; an
entry of ``ENTRIES`` is counted under its own name.
"""

from __future__ import annotations

from typing import Dict

KERNELS = ("window_hits", "tile_stats", "fused_sketch", "pairlist",
           "hll_union", "murmur3_k21", "positional_hashes", "slab_fold")

#: further entries of a kernel's library counted apart from it: the
#: gathered-tile entry of ``tile_stats.cu`` (the survivor strategy
#: ``gather``), whose launches are not the full form's
ENTRIES = ("tile_stats_gather",)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS + ENTRIES}


def reset_launches() -> None:
    for name in KERNELS + ENTRIES:
        LAUNCHES[name] = 0
