"""Host-side loop for blocked sparse extraction (the port of
``galah_tpu/ops/compact.py``): one device pass per row block returns at
most `cap` compacted candidates plus the true passing count, and the
host reruns a block whose candidates overflowed with a larger
capacity. The cap bounds what one block copies back to the host."""

from __future__ import annotations

from typing import Callable, Iterator, Tuple


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def iter_blocks(
    n: int,
    row_tile: int,
    cap_per_row: int,
    run_block: Callable[[int, int], Tuple],
) -> Iterator[Tuple[int, Tuple]]:
    """Yield (r0, result) per row block, retrying on overflow.

    `run_block(r0, cap)` returns a tuple whose LAST element is the true
    passing count (an int); a count above `cap` reruns the block with
    the next power-of-two capacity that holds it.
    """
    for r0 in range(0, n, row_tile):
        cap = _pow2_at_least(cap_per_row * row_tile)
        while True:
            result = run_block(r0, cap)
            count = int(result[-1])
            if count <= cap:
                break
            cap = _pow2_at_least(max(2 * cap, count))
        yield r0, result
