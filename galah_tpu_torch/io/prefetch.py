"""Bounded read-ahead: host FASTA reads run beside device work.

The port of ``galah_tpu/io/prefetch.py``'s ``iter_prefetched``
(``iter_batches`` and ``process_stream`` serve ``galah_tpu``'s batched
profile build, which the port does not have yet). Reads run on a pool
of worker threads; the C parser and the standard library's gzip
release the interpreter lock, so `depth` reads parse at once. Items come back in
order, an exception surfaces at the failing item's turn, and an
abandoned stream (closed, or left by an exception) cancels its queued
reads and waits out the running ones before it returns.

Only the consumer thread touches CUDA tensors: the pool threads return
host arrays, and the caller builds profiles and sketches from them.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence, Tuple, TypeVar

T = TypeVar("T")


def ingest_depth(threads: int) -> int:
    """FASTA reads in flight ahead of the consumer: ``max(2, threads)``
    (deep enough to keep `threads` parsers busy, shallow enough to bound
    the parsed genomes held at once)."""
    return max(2, threads)


def _settle(futures: Iterable[Future]) -> None:
    """Cancel queued futures and wait out the running ones; their
    errors have no consumer left and are dropped."""
    for f in futures:
        if not f.cancel():
            f.exception()


def iter_prefetched(
    paths: Sequence[str],
    load_fn: Callable[[str], T],
    depth: int = 2,
) -> Iterator[Tuple[str, T]]:
    """Yield (path, load_fn(path)) in order, loading up to `depth`
    ahead on worker threads."""
    depth = max(1, int(depth))
    if not paths:
        return
    pending = []
    with ThreadPoolExecutor(max_workers=depth,
                            thread_name_prefix="galah-read") as pool:
        try:
            for idx in range(min(depth, len(paths))):
                pending.append(pool.submit(load_fn, paths[idx]))
            for i, path in enumerate(paths):
                fut = pending.pop(0)
                nxt = i + depth
                if nxt < len(paths):
                    pending.append(pool.submit(load_fn, paths[nxt]))
                yield path, fut.result()
        finally:
            _settle(pending)
