"""Bounded read-ahead: host FASTA reads run beside device work.

The port of ``galah_tpu/io/prefetch.py``'s ``iter_prefetched`` and
``iter_batches`` (``process_stream``'s per-genome branch serves
``galah_tpu``'s CPU backends; the port always groups). Reads run on a pool
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
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple, TypeVar)

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


def iter_batches(
    items: Iterable[Tuple[str, T]],
    size_fn: Callable[[T], int],
    budget: int,
    alone_above: Optional[int] = None,
) -> Iterator[List[Tuple[str, T]]]:
    """Cut a (path, item) stream, in order, into lists whose sizes (per
    `size_fn`) sum to at most `budget`; an item larger than the budget,
    or than `alone_above`, forms a list of its own. Pulls each item
    only when it is needed, so a read-ahead below keeps loading while
    the caller works on a list."""
    buf: List[Tuple[str, T]] = []
    total = 0
    for path, item in items:
        size = int(size_fn(item))
        alone = alone_above is not None and size > alone_above
        if buf and (alone or total + size > budget):
            yield buf
            buf, total = [], 0
        buf.append((path, item))
        total += size
        if alone:
            yield buf
            buf, total = [], 0
    if buf:
        yield buf
