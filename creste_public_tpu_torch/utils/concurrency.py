"""Host-side parallel mapping for the preprocessing entry points.

Counterpart of ``creste_public_tpu/utils/concurrency.py``: per-frame work
fans over a pool, the in-process equivalent of the reference's
multiprocessing Pool(24) (build_dense_depth.py:574). Two modes:

  * ``thread``: for bodies that release the GIL (file I/O, image decode,
    torch kernels on the card). Threads share the parent's CUDA context.
  * ``process``: a ``spawn`` pool for GIL-bound NumPy/PIL bodies; ``fn``
    and the items must pickle (a module-level function and plain data). A
    forked child cannot use CUDA, so the pool never forks.
"""
from __future__ import annotations

from typing import Callable, Iterable, Literal, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def parallel_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    workers: int = 1,
    mode: Literal["thread", "process"] = "thread",
) -> list[R]:
    """map(fn, items) on ``workers`` threads or processes, in order.

    workers <= 1 (or a single item) runs in the caller, one item at a time.
    """
    items = list(items)
    if workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    if mode == "process":
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        chunk = max(1, len(items) // (workers * 4))
        with ProcessPoolExecutor(workers,
                                 mp_context=mp.get_context("spawn")) as ex:
            return list(ex.map(fn, items, chunksize=chunk))
    if mode != "thread":
        raise ValueError(f"unknown mode {mode!r}")
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, items))
