"""Host-side data pipeline: dataset construction and the prefetching epoch
loader.

A copy of ``build_dataset`` and ``EpochLoader`` (thread mode) of
``creste_public_tpu/data/dataloader.py``: numpy batches, collated on the
host and prefetched by a background thread while the card runs the previous
step, with the same per-epoch seeded shuffle, so that both packages give the
same batches bit for bit. The CODa reader, augmentation (with its
per-sample rng), the process-pool workers, ``MultiTaskIterator`` and
``SequenceChunkLoader`` are not ported yet.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Any, Iterator

import numpy as np

from creste_public_tpu_torch.data.synthetic import SyntheticCodaDataset, collate


_PREFETCH = 2  # collated batches kept ready ahead of the consumer


def build_dataset(ds_cfg: Any, split: str = "train"):
    """Dataset factory by config name: 'synthetic' ('coda' is not ported
    yet)."""
    name = ds_cfg.get("name", "synthetic")
    if name == "synthetic":
        return SyntheticCodaDataset(
            cfg=ds_cfg.get(split, ds_cfg),
            seed={"train": 0, "val": 1, "test": 2}.get(split, 0),
        )
    if name == "coda":
        raise NotImplementedError("the CODa dataset is not ported yet")
    raise ValueError(f"Unknown dataset: {name}")


class EpochLoader:
    """Shuffled, collated, background-prefetched epoch iterator: one
    producer thread keeps ``_PREFETCH`` collated batches ready, fetching the
    samples of a batch on ``num_workers`` threads."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 num_workers: int = 4, worker_mode: str = "thread"):
        if worker_mode != "thread":
            raise NotImplementedError(
                f"worker_mode {worker_mode!r}: only 'thread' is ported")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, int(num_workers))

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        end = n - (n % self.batch_size) if self.drop_last else n

        q: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()
        error: list[BaseException] = []

        def fetch_one(j: int) -> dict:
            return self.dataset[int(j)]

        def put(item) -> bool:
            """Bounded put that gives up once the consumer has left the
            epoch (else the producer blocks on a full queue forever)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # a producer failure reaches the consumer instead of ending the
            # epoch early
            pool_cm = (ThreadPoolExecutor(self.num_workers)
                       if self.num_workers > 1 else nullcontext())
            try:
                with pool_cm as pool:
                    for i in range(0, end, self.batch_size):
                        if stop.is_set():
                            return
                        idxs = [int(j) for j in order[i:i + self.batch_size]]
                        samples = (list(pool.map(fetch_one, idxs)) if pool
                                   else [fetch_one(j) for j in idxs])
                        if not put(collate(samples)):
                            return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                error.append(e)
            finally:
                put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()

    def __iter__(self):
        return self.epoch(0)
