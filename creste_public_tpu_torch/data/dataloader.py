"""Host-side data pipeline: dataset construction and the prefetching epoch
loader.

A copy of ``build_dataset`` and ``EpochLoader`` (thread mode) of
``creste_public_tpu/data/dataloader.py``: numpy batches, collated on the
host and prefetched by a background thread while the card runs the previous
step, with the same per-epoch seeded shuffle, so that both packages give the
same batches bit for bit, and ``SequenceChunkLoader``, the temporal
mini-sequence batches. The CODa reader, augmentation (with its per-sample
rng), the process-pool workers and ``MultiTaskIterator`` are not ported
yet.
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


class SequenceChunkLoader:
    """Temporal mini-sequence batches for ConvGRU training (the JAX
    package's ``SequenceChunkLoader``): the dataset is cut into windows of
    ``seq_len`` consecutive samples, a batch takes ``batch_size`` windows
    (shuffled per epoch with the same seed rule) and yields each window's
    ``seq_len // chunk_len`` chunks in order. The frame keys (image, p2p,
    depth_label, fimg_label) are stacked on a [B, T, ...] time axis (a
    sample's singleton view axis folds into it); every other key is the
    chunk's last frame's; ``bos`` [B] bool is True on a window's first
    chunk only, where the hidden state starts from zeros."""

    FRAME_KEYS = ("image", "p2p", "depth_label", "fimg_label")

    def __init__(self, dataset, batch_size: int, seq_len: int,
                 chunk_len: int, shuffle: bool = True, seed: int = 0):
        if seq_len % chunk_len:
            raise ValueError("seq_len must be divisible by chunk_len")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.chunk_len = chunk_len
        self.shuffle = shuffle
        self.seed = seed
        self.windows = list(range(0, len(dataset) - seq_len + 1, seq_len))

    def __len__(self) -> int:
        per_seq = self.seq_len // self.chunk_len
        return (len(self.windows) // self.batch_size) * per_seq

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        order = np.asarray(self.windows)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        n_seq = len(order) - (len(order) % self.batch_size)
        per_seq = self.seq_len // self.chunk_len
        for i in range(0, n_seq, self.batch_size):
            starts = order[i:i + self.batch_size]
            for c in range(per_seq):
                frames = [[self.dataset[int(s + c * self.chunk_len + t)]
                           for t in range(self.chunk_len)] for s in starts]
                last = frames[0][-1]
                batch: dict = {}
                for k in last:
                    if k in self.FRAME_KEYS:
                        batch[k] = np.stack([
                            np.concatenate([np.asarray(f[k]) for f in seq])
                            for seq in frames])
                    elif isinstance(last[k], dict):
                        batch[k] = collate([seq[-1][k] for seq in frames])
                    else:
                        batch[k] = np.stack([np.asarray(seq[-1][k])
                                             for seq in frames])
                batch["bos"] = np.full((len(starts),), c == 0)
                yield batch
