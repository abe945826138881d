"""Host-side data pipeline: dataset construction, the prefetching epoch
loader, multi-task cycling.

A copy of ``build_dataset``, ``EpochLoader``, ``SequenceChunkLoader`` and
``MultiTaskIterator`` of ``creste_public_tpu/data/dataloader.py``: numpy
batches, collated on the host and prefetched by a background thread while
the card runs the previous step, with the same per-epoch seeded shuffle and
the same per-sample augmentation generator (``_sample_rng``), so that both
packages give the same batches bit for bit, in either worker mode (threads,
or a persistent pool of spawned processes). Under data parallelism each
rank's loader fetches only that rank's rows of every global batch
(``rank``, ``world_size``). ``build_dataset`` gives the synthetic
dataset or the on-disk CODa reader (``data.coda_dataset``).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Any, Callable, Iterator

import numpy as np

from creste_public_tpu_torch.data.synthetic import SyntheticCodaDataset, collate
from creste_public_tpu_torch.parallel.mesh import pad_to_multiple, shard_batch


_PREFETCH = 2  # collated batches kept ready ahead of the consumer


def _sample_rng(seed: int, epoch: int, j: int) -> np.random.Generator:
    """The augmentation generator of sample ``j`` in ``epoch``: the one
    derivation both worker modes use, so that their batches are equal bit
    for bit."""
    return np.random.default_rng((seed + epoch) * 1_000_003 + int(j))


# the state of a process-pool worker (spawned: the module is imported anew
# in each worker)
_WORKER: dict = {}


def _proc_init(dataset, transform, seed):
    _WORKER.update(dataset=dataset, transform=transform, seed=seed)


def _proc_fetch(job):
    """Fetch and transform one sample inside a worker process."""
    epoch, j = job
    s = _WORKER["dataset"][int(j)]
    tf = _WORKER["transform"]
    if tf is not None:
        s = tf(s, _sample_rng(_WORKER["seed"], epoch, j))
    return s


def build_dataset(ds_cfg: Any, split: str = "train", device="cuda"):
    """Dataset factory by config name: 'synthetic' | 'coda' (the whole
    dataset config goes to the reader, which picks its split's list, and
    decodes its frames on ``device``: a card, or ``"cpu"`` for PIL; the
    synthetic dataset ignores it)."""
    name = ds_cfg.get("name", "synthetic")
    if name == "synthetic":
        return SyntheticCodaDataset(
            cfg=ds_cfg.get(split, ds_cfg),
            seed={"train": 0, "val": 1, "test": 2}.get(split, 0),
        )
    if name == "coda":
        from creste_public_tpu_torch.data.coda_dataset import CodaDataset

        return CodaDataset(ds_cfg, split=split, device=device)
    raise ValueError(f"Unknown dataset: {name}")


class EpochLoader:
    """Shuffled, collated, background-prefetched epoch iterator: one
    producer thread keeps ``_PREFETCH`` collated batches ready, fetching the
    samples of a batch on ``num_workers`` threads (``worker_mode="thread"``)
    or through a persistent pool of ``num_workers`` spawned processes
    (``"process"``: the dataset and ``transform`` must pickle, and the
    dataset must decode on the host: a CODa reader that decodes on a card
    is refused there).
    ``transform(sample, rng)`` (augmentation) gets the sample's own
    generator, ``_sample_rng(seed, epoch, j)``.

    With ``world_size`` > 1 the loader is rank ``rank``'s: ``batch_size``
    is the global batch, whose samples every rank orders alike, and it
    fetches only its rows of each (a last partial batch padded first by
    repeating its own samples, as ``pad_to_multiple`` pads the collated
    batch)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 transform: Callable | None = None,
                 num_workers: int = 4, worker_mode: str = "thread",
                 rank: int = 0, world_size: int = 1):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode: {worker_mode!r}")
        if worker_mode == "process" and getattr(
                getattr(dataset, "device", None), "type", None) == "cuda":
            raise ValueError(
                "process-mode loader workers do not decode on the card: "
                "each spawned worker would hold its own CUDA context and "
                "nvJPEG handle on it, and the card's decode already runs "
                "outside the GIL in threads. Use loader_worker_mode=thread, "
                "or trainer.device=cpu (a reader with device='cpu') for "
                "PIL decoding in worker processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.transform = transform
        self.num_workers = max(1, int(num_workers))
        self.worker_mode = worker_mode
        self.rank = rank
        self.world_size = world_size
        self._pool = None

    def _process_pool(self):
        if self._pool is None:
            import multiprocessing as mp

            self._pool = mp.get_context("spawn").Pool(
                self.num_workers, initializer=_proc_init,
                initargs=(self.dataset, self.transform, self.seed))
        return self._pool

    def close(self) -> None:
        """Terminate the persistent process pool (no-op in thread mode)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def rows(self, idxs: list[int]) -> list[int]:
        """This rank's samples of a global batch of samples ``idxs``."""
        if self.world_size == 1:
            return idxs
        padded = pad_to_multiple({"i": np.asarray(idxs)}, self.world_size)
        return [int(j) for j in shard_batch(padded, self.rank,
                                            self.world_size)["i"]]

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
            s = self.dataset[int(j)]
            if self.transform is not None:
                s = self.transform(s, _sample_rng(self.seed, epoch, j))
            return s

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

        def fetch_batch(pool, idxs):
            if self.worker_mode == "process":
                return self._process_pool().map(
                    _proc_fetch, [(epoch, j) for j in idxs])
            if pool is not None:
                return list(pool.map(fetch_one, idxs))
            return [fetch_one(j) for j in idxs]

        def produce():
            # a producer failure reaches the consumer instead of ending the
            # epoch early
            pool_cm = (ThreadPoolExecutor(self.num_workers)
                       if self.worker_mode == "thread"
                       and self.num_workers > 1 else nullcontext())
            try:
                with pool_cm as pool:
                    for i in range(0, end, self.batch_size):
                        if stop.is_set():
                            return
                        idxs = self.rows(
                            [int(j) for j in order[i:i + self.batch_size]])
                        if not put(collate(fetch_batch(pool, idxs))):
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


class MultiTaskIterator:
    """Cycle named task loaders to the longest one (the reference's
    CombinedLoader ``max_size_cycle``, dataloader.py:352-368): per round
    one batch of each task in order, a shorter task's loader restarted on
    the epoch ``epoch + 1000 + count`` (its count-th restart). Yields
    ``(task, batch)``."""

    def __init__(self, loaders: dict[str, EpochLoader]):
        self.loaders = loaders

    def epoch(self, epoch: int = 0) -> Iterator[tuple[str, dict]]:
        iters = {k: v.epoch(epoch) for k, v in self.loaders.items()}
        longest = max(len(v) for v in self.loaders.values())
        counts = dict.fromkeys(iters, 0)
        for _ in range(longest):
            for task in list(iters):
                try:
                    batch = next(iters[task])
                except StopIteration:
                    iters[task] = self.loaders[task].epoch(
                        epoch + 1000 + counts[task])
                    counts[task] += 1
                    batch = next(iters[task])
                yield task, batch
