"""Host-side batching (`plankassembly_tpu/data/loader.py`).

Numpy collation with the JAX loader's batch order (a seeded
`np.random.default_rng` shuffle, `drop_last`, a fixed `order`,
`pad_to_batch`), threaded sample packing and a one-deep prefetch thread.
Batches stay numpy on the host; the trainer moves them to its device.

In a process group every rank iterates the same global batches (the same
seed gives the same permutation) and packs only its own rows of each,
`rows=(lo, hi)` (`parallel.multihost.owned_row_range`), as the JAX loader
packs its process's rows.
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np


def parse_splits_list(splits) -> list[str]:
    """Expand .txt split files (and .json names) into a list of info-JSON
    names."""
    if isinstance(splits, str):
        splits = splits.split()
    info_files: list[str] = []
    for split in splits:
        ext = os.path.splitext(split)[1]
        if ext == ".json":
            info_files.append(split)
        elif ext == ".txt":
            with open(split) as f:
                info_files += [line.rstrip() for line in f]
        else:
            raise NotImplementedError(f"{split} not a valid info_file type")
    return info_files


def collate(samples: list[dict]) -> dict:
    """Stack per-sample dicts: arrays along a new leading axis; other
    fields ('name') stay lists."""
    batch: dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        batch[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) \
            else vals
    return batch


class DataLoader:
    """Batched loader: shuffling, drop_last, a fixed order, padding of the
    last batch, threaded workers and a prefetch thread. The dataset makes
    one sample with `read(index, rng)`.

    For a dataset with `augmentation`, each read gets a RandomState of its
    own, seeded in index order from the dataset's `rng`, so what a batch
    draws does not depend on the number of workers or their scheduling.
    The seeds of every row of the global batch are drawn, so a rank that
    packs `rows` (lo, hi) of it packs exactly what one process packs
    there, augmentation included."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, order=None,
                 num_workers: int = 0, pad_to_batch: bool = False,
                 rows: tuple[int, int] | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        # pad_to_batch: a short last batch repeats row 0; the bool field
        # 'sample_valid' marks the real rows
        self.pad_to_batch = pad_to_batch
        self.rows = rows or (0, batch_size)
        self.order = None if order is None else np.asarray(order)
        # threads, not processes: file reads and numpy release the GIL
        self.num_workers = int(num_workers)
        self._pool = None

    def _get_samples(self, idx) -> list[dict]:
        """The samples of this loader's `rows` of the global batch `idx`."""
        idx = [int(i) for i in idx]
        if getattr(self.dataset, "augmentation", False):
            seeds = self.dataset.rng.randint(0, 2 ** 31 - 1, size=len(idx))
            rngs = [np.random.RandomState(s) for s in seeds]
        else:
            rngs = [None] * len(idx)
        lo, hi = self.rows
        idx, rngs = idx[lo:hi], rngs[lo:hi]
        if self.num_workers > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_workers,
                    thread_name_prefix="loader-worker")
            return list(self._pool.map(self.dataset.read, idx, rngs))
        return [self.dataset.read(i, rng) for i, rng in zip(idx, rngs)]

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        order = self.order if self.order is not None \
            else np.arange(len(self.dataset))
        if self.shuffle:
            order = order.copy()
            self.rng.shuffle(order)
        lo, hi = self.rows
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            if self.pad_to_batch:
                # a short last batch repeats its first row
                valid = np.arange(self.batch_size) < len(idx)
                idx = np.concatenate([idx, np.repeat(
                    idx[:1], self.batch_size - len(idx))])
            batch = collate(self._get_samples(idx))
            if self.pad_to_batch:
                batch["sample_valid"] = valid[lo:hi]
                batch["_local_valid"] = valid[lo:hi]
            yield batch

    def __iter__(self):
        # one-deep producer thread: packs the next batch while the
        # consumer computes on this one; its exception is re-raised here
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()
        stop = threading.Event()

        def producer():
            try:
                for batch in self._batches():
                    if stop.is_set():
                        return
                    q.put(batch)
                q.put(sentinel)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # unblock a producer waiting to put
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()


def pad_batch_to(batch: dict, batch_size: int) -> tuple[dict, np.ndarray]:
    """Pad a short batch to `batch_size` by repeating row 0 of every array
    and list field. Returns (padded batch, valid mask)."""
    some = next(v for v in batch.values() if isinstance(v, np.ndarray))
    n = some.shape[0]
    valid = np.zeros(batch_size, dtype=bool)
    valid[:n] = True
    if n == batch_size:
        return batch, valid
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            out[key] = np.concatenate(
                [value, np.repeat(value[:1], batch_size - n, axis=0)])
        elif isinstance(value, list):
            out[key] = value + value[:1] * (batch_size - n)
        else:
            out[key] = value
    return out, valid
