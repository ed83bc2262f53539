"""Device-resident training data (`plankassembly_tpu/data/device_loader.py`):
the packed split lives on the card, and each training batch is assembled
there from an index vector.

The whole cached split (`data/cache.py`) is copied to the device once, its
token streams as int16 (every token value is below VOCAB_SIZE +
MAX_OUTPUT_LENGTH = 642 < 2^15). A step then sends only its row indices
and its augmented rows: the batch is gathered on the device by index, and
the augmented rows are written over it at their positions.

The order and the augmentation draws follow the JAX loader exactly: one
`np.random.default_rng(seed)` gives each epoch's permutation and, per
batch, one Bernoulli(AUG_RATIO) draw per row; at most `max_aug_rows` of
the chosen rows are packed afresh with noise (the others stay clean) on a
one-deep producer thread. The augmented rows are packed by the dataset's
`_pack(index, True, rng)` with the dataset's own `rng`.

One difference from the JAX loader: a step's indices, positions and
augmented rows go to the device as separate small copies, and only the
rows in use are sent. The JAX loader packs them into one flat int16
buffer of a fixed size to spare a remote-TPU transport its round trips;
a local card has no such cost per copy.

Training only (shuffle and drop_last); evaluation keeps `DataLoader`.
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

# the token streams held as int16 on the device
INT16_KEYS = frozenset((
    "input_value", "input_pos", "input_coord", "input_view", "input_type",
    "output_value", "output_label",
))


def _narrow(key: str, value: np.ndarray) -> np.ndarray:
    if key in INT16_KEYS and value.dtype in (np.int64, np.int32):
        return value.astype(np.int16)
    if value.dtype == np.int64:
        return value.astype(np.int32)
    return value


def assemble(fields: dict, idx: torch.Tensor, aug: dict,
             pos: torch.Tensor) -> dict:
    """The batch of rows `idx` (B,) of the resident split, with the rows
    `aug[key]` (K, ...) written at positions `pos` (K,). Integer streams
    come back as int64, the dtype the host loader gives."""
    out = {}
    for key, store in fields.items():
        b = store.index_select(0, idx)
        if pos.numel():
            b.index_copy_(0, pos, aug[key])
        out[key] = b.long() if b.dtype in (torch.int16, torch.int32) else b
    return out


class DeviceDataLoader:
    """Iterable of training batches assembled on `device`.

    dataset: a `LineDataset` or `SidefaceDataset`; its `_pack` makes the
    augmented rows only, the clean rows come from `cache` (a
    `PackedSampleCache` of the same split). Each yielded batch holds
    `idx` (B,) int64, `pos` (K,) int64 and `aug` {key: (K, ...)} on the
    device, K <= max_aug_rows, and the rows' `name`s; `materialize`
    assembles it."""

    def __init__(self, dataset, cache, batch_size: int, device, seed: int = 0,
                 max_aug_rows: int = 16):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.max_aug_rows = max_aug_rows
        self.names = [os.path.splitext(f)[0].split("/")[-1]
                      for f in dataset.info_files]
        host = {key: _narrow(key, np.asarray(arr))
                for key, arr in cache.fields.items()}
        # a field kept at its dtype is still the read-only memmap
        host = {key: a if a.flags.writeable else a.copy()
                for key, a in host.items()}
        self.row_layout = {key: (a.shape[1:], a.dtype)
                           for key, a in host.items()}
        # one copy of the whole split
        self.fields = {key: torch.from_numpy(a).to(self.device)
                       for key, a in host.items()}
        self.aug_ratio = (dataset.cfg.DATA.AUG_RATIO
                          if dataset.augmentation else 0.0)

    def __len__(self) -> int:
        return len(self.names) // self.batch_size  # drop_last

    def close(self):
        """Nothing to release (the producer thread ends with its epoch);
        the surface of `DataLoader`."""

    def _aug_rows(self, idx: np.ndarray):
        """This batch's augmented rows, packed on the host: (positions
        (K,), {key: rows (K, ...)}) with K <= max_aug_rows."""
        pos: list[int] = []
        packed: list[dict] = []
        if self.aug_ratio > 0.0:
            draw = self.rng.random(len(idx)) < self.aug_ratio
            for j in np.flatnonzero(draw)[: self.max_aug_rows]:
                _, arrays = self.dataset._pack(int(idx[j]), True,
                                               self.dataset.rng)
                pos.append(int(j))
                packed.append(arrays)
        aug = {}
        for key, (shape, dtype) in self.row_layout.items():
            rows = np.zeros((len(packed), *shape), dtype=dtype)
            for r, arrays in enumerate(packed):
                rows[r] = arrays[key]
            aug[key] = rows
        return np.asarray(pos, np.int64), aug

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def __iter__(self):
        # one-deep producer thread: the augmented rows' JSON reads and
        # packing overlap the device's work. A stop event, checked around
        # the bounded put, ends the producer when the consumer leaves early
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                order = self.rng.permutation(len(self.names))
                for start in range(0, len(order), self.batch_size):
                    if stop.is_set():
                        return
                    idx = order[start:start + self.batch_size]
                    if len(idx) < self.batch_size:
                        break  # drop_last
                    pos, aug = self._aug_rows(idx)
                    if not _put((idx, pos, aug)):
                        return
                _put(sentinel)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                _put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                idx, pos, aug = item
                yield {"idx": self._to_device(idx.astype(np.int64)),
                       "pos": self._to_device(pos),
                       "aug": {k: self._to_device(v) for k, v in aug.items()},
                       "name": [self.names[i] for i in idx]}
        finally:
            stop.set()
            thread.join()

    def materialize(self, batch: dict) -> dict:
        """The yielded batch assembled into tensors on the device, with
        its names."""
        out = assemble(self.fields, batch["idx"], batch["aug"], batch["pos"])
        out["name"] = batch["name"]
        return out
