"""Packed-sample cache: memmap-backed snapshots of a packed split; a copy
of `plankassembly_tpu/data/cache.py` with the same layout and digest, so a
cache built by either package is read row for row by the other.

Every sample packs to the same static shapes, so a whole split flattens
into a few fixed-stride arrays: each sample is packed ONCE, the arrays are
kept as `.npy` memmaps, and later epochs (and validation and test, and
other processes) read rows by offset with no JSON parse or packing.
Augmented samples bypass the cache (fresh noise on every read).

Layout: `<cache_dir>/<digest>/meta.json` + one `<field>.npy` per stream.
The digest covers the dataset class, the packing-relevant config, and the
split's file list with every member's size and mtime, so a stale cache is
never read. Builds are atomic (a temporary directory renamed into place);
concurrent builders race benignly (one rename wins).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np

_OPEN_CACHES: dict = {}  # path -> PackedSampleCache (per-process reuse)


def _digest(parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(str(p).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


class PackedSampleCache:
    """Read view over a completed cache directory."""

    def __init__(self, path: str):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.n = self.meta["n"]
        self.fields = {
            name: np.load(os.path.join(path, f"{name}.npy"), mmap_mode="r")
            for name in self.meta["fields"]
        }

    def row(self, i: int) -> dict:
        # copy: rows feed collate/np.stack and must not pin the mmap pages
        return {name: np.array(arr[i]) for name, arr in self.fields.items()}


def build_or_open(cache_dir: str, key_parts, n: int, sample_fn,
                  progress_every: int = 0):
    """Return a PackedSampleCache for `n` samples, building it if absent.

    sample_fn(i) -> dict[str, np.ndarray] with identical shapes/dtypes for
    every i (static-shape contract). Non-array fields must be excluded by
    the caller. Open caches are kept per process by path (the JAX
    package keeps them by digest, so a second `cache_dir` with the same
    digest reads the first directory's files).
    """
    digest = _digest(list(key_parts) + [n, "v1"])
    path = os.path.join(cache_dir, digest)
    hit = _OPEN_CACHES.get(path)
    if hit is not None:
        return hit
    if not os.path.exists(os.path.join(path, "meta.json")):
        _build(path, n, sample_fn, progress_every)
    cache = PackedSampleCache(path)
    _OPEN_CACHES[path] = cache
    return cache


def _build(path: str, n: int, sample_fn, progress_every: int):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".build-", dir=os.path.dirname(path) or ".")
    try:
        first = sample_fn(0)
        writers = {}
        for name, value in first.items():
            value = np.asarray(value)
            writers[name] = np.lib.format.open_memmap(
                os.path.join(tmp, f"{name}.npy"), mode="w+",
                dtype=value.dtype, shape=(n, *value.shape))
            writers[name][0] = value
        for i in range(1, n):
            sample = sample_fn(i)
            for name, w in writers.items():
                w[i] = sample[name]
            if progress_every and i % progress_every == 0:
                print(f"[sample-cache] packed {i}/{n}", flush=True)
        for name, w in writers.items():
            w.flush()
        meta = {"n": n,
                "fields": {name: [list(w.shape[1:]), str(w.dtype)]
                           for name, w in writers.items()}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        del writers
        try:
            os.rename(tmp, path)
        except OSError:
            if os.path.exists(os.path.join(path, "meta.json")):
                shutil.rmtree(tmp, ignore_errors=True)  # lost a benign race
            else:
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def split_fingerprint(root: str, info_files) -> list:
    """Digest parts for a dataset: the root, its mtime, and a hash of the
    file list with every member's (size, mtime). Every member is stat'ed,
    so a JSON rewritten in place (same name) changes the digest; no file
    is opened."""
    try:
        dir_mtime = os.stat(root).st_mtime_ns
    except OSError:
        dir_mtime = 0
    h = hashlib.sha256()
    for name in info_files:
        h.update(name.encode())
        try:
            st = os.stat(os.path.join(root, name))
            h.update(f":{st.st_size}:{st.st_mtime_ns}\0".encode())
        except OSError:
            h.update(b":missing\0")
    return [root, dir_mtime, h.hexdigest()]
