"""Line-input dataset (complete and visible modalities): a copy of
`plankassembly_tpu/data/line_data.py`.

Reads the per-sample info JSONs of the data factory and packs them into
static-shape token arrays. One relaxation: the `svgs` polylines are parsed
only for an augmented read, the one place they are used, so an info JSON
without them (the serving fixture's) still packs for evaluation.
"""
from __future__ import annotations

import json
import os

import numpy as np

from plankassembly_tpu_torch.config import Config
from plankassembly_tpu_torch.data import cache as sample_cache
from plankassembly_tpu_torch.data import geometry as geo
from plankassembly_tpu_torch.data.noise import add_noise
from plankassembly_tpu_torch.data.packing import (
    pack_input_sequence, pack_output_sequence,
)


class LineDataset:
    """Map-style dataset: index -> dict of numpy arrays + 'name'. With
    `augmentation`, a read is corrupted by `add_noise` with probability
    DATA.AUG_RATIO, drawing from `rng` (default numpy's global RNG).

    cache_dir: a packed-sample cache (`data/cache.py`) of the clean
    samples, built on first use with the JAX dataset's key: clean reads
    come from it, augmented reads pack afresh from the JSON."""

    def __init__(self, root: str, info_files: list[str], cfg: Config,
                 augmentation: bool = False, rng=None,
                 cache_dir: str | None = None):
        self.root = root
        self.info_files = info_files
        self.cfg = cfg
        self.augmentation = augmentation
        self.rng = rng or np.random
        self._cache = None
        if cache_dir:
            key = [type(self).__name__,
                   cfg.DATA.MAX_INPUT_LENGTH, cfg.DATA.MAX_OUTPUT_LENGTH,
                   cfg.DATA.NUM_BITS, cfg.TOKEN.END, cfg.TOKEN.PAD]
            key += sample_cache.split_fingerprint(root, info_files)
            self._cache = sample_cache.build_or_open(
                cache_dir, key, len(info_files),
                lambda i: self._pack(i, False, None)[1], progress_every=5000)

    def __len__(self) -> int:
        return len(self.info_files)

    def _pack(self, index: int, augment: bool, rng):
        with open(os.path.join(self.root, self.info_files[index])) as f:
            info = json.loads(f.read())
        lines = np.array(info["lines"], dtype=np.float64)
        views = np.array(info["views"], dtype=np.int64)
        types = np.array(info["types"], dtype=np.int64)
        planks = np.array(info["coords"]).flatten()
        attach = np.array(info["attach"]).flatten()
        if augment:
            linestrings = [geo.from_geojson(svg) for svg in info["svgs"]]
            linestrings, views, types = add_noise(
                linestrings, views, types, self.cfg.DATA.NOISE_RATIO,
                self.cfg.DATA.NOISE_LENGTH, rng=rng)
            lines = geo.bounds_many(linestrings)
        inputs = pack_input_sequence(lines, views, types, self.cfg.DATA,
                                     self.cfg.TOKEN, with_type=True)
        outputs = pack_output_sequence(planks, attach, self.cfg.DATA,
                                       self.cfg.TOKEN)
        return info["name"], {**inputs, **outputs}

    def __getitem__(self, index: int) -> dict:
        return self.read(index, self.rng)

    def read(self, index: int, rng=None) -> dict:
        """One read, drawing its augmentation from `rng` (default the
        dataset's)."""
        rng = rng or self.rng
        augment = (self.augmentation
                   and rng.random() < self.cfg.DATA.AUG_RATIO)
        if self._cache is not None and not augment:
            return {"name": cached_name(self.info_files[index]),
                    **self._cache.row(index)}
        name, arrays = self._pack(index, augment, rng)
        return {"name": name, **arrays}


def cached_name(info_file: str) -> str:
    """A cached row's name: the info file's base name without extension
    (the JSON is not read)."""
    return os.path.splitext(info_file)[0].split("/")[-1]
