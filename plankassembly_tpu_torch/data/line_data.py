"""Line-input dataset (complete and visible modalities): a copy of
`plankassembly_tpu/data/line_data.py` without the packed-sample cache.

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
from plankassembly_tpu_torch.data import geometry as geo
from plankassembly_tpu_torch.data.noise import add_noise
from plankassembly_tpu_torch.data.packing import (
    pack_input_sequence, pack_output_sequence,
)


class LineDataset:
    """Map-style dataset: index -> dict of numpy arrays + 'name'. With
    `augmentation`, a read is corrupted by `add_noise` with probability
    DATA.AUG_RATIO, drawing from `rng` (default numpy's global RNG)."""

    def __init__(self, root: str, info_files: list[str], cfg: Config,
                 augmentation: bool = False, rng=None):
        self.root = root
        self.info_files = info_files
        self.cfg = cfg
        self.augmentation = augmentation
        self.rng = rng or np.random

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
        name, arrays = self._pack(index, augment, rng)
        return {"name": name, **arrays}
