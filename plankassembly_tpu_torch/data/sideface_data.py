"""Side-face dataset (the sideface modality): a copy of
`plankassembly_tpu/data/sideface_data.py`.

Extracts the thin-rectangle "side faces" of the three-view line drawings
and packs their bounds as input tokens, with no line-type stream. Per
view: the faces of the axis-aligned line arrangement
(`geometry.polygonize_bounds`), thin-face detection, and the iterative
merge of colinear faces, whose result depends on its order (the list pops
in reverse index order, the query's bounds grown over the colinear set).

One difference from the JAX dataset: a read draws its augmentation from
an explicit `rng` (`read(index, rng)`, `_pack(index, augment, rng)`), and
in two parts, as the port's `LineDataset` does (`NoisyReads`): the loader
makes each row's draws in turn and leaves the polygonizer to its workers.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from plankassembly_tpu_torch.config import Config
from plankassembly_tpu_torch.data import cache as sample_cache
from plankassembly_tpu_torch.data import geometry as geo
from plankassembly_tpu_torch.data.line_data import NoisyReads
from plankassembly_tpu_torch.data.noise import add_noise
from plankassembly_tpu_torch.data.packing import (
    pack_input_sequence, pack_output_sequence,
)


@dataclass
class Sideface:
    """A detected thin face: a center-line segment and its thickness.

    line_type: 1 = horizontal center line (face thin in y),
               0 = vertical center line (face thin in x).
    """

    p0: np.ndarray
    p1: np.ndarray
    line_width: float
    line_type: int

    @property
    def coords(self) -> np.ndarray:
        return np.stack([self.p0, self.p1])

    def buffer_bounds(self) -> np.ndarray:
        """Bounds of the flat-cap buffer polygon of the center line."""
        d = self.p1 - self.p0
        norm = np.hypot(*d)
        if norm == 0:
            n = np.zeros(2)
        else:
            n = np.array([-d[1], d[0]]) / norm
        r = self.line_width / 2.0
        corners = np.stack([self.p0 + r * n, self.p0 - r * n,
                            self.p1 + r * n, self.p1 - r * n])
        return np.concatenate([corners.min(axis=0), corners.max(axis=0)])


def parse_sideface_from_polygons(face_bounds: np.ndarray,
                                 max_thickness: float) -> list[Sideface]:
    """Thin-rectangle detection from face bounding boxes. A face thin in y
    yields a horizontal center line, thin in x a vertical one (a face may
    yield both)."""
    sidefaces = []
    for b in np.asarray(face_bounds).reshape(-1, 4):
        (xmin, ymin, xmax, ymax) = b
        w, h = xmax - xmin, ymax - ymin
        cx, cy = (xmin + xmax) / 2.0, (ymin + ymax) / 2.0
        if h < max_thickness:
            sidefaces.append(Sideface(np.array([xmin, cy]),
                                      np.array([xmax, cy]), h, 1))
        if w < max_thickness:
            sidefaces.append(Sideface(np.array([cx, ymin]),
                                      np.array([cx, ymax]), w, 0))
    return sidefaces


def merge_colinear_sidefaces(lines: list[Sideface], merge_tolerance: float,
                             min_thickness: float) -> np.ndarray:
    """Merge near-colinear side faces of matching type and width, one
    query at a time, then return the buffer bounds of the survivors at
    least `min_thickness` thick: (K, 4)."""
    merged: list[Sideface] = [lines[0]]

    for query in lines[1:]:
        colinear_indices = []
        for index in range(len(merged)):
            if not geo.segments_intersect_aabb(query.coords,
                                               merged[index].coords):
                continue
            coords = np.concatenate([query.coords, merged[index].coords])
            if ((coords[:, 0].max() - coords[:, 0].min()) < merge_tolerance
                    or (coords[:, 1].max() - coords[:, 1].min())
                    < merge_tolerance) \
                    and abs(query.line_width - merged[index].line_width) \
                    < merge_tolerance \
                    and query.line_type == merged[index].line_type:
                colinear_indices.append(index)

        if colinear_indices:
            coords = np.concatenate(
                [query.coords] + [merged[i].coords for i in colinear_indices])
            lo, hi = coords.min(axis=0), coords.max(axis=0)
            query = Sideface(lo, hi, query.line_width, query.line_type)
            for i in reversed(colinear_indices):
                merged.pop(i)

        merged.append(query)

    kept = [s.buffer_bounds() for s in merged if s.line_width >= min_thickness]
    return np.array(kept, dtype=np.float64).reshape(-1, 4)


def extract_sidefaces(linestrings, views, max_thickness, merge_tolerance,
                      min_thickness):
    """Per view: polygonize, detect thin faces, merge colinear ones.
    Returns (faces (K, 4) float bounds, faceviews (K,) int64)."""
    all_bounds = []
    faceviews = []

    for view_index in range(3):
        view_lines = [l for l, v in zip(linestrings, views) if v == view_index]
        if len(view_lines) == 0:
            continue

        face_bounds = geo.polygonize_bounds(view_lines)
        sidefaces = parse_sideface_from_polygons(face_bounds, max_thickness)
        if len(sidefaces) == 0:
            continue

        merged = merge_colinear_sidefaces(sidefaces, merge_tolerance,
                                          min_thickness)
        all_bounds.append(merged)
        faceviews.extend([view_index] * len(merged))

    if all_bounds:
        faces = np.concatenate(all_bounds, axis=0)
    else:
        faces = np.zeros((0, 4), dtype=np.float64)
    return faces, np.array(faceviews, dtype=np.int64)


class SidefaceDataset(NoisyReads):
    """Map-style dataset for the sideface modality: index -> dict of numpy
    arrays + 'name'.

    Clean extractions are deterministic per sample and kept in a memo;
    only an augmented read (probability DATA.AUG_RATIO with
    `augmentation`) runs the polygonizer on noisy lines. A read whose
    noisy lines give no side face falls back to the clean sample.

    cache_dir: a packed-sample cache (`data/cache.py`) of the clean
    samples, with the JAX dataset's key: clean reads, and the zero-face
    fallback, come from it."""

    def __init__(self, root: str, info_files: list[str], cfg: Config,
                 augmentation: bool = False, rng=None,
                 cache_dir: str | None = None):
        self.root = root
        self.info_files = info_files
        self.cfg = cfg
        self.augmentation = augmentation
        self.rng = rng or np.random

        data = cfg.DATA
        self.max_thickness = data.MAX_THICKNESS / data.SCALE
        self.min_thickness = data.MIN_THICKNESS / data.SCALE
        self.merge_tolerance = data.MERGE_TOLERANCE / data.SCALE
        self._clean_cache: dict[int, tuple] = {}
        self._cache = None
        if cache_dir:
            key = [type(self).__name__,
                   data.MAX_INPUT_LENGTH, data.MAX_OUTPUT_LENGTH,
                   data.NUM_BITS, cfg.TOKEN.END, cfg.TOKEN.PAD,
                   data.MAX_THICKNESS, data.MIN_THICKNESS,
                   data.MERGE_TOLERANCE, data.SCALE]
            key += sample_cache.split_fingerprint(root, info_files)
            self._cache = sample_cache.build_or_open(
                cache_dir, key, len(info_files), self._pack_clean,
                progress_every=2000)

    def _load(self, index: int):
        with open(os.path.join(self.root, self.info_files[index])) as f:
            info = json.loads(f.read())
        name = info["name"]
        linestrings = [geo.from_geojson(svg) for svg in info["svgs"]]
        views = np.array(info["views"], dtype=np.int64)
        types = np.array(info["types"], dtype=np.int64)
        planks = np.array(info["coords"]).flatten()
        attach = np.array(info["attach"]).flatten()
        return name, linestrings, views, types, planks, attach

    def _clean_faces(self, index, linestrings, views):
        if index in self._clean_cache:
            return self._clean_cache[index]
        faces, faceviews = extract_sidefaces(
            linestrings, views, self.max_thickness,
            self.merge_tolerance, self.min_thickness)
        self._clean_cache[index] = (faces, faceviews)
        return faces, faceviews

    def _pack_faces(self, faces, faceviews, planks, attach) -> dict:
        inputs = pack_input_sequence(
            faces, faceviews, None, self.cfg.DATA, self.cfg.TOKEN,
            with_type=False)
        outputs = pack_output_sequence(planks, attach, self.cfg.DATA,
                                       self.cfg.TOKEN)
        return {**inputs, **outputs}

    def _pack_clean(self, index: int) -> dict:
        _, linestrings, views, _, planks, attach = self._load(index)
        faces, faceviews = self._clean_faces(index, linestrings, views)
        return self._pack_faces(faces, faceviews, planks, attach)

    def _noisy(self, index: int, rng):
        loaded = self._load(index)
        _, linestrings, views, types, _, _ = loaded
        noisy_lines, noisy_views, _ = add_noise(
            linestrings, views, types,
            self.cfg.DATA.NOISE_RATIO, self.cfg.DATA.NOISE_LENGTH, rng=rng)
        return loaded, noisy_lines, noisy_views

    def _pack_drawn(self, index: int, drawn):
        """(name, arrays) of one sample, its faces extracted from the noisy
        lines of `drawn` if given; the clean sample if no side face is
        found."""
        faces = np.zeros((0, 4))
        faceviews = np.zeros((0,), dtype=np.int64)
        if drawn is None:
            loaded = self._load(index)
        else:
            loaded, noisy_lines, noisy_views = drawn
            faces, faceviews = extract_sidefaces(
                noisy_lines, noisy_views, self.max_thickness,
                self.merge_tolerance, self.min_thickness)
        name, linestrings, views, _, planks, attach = loaded

        if len(faces) == 0:
            if self._cache is not None:
                return name, self._cache.row(index)
            faces, faceviews = self._clean_faces(index, linestrings, views)

        return name, self._pack_faces(faces, faceviews, planks, attach)
