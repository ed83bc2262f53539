"""Raster-image inputs: rasterize the three views of a line drawing, on the
host or on the device, and the raster dataset; the port's copy of
`plankassembly_tpu/data/raster.py`.

The raster/ViT modality reads images of the three orthographic views in
place of line tokens: a (3, S, S) float image, one channel per view,
visible lines at 1.0 and hidden ones at 0.5. `rasterize_lines` draws on
the host (the native rasterizer when `native/libplankgeom.so` has it,
else a supersampled numpy splat); `pack_lines` packs a drawing's segments
into fixed-shape arrays that `rasterize_device` draws on the device.
"""
from __future__ import annotations

import json
import os
import warnings

import numpy as np
import torch

from plankassembly_tpu_torch.config import Config
from plankassembly_tpu_torch.data import cache as sample_cache
from plankassembly_tpu_torch.data import geometry as geo
from plankassembly_tpu_torch.data.line_data import NoisyReads
from plankassembly_tpu_torch.data.noise import add_noise
from plankassembly_tpu_torch.data.packing import pack_output_sequence

# the packed raster inputs of a sample (`pack_lines`), or its host image
RASTER_KEYS = ("input_image", "input_lines", "input_line_view",
               "input_line_inten")


def rasterize_lines(lines, types, image_size: int = 256,
                    world_extent: float = 1.0,
                    supersample: int = 2) -> np.ndarray:
    """Draw polylines (world coordinates in [-extent, extent]) into
    (S, S) floats: visible lines (type 0) at 1.0, hidden (type 1) at 0.5,
    overlaps taking the max. Supersampled splatting keeps thin geometry
    visible at any angle without an anti-aliasing kernel."""
    from plankassembly_tpu_torch.factory import native
    if native.available():
        intensities = [1.0 if t == 0 else 0.5 for t in types]
        out = native.rasterize(list(lines), intensities, image_size,
                               supersample, world_extent)
        if out is not None:
            return out

    ss = image_size * supersample
    img = np.zeros((ss, ss), dtype=np.float32)
    scale = ss / (2.0 * world_extent)

    for line, line_type in zip(lines, types):
        line = np.asarray(line, dtype=np.float64)
        intensity = 1.0 if line_type == 0 else 0.5
        for k in range(len(line) - 1):
            p, q = line[k], line[k + 1]
            length = np.hypot(*(q - p))
            n = max(2, int(np.ceil(length * scale * 2)))
            ts = np.linspace(0.0, 1.0, n)
            pts = p[None, :] + ts[:, None] * (q - p)[None, :]
            xi = np.clip(((pts[:, 0] + world_extent) * scale).astype(int),
                         0, ss - 1)
            yi = np.clip(((pts[:, 1] + world_extent) * scale).astype(int),
                         0, ss - 1)
            np.maximum.at(img, (yi, xi), intensity)

    if supersample > 1:
        img = img.reshape(image_size, supersample,
                          image_size, supersample).max(axis=(1, 3))
    return img


def rasterize_views(linestrings, views, types,
                    image_size: int = 256) -> np.ndarray:
    """(3, S, S): one channel per orthographic view."""
    out = np.zeros((3, image_size, image_size), dtype=np.float32)
    for v in range(3):
        vl = [l for l, vi in zip(linestrings, views) if vi == v]
        vt = [t for t, vi in zip(types, views) if vi == v]
        if vl:
            out[v] = rasterize_lines(vl, vt, image_size)
    return out


def pack_lines(linestrings, views, types, max_lines: int) -> dict:
    """A drawing's segments as fixed-shape arrays for `rasterize_device`:
    endpoints `input_lines` (N, 4) f32 [x0, y0, x1, y1], `input_line_view`
    (N,) int32, `input_line_inten` (N,) f32 (1.0 visible, 0.5 hidden, 0.0
    padding). The device rasterizer draws axis-aligned segments only: a
    segment within 1e-4 of an axis snaps to it, and a diagonal one is
    dropped with a warning (a missing line, the corruption the delete
    augmentation trains against). Segments past `max_lines` are dropped
    with a warning, as the token path caps its length."""
    segs, seg_views, seg_inten = [], [], []
    dropped = 0
    for line, view, line_type in zip(linestrings, views, types):
        line = np.asarray(line, dtype=np.float32)
        inten = 1.0 if line_type == 0 else 0.5
        for k in range(len(line) - 1):
            p, q = line[k], line[k + 1]
            dx, dy = abs(p[0] - q[0]), abs(p[1] - q[1])
            if dx >= 1e-7 and dy >= 1e-7:
                if min(dx, dy) <= 1e-4:  # snap float jitter
                    if dx < dy:
                        q = (p[0], q[1])
                    else:
                        q = (q[0], p[1])
                else:
                    dropped += 1
                    continue
            segs.append((p[0], p[1], q[0], q[1]))
            seg_views.append(view)
            seg_inten.append(inten)
    if dropped:
        warnings.warn(f"pack_lines: dropped {dropped} non-axis-aligned "
                      "segment(s); device rasterization is axis-aligned only")
    n = len(segs)
    if n > max_lines:
        warnings.warn(f"pack_lines: {n} segments exceed max_lines="
                      f"{max_lines}; truncating")
        segs, seg_views, seg_inten = (segs[:max_lines], seg_views[:max_lines],
                                      seg_inten[:max_lines])
        n = max_lines
    lines_arr = np.zeros((max_lines, 4), np.float32)
    views_arr = np.zeros((max_lines,), np.int32)
    inten_arr = np.zeros((max_lines,), np.float32)
    if n:
        lines_arr[:n] = np.asarray(segs, np.float32)
        views_arr[:n] = np.asarray(seg_views, np.int32)
        inten_arr[:n] = np.asarray(seg_inten, np.float32)
    return {"input_lines": lines_arr, "input_line_view": views_arr,
            "input_line_inten": inten_arr}


def rasterize_device(lines, views, intens, image_size: int,
                     supersample: int = 2, world_extent: float = 1.0):
    """Rasterize axis-aligned segments on the tensors' device, pixel for
    pixel what `rasterize_lines` draws.

    An axis-aligned segment's supersampled splat covers a row interval
    times a column interval, and the max-pool of that outer product is the
    outer product of the pooled intervals. So the coverage counts per
    (view, intensity class) are plain batched matrix products:

        count[b, k, i, j] = sum_n row[b, n, i] * class_k[b, n] * col[b, n, j]
        pixel = 1.0 if any visible count, else 0.5 if any hidden, else 0.

    lines (B, N, 4) f32, views (B, N) int, intens (B, N) f32 in {0, .5, 1}.
    Returns (B, 3, S, S) f32. The counts are f32 products of 0/1 operands
    (exact below 2^24; the JAX package multiplies them in bf16 into f32).
    """
    S = image_size
    ss = S * supersample
    scale = ss / (2.0 * world_extent)

    def to_cell(a):  # world coordinate -> output pixel (the splat's rule)
        cells = torch.clamp(torch.floor((a + world_extent) * scale), 0, ss - 1)
        return cells.to(torch.int32) // supersample

    x_lo = to_cell(torch.minimum(lines[..., 0], lines[..., 2]))
    x_hi = to_cell(torch.maximum(lines[..., 0], lines[..., 2]))
    y_lo = to_cell(torch.minimum(lines[..., 1], lines[..., 3]))
    y_hi = to_cell(torch.maximum(lines[..., 1], lines[..., 3]))

    idx = torch.arange(S, dtype=torch.int32, device=lines.device)
    rows = (idx >= y_lo[..., None]) & (idx <= y_hi[..., None])  # (B, N, S)
    cols = (idx >= x_lo[..., None]) & (idx <= x_hi[..., None])  # (B, N, S)

    view_oh = views[..., None] == torch.arange(3, device=lines.device)
    vis = intens >= 0.75
    hid = (intens > 0.0) & ~vis
    cls = torch.stack([vis, hid], dim=-1)                       # (B, N, 2)
    B, N = intens.shape
    w6 = (view_oh[..., None] & cls[:, :, None, :]).reshape(B, N, 6)

    rows6 = (rows[:, :, None, :] & w6[..., None]).float()       # (B, N, 6, S)
    counts = torch.bmm(rows6.reshape(B, N, 6 * S).transpose(1, 2),
                       cols.float())                           # (B, 6S, S)
    counts = counts.reshape(B, 3, 2, S, S)
    any_vis = counts[:, :, 0] > 0.5
    any_hid = counts[:, :, 1] > 0.5
    return torch.where(any_vis, 1.0, torch.where(any_hid, 0.5, 0.0))


class RasterDataset(NoisyReads):
    """Map-style dataset of the raster/ViT modality: index -> the packed
    segments (`pack_lines`; `device_rasterize=True`, the default) or a
    host-drawn `input_image` (False), beside the same shape-program
    targets as the line modalities, and 'name'. With `augmentation`, a
    read is corrupted by `add_noise` with probability DATA.AUG_RATIO,
    drawing from `rng` (default numpy's global RNG).

    cache_dir (with device_rasterize): a packed-sample cache
    (`data/cache.py`) of the clean samples with the JAX dataset's key, so
    either package reads a cache the other built."""

    def __init__(self, root: str, info_files: list[str], cfg: Config,
                 augmentation: bool = False, rng=None,
                 image_size: int = 256, device_rasterize: bool = True,
                 cache_dir: str | None = None):
        self.root = root
        self.info_files = info_files
        self.cfg = cfg
        self.augmentation = augmentation
        self.rng = rng or np.random
        self.image_size = image_size
        self.device_rasterize = device_rasterize
        # every input token quadruple is one segment, so the token budget
        # bounds the segment count
        self.max_lines = cfg.DATA.MAX_INPUT_LENGTH // cfg.DATA.NUM_INPUT_DOF
        self._cache = None
        if cache_dir and device_rasterize:
            key = [type(self).__name__, self.max_lines,
                   cfg.DATA.MAX_OUTPUT_LENGTH, cfg.DATA.NUM_BITS,
                   cfg.TOKEN.END, cfg.TOKEN.PAD]
            key += sample_cache.split_fingerprint(root, info_files)
            self._cache = sample_cache.build_or_open(
                cache_dir, key, len(info_files),
                lambda i: self._pack(i, False, None)[1], progress_every=5000)

    def _load(self, index: int):
        with open(os.path.join(self.root, self.info_files[index])) as f:
            info = json.loads(f.read())
        linestrings = [geo.from_geojson(svg) for svg in info["svgs"]]
        views = np.array(info["views"], dtype=np.int64)
        types = np.array(info["types"], dtype=np.int64)
        return info, linestrings, views, types

    def _noisy(self, index: int, rng):
        info, linestrings, views, types = self._load(index)
        return (info, *add_noise(linestrings, views, types,
                                 self.cfg.DATA.NOISE_RATIO,
                                 self.cfg.DATA.NOISE_LENGTH, rng=rng))

    def _pack_drawn(self, index: int, drawn):
        info, linestrings, views, types = drawn or self._load(index)
        planks = np.array(info["coords"]).flatten()
        attach = np.array(info["attach"]).flatten()
        outputs = pack_output_sequence(planks, attach, self.cfg.DATA,
                                       self.cfg.TOKEN)
        if self.device_rasterize:
            inputs = pack_lines(linestrings, views, types, self.max_lines)
        else:
            inputs = {"input_image": rasterize_views(linestrings, views, types,
                                                     self.image_size)}
        return info["name"], {**inputs, **outputs}
