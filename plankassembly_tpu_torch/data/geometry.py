"""2D polyline geometry on numpy arrays (no GEOS / shapely): the part of
`plankassembly_tpu/data/geometry.py` that `line_data.py` and `noise.py`
use, copied. Lines are float64 arrays of shape (N, 2), N >= 2 vertices.
"""
from __future__ import annotations

import json

import numpy as np


def linestring(points) -> np.ndarray:
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"a linestring is (N, 2), got {pts.shape}")
    return pts


def from_geojson(text: str) -> np.ndarray:
    """Parse a GeoJSON LineString (the `svgs` entries of an info JSON)."""
    obj = json.loads(text)
    if obj.get("type") != "LineString":
        raise ValueError(f"expected LineString, got {obj.get('type')!r}")
    return linestring(obj["coordinates"])


def bounds(line: np.ndarray) -> np.ndarray:
    """(xmin, ymin, xmax, ymax) of a single polyline."""
    line = np.asarray(line)
    return np.concatenate([line.min(axis=0), line.max(axis=0)])


def bounds_many(lines) -> np.ndarray:
    """Bounds of a sequence of polylines, shape (K, 4)."""
    if len(lines) == 0:
        return np.zeros((0, 4), dtype=np.float64)
    return np.stack([bounds(line) for line in lines])


def length(line: np.ndarray) -> float:
    line = np.asarray(line)
    return float(np.linalg.norm(np.diff(line, axis=0), axis=1).sum())


def interpolate(line: np.ndarray, distance: float) -> np.ndarray:
    """Point at arc length `distance` along the polyline; a negative
    distance measures from the end (as `shapely.line_interpolate_point`).
    Clamped to the line."""
    line = np.asarray(line, dtype=np.float64)
    seg = np.diff(line, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    total = seg_len.sum()
    d = distance if distance >= 0 else total + distance
    d = min(max(d, 0.0), total)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    i = int(np.searchsorted(cum, d, side="right") - 1)
    i = min(i, len(seg_len) - 1)
    if seg_len[i] == 0:
        return line[i].copy()
    t = (d - cum[i]) / seg_len[i]
    return line[i] + t * seg[i]
