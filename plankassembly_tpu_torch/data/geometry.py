"""2D polyline geometry on numpy arrays (no GEOS / shapely): a copy of
`plankassembly_tpu/data/geometry.py`, used by `line_data.py`, `noise.py`
and the side-face extractor (`sideface_data.py`). Lines are float64 arrays
of shape (N, 2), N >= 2 vertices.

`polygonize_bounds` is copied with its arithmetic unchanged (the 9-decimal
snap, the `np.unique` grids, the float equality tests): which faces close
depends on it bit for bit.
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


def to_geojson(line: np.ndarray) -> str:
    return json.dumps(
        {"type": "LineString", "coordinates": np.asarray(line, dtype=float).tolist()},
        separators=(",", ":"),
    )


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


def segments_intersect_aabb(a: np.ndarray, b: np.ndarray, tol: float = 0.0) -> bool:
    """Axis-aligned bounding-box overlap test between two polylines —
    sufficient as an 'intersects' predicate for the axis-aligned segments
    this domain produces (used in place of the STRtree query at
    `sideface_data.py:47-48`)."""
    ba, bb = bounds(a), bounds(b)
    return bool(
        ba[0] <= bb[2] + tol and bb[0] <= ba[2] + tol
        and ba[1] <= bb[3] + tol and bb[1] <= ba[3] + tol
    )


def polygonize_bounds(lines, snap_decimals: int = 9) -> np.ndarray:
    """Bounding boxes of the bounded faces of an axis-aligned line arrangement.

    Replacement for `shapely.polygonize` at `sideface_data.py:121`:
    the downstream consumer (`parse_sideface_from_polygons`,
    `sideface_data.py:22-38`) only ever reads `shapely.bounds(polygon)`, so we
    return face bounding boxes directly. Works on the axis-aligned segment
    arrangements produced by orthographic box projections.

    Algorithm: snap endpoint coordinates onto the sorted unique coordinate
    grid, mark blocked cell walls wherever a segment covers them, flood-fill
    from the outside, and report each enclosed connected region's bbox.

    Returns (F, 4) array of (xmin, ymin, xmax, ymax).
    """
    segs = []
    for line in lines:
        line = np.asarray(line, dtype=np.float64)
        for k in range(len(line) - 1):
            p, q = line[k], line[k + 1]
            if np.allclose(p, q):
                continue
            segs.append((p, q))
    if not segs:
        return np.zeros((0, 4), dtype=np.float64)

    pts = np.round(np.array([c for s in segs for c in s]), snap_decimals)
    xs = np.unique(pts[:, 0])
    ys = np.unique(pts[:, 1])
    nx, ny = len(xs) - 1, len(ys) - 1  # number of cell columns / rows
    if nx < 1 or ny < 1:
        return np.zeros((0, 4), dtype=np.float64)

    # Wall arrays: vwall[i, j] blocks movement between cell (i-1, j) and
    # (i, j) across the vertical grid line x = xs[i]; similarly hwall.
    vwall = np.zeros((nx + 1, ny), dtype=bool)
    hwall = np.zeros((nx, ny + 1), dtype=bool)

    for p, q in segs:
        p = np.round(p, snap_decimals)
        q = np.round(q, snap_decimals)
        if p[0] == q[0]:  # vertical segment
            i = int(np.searchsorted(xs, p[0]))
            if i >= len(xs) or xs[i] != p[0]:
                continue  # off-grid (shouldn't happen after snapping)
            y0, y1 = sorted((p[1], q[1]))
            j0 = int(np.searchsorted(ys, y0))
            j1 = int(np.searchsorted(ys, y1))
            vwall[i, j0:j1] = True
        elif p[1] == q[1]:  # horizontal segment
            j = int(np.searchsorted(ys, p[1]))
            if j >= len(ys) or ys[j] != p[1]:
                continue
            x0, x1 = sorted((p[0], q[0]))
            i0 = int(np.searchsorted(xs, x0))
            i1 = int(np.searchsorted(xs, x1))
            hwall[i0:i1, j] = True
        # non-axis-aligned segments cannot bound an axis-aligned face; skip.

    # Flood fill the outside: BFS over cells, plus a virtual outside node.
    # label -1 = unvisited, 0 = outside, >0 = enclosed region id.
    label = np.full((nx, ny), -1, dtype=np.int32)
    stack = []
    for i in range(nx):
        if not hwall[i, 0]:
            stack.append((i, 0))
        if not hwall[i, ny]:
            stack.append((i, ny - 1))
    for j in range(ny):
        if not vwall[0, j]:
            stack.append((0, j))
        if not vwall[nx, j]:
            stack.append((nx - 1, j))
    while stack:
        i, j = stack.pop()
        if label[i, j] != -1:
            continue
        label[i, j] = 0
        if i > 0 and not vwall[i, j] and label[i - 1, j] == -1:
            stack.append((i - 1, j))
        if i < nx - 1 and not vwall[i + 1, j] and label[i + 1, j] == -1:
            stack.append((i + 1, j))
        if j > 0 and not hwall[i, j] and label[i, j - 1] == -1:
            stack.append((i, j - 1))
        if j < ny - 1 and not hwall[i, j + 1] and label[i, j + 1] == -1:
            stack.append((i, j + 1))

    # Remaining cells are enclosed; group into connected regions.
    region_bounds = []
    next_id = 1
    for si in range(nx):
        for sj in range(ny):
            if label[si, sj] != -1:
                continue
            xmin, ymin = xs[si], ys[sj]
            xmax, ymax = xs[si + 1], ys[sj + 1]
            stack = [(si, sj)]
            label[si, sj] = next_id
            while stack:
                i, j = stack.pop()
                xmin, xmax = min(xmin, xs[i]), max(xmax, xs[i + 1])
                ymin, ymax = min(ymin, ys[j]), max(ymax, ys[j + 1])
                if i > 0 and not vwall[i, j] and label[i - 1, j] == -1:
                    label[i - 1, j] = next_id
                    stack.append((i - 1, j))
                if i < nx - 1 and not vwall[i + 1, j] and label[i + 1, j] == -1:
                    label[i + 1, j] = next_id
                    stack.append((i + 1, j))
                if j > 0 and not hwall[i, j] and label[i, j - 1] == -1:
                    label[i, j - 1] = next_id
                    stack.append((i, j - 1))
                if j < ny - 1 and not hwall[i, j + 1] and label[i, j + 1] == -1:
                    label[i, j + 1] = next_id
                    stack.append((i, j + 1))
            region_bounds.append((xmin, ymin, xmax, ymax))
            next_id += 1

    return np.array(region_bounds, dtype=np.float64).reshape(-1, 4)
