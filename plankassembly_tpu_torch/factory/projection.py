"""Orthographic projection + hidden-line removal for axis-aligned boxes (a
copy of `plankassembly_tpu/factory/projection.py`: the geometry depends on
the order of its operations and on its rounding, so it is kept as it is).

The reference delegates this to the OCCT CAD kernel (`HLRBRep_Algo`,
`dataset/data_utils.py:63-101`) — a general-purpose C++ HLR. PlankAssembly
shapes are unions of axis-aligned boxes, for which HLR has an exact
closed-form treatment:

- each box contributes 4 axis-aligned 2D segments per view (its 12 edges
  project onto the silhouette rectangle; edges parallel to the view axis
  project to points);
- after globally noding the arrangement (splitting segments at crossings
  and at interior endpoints — the same normalization the reference performs
  in `split_lines_on_crossing_points`/`split_lines_on_endpoints`,
  `dataset/data_utils.py:113-176`), each atomic sub-segment is visible iff
  no box's silhouette strictly contains its midpoint at strictly nearer
  depth;
- coincident duplicates are removed longest-first with visible lines
  taking precedence (`remove_overlapping_lines`, `data_utils.py:179-205`).

View conventions derived from the reference's projector axes
(`data_utils.py:15-25`) and the 2D flip in `get_discretize_edge`
(`data_utils.py:104-110`):

    view 'f' (front): 2D = ( x, -z), depth = +y (nearer = smaller y)
    view 't' (top):   2D = ( x, -y), depth = -z (nearer = larger z)
    view 's' (side):  2D = ( y, -z), depth = -x (nearer = larger x)

All coordinates are rounded to `decimals` (default 3) exactly like the
reference's edge discretization.
"""
from __future__ import annotations

import numpy as np

VIEWS = ("f", "t", "s")

# (u axis, v axis, v sign, depth axis, depth sign) per view; depth is
# oriented so that *smaller* oriented depth = nearer to the viewer.
_VIEW_AXES = {
    "f": (0, 2, -1.0, 1, +1.0),
    "t": (0, 1, -1.0, 2, -1.0),
    "s": (1, 2, -1.0, 0, -1.0),
}


def box_view_segments(boxes: np.ndarray, view: str, decimals: int = 3):
    """Candidate 2D segments for all boxes in one view.

    boxes: (N, 6) (x0,y0,z0,x1,y1,z1), already scaled to world units.
    Returns (segments (K, 4) as (ua, va, ub, vb), depths (K,) oriented
    near=small, owner (K,) box index).
    """
    ua, va, vsign, da, dsign = _VIEW_AXES[view]
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 6)
    lo, hi = boxes[:, :3], boxes[:, 3:]

    segs, depths, owners = [], [], []
    for i in range(len(boxes)):
        u0, u1 = lo[i, ua], hi[i, ua]
        v_cands = sorted((vsign * lo[i, va], vsign * hi[i, va]))
        v0, v1 = v_cands
        # near/far depth of the box's edge pair at each rectangle side
        d_near = min(dsign * lo[i, da], dsign * hi[i, da])
        rect = [
            (u0, v0, u1, v0),  # bottom
            (u1, v0, u1, v1),  # right
            (u1, v1, u0, v1),  # top
            (u0, v1, u0, v0),  # left
        ]
        for s in rect:
            segs.append(s)
            depths.append(d_near)
            owners.append(i)
    segs = np.round(np.array(segs, dtype=np.float64), decimals)
    return segs, np.array(depths), np.array(owners, dtype=np.int64)


def _node_segments(segs: np.ndarray, extra_points: np.ndarray | None = None):
    """Split axis-aligned segments at every crossing and at every endpoint
    lying in a segment's interior (global noding). Returns (atomic segs
    (M, 4), parent index (M,))."""
    segs = np.asarray(segs, dtype=np.float64)
    endpoints = np.concatenate([segs[:, :2], segs[:, 2:]], axis=0)
    if extra_points is not None and len(extra_points):
        endpoints = np.concatenate([endpoints, extra_points], axis=0)

    out_segs, out_parent = [], []
    for idx, (ax, ay, bx, by) in enumerate(segs):
        cuts = []
        if ax == bx:  # vertical
            y0, y1 = sorted((ay, by))
            # crossings with horizontal segments
            for (cx, cy, dx, dy) in segs:
                if cy == dy and min(cx, dx) < ax < max(cx, dx) \
                        and y0 < cy < y1:
                    cuts.append(cy)
            # endpoints on the interior
            on = endpoints[(endpoints[:, 0] == ax)
                           & (endpoints[:, 1] > y0) & (endpoints[:, 1] < y1)]
            cuts.extend(on[:, 1].tolist())
            knots = np.unique([y0, *cuts, y1])
            for k in range(len(knots) - 1):
                out_segs.append((ax, knots[k], ax, knots[k + 1]))
                out_parent.append(idx)
        elif ay == by:  # horizontal
            x0, x1 = sorted((ax, bx))
            for (cx, cy, dx, dy) in segs:
                if cx == dx and min(cy, dy) < ay < max(cy, dy) \
                        and x0 < cx < x1:
                    cuts.append(cx)
            on = endpoints[(endpoints[:, 1] == ay)
                           & (endpoints[:, 0] > x0) & (endpoints[:, 0] < x1)]
            cuts.extend(on[:, 0].tolist())
            knots = np.unique([x0, *cuts, x1])
            for k in range(len(knots) - 1):
                out_segs.append((knots[k], ay, knots[k + 1], ay))
                out_parent.append(idx)
        else:
            raise ValueError("non-axis-aligned segment in box projection")
    return (np.array(out_segs, dtype=np.float64).reshape(-1, 4),
            np.array(out_parent, dtype=np.int64))


def _silhouettes(boxes: np.ndarray, view: str, decimals: int = 3):
    """(N, 4) 2D silhouette rects (umin, vmin, umax, vmax) + near depths."""
    ua, va, vsign, da, dsign = _VIEW_AXES[view]
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 6)
    lo, hi = boxes[:, :3], boxes[:, 3:]
    u0, u1 = lo[:, ua], hi[:, ua]
    vv = np.stack([vsign * lo[:, va], vsign * hi[:, va]])
    v0, v1 = vv.min(axis=0), vv.max(axis=0)
    dd = np.stack([dsign * lo[:, da], dsign * hi[:, da]])
    d_near = dd.min(axis=0)
    rects = np.round(np.stack([u0, v0, u1, v1], axis=1), decimals)
    return rects, d_near


def project_boxes(boxes: np.ndarray, view: str, decimals: int = 3,
                  use_native: bool = True):
    """HLR projection of a box compound onto one view.

    Returns (lines: list of (2,2) arrays, types: list of int 0=visible,
    1=hidden) — the same contract as the reference `project`
    (`dataset/data_utils.py:63-101`), already noded.

    Uses the C++ core (native/geometry.cpp via ctypes) when built; the numpy
    path below is the semantic reference and fallback.
    """
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 6)
    # drop degenerate boxes
    keep = (boxes[:, 3:] - boxes[:, :3] > 0).all(axis=1)
    boxes = boxes[keep]
    if len(boxes) == 0:
        return [], []

    segs, depths, _ = box_view_segments(boxes, view, decimals)
    rects, rect_near = _silhouettes(boxes, view, decimals)

    if use_native:
        from plankassembly_tpu_torch.factory import native
        if native.available():
            atomic, hidden = native.node_classify(segs, depths, rects,
                                                  rect_near)
            lines = [atomic[i].reshape(2, 2) for i in range(len(atomic))]
            return lines, hidden.astype(int).tolist()

    atomic, parent = _node_segments(segs)
    mids = (atomic[:, :2] + atomic[:, 2:]) / 2.0
    d = depths[parent]

    # occluded iff strictly inside some silhouette with strictly nearer depth
    inside = ((mids[:, None, 0] > rects[None, :, 0])
              & (mids[:, None, 0] < rects[None, :, 2])
              & (mids[:, None, 1] > rects[None, :, 1])
              & (mids[:, None, 1] < rects[None, :, 3]))
    nearer = rect_near[None, :] < d[:, None]
    hidden = (inside & nearer).any(axis=1)

    lines = [atomic[i].reshape(2, 2) for i in range(len(atomic))]
    types = hidden.astype(int).tolist()
    return lines, types


def _seg_key(line: np.ndarray, decimals: int = 9):
    a, b = line[0], line[1]
    pts = sorted([tuple(np.round(a, decimals)), tuple(np.round(b, decimals))])
    return tuple(pts[0]) + tuple(pts[1])


def _covers(a: np.ndarray, b: np.ndarray, tol: float = 1e-12) -> bool:
    """True if segment a covers segment b (collinear containment)."""
    (ax0, ay0), (ax1, ay1) = a
    (bx0, by0), (bx1, by1) = b
    if ax0 == ax1 and bx0 == bx1 and ax0 == bx0:  # both vertical, same x
        lo, hi = sorted((ay0, ay1))
        return min(by0, by1) >= lo - tol and max(by0, by1) <= hi + tol
    if ay0 == ay1 and by0 == by1 and ay0 == by0:  # both horizontal
        lo, hi = sorted((ax0, ax1))
        return min(bx0, bx1) >= lo - tol and max(bx0, bx1) <= hi + tol
    return False


def remove_overlapping_lines(lines, types, use_native: bool = True):
    """Longest-first cover dedupe, visible lines first
    (`dataset/data_utils.py:179-205`)."""
    if not lines:
        return [], []
    lengths = np.array([np.linalg.norm(np.asarray(l)[1] - np.asarray(l)[0])
                        for l in lines])
    order = np.lexsort((-lengths, np.asarray(types)))
    order = [i for i in order if lengths[i] > 0]
    if not order:
        return [], []

    if use_native:
        from plankassembly_tpu_torch.factory import native
        if native.available():
            flat = np.stack([np.asarray(l).reshape(4) for l in lines])
            keep = native.dedupe_covers(flat, np.asarray(types))
            return ([lines[i] for i in order if keep[i]],
                    [types[i] for i in order if keep[i]])

    unique_lines = [lines[order[0]]]
    unique_types = [types[order[0]]]
    for i in order[1:]:
        if not any(_covers(u, lines[i]) for u in unique_lines):
            unique_lines.append(lines[i])
            unique_types.append(types[i])
    return unique_lines, unique_types


def merge_degenerated_lines(lines):
    """Iteratively merge collinear line pairs that meet at a degree-2
    endpoint (`dataset/render_visible_svg.py:22-65`)."""
    lines = [np.asarray(l, dtype=np.float64) for l in lines]
    changed = True
    while changed:
        changed = False
        # endpoint -> list of line indices
        table: dict[tuple, list[int]] = {}
        for i, l in enumerate(lines):
            for p in (l[0], l[-1]):
                table.setdefault(tuple(np.round(p, 9)), []).append(i)
        merged: set[int] = set()
        additions = []
        for pt, idxs in table.items():
            if len(idxs) != 2:
                continue
            i, j = idxs
            if i == j or i in merged or j in merged:
                continue
            coords = np.concatenate([lines[i], lines[j]])
            if (len(np.unique(coords[:, 0])) == 1
                    or len(np.unique(coords[:, 1])) == 1):
                lo = coords.min(axis=0)
                hi = coords.max(axis=0)
                additions.append(np.stack([lo, hi]))
                merged.update((i, j))
                changed = True
        if changed:
            lines = [l for k, l in enumerate(lines) if k not in merged]
            lines.extend(additions)
    return lines


def postprocess_complete(lines, types):
    """Reference complete-view post-process (`render_complete_svg.py:14-22`).
    Our projection already nodes the arrangement, so only dedupe remains."""
    return remove_overlapping_lines(lines, types)


def postprocess_visible(lines, types):
    """Visible-only post-process (`render_visible_svg.py:68-80`): drop
    hidden lines, dedupe, merge degenerate collinear chains."""
    visible = [l for l, t in zip(lines, types) if t == 0]
    vis_types = [0] * len(visible)
    lines2, types2 = remove_overlapping_lines(visible, vis_types)
    lines3 = merge_degenerated_lines(lines2)
    return lines3, [0] * len(lines3)
