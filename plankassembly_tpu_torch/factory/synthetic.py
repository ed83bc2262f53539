"""Procedural cabinet generator: synthetic shape programs with attachments
(a copy of `plankassembly_tpu/factory/synthetic.py`: the same arrays for
every seed, the RNG calls in the same order).

The reference trains on a proprietary 26k-model cabinet dataset whose
per-model JSONs hold ``{"planks": (P, 6) raw coords, "attach": (P, 6)
pointer indices}`` (consumed by `dataset/render_complete_svg.py:27-30` and
`dataset/prepare_info.py:39-70`). That data isn't redistributable, so this
module generates structurally equivalent cabinets: axis-aligned plank
assemblies with legal attachment pointers (coordinate k of a plank may
reference coordinate (k+3)%6 of an earlier plank or coordinate k of the
global bbox — the pointer grammar enforced by `models.py:91-101`).

Raw units match the reference scale: the factory divides by SCALE=1280 to
land in [-1, 1] (`dataset/data_utils.py:49-60`).
"""
from __future__ import annotations

import numpy as np

SCALE = 1280.0


class _Program:
    """Accumulates plank rows + attachment pointers with index bookkeeping."""

    def __init__(self, bbox):
        self.rows = [list(bbox)]
        self.attach = [[-1] * 6]

    def token(self, row: int, coord: int) -> int:
        return row * 6 + coord

    def add(self, coords, attach):
        """coords: 6 floats; attach: 6 token indices or -1."""
        row = len(self.rows)
        self.rows.append([float(c) for c in coords])
        self.attach.append([int(a) for a in attach])
        return row

    def finish(self):
        return (np.array(self.rows, dtype=np.float64),
                np.array(self.attach, dtype=np.int64))


def generate_cabinet(seed: int, max_planks: int = 20):
    """Generate one cabinet. Returns (planks (P, 6) raw units,
    attach (P, 6) int token pointers), P <= max_planks + 1 (incl. bbox row).
    """
    rng = np.random.default_rng(seed)

    t = float(rng.choice([16, 18, 20, 24]))           # plank thickness
    W = float(rng.integers(700, 1260))                # width  (x)
    H = float(rng.integers(600, 1260))                # height (y)
    D = float(rng.integers(280, 620))                 # depth  (z)
    X0, X1 = -W / 2, W / 2
    Y0, Y1 = -H / 2, H / 2
    Z0, Z1 = -D / 2, D / 2

    p = _Program([X0, Y0, Z0, X1, Y1, Z1])
    B = lambda k: k  # bbox token k

    # left / right side panels span the full height
    left = p.add([X0, Y0, Z0, X0 + t, Y1, Z1],
                 [B(0), B(1), B(2), -1, B(4), B(5)])
    right = p.add([X1 - t, Y0, Z0, X1, Y1, Z1],
                  [-1, B(1), B(2), B(3), B(4), B(5)])
    lx = p.token(left, 3)   # left.xmax
    rx = p.token(right, 0)  # right.xmin

    # bottom / top between the sides
    bottom = p.add([X0 + t, Y0, Z0, X1 - t, Y0 + t, Z1],
                   [lx, B(1), B(2), rx, -1, B(5)])
    top = p.add([X0 + t, Y1 - t, Z0, X1 - t, Y1, Z1],
                [lx, -1, B(2), rx, B(4), B(5)])
    by = p.token(bottom, 4)  # bottom.ymax
    ty = p.token(top, 1)     # top.ymin

    has_back = rng.random() > 0.15  # open-back variant
    if has_back:
        bt = float(rng.choice([9, 12, t]))
        back = p.add([X0 + t, Y0 + t, Z0, X1 - t, Y1 - t, Z0 + bt],
                     [lx, by, B(2), rx, ty, -1])
        bz = p.token(back, 5)  # back.zmax
        interior_z0 = Z0 + bt
        n_used = 5
    else:
        bz = B(2)  # interiors reach the bbox back plane
        interior_z0 = Z0
        n_used = 4

    budget = max(0, max_planks - n_used)

    # vertical dividers split the interior into bays
    n_div = int(rng.integers(0, min(3, budget) + 1)) if W > 500 else 0
    n_div = min(n_div, budget)
    div_tokens = []  # (xmin_token, xmax_token) per bay boundary
    if n_div:
        xs = np.sort(rng.uniform(X0 + t + 60, X1 - t - 60, n_div))
        xs = xs[np.concatenate([[True], np.diff(xs) > 3 * t])]  # no overlap
        n_div = len(xs)
    else:
        xs = []
    prev_hi_token = lx
    bays = []
    for k in range(n_div):
        x = float(np.round(xs[k]))
        div = p.add([x, Y0 + t, interior_z0, x + t, Y1 - t, Z1],
                    [-1, by, bz, -1, ty, B(5)])
        bays.append((prev_hi_token, p.token(div, 0)))
        prev_hi_token = p.token(div, 3)
        div_tokens.append(div)
        budget -= 1
    bays.append((prev_hi_token, rx))

    def _bay_x(lo_tok, hi_tok):
        lo_row, lo_coord = divmod(lo_tok, 6)
        hi_row, hi_coord = divmod(hi_tok, 6)
        return p.rows[lo_row][lo_coord], p.rows[hi_row][hi_coord]

    # shelves inside bays
    for (lo_tok, hi_tok) in bays:
        n_shelf = int(rng.integers(0, 4))
        if n_shelf == 0 or budget <= 0:
            continue
        ys = np.sort(rng.uniform(Y0 + t + 50, Y1 - t - 50, n_shelf))
        # minimum spacing so shelf slabs don't overlap
        ys = ys[np.concatenate([[True], np.diff(ys) > 2 * t])]
        x_lo, x_hi = _bay_x(lo_tok, hi_tok)
        for y in ys:
            if budget <= 0:
                break
            y = float(np.round(y))
            p.add([x_lo, y, interior_z0, x_hi, y + t, Z1],
                  [lo_tok, -1, bz, hi_tok, -1, B(5)])
            budget -= 1

    # door panel covering one bay's front (set back by its thickness)
    if budget > 0 and bays and rng.random() < 0.35:
        lo_tok, hi_tok = bays[int(rng.integers(0, len(bays)))]
        x_lo, x_hi = _bay_x(lo_tok, hi_tok)
        dt_ = float(rng.choice([16, 18]))
        p.add([x_lo, Y0 + t, Z1 - dt_, x_hi, Y1 - t, Z1],
              [lo_tok, by, -1, hi_tok, ty, B(5)])
        budget -= 1

    # drawer front strip at the bottom of a bay
    if budget > 0 and bays and rng.random() < 0.3:
        lo_tok, hi_tok = bays[int(rng.integers(0, len(bays)))]
        x_lo, x_hi = _bay_x(lo_tok, hi_tok)
        h = float(rng.integers(80, 180))
        p.add([x_lo, Y0 + t, Z1 - t, x_hi, Y0 + t + h, Z1],
              [lo_tok, by, -1, hi_tok, -1, B(5)])
        budget -= 1

    # occasionally a toe-kick front rail
    if budget > 0 and rng.random() < 0.3:
        p.add([X0 + t, Y0 + t, Z1 - t, X1 - t, Y0 + t + float(rng.integers(60, 120)), Z1],
              [lx, by, -1, rx, -1, B(5)])
        budget -= 1

    return p.finish()


def generate_model_json(seed: int) -> dict:
    planks, attach = generate_cabinet(seed)
    return {"planks": planks.tolist(), "attach": attach.tolist()}


def validate_program(planks: np.ndarray, attach: np.ndarray):
    """Sanity checks: pointer legality + value consistency (debug aid)."""
    flat = np.asarray(planks, dtype=np.float64).reshape(-1)
    att = np.asarray(attach, dtype=np.int64).reshape(-1)
    for i, j in enumerate(att):
        if j == -1:
            continue
        assert j < i, (i, j)
        assert i >= 6, i
        if j < 6:
            assert j % 6 == i % 6, (i, j)
        else:
            assert j % 6 == (i % 6 + 3) % 6, (i, j)
        assert flat[i] == flat[j], (i, j, flat[i], flat[j])
    # planks must fit inside the bbox
    rows = flat.reshape(-1, 6)
    bbox = rows[0]
    assert (rows[1:, :3] >= bbox[:3] - 1e-9).all()
    assert (rows[1:, 3:] <= bbox[3:] + 1e-9).all()
    assert (rows[:, 3:] - rows[:, :3] > 0).all(), "degenerate plank"
