"""The drawing pool: 128 drawings from which every cell's requests are
drawn by the seed. A configuration names its pool by the key "pool": the
set `<pool>_serve64.json.gz` and `<pool>_train64.json.gz` under
bench_port/data/. Without the key the pool is serve64.json.gz and
train64.json.gz, frozen copies of the program's complete-lines fixtures
(42-260 lines each); "visible" is the same 128 cabinets as visible lines
only (`data/make_visible_pool.py`).

A request is an info JSON as users send it to the configuration: `lines`
with their views and line types.
"""
from __future__ import annotations

import gzip
import json
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
FILES = ("serve64.json.gz", "train64.json.gz")


def files(config: dict | None = None) -> list[str]:
    """The pool's files, serve half first."""
    pool = (config or {}).get("pool")
    return [f"{pool}_{f}" if pool else f for f in FILES]


def drawings(config: dict | None = None) -> list[dict]:
    out = []
    for f in files(config):
        with gzip.open(os.path.join(DATA, f), "rt") as fh:
            out += json.load(fh)
    return out


def requests(config: dict | None = None) -> list[dict]:
    """The pool as request bodies."""
    return [{"name": info["name"], "views": info["views"],
             "types": info["types"], "lines": info["lines"]}
            for info in drawings(config)]


def balanced_order(n_pool: int, count: int, seed: int) -> np.ndarray:
    """`count` pool indices in which every drawing appears equally often
    (within one), in an order drawn from the seed: every seed sends the
    same set of sizes."""
    reps = -(-count // n_pool)
    rng = np.random.default_rng([seed, 1])
    return np.concatenate([rng.permutation(n_pool)
                           for _ in range(reps)])[:count]
