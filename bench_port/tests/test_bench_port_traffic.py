"""The traffic is fixed by the seed: the same seed gives the same
requests; other seeds the same set in another order."""
from __future__ import annotations

import numpy as np

from bench_port.harness import pool as P


def test_requests_fixed_by_seed():
    x = P.balanced_order(128, 1024, 7)
    assert np.array_equal(x, P.balanced_order(128, 1024, 7))
    y = P.balanced_order(128, 1024, 2 ** 32 + 3)
    assert not np.array_equal(x, y)
    assert np.array_equal(np.bincount(x), np.full(128, 8))
    assert np.array_equal(np.sort(x), np.sort(y))


def test_pool_requests():
    bodies = P.requests()
    assert len(bodies) == 128
    assert all(len(r["lines"]) == len(r["views"]) == len(r["types"])
               for r in bodies)
