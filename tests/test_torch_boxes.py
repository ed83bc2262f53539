"""The port's 3D box operations (`plankassembly_tpu_torch/ops/boxes.py`)
against the JAX package's (`plankassembly_tpu/ops/boxes.py`) on random
boxes from a numpy seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.ops import boxes as J
from plankassembly_tpu_torch.ops import boxes as P

ATOL = 1e-6


def random_boxes(n, seed):
    """(n, 6) float32 boxes with random corners, some thin or empty and
    some outside a (2, 3, 4) reference box."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1.0, 3.0, (n, 3))
    size = rng.uniform(0.0, 2.0, (n, 3))
    size[rng.random((n, 3)) < 0.1] = 0.0
    return np.concatenate([lo, lo + size], axis=1).astype(np.float32)


def _eq(got, want, atol=ATOL):
    assert isinstance(got, torch.Tensor)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unary_ops_equal_jax(seed):
    b = random_boxes(40, seed)
    t = torch.from_numpy(b)
    _eq(P.volume(t), J.volume(jnp.asarray(b)))
    _eq(P.get_centers(t), J.get_centers(jnp.asarray(b)))
    _eq(P.clip(t, (2, 3, 4)), J.clip(jnp.asarray(b), (2, 3, 4)))
    for thr in (0.0, 0.05):
        _eq(P.nonempty(t, thr), J.nonempty(jnp.asarray(b), thr))
    for thr in (0, 1):
        _eq(P.inside_box(t, (2, 3, 4), thr),
            J.inside_box(jnp.asarray(b), (2, 3, 4), thr))
    _eq(P.scale(t, 2.0, 0.5, 3.0), J.scale(jnp.asarray(b), 2.0, 0.5, 3.0))
    # array-likes are taken too, as float32
    _eq(P.volume(b.astype(np.float64).tolist()), J.volume(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_ops_equal_jax(seed):
    b1, b2 = random_boxes(17, seed), random_boxes(23, seed + 100)
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    j1, j2 = jnp.asarray(b1), jnp.asarray(b2)
    _eq(P.pairwise_intersection(t1, t2), J.pairwise_intersection(j1, j2))
    _eq(P.pairwise_iou(t1, t2), J.pairwise_iou(j1, j2))
    ioa = J.pairwise_ioa(j1, j2)
    _eq(P.pairwise_ioa(t1, t2), ioa)
    # matched pairs with a positive volume on both sides
    m1, m2 = b1[:15], b2[:15]
    keep = (np.prod(m1[:, 3:] - m1[:, :3], 1) > 0) \
        & (np.prod(m2[:, 3:] - m2[:, :3], 1) > 0)
    _eq(P.matched_pairwise_iou(torch.from_numpy(m1[keep]),
                               torch.from_numpy(m2[keep])),
        J.matched_pairwise_iou(jnp.asarray(m1[keep]), jnp.asarray(m2[keep])))


def test_cat_and_device():
    b = random_boxes(5, 9)
    _eq(P.cat([torch.from_numpy(b), b[:2]]), J.cat([b, b[:2]]))
    assert tuple(P.cat([]).shape) == (0, 6)
    # results stay on the caller's device and dtype
    out = P.clip(torch.from_numpy(b).double(), (1, 1, 1))
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    assert P.pairwise_iou(torch.from_numpy(b), torch.from_numpy(b)).shape \
        == (5, 5)
