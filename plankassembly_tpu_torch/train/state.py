"""Train state and the update step (`plankassembly_tpu/train/state.py`).

Adam(lr) over the whole parameter tree: `torch.optim.Adam` with its
defaults (betas 0.9 / 0.999, eps 1e-8 added to the bias-corrected root)
makes the same update as `optax.adam(lr)`. The parameters are updated in
place, where the JAX step returns new arrays.

With a mesh (`parallel/mesh.py`) the step is the global batch's, as JAX's
SPMD step: each rank's loss is its share of the global token-weighted
mean (`models.model.token_loss`), the gradients are summed over the data
group in one flat all-reduce, and Adam runs on each rank's shards as they
are.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.data.device_loader import assemble
from plankassembly_tpu_torch.models.model import train_step_loss


def tree_leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted key order, the order of JAX's
    flattening of a dict tree."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key], prefix + (key,))
    else:
        yield prefix, tree


@dataclasses.dataclass
class TrainState:
    params: dict                   # nested dict of leaf tensors
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(lr: float):
    """A factory of Adam(lr) over a list of tensors."""
    return lambda leaves: torch.optim.Adam(leaves, lr=lr)


def init_state(params, optimizer, device=None) -> TrainState:
    """Float32 trainable leaves on `device` (default: where they are) and a
    fresh optimizer over them."""
    def leaf(t):
        return t.detach().to(device=device or t.device,
                             dtype=torch.float32).clone().requires_grad_(True)

    params = _map(leaf, params)
    return TrainState(params, optimizer([t for _, t in tree_leaves(params)]),
                      0)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def reduce_gradients(params, mesh) -> None:
    """Sum every leaf's gradient over the data group, in one all-reduce of
    a flat buffer. A leaf the loss does not read (the type embedding of a
    sideface batch) has none on any rank, and keeps none."""
    if mesh is None or mesh.data_group is None:
        return
    grads = [t.grad for _, t in tree_leaves(params) if t.grad is not None]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.data_group)
    for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


def make_train_step(dims: ModelDims, compute_dtype=torch.bfloat16,
                    flash: bool = False, loss_impl=train_step_loss,
                    mesh=None):
    """The training step: fn(state, batch, rng) -> metrics (the state's
    parameters, optimizer state and step advance in place). `batch` holds
    tensors on the parameters' device; `rng` is a torch.Generator there.
    The metrics stay device tensors, so a step does not wait for the
    device. `loss_impl` is the loss with `model.train_step_loss`'s
    signature (the raster modality's `vit.train_step_loss_raster`). With a
    `mesh`, `batch` is this rank's rows and the step is the global
    batch's."""

    def step(state: TrainState, batch: dict, rng) -> dict:
        state.optimizer.zero_grad(set_to_none=True)
        loss, mets = loss_impl(state.params, batch, dims, rng=rng,
                               deterministic=False,
                               compute_dtype=compute_dtype, flash=flash,
                               mesh=mesh)
        loss.backward()
        reduce_gradients(state.params, mesh)
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in mets.items()}

    return step


def make_device_train_step(dims: ModelDims, compute_dtype=torch.bfloat16,
                           flash: bool = False, loss_impl=train_step_loss,
                           mesh=None):
    """The training step on device-resident data (`data/device_loader.py`;
    JAX `make_device_train_step`): fn(state, fields, idx, aug, pos, rng)
    gathers rows `idx` of the resident split `fields`, writes the
    augmented rows `aug` at positions `pos`, and runs the step of
    `make_train_step` on that batch."""
    step = make_train_step(dims, compute_dtype=compute_dtype, flash=flash,
                           loss_impl=loss_impl, mesh=mesh)

    def device_step(state: TrainState, fields, idx, aug, pos, rng) -> dict:
        return step(state, assemble(fields, idx, aug, pos), rng)

    return device_step
