"""Process meshes and the tensor-parallel layout: the port of
`plankassembly_tpu/parallel/mesh.py`.

JAX builds a `('data', 'model')` device mesh and lets XLA's partitioner
insert the collectives. Here every rank is a process, and the mesh is the
process groups that carry those collectives:

- `make_mesh(num_data, num_model)`: rank = data_rank * num_model +
  model_rank. Ranks of one model rank form a data group (gradient sums);
  ranks of one data replica form a model group (tensor-parallel sums). With
  ``num_model = 1`` it is plain data parallelism, JAX's "ddp"; above 1 the
  attention heads and FFN hidden units are split Megatron-style over the
  model group, JAX's "dp+tp".
- `make_seq_mesh(num_data, num_seq)`: the encoder's length axis split over
  a seq group (`models.model.run_encoder_stack(seq_mesh=)`), parameters
  replicated.

The layout rules (`spec_for_path`) are JAX's path rules on the port's
``a/b/c`` parameter paths: `wq`/`wk`/`wv`/`bq`/`bk`/`bv` of an attention
block and `w1`/`b1` of an FFN split on their output axis (column-parallel),
`wo`/`w2` on their input axis (row-parallel), everything else replicated.
One difference: GSPMD may cut inside a head, and the port splits by whole
heads only, so the model group's size must divide the query heads, the
kv heads and the FFN width (`check_tensor_parallel`).

The Megatron pair (`copy_to_model`, `reduce_from_model`) brackets each
split block: identity forward and a model-group sum backward at its input,
a model-group sum forward and identity backward after its row-parallel
product. A replicated leaf's gradient is then whole and equal on every
rank of a model group, so gradients are summed over the data group only.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from plankassembly_tpu_torch.parallel import multihost

COLUMN_ATTN = ("wq", "wk", "wv", "bq", "bk", "bv")
COLUMN_FFN = ("w1", "b1")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, inner) grid of processes and the
    groups it belongs to. The inner axis is "model" (tensor parallelism)
    or "seq" (the encoder's length axis). Groups are None in a single
    process, and every collective of the port is then skipped."""

    num_data: int = 1
    num_model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: object = None        # same inner rank: gradient sums
    model_group: object = None       # same data replica: TP / seq sums
    host_data_group: object = None   # gloo twin of data_group: host sums
    host_group: object = None        # gloo group of every rank: broadcasts
    axis: str = "model"

    @property
    def tensor_parallel(self) -> bool:
        return self.axis == "model" and self.num_model > 1

    @property
    def num_seq(self) -> int:
        return self.num_model

    @property
    def seq_rank(self) -> int:
        return self.model_rank

    @property
    def seq_group(self):
        return self.model_group

    @property
    def row_shard(self) -> tuple[int, int, int]:
        """(axis, parts, index) of this rank's rows of a global batch."""
        return 0, self.num_data, self.data_rank


def _own_groups(rank_lists, rank, timeout, backend=None):
    """Create every group of `rank_lists` (all ranks must, in one order)
    and return the one holding `rank`."""
    mine = None
    for ranks in rank_lists:
        group = dist.new_group(ranks, timeout=timeout, backend=backend)
        if rank in ranks:
            mine = group
    return mine


def _grid(num_data: int, num_inner: int, axis: str,
          timeout=multihost.TIMEOUT) -> Mesh:
    world = multihost.world_size()
    count = num_data * num_inner
    if count > world:
        raise ValueError(f"mesh needs {count} devices, have {world}")
    if not dist.is_initialized():
        return Mesh(axis=axis)
    if count != world:
        raise ValueError(
            f"the mesh takes {count} of the {world} processes: launch "
            f"{count} processes, or size the mesh to all of them")
    rank = dist.get_rank()
    data_rank, inner_rank = divmod(rank, num_inner)
    data_lists = [[d * num_inner + m for d in range(num_data)]
                  for m in range(num_inner)]
    inner_lists = [[d * num_inner + m for m in range(num_inner)]
                   for d in range(num_data)]
    data_group = _own_groups(data_lists, rank, timeout)
    inner_group = _own_groups(inner_lists, rank, timeout)
    if dist.get_backend() == "gloo":
        host_data, host = data_group, dist.group.WORLD
    else:  # NCCL reduces device tensors only
        host_data = _own_groups(data_lists, rank, timeout, backend="gloo")
        host = dist.new_group(list(range(world)), timeout=timeout,
                              backend="gloo")
    return Mesh(num_data, num_inner, data_rank, inner_rank, data_group,
                inner_group, host_data, host, axis)


def make_mesh(num_data: int | None = None, num_model: int = 1,
              timeout=multihost.TIMEOUT) -> Mesh:
    """The ('data', 'model') mesh over every process of the group (one
    process: the trivial mesh). Defaults to all ranks on 'data'. Every rank
    must call it: it creates the groups."""
    if num_data is None:
        num_data = max(1, multihost.world_size() // num_model)
    return _grid(num_data, num_model, "model", timeout)


def make_seq_mesh(num_data: int, num_seq: int,
                  timeout=multihost.TIMEOUT) -> Mesh:
    """The ('data', 'seq') mesh for encoder sequence parallelism."""
    return _grid(num_data, num_seq, "seq", timeout)


def check_tensor_parallel(dims, tp: int) -> None:
    """Raise unless `tp` splits the model by whole heads and whole FFN
    units."""
    for what, n in (("query heads", dims.num_head),
                    ("kv heads", dims.kv_heads),
                    ("NUM_FEEDFORWARD", dims.num_feedforward)):
        if n % tp:
            raise ValueError(
                f"tensor_parallel={tp} does not divide the {n} {what}: the "
                f"port splits the model by whole heads and FFN units")


def spec_for_path(path: str, tensor_parallel: bool) -> int | None:
    """The axis the leaf at `path` (``encoder/self_attn/wq``) is split on:
    -1 column-parallel, -2 row-parallel, None replicated."""
    if not tensor_parallel:
        return None
    *blocks, name = path.split("/")
    if any("attn" in b for b in blocks):
        if name in COLUMN_ATTN:
            return -1
        if name == "wo":
            return -2
    elif "ffn" in blocks:
        if name in COLUMN_FFN:
            return -1
        if name == "w2":
            return -2
    return None


def _map_paths(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn("/".join(prefix), tree)


def param_specs(params, tensor_parallel: bool = False) -> dict:
    """The split axis of every leaf of `params` (`spec_for_path`)."""
    return _map_paths(lambda p, _: spec_for_path(p, tensor_parallel), params)


def shard_leaf(t: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    if axis is None or not mesh.tensor_parallel:
        return t
    return t.chunk(mesh.num_model, dim=axis)[mesh.model_rank].contiguous()


def gather_leaf(t: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from its shards (a model-group all-gather)."""
    t = t.detach()
    if axis is None or not mesh.tensor_parallel:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.num_model)]
    dist.all_gather(parts, t, group=mesh.model_group)
    return torch.cat(parts, dim=axis)


def shard_params(params, mesh: Mesh) -> dict:
    """This rank's shard of every leaf of the whole tree `params`."""
    tp = mesh.tensor_parallel
    return _map_paths(lambda p, t: shard_leaf(t, spec_for_path(p, tp), mesh),
                      params)


def gather_params(params, mesh: Mesh) -> dict:
    """The whole tree from every rank's shards (detached). Every rank of
    the model group must call it."""
    tp = mesh.tensor_parallel
    return _map_paths(lambda p, t: gather_leaf(t, spec_for_path(p, tp), mesh),
                      params)


class _CopyToModel(torch.autograd.Function):
    """Identity forward, model-group sum backward: the input of a
    column-parallel block (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Model-group sum forward, identity backward: after a row-parallel
    product (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherSeq(torch.autograd.Function):
    """All-gather of the length axis over the seq group. Backward: when the
    gathered tensor feeds every rank's own share of the work (`reduce`, the
    K/V of the seq-parallel encoder), the ranks' gradients are summed before
    this rank's slice is taken; when every rank computes the same function
    of it (the memory after the encoder), the slice alone."""

    @staticmethod
    def forward(ctx, x, group, n, index, reduce):
        ctx.group, ctx.index, ctx.reduce = group, index, reduce
        ctx.width = x.shape[1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce:
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=ctx.group)
        w = ctx.width
        return grad[:, ctx.index * w:(ctx.index + 1) * w], None, None, None, \
            None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)


def gather_seq(x: torch.Tensor, mesh: Mesh, reduce: bool) -> torch.Tensor:
    """(B, L/n, ...) on each seq rank -> (B, L, ...) on every one."""
    return _GatherSeq.apply(x, mesh.seq_group, mesh.num_seq, mesh.seq_rank,
                            reduce)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of a device tensor over `group` (a new tensor, no gradient);
    `t` itself without a group."""
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t
