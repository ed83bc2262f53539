"""Multi-process runtime on `torch.distributed`: process-group set-up from
the environment, rank-0 IO, each rank's rows of a global batch, and host
sums over ranks. The port of `plankassembly_tpu/parallel/multihost.py`.

One process drives one device. Launch:

    PLANK_NUM_PROCESSES=2 PLANK_COORDINATOR=host0:29400 \\
    PLANK_PROCESS_ID=<0|1> python -m plankassembly_tpu_torch.trainer_complete fit ...

or under `torchrun`, whose variables (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, LOCAL_RANK) the ``env://`` rendezvous reads:

    PLANK_DISTRIBUTED=1 torchrun --nproc_per_node 4 \\
        -m plankassembly_tpu_torch.trainer_complete fit --config configs/train_complete.yaml

`PLANK_COORDINATOR` is ``host:port`` (a TCP rendezvous) or a URL such as
``file:///shared/rdv`` taken as it is. The backend is NCCL on CUDA and
gloo on the CPU. Every group has a timeout, so a missing peer fails the
run instead of hanging it.

Differences from JAX, where one process drives every device of a host:
here every rank is a process, so a rank of a tensor-parallel group holds
the same rows as the other ranks of its group. Sums of per-row metrics
therefore run over a data group (`mesh.Mesh.host_data_group`), never over
the world.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from plankassembly_tpu_torch.device import resolve_device

TIMEOUT = datetime.timedelta(minutes=10)


def initialize_from_env(backend: str | None = None, device=None,
                        timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Form the process group the environment describes. Returns True when
    there is a group of more than one process; a single process (no
    PLANK_* variables) is a no-op, and a second call returns at once.

    backend: "nccl" or "gloo"; by default NCCL when `device` (default
    CUDA) is a CUDA device and gloo for the CPU. A CUDA device without
    CUDA raises, as the entry points do."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if env.get("PLANK_DISTRIBUTED") == "1":
        init_method, world, rank = "env://", None, None
    else:
        world = int(env.get("PLANK_NUM_PROCESSES", "1"))
        if world <= 1:
            return False
        coord = env["PLANK_COORDINATOR"]
        init_method = coord if "://" in coord else f"tcp://{coord}"
        rank = int(env["PLANK_PROCESS_ID"])
    if backend is None:
        backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_rank(rank))
    kwargs = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timeout, **kwargs)
    return dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank(global_rank: int | None = None) -> int:
    """This process's device index on its host: LOCAL_RANK (torchrun's),
    else the rank modulo the visible CUDA devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    r = rank() if global_rank is None else global_rank
    return r % max(1, torch.cuda.device_count())


def default_device() -> str:
    """The device of this rank when the caller names none: ``cuda`` in a
    single process, ``cuda:<local rank>`` in a group."""
    return "cuda" if world_size() == 1 else f"cuda:{local_rank()}"


def is_main() -> bool:
    """True on the process that writes logs, hparams and checkpoints (the
    analog of Lightning's rank-zero-only IO)."""
    return rank() == 0


def owned_row_range(n_rows: int, mesh=None) -> tuple[int, int]:
    """[lo, hi) of this rank's rows of a global batch of `n_rows`: the
    `mesh`'s data rank's contiguous share (every rank of one data replica
    holds the same rows)."""
    if mesh is None or mesh.num_data == 1:
        return 0, n_rows
    if n_rows % mesh.num_data:
        raise ValueError(f"{n_rows} rows do not split over "
                         f"{mesh.num_data} data ranks")
    per = n_rows // mesh.num_data
    return mesh.data_rank * per, (mesh.data_rank + 1) * per


def host_allsum(values, group=None) -> np.ndarray:
    """Sum a small host vector over the ranks of `group` (a gloo group:
    NCCL cannot reduce host tensors), in float64 (torchmetrics'
    `dist_reduce_fx="sum"`). Without a group, the values as they are."""
    arr = torch.as_tensor(np.asarray(values, dtype=np.float64))
    if group is not None:
        dist.all_reduce(arr, op=dist.ReduceOp.SUM, group=group)
    return arr.numpy()


def host_allmax(value: int, group=None) -> int:
    """The largest of one integer over the ranks of `group` (gloo)."""
    t = torch.tensor([int(value)], dtype=torch.int64)
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def barrier(group=None) -> None:
    """Wait for every rank of `group` (none: return at once)."""
    if group is not None:
        dist.barrier(group=group)


def broadcast_object(obj, group=None):
    """Rank 0's `obj` on every rank of `group` (gloo; the world's when it
    holds rank 0)."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]
