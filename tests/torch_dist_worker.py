"""Worker process of tests/test_torch_parallel.py and
tests/test_torch_multihost.py: one rank of the port's process groups on
the CPU (gloo).

    python tests/torch_dist_worker.py <spec.json> <process index>

The spec lists phases; in each, this process runs its job (or none), a
function of this module called with the job's arguments, and saves what
it returns to the job's `out` (an npz). A phase's group is formed by its
job (a `file://` rendezvous under the test's directory, never a port) and
destroyed after it, so one spawn runs several worlds in turn. Imports the
port only, never JAX.
"""
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from plankassembly_tpu_torch.checkpoint import load_npz  # noqa: E402
from plankassembly_tpu_torch.config import (  # noqa: E402
    ModelDims, config_from_hparams_file,
)
from plankassembly_tpu_torch.parallel import multihost  # noqa: E402
from plankassembly_tpu_torch.parallel.mesh import (  # noqa: E402
    gather_params, make_mesh, make_seq_mesh, shard_params,
)
from plankassembly_tpu_torch.train.state import (  # noqa: E402
    init_state, make_optimizer, make_train_step, tree_leaves,
)

TIMEOUT = datetime.timedelta(seconds=120)


def _join(init, world, rank):
    if world:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank, timeout=TIMEOUT)


def _flat(tree):
    return {"/".join(p): t.detach().numpy() for p, t in tree_leaves(tree)}


def _dims(cfg_path, dropout):
    cfg = config_from_hparams_file(cfg_path)
    return cfg, dataclasses.replace(ModelDims.from_config(cfg),
                                    dropout=dropout)


def _batch(path):
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def step(cfg, params, batch, num_data=1, num_model=1, dropout=0.0,
         flash=True, steps=1, lr=1e-3, init=None, world=0, rank=0,
         raster=None):
    """`steps` training steps of the global batch on a (num_data,
    num_model) mesh (one process when `world` is 0): the global loss and
    accuracy of each, the gathered parameters after them, this rank's
    shard shapes and token count. `raster` (image size, patch size) takes
    the ViT's loss on the batch's `input_image`."""
    _join(init, world, rank)
    cfg, dims = _dims(cfg, dropout)
    mesh = make_mesh(num_data, num_model, timeout=TIMEOUT) if world else None
    whole = load_npz(params)
    local = shard_params(whole, mesh) if mesh else whole
    state = init_state(local, make_optimizer(lr))
    batch = _batch(batch)
    lo, hi = multihost.owned_row_range(len(batch["output_label"]), mesh)
    rows = {k: v[lo:hi] for k, v in batch.items()}
    kw = {}
    if raster:
        from functools import partial

        from plankassembly_tpu_torch.models.vit import (
            VitDims, train_step_loss_raster,
        )
        kw["loss_impl"] = partial(train_step_loss_raster,
                                  vit=VitDims(*raster))
    fn = make_train_step(dims, compute_dtype=torch.float32, flash=flash,
                         mesh=mesh, **kw)
    losses, accs = [], []
    for _ in range(steps):
        mets = fn(state, rows, torch.Generator().manual_seed(17))
        losses.append(float(mets["loss"]))
        accs.append(float(mets["accuracy"]))
    out = gather_params(state.params, mesh) if mesh else state.params
    res = {"loss": np.array(losses), "accuracy": np.array(accs),
           "tokens": np.array(int((rows["output_label"] != dims.pad).sum()))}
    res.update({"param/" + k: v for k, v in _flat(out).items()})
    res.update({"shape/" + "/".join(p): np.array(t.shape)
                for p, t in tree_leaves(state.params)})
    return res


def seq_encoder(cfg, params, batch, num_seq=1, init=None, world=0, rank=0):
    """The encoder's memory of the batch on a (1, num_seq) seq mesh, and
    the encoder leaves' gradients of sum(memory * probe) summed over the
    seq group."""
    from plankassembly_tpu_torch.models.model import encode

    _join(init, world, rank)
    cfg, dims = _dims(cfg, 0.0)
    mesh = make_seq_mesh(1, num_seq, timeout=TIMEOUT) if world else None
    tree = load_npz(params)
    for part in ("encoder", "embed"):
        for _, t in tree_leaves(tree[part]):
            t.requires_grad_()
    batch = _batch(batch)
    inputs = {k: v for k, v in batch.items() if k.startswith("input")}
    memory = encode(tree, inputs, dims, compute_dtype=torch.float32,
                    flash=True, seq_mesh=mesh)
    probe = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(memory.shape)).astype(np.float32))
    (memory * probe).sum().backward()
    res = {"memory": memory.detach().numpy()}
    for part in ("encoder", "embed"):
        for p, t in tree_leaves(tree[part]):
            if t.grad is None:  # the decoder's embeddings
                continue
            g = t.grad.clone()
            if mesh is not None:
                dist.all_reduce(g, group=mesh.seq_group)
            res[f"grad/{part}/" + "/".join(p)] = g.numpy()
    return res


def fit(cfg, env=None, init=None, world=0, rank=0, validate=True,
        test=True, save=None, reload=None):
    """The port's trainer as the CLI runs it: the process group from the
    PLANK_* variables in `env` (`multihost.initialize_from_env`), or from
    `init`; fit, validate, test. Returns the validation and test scores,
    the kv bucket of each batch validate() decoded beside the one its rows
    alone would take, the prediction JSONs this rank wrote and the
    gathered parameters. `save` names a file to write the 'last'
    checkpoint's path to; `reload` a file holding a checkpoint's path,
    loaded instead of fitting."""
    from plankassembly_tpu_torch.decode import pick_kv_bucket
    from plankassembly_tpu_torch.train import loop

    if env:
        os.environ.update(env)
        assert multihost.initialize_from_env(device="cpu",
                                             timeout=TIMEOUT)
        # a second call is a no-op
        assert multihost.initialize_from_env(device="cpu")
    else:
        _join(init, world, rank)
    config = config_from_hparams_file(cfg)
    buckets, written = [], []
    decode, dump = loop.greedy_decode, loop._dump

    def recording_decode(*a, **kw):
        own = pick_kv_bucket(a[1]["input_mask"],
                             quantum=config.trainer.kv_quantum)
        buckets.append((kw["kv_bucket"], own))
        return decode(*a, **kw)

    def recording_dump(pred_dir, name, payload):
        if pred_dir is not None:
            written.append(name)
        dump(pred_dir, name, payload)

    loop.greedy_decode, loop._dump = recording_decode, recording_dump
    trainer = loop.Trainer(config, compute_dtype=torch.float32,
                           device="cpu")
    try:
        if reload:
            with open(reload) as f:
                state = trainer.load_checkpoint(f.read())
        else:
            state = trainer.fit(trainer.init_state())
        res = {"log_dir": np.array(trainer.log_dir),
               "mesh": np.array([trainer.mesh.num_data,
                                 trainer.mesh.num_model]),
               "rows": np.array(trainer.rows)}
        if validate:
            buckets.clear()
            res["val"] = np.array(trainer.validate(state))
            res["val_buckets"] = np.array(buckets)
        if test:
            res["test"] = np.array(trainer.test(state))
            res["written"] = np.array(written)
        whole = gather_params(state.params, trainer.mesh)
        res.update({"param/" + k: v for k, v in _flat(whole).items()})
        if save:
            path = trainer.save_checkpoint(state, "last")
            with open(save, "w") as f:
                f.write(path)
    finally:
        trainer.close()
        loop.greedy_decode, loop._dump = decode, dump
        for key in env or ():
            os.environ.pop(key)
    return res


def spawn(phases, tmp, timeout=300):
    """Run `phases` (a list, per phase, of each process's job or None) in
    one set of worker processes; raises with a process's output if one
    fails or the set outlasts `timeout` seconds."""
    import subprocess
    import time

    spec = os.path.join(str(tmp), "spec.json")
    with open(spec, "w") as f:
        json.dump({"phases": phases}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), spec, str(i)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(max(len(p) for p in phases))]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"worker {i} exited {p.returncode}:\n"
                               f"{out[-4000:]}")


def main():
    spec_path, index = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    for phase in spec["phases"]:
        job = phase[index] if index < len(phase) else None
        if job is None:
            continue
        res = globals()[job["fn"]](**job["args"])
        np.savez(job["out"], **res)
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
