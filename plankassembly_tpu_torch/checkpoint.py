"""Checkpoints: the released ones (`checkpoints/*.npz`), the port's own
training checkpoints, and the JAX parameter layout.

A released checkpoint is one flat npz whose keys are ``a/b/c`` paths into
the parameter tree and whose arrays are bfloat16 stored as the raw 2-byte
void dtype ``|V2`` (numpy has no bfloat16). `load_npz` reads those bytes as
uint16 and reinterprets them as `torch.bfloat16`, so it needs no extra dtype
package. The port keeps the JAX package's parameter layout: a nested dict
whose decoder/encoder tensors are stacked on a leading layer axis and whose
projections act as ``x @ W``.

A training checkpoint of the port (`train/loop.py::Trainer.save_checkpoint`)
is `<run>/checkpoints/<tag>.pt`: a `torch.save` of the flat ``a/b/c``
parameter dict, the Adam state and the step, with `<tag>.meta.json` beside
it and the run's config in `<run>/hparams.yaml`. It holds tensors and plain
containers only and loads with ``weights_only=True``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from plankassembly_tpu_torch.config import Config, config_from_hparams_file
from plankassembly_tpu_torch.device import resolve_device


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def load_npz(path: str) -> dict:
    """Nested dict of CPU tensors (bf16 where the file stores ``|V2``)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: _to_tensor(z[k]) for k in z.files if k != "__step__"}
    return _unflatten(flat)


def params_from_jax(tree) -> dict:
    """JAX parameters (a nested dict of numpy or JAX arrays, converted with
    ``np.asarray``) -> the port's nested dict of float32 CPU tensors."""
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32, copy=True)), tree)


def params_to_numpy(params) -> dict:
    return tree_map(lambda t: t.detach().float().cpu().numpy(), params)


def _training_file(path: str) -> str:
    return path if path.endswith(".pt") else path + ".pt"


def load_training_params(path: str) -> tuple[dict, dict | None, int]:
    """(params as float32 CPU tensors, Adam state dict or None, step) of a
    training checkpoint (`<tag>.pt`, or its path without the suffix) or of
    a released `.npz` (no optimizer state, step 0)."""
    if path.endswith(".npz"):
        return tree_map(lambda t: t.float(), load_npz(path)), None, 0
    blob = torch.load(_training_file(path), map_location="cpu",
                      weights_only=True)
    params = tree_map(lambda t: t.float(), _unflatten(blob["params"]))
    return params, blob["opt_state"], int(blob["step"])


def load_checkpoint(path: str, hparams_path: str | None = None,
                    device=None) -> tuple[dict, Config]:
    """(params as float32 tensors on `device`, Config) for serving: a
    released npz with its sidecar `.hparams.yaml` (bf16 weights widen
    exactly to f32, as the JAX package's loader does,
    `tools/predict.py:38-49`), or a training checkpoint of the port with
    its run's `hparams.yaml`."""
    dev = resolve_device(device)
    if path.endswith(".npz"):
        hp = hparams_path or os.path.splitext(path)[0] + ".hparams.yaml"
    else:
        run_dir = os.path.dirname(os.path.dirname(
            os.path.abspath(_training_file(path))))
        hp = hparams_path or os.path.join(run_dir, "hparams.yaml")
    params, _, _ = load_training_params(path)
    params = tree_map(lambda t: t.to(device=dev, dtype=torch.float32), params)
    return params, config_from_hparams_file(hp)
