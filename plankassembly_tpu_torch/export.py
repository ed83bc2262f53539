"""Serving artifacts of the port: a trained model and its serving contract
in one file, loaded as a backend with `serving.pad_request`'s contract.
The port's counterpart of `plankassembly_tpu/export.py`.

JAX's PSRV1 artifact is the serving program lowered to StableHLO by
`jax.export`, the weights baked in as constants. The port's kernels are
libraries built by `nvcc` and loaded with ctypes, which no such format can
carry, so the port's artifact holds what it takes to rebuild the live
backend instead: the serving contract and the weights. A loaded artifact
runs `serving.decode_backend`, the code of `serving.make_live_backend`,
with the header's options, so it answers as a live backend with those
options does, bit for bit.

Format PTRV1: the 6-byte magic ``PTRV1\\n``, the header's length as a
u64-le, the JSON header, then an npz of the weights under their flat
``a/b/c`` keys. Float weights that bf16 holds exactly (a released
checkpoint's) are stored as bf16, in the raw ``|V2`` layout of
`checkpoints/*.npz`; other float weights as float32; `weight_quant`'s int8
matrices as int8 beside their float scales. The npz is read by
`checkpoint.load_npz` with ``allow_pickle=False``: loading an artifact
runs no code from it.

Header: the keys of JAX `serving_meta` (`serving.serving_meta`, `format`
"PTRV1"), plus `model`, the `ModelDims` fields, which rebuild the model
without a checkpoint or a config, and `decode`, the greedy decode path.
Greedy artifacts decode as JAX's do: ``cross_impl="mxu"`` with int8 cross
K/V at the artifact's bucket and early exit (`plankassembly_tpu/export.py:
138-147`); `beam >= 2` decodes by beam search (`:130-137`).

`data_parallel` > 1 (JAX's SPMD artifact, `:101-116, 233-252`): a loaded
program splits each request's batch into that many equal chunks and
decodes each on one of the first `data_parallel` CUDA devices, which must
be visible; on an explicit CPU device the chunks decode in turn. Rows
decode independently, so the answers are the one-device artifact's.
"""
from __future__ import annotations

import dataclasses
import io
import json
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from plankassembly_tpu_torch.checkpoint import load_npz, tree_map
from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.decode import quantize_decoder_weights
from plankassembly_tpu_torch.device import resolve_device
from plankassembly_tpu_torch.serving import (
    ARTIFACT_FORMAT, decode_backend, pad_request, serving_meta,
)
from plankassembly_tpu_torch.train.state import tree_leaves

MAGIC = (ARTIFACT_FORMAT + "\n").encode()
_JAX_MAGIC = b"PSRV1\n"   # plankassembly_tpu/export.py's artifacts
GREEDY_IMPL = "mxu"


def _stored(t: torch.Tensor) -> np.ndarray:
    """One weight as the npz stores it: bf16 (``|V2``) where that is
    exact, int8 as it is, float32 otherwise."""
    t = t.detach().cpu()
    if t.dtype == torch.int8:
        return t.numpy()
    t = t.float()
    b = t.to(torch.bfloat16)
    if torch.equal(b.float(), t):
        return b.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def export_serving(params, cfg, *, batch: int, bucket: int, beam: int = 0,
                   compute_dtype=torch.bfloat16, early_exit: bool = True,
                   weight_quant: bool = False, data_parallel: int = 1,
                   with_type: bool = True) -> tuple[bytes, dict]:
    """(weights blob, header) of the serving artifact for `params` (the
    port's tree, float32 tensors) under `cfg`. batch/bucket fix the
    request contract; `beam >= 2` serves beam search of that width;
    `weight_quant=True` stores `quantize_decoder_weights(params)`, int8
    decoder and head matrices that the decode takes as they are (a
    smaller file); with_type=False is the sideface contract.
    data_parallel > 1 serves each request's rows split over that many
    devices; with `params` on a CUDA device, as many must be visible."""
    dims = ModelDims.from_config(cfg)
    if batch % data_parallel:
        raise ValueError(f"batch {batch} must divide over "
                         f"data_parallel={data_parallel}")
    device = next(t for _, t in tree_leaves(params)).device
    if data_parallel > 1 and device.type == "cuda":
        _check_visible(data_parallel, "data_parallel="
                       f"{data_parallel} needs that many visible devices")
    if bucket > cfg.DATA.MAX_INPUT_LENGTH - 1:
        raise ValueError(
            f"bucket {bucket} exceeds the model's trained input width "
            f"{cfg.DATA.MAX_INPUT_LENGTH - 1}")
    if weight_quant:
        params = quantize_decoder_weights(params)
    buf = io.BytesIO()
    np.savez(buf, **{"/".join(path): _stored(t)
                     for path, t in tree_leaves(params)})
    meta = serving_meta(dims, batch=batch, bucket=bucket, beam=beam,
                        compute_dtype=compute_dtype, device="cuda",
                        early_exit=early_exit,
                        weight_quant=weight_quant, with_type=with_type)
    meta["data_parallel"] = data_parallel
    meta["model"] = dataclasses.asdict(dims)
    meta["decode"] = {"cross_impl": GREEDY_IMPL}
    return buf.getvalue(), meta


def _check_visible(count: int, what: str) -> None:
    have = torch.cuda.device_count()
    if have < count:
        raise ValueError(f"{what}; {have} visible devices")


def save_artifact(path: str, blob: bytes, meta: dict) -> None:
    header = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(blob)


def load_artifact(path: str, device=None) -> "ServingProgram":
    """The artifact at `path` as a backend on `device` (default CUDA; it
    raises without CUDA unless the caller asks for the CPU)."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == _JAX_MAGIC:
            raise ValueError(
                f"{path}: a JAX PSRV1 serving artifact "
                f"(plankassembly_tpu/export.py); the port loads its own "
                f"{ARTIFACT_FORMAT} artifacts "
                f"(python -m plankassembly_tpu_torch.export_serving)")
        if magic != MAGIC:
            raise ValueError(f"{path}: not a {ARTIFACT_FORMAT} serving "
                             f"artifact of the port")
        (hlen,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(hlen).decode())
        blob = f.read()
    return ServingProgram(meta, load_npz(io.BytesIO(blob)), device)


class ServingProgram:
    """A loaded artifact: validates and pads a request (`pad_request`)
    and decodes its real rows as the header says. `meta` is the header,
    its `platforms` naming the devices the weights were loaded on (the
    first `data_parallel` CUDA devices for a data-parallel artifact on
    CUDA)."""

    def __init__(self, meta: dict, params: dict, device=None):
        dev = resolve_device(device)
        dp = meta.get("data_parallel", 1)
        devices = [dev]
        if dp > 1 and dev.type == "cuda":
            _check_visible(dp, f"artifact was exported for {dp} devices")
            devices = [torch.device("cuda", i) for i in range(dp)]
        self.meta = {**meta, "platforms": [str(d) for d in devices]}
        self.dims = ModelDims(**meta["model"])
        self.devices = devices
        self._backends = []
        for d in devices:
            on_d = tree_map(lambda t: t.to(d) if t.dtype == torch.int8
                            else t.to(device=d, dtype=torch.float32), params)
            self._backends.append(decode_backend(
                on_d, self.dims, self.meta, d,
                cross_impl=meta["decode"]["cross_impl"]))
        self.params = on_d

    def __call__(self, batch: dict) -> dict:
        dp = self.meta.get("data_parallel", 1)
        if dp == 1:
            return self._backends[0](batch)
        padded, rows = pad_request(batch, self.meta)
        step = self.meta["batch"] // dp
        chunks = [{k: v[lo:min(lo + step, rows)] for k, v in padded.items()}
                  for lo in range(0, rows, step)]
        if len(self._backends) == 1:  # the CPU: the chunks in turn
            outs = [self._backends[0](c) for c in chunks]
        else:
            def run(i):
                with torch.cuda.device(self.devices[i]):
                    return self._backends[i](chunks[i])

            with ThreadPoolExecutor(len(chunks)) as pool:
                outs = list(pool.map(run, range(len(chunks))))
        return {"samples": np.concatenate([o["samples"] for o in outs]),
                "attach": np.concatenate([o["attach"] for o in outs]),
                "num_steps": np.asarray(max(int(o["num_steps"])
                                            for o in outs))}
