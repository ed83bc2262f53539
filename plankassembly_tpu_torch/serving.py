"""Online serving over the port's greedy decode.

Ports the serving half of `plankassembly_tpu/serving.py` and the serving
contract of `plankassembly_tpu/export.py` (`serving_meta`, `pad_request`):

- `pack_info_dict` packs one info-JSON request (`lines`, or the `svgs`
  GeoJSON linestrings) into the model's input streams;
- `make_live_backend` turns a loaded checkpoint into a backend callable
  with the (batch, bucket) serving contract;
- `BatchingServer` multiplexes concurrent single-sample requests onto that
  backend: its worker drains the queue up to `batch` rows or `max_wait_ms`
  after the first arrival, runs one decode, and fans the rows back out;
- `postprocess_prediction` turns a decoded row into planks + attachments.

Requests of the sideface modality are not ported yet.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.data import geometry as geo
from plankassembly_tpu_torch.data.packing import pack_input_sequence
from plankassembly_tpu_torch.decode import greedy_decode, parse_sequence
from plankassembly_tpu_torch.device import resolve_device

_INPUT_DTYPES = {
    "input_value": np.int32,
    "input_pos": np.int32,
    "input_coord": np.int32,
    "input_view": np.int32,
    "input_type": np.int32,
    "input_mask": np.bool_,
}


def serving_meta(dims: ModelDims, *, batch: int, bucket: int,
                 compute_dtype=torch.bfloat16, device="cuda") -> dict:
    """The serving contract header (`plankassembly_tpu/export.py:50`) of
    a greedy, early-exiting backend for line-drawing requests."""
    return {
        "batch": batch,
        "bucket": bucket,
        "beam": 0,
        "platforms": [str(device)],
        "early_exit": True,
        "with_type": True,
        "compute_dtype": str(compute_dtype).replace("torch.", ""),
        "input_keys": sorted(_INPUT_DTYPES),
        "input_dtypes": {k: np.dtype(v).name
                         for k, v in _INPUT_DTYPES.items()},
        "max_output_length": dims.max_output_length,
        "num_output_dof": dims.num_output_dof,
        "token_end": dims.end,
        "token_pad": dims.pad,
        "vocab_size": dims.vocab_size,
        "num_model": dims.num_model,
        "kv_heads": dims.kv_heads,
    }


def pad_request(batch: dict, meta: dict) -> tuple[dict, int]:
    """Validate and pad a request to the (batch, bucket) contract
    (`plankassembly_tpu/export.py:192`). Returns (padded arrays, real row
    count). Width beyond the bucket is cropped only if fully masked."""
    B, W = meta["batch"], meta["bucket"]
    arrays = {k: np.asarray(batch[k]) for k in meta["input_keys"]}
    rows = arrays["input_value"].shape[0]
    if rows > B:
        raise ValueError(f"request has {rows} rows; backend serves batch "
                         f"{B} (split the request)")
    width = arrays["input_value"].shape[1]
    if width > W:
        if not np.asarray(arrays["input_mask"][:, W:], bool).all():
            raise ValueError(
                f"request has real tokens beyond the bucket {W} (width "
                f"{width}); use a backend with a larger bucket")
        arrays = {k: v[:, :W] for k, v in arrays.items()}
    padded = {}
    for k, v in arrays.items():
        dt = np.dtype(meta["input_dtypes"][k])
        full = np.full((B, W), meta["token_pad"] if k == "input_value"
                       else (True if k == "input_mask" else 0), dtype=dt)
        full[:rows, :v.shape[1]] = v.astype(dt)
        padded[k] = full
    return padded, rows


def pack_info_dict(info: dict, cfg) -> dict:
    """Pack one prepare_info-contract dict (`lines`/`views`/`types`, or
    raw `svgs` GeoJSON linestrings in place of `lines`, whose bounding
    boxes are the lines) into the model's input streams. (The sideface
    modality's requests are not ported yet.)"""
    if "lines" in info:
        lines = np.array(info["lines"], dtype=np.float64)
    else:
        lines = geo.bounds_many([geo.from_geojson(s) for s in info["svgs"]])
    return pack_input_sequence(
        lines, np.asarray(info["views"]), np.asarray(info["types"]),
        cfg.DATA, cfg.TOKEN, with_type=True)


def postprocess_prediction(sample_row, attach_row, dims: ModelDims):
    """Token row -> (planks (N, 6) incl. the bbox row, attach list), with
    the zero-extent plank filter of the eval dump."""
    pred = parse_sequence(np.asarray(sample_row), dims)
    if len(pred) > 0:
        body = pred[1:]
        keep = np.all(np.abs(body[:, 3:] - body[:, :3]) != 0, axis=1)
        pred = np.concatenate([pred[:1], body[keep]])
    attach = np.asarray(attach_row)[: pred.size].reshape(-1, 6).tolist()
    return pred, attach


def make_live_backend(params, cfg, *, batch: int, bucket: int,
                      compute_dtype=torch.bfloat16, device=None,
                      cross_impl: str = "persistent"):
    """A checkpoint-backed backend with the serving contract. Returns
    (backend callable, meta dict). It decodes with int8 cross K/V
    (`kv_quant=True`) by the decode path `cross_impl` names
    (`decode.decode_from_memory`).

    Unlike the JAX backend, which compiles for a fixed batch, this decodes
    only the request's real rows after `pad_request` validates and pads
    it: every row decodes independently, so the padding rows would change
    nothing but the time taken."""
    dev = resolve_device(device)
    dims = ModelDims.from_config(cfg)
    meta = serving_meta(dims, batch=batch, bucket=bucket,
                        compute_dtype=compute_dtype, device=dev)

    def backend(request: dict) -> dict:
        padded, rows = pad_request(request, meta)
        inputs = {k: torch.from_numpy(v[:rows]).to(dev)
                  for k, v in padded.items()}
        out = greedy_decode(params, inputs, dims,
                            compute_dtype=compute_dtype, kv_bucket=bucket,
                            kv_quant=True, cross_impl=cross_impl)
        return {"samples": out["samples"].cpu().numpy(),
                "attach": out["attach"].cpu().numpy(),
                "num_steps": np.asarray(out["num_steps"])}

    return backend, meta


class BatchingServer:
    """Multiplex concurrent single-sample requests onto one backend call.

    submit() is thread-safe and blocks until the worker has run the
    sample's batch; results carry `batched_rows` (how many requests shared
    the call)."""

    def __init__(self, backend, meta: dict, max_wait_ms: float = 10.0):
        self.backend = backend
        self.meta = meta
        self.max_wait = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0
        self.rows_served = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        while True:
            try:
                _, done, slot = self._q.get_nowait()
            except queue.Empty:
                break
            slot["error"] = RuntimeError("serving backend closed")
            done.set()

    def submit(self, sample: dict, timeout: float = 300.0) -> dict:
        """sample: dict of (W,) input arrays. Returns the decoded row:
        samples/attach/num_steps + batched_rows."""
        if self._stop.is_set():
            raise RuntimeError("serving backend closed")
        W = self.meta["bucket"]
        width = sample["input_value"].shape[0]
        if width > W and not np.asarray(sample["input_mask"][W:],
                                        bool).all():
            raise ValueError(
                f"request has real tokens beyond the bucket {W} (width "
                f"{width}); use a backend with a larger bucket")
        done = threading.Event()
        slot: dict = {}
        self._q.put((sample, done, slot))
        if not done.wait(timeout):
            raise TimeoutError("serving backend did not answer in time")
        if "error" in slot:
            raise slot["error"]
        return slot

    def _worker(self):
        B = self.meta["batch"]
        while not self._stop.is_set():
            try:
                items = [self._q.get(timeout=0.1)]
            except queue.Empty:
                continue
            deadline = time.monotonic() + self.max_wait
            while len(items) < B:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                width = max(s["input_value"].shape[0] for s, _, _ in items)
                request = {
                    k: np.stack([
                        np.pad(s[k], (0, width - s[k].shape[0]),
                               constant_values=(
                                   self.meta["token_pad"]
                                   if k == "input_value" else
                                   True if k == "input_mask" else 0))
                        for s, _, _ in items])
                    for k in self.meta["input_keys"]}
                out = self.backend(request)
            except Exception as e:  # noqa: BLE001 — every waiter gets it
                for _, done, slot in items:
                    slot["error"] = e
                    done.set()
                continue
            self.batches_run += 1
            self.rows_served += len(items)
            batch_steps = int(out["num_steps"])
            for i, (_, done, slot) in enumerate(items):
                row = np.asarray(out["samples"][i])
                slot["samples"] = row
                slot["attach"] = out["attach"][i]
                # per-row step count (first END), not the batch's bound
                ends = np.nonzero(row == self.meta["token_end"])[0]
                slot["num_steps"] = (int(ends[0]) + 1 if ends.size
                                     else batch_steps)
                slot["batched_rows"] = len(items)
                done.set()
