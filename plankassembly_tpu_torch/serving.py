"""Online serving over the port's decode: dynamic batching, a bucket
ladder and an HTTP front end.

Ports `plankassembly_tpu/serving.py` and the serving contract of
`plankassembly_tpu/export.py` (`serving_meta`, `pad_request`):

- `pack_info_dict` packs one info-JSON request (`lines`, or the `svgs`
  GeoJSON linestrings) into the model's input streams; for the sideface
  modality (`with_type=False`) it extracts the side faces of the `svgs`
  and packs them with no line-type stream;
- `make_live_backend` turns a loaded checkpoint into a backend callable
  with the (batch, bucket) serving contract, greedy (`cross_impl`, "auto"
  by default) or beam search (`beam`);
- `BatchingServer` multiplexes concurrent single-sample requests onto that
  backend: its worker drains the queue up to `batch` rows or `max_wait_ms`
  after the first arrival, runs one decode, and fans the rows back out;
- `BucketRouter` sends each request to the smallest bucket of a ladder of
  servers that fits its real tokens;
- `make_http_server` exposes a server or a router over stdlib HTTP
  (`POST /v1/reconstruct`, `GET /healthz`, `GET /meta`);
- `postprocess_prediction` turns a decoded row into planks + attachments.
"""
from __future__ import annotations

import json
import queue
import threading
import time

import numpy as np
import torch

from plankassembly_tpu_torch.beam import beam_decode
from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.data import geometry as geo
from plankassembly_tpu_torch.data.packing import pack_input_sequence
from plankassembly_tpu_torch.data.sideface_data import extract_sidefaces
from plankassembly_tpu_torch.decode import (
    _is_prequantized, greedy_decode, parse_sequence,
)
from plankassembly_tpu_torch.device import resolve_device

_INPUT_DTYPES = {
    "input_value": np.int32,
    "input_pos": np.int32,
    "input_coord": np.int32,
    "input_view": np.int32,
    "input_type": np.int32,
    "input_mask": np.bool_,
}


def serving_meta(dims: ModelDims, *, batch: int, bucket: int, beam: int = 0,
                 compute_dtype=torch.bfloat16, device="cuda",
                 weight_quant: bool = False, with_type: bool = True) -> dict:
    """The serving contract header (`plankassembly_tpu/export.py:50`) of
    an early-exiting backend. with_type=False is the sideface modality's
    contract: no `input_type` stream, so the encoder adds no type
    embedding."""
    keys = {k: v for k, v in _INPUT_DTYPES.items()
            if with_type or k != "input_type"}
    return {
        "batch": batch,
        "bucket": bucket,
        "beam": beam,
        "platforms": [str(device)],
        "early_exit": True,
        "weight_quant": bool(weight_quant),
        "with_type": bool(with_type),
        "compute_dtype": str(compute_dtype).replace("torch.", ""),
        "input_keys": sorted(keys),
        "input_dtypes": {k: np.dtype(v).name for k, v in keys.items()},
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


def pack_info_dict(info: dict, cfg, with_type: bool = True) -> dict:
    """Pack one prepare_info-contract dict (`lines`/`views`/`types`, or
    raw `svgs` GeoJSON linestrings in place of `lines`, whose bounding
    boxes are the lines) into the model's input streams.

    with_type=False is the sideface modality: the request's `svgs` go
    through the side-face extractor (`data/sideface_data.py`, as the
    sideface dataset derives its inputs) and pack with no line-type
    stream. A request without `svgs` raises ValueError."""
    if not with_type:
        if "svgs" not in info:
            raise ValueError("sideface requests need 'svgs' (GeoJSON view "
                             "linestrings): side faces are derived, not "
                             "given as lines")
        linestrings = [geo.from_geojson(s) for s in info["svgs"]]
        data = cfg.DATA
        faces, faceviews = extract_sidefaces(
            linestrings, np.asarray(info["views"]),
            data.MAX_THICKNESS / data.SCALE,
            data.MERGE_TOLERANCE / data.SCALE,
            data.MIN_THICKNESS / data.SCALE)
        return pack_input_sequence(faces, faceviews, None, cfg.DATA,
                                   cfg.TOKEN, with_type=False)
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


def make_live_backend(params, cfg, *, batch: int, bucket: int, beam: int = 0,
                      compute_dtype=torch.bfloat16, device=None,
                      cross_impl: str = "auto", with_type: bool = True):
    """A checkpoint-backed backend with the serving contract. Returns
    (backend callable, meta dict). beam >= 2 decodes by beam search of
    that width (`beam.beam_decode`); otherwise greedily with int8 cross
    K/V (`kv_quant=True`) by the decode path `cross_impl` names
    (`decode.decode_from_memory`; "auto" takes the persistent kernels on
    a GPU in their batch band). with_type=False serves the sideface
    modality (requests packed by `pack_info_dict(with_type=False)`).
    Weights from
    `decode.quantize_decoder_weights` decode with int8 weights.

    Unlike the JAX backend, which compiles for a fixed batch, this decodes
    only the request's real rows after `pad_request` validates and pads
    it: every row decodes independently, so the padding rows would change
    nothing but the time taken. Backends on one device may be called from
    several threads at once (a `BucketRouter`'s servers)."""
    dev = resolve_device(device)
    dims = ModelDims.from_config(cfg)
    meta = serving_meta(dims, batch=batch, bucket=bucket, beam=beam,
                        compute_dtype=compute_dtype, device=dev,
                        weight_quant=_is_prequantized(
                            params["decoder"]["self_attn"]["wq"]),
                        with_type=with_type)

    def decode(inputs):
        if beam >= 2:
            return beam_decode(params, inputs, dims, num_beams=beam,
                               compute_dtype=compute_dtype)
        return greedy_decode(params, inputs, dims,
                             compute_dtype=compute_dtype, kv_bucket=bucket,
                             kv_quant=True, cross_impl=cross_impl)

    def backend(request: dict) -> dict:
        padded, rows = pad_request(request, meta)
        inputs = {k: torch.from_numpy(v[:rows]).to(dev)
                  for k, v in padded.items()}
        out = decode(inputs)
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


class BucketRouter:
    """Route each request to the smallest serving bucket that fits it.

    The serving analogue of the eval loop's per-batch kv bucket: a small
    ladder of servers (e.g. buckets 512 / 768 / 1152) with requests routed
    by their real token count, so inputs longer than the smallest bucket
    are served without every request paying the largest one's
    cross-attention. Exposes the submit()/meta/close() surface of
    BatchingServer, so the HTTP front end treats them alike; an answer
    carries the bucket that served it (`bucket`)."""

    def __init__(self, servers: list[BatchingServer]):
        if not servers:
            raise ValueError("BucketRouter needs at least one server")
        self.servers = sorted(servers, key=lambda s: s.meta["bucket"])
        buckets = [s.meta["bucket"] for s in self.servers]
        if len(set(buckets)) != len(buckets):
            raise ValueError(f"duplicate buckets in the ladder: {buckets}")
        for key in ("token_pad", "token_end", "input_keys", "with_type",
                    "max_output_length", "num_output_dof"):
            vals = {json.dumps(s.meta.get(key), sort_keys=True)
                    for s in self.servers}
            if len(vals) != 1:
                raise ValueError(
                    f"bucket ladder mixes incompatible programs: {key} "
                    f"differs across backends")
        self.meta = dict(self.servers[-1].meta)  # the widest contract
        self.meta["buckets"] = buckets

    @property
    def batches_run(self):
        return sum(s.batches_run for s in self.servers)

    @property
    def rows_served(self):
        return sum(s.rows_served for s in self.servers)

    def submit(self, sample: dict, timeout: float = 300.0) -> dict:
        n_real = int((~np.asarray(sample["input_mask"], bool)).sum())
        for server in self.servers:  # real tokens form a prefix (packing)
            if n_real <= server.meta["bucket"]:
                out = server.submit(sample, timeout=timeout)
                out["bucket"] = server.meta["bucket"]
                return out
        raise ValueError(
            f"request has {n_real} real tokens; largest bucket in the "
            f"ladder is {self.servers[-1].meta['bucket']} — serve it with a "
            f"larger bucket")

    def close(self):
        for s in self.servers:
            s.close()


def make_http_server(server, cfg, dims: ModelDims, port: int = 0):
    """A stdlib ThreadingHTTPServer on 127.0.0.1 over a BatchingServer or
    a BucketRouter: POST /v1/reconstruct (an info JSON in, planks and
    attachments out), GET /healthz, GET /meta. A request that cannot be
    served (a ValueError: too long, malformed numbers) answers 400, an
    unknown route 404, any other failure 500; the server keeps running.
    The caller runs `serve_forever` and, at the end, `shutdown`."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def reconstruct(info: dict) -> dict:
        sample = pack_info_dict(info, cfg,
                                with_type=server.meta.get("with_type", True))
        t0 = time.perf_counter()
        row = server.submit({k: v for k, v in sample.items()
                             if k.startswith("input")})
        pred, attach = postprocess_prediction(row["samples"], row["attach"],
                                              dims)
        resp = {
            "name": info.get("name", "sample"),
            "prediction": pred.tolist(),
            "attach": attach,
            "num_steps": row["num_steps"],
            "batched_rows": row["batched_rows"],
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 1),
        }
        if "bucket" in row:  # a BucketRouter names the bucket it took
            resp["bucket"] = row["bucket"]
        return resp

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True,
                                 "batches_run": server.batches_run,
                                 "rows_served": server.rows_served})
            elif self.path == "/meta":
                self._send(200, server.meta)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/reconstruct":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                info = json.loads(self.rfile.read(n).decode())
                self._send(200, reconstruct(info))
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the server stays up
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)
