"""Online reconstruction service over the port, with dynamic batching. The
port's counterpart of `tools/serve.py` (its `--ckpt` backend).

  python -m plankassembly_tpu_torch.serve --ckpt checkpoints/gqa_complete_ep221.npz \\
      --batch 16 --bucket 512 [--beam 4] [--weight_quant] [--cpu] --port 8713
  python -m plankassembly_tpu_torch.serve --ckpt ... --bucket 512 768 1152   # a ladder
  python -m plankassembly_tpu_torch.serve --ckpt checkpoints/gqa_sideface_ep119.npz \
      --no_input_type --bucket 128 299                                   # sideface

  curl -s localhost:8713/v1/reconstruct -d @info.json
  curl -s localhost:8713/healthz

Concurrent requests share one decode call (`serving.BatchingServer`): up to
--batch rows after at most --max_wait_ms of queueing. Several --bucket
values serve a ladder: each request goes to the smallest bucket that fits
its real tokens (`serving.BucketRouter`). --no_input_type serves a
sideface checkpoint: each request's `svgs` go through the side-face
extractor, and its bucket is chosen by its packed face tokens. Without
--cpu it runs on the GPU and raises if CUDA is absent.
"""
from __future__ import annotations

import argparse

import torch

from plankassembly_tpu_torch.checkpoint import load_checkpoint
from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.device import resolve_device

ARTIFACT_TODO = "not ported yet (ROADMAP.md §1, item 6: export)"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.serve",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="released .npz or a training checkpoint of the port")
    ap.add_argument("--artifact", default=None,
                    help=f"serving artifact: {ARTIFACT_TODO}")
    ap.add_argument("--hparams", default=None,
                    help="hparams.yaml (default: beside the checkpoint)")
    ap.add_argument("--port", type=int, default=8713)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--bucket", type=int, nargs="+", default=[512],
                    help="kv bucket; several make a ladder")
    ap.add_argument("--beam", type=int, default=0,
                    help="beam width (0 = greedy)")
    ap.add_argument("--max_wait_ms", type=float, default=10.0)
    ap.add_argument("--weight_quant", action="store_true",
                    help="int8 decoder and head weights "
                    "(decode.quantize_decoder_weights; greedy takes mxu)")
    ap.add_argument("--no_input_type", action="store_true",
                    help="sideface input contract: requests' svgs run the "
                    "side-face extractor and pack with no line-type stream")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.artifact:
        ap.error(f"--artifact: {ARTIFACT_TODO}")
    return args


def make_server(argv=None):
    """(HTTP server, BatchingServer or BucketRouter) for the given
    arguments; the caller serves and closes them."""
    from plankassembly_tpu_torch.decode import quantize_decoder_weights
    from plankassembly_tpu_torch.serving import (
        BatchingServer, BucketRouter, make_http_server, make_live_backend,
    )

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    params, cfg = load_checkpoint(args.ckpt, args.hparams, device=dev)
    if args.weight_quant:
        params = quantize_decoder_weights(params)
    servers = []
    for bucket in sorted(set(args.bucket)):
        backend, meta = make_live_backend(
            params, cfg, batch=args.batch, bucket=bucket, beam=args.beam,
            compute_dtype=torch.bfloat16, device=dev,
            with_type=not args.no_input_type)
        servers.append(BatchingServer(backend, meta,
                                      max_wait_ms=args.max_wait_ms))
    server = servers[0] if len(servers) == 1 else BucketRouter(servers)
    httpd = make_http_server(server, cfg, ModelDims.from_config(cfg),
                             port=args.port)
    return httpd, server


def main(argv=None):
    httpd, server = make_server(argv)
    meta = server.meta
    print(f"serving on http://127.0.0.1:{httpd.server_address[1]} "
          f"(batch={meta['batch']} "
          f"bucket={meta.get('buckets', meta['bucket'])} "
          f"beam={meta['beam']} weight_quant={meta['weight_quant']} "
          f"device={meta['platforms'][0]})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
