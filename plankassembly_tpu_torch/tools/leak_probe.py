"""The host memory slope of the raster training path, stage by stage (the
port's counterpart of the JAX package's `tools/leak_probe.py`).

  python -m plankassembly_tpu_torch.tools.leak_probe \\
      [--stages dataset,put,step,full] [--iters 300] [--batch 16] \\
      [--image-size 256] [--patch-size 32] [--data-root DIR] \\
      [--config YAML] [--device cuda|cpu]

Each stage runs `--iters` iterations and prints one JSON line with its
resident-set slope in KiB an iteration (a least-squares line over the last
80% of the iterations, past the warm-up allocations) and the RSS at its
end:

- dataset: `RasterDataset` reads (augmented, AUG_RATIO as configured) and
  `collate`, host only;
- put: the same batches copied to the device (pinned, as the trainer
  copies them), then dropped;
- step: the raster train step (`RasterTrainer`'s, the ViT, the line
  decoder, Adam) on one fixed device batch;
- full: the loop a fit runs: read, copy, step.

`--data-root` is a dataset of the factory (`data/complete/infos` and
`splits/train.txt` under it); without it the 64 training drawings of
`fixtures/train64.json.gz` are used. The model is `--config`'s, by
default the default config's (d=512, 6+6 layers), with a `--image-size`
ViT of `--patch-size` patches, as the JAX probe's.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import tempfile

import numpy as np

from plankassembly_tpu_torch.utils.profiling import host_rss_kb

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "train64.json.gz")


def slope(samples) -> float:
    """KiB an iteration over the last 80% of `samples`."""
    xs = np.arange(len(samples))
    cut = len(samples) // 5
    return float(np.polyfit(xs[cut:], np.asarray(samples[cut:], np.float64),
                            1)[0])


def unpack_fixture(root: str) -> tuple[str, str]:
    """The training fixture as info JSONs under `root`; (infos dir, split
    file)."""
    infos = os.path.join(root, "infos")
    os.makedirs(infos, exist_ok=True)
    with gzip.open(FIXTURE, "rt") as f:
        drawings = json.load(f)
    split = os.path.join(root, "train.txt")
    with open(split, "w") as f:
        for info in drawings:
            with open(os.path.join(infos, f"{info['name']}.json"), "w") as g:
                json.dump(info, g)
            f.write(f"{info['name']}.json\n")
    return infos, split


def report(stage: str, rss: list, device: str) -> dict:
    rec = {"stage": stage, "kb_per_iter": round(slope(rss), 2),
           "rss_mb": rss[-1] // 1024, "iters": len(rss), "device": device}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools.leak_probe",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default="dataset,put,step,full")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--patch-size", type=int, default=32)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--config", default=None,
                    help="a config YAML for the model (default: Config())")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    stages = args.stages.split(",")
    unknown = set(stages) - {"dataset", "put", "step", "full"}
    if unknown:
        ap.error(f"unknown stages {sorted(unknown)}")
    if args.iters < 5:
        ap.error("--iters must be >= 5")

    import torch

    from plankassembly_tpu_torch.config import Config, load_config
    from plankassembly_tpu_torch.data.loader import collate
    from plankassembly_tpu_torch.train.loop import _to_device
    from plankassembly_tpu_torch.train.raster_loop import RasterTrainer

    out = []
    with tempfile.TemporaryDirectory(prefix="leak_probe_") as tmp:
        if args.data_root:
            infos = os.path.join(args.data_root, "data", "complete", "infos")
            split = os.path.join(args.data_root, "splits", "train.txt")
        else:
            infos, split = unpack_fixture(tmp)
        cfg = load_config(args.config) if args.config else Config()
        cfg = dataclasses.replace(
            cfg, ROOT=infos, DATASETS_TRAIN=split, BATCH_SIZE=args.batch,
            trainer=dataclasses.replace(cfg.trainer, default_root_dir=tmp))
        trainer = RasterTrainer(cfg, device=args.device,
                                image_size=args.image_size,
                                patch_size=args.patch_size)
        device = str(trainer.device)
        ds = trainer._dataset(cfg.DATASETS_TRAIN, True)

        def batch_at(i):
            return collate([ds[(i * args.batch + j) % len(ds)]
                            for j in range(args.batch)])

        def sync():
            if trainer.device.type == "cuda":
                torch.cuda.synchronize(trainer.device)

        try:
            if "dataset" in stages:
                rss = []
                for i in range(args.iters):
                    batch_at(i)
                    rss.append(host_rss_kb())
                out.append(report("dataset", rss, device))
            if "put" in stages:
                rss = []
                for i in range(args.iters):
                    arrays = _to_device(batch_at(i), trainer.device)
                    sync()
                    del arrays
                    rss.append(host_rss_kb())
                out.append(report("put", rss, device))
            state = trainer.init_state()
            if "step" in stages:
                fixed = _to_device(batch_at(0), trainer.device)
                rss = []
                for _ in range(args.iters):
                    mets = trainer.train_step_fn(state, fixed, trainer._rng)
                    float(mets["loss"])
                    rss.append(host_rss_kb())
                out.append(report("step", rss, device))
            if "full" in stages:
                rss = []
                for i in range(args.iters):
                    arrays = _to_device(batch_at(i), trainer.device)
                    mets = trainer.train_step_fn(state, arrays, trainer._rng)
                    float(mets["loss"])
                    rss.append(host_rss_kb())
                out.append(report("full", rss, device))
        finally:
            trainer.close()
    return out


if __name__ == "__main__":
    main()
