"""Command line of the port's trainers (the surface of
`plankassembly_tpu/cli.py`):

    python -m plankassembly_tpu_torch.cli fit --config configs/train_synthetic_gqa.yaml
    python -m plankassembly_tpu_torch.cli validate --config ... --ckpt_path <run>/checkpoints/best
    python -m plankassembly_tpu_torch.cli test --config ... --ckpt_path <run>/checkpoints/last

`cli` (and `trainer_complete`) trains the complete-lines modality;
`python -m plankassembly_tpu_torch.trainer_visible`,
`python -m plankassembly_tpu_torch.trainer_sideface` and
`python -m plankassembly_tpu_torch.trainer_raster` take the same
arguments for the visible-lines, sideface and raster/ViT modalities.

`--device cuda|cpu` picks the device (default cuda; without CUDA it
raises rather than run on the CPU), `--precision bf16|f32` the compute
dtype (default bf16, as the JAX trainer's). Several processes train one model when
the environment describes a process group (`parallel/multihost.py`), for
instance on four GPUs of one host:

    PLANK_DISTRIBUTED=1 torchrun --nproc_per_node 4 \
        -m plankassembly_tpu_torch.trainer_complete fit --config configs/train_complete.yaml

Each rank then takes `cuda:<LOCAL_RANK>` and NCCL (gloo with --device
cpu). `fit --ckpt_path` resumes from a
training checkpoint of the port, or starts from a released `.npz` with a
fresh Adam state. Any other ``--dot.path value`` pair overrides the config
(``--model.hparams.LR 2e-5``, ``--trainer.max_epochs 20``).
"""
from __future__ import annotations

import sys

from plankassembly_tpu_torch.config import load_config
from plankassembly_tpu_torch.parallel import multihost

SUBCOMMANDS = ("fit", "test", "validate")
PRECISIONS = {"bf16": "bfloat16", "f32": "float32"}


def parse_args(argv: list[str]):
    """(subcommand, config path, ckpt path or None, device or None,
    overrides)."""
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        sys.exit(0)
    subcommand = argv[0]
    if subcommand not in SUBCOMMANDS:
        raise SystemExit(f"unknown subcommand {subcommand!r} "
                         "(expected fit/test/validate)")
    config_path = ckpt_path = device = None
    overrides: dict[str, str] = {}
    i = 1
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument {arg!r}")
        if i + 1 >= len(argv):
            raise SystemExit(f"{arg} needs a value")
        value = argv[i + 1]
        if arg == "--config":
            config_path = value
        elif arg == "--ckpt_path":
            ckpt_path = value
        elif arg == "--device":
            device = value
        else:
            overrides[arg[2:]] = value
        i += 2
    if config_path is None:
        raise SystemExit("--config is required")
    if subcommand != "fit" and ckpt_path is None:
        raise SystemExit(f"{subcommand} requires --ckpt_path")
    return subcommand, config_path, ckpt_path, device, overrides


def main(argv: list[str] | None = None, trainer_cls=None):
    """Run one subcommand with `trainer_cls` (default the complete-lines
    `Trainer`); returns (the trainer, the trained TrainState) for fit and
    (the trainer, (precision, recall, fmeasure)) otherwise."""
    if trainer_cls is None:
        from plankassembly_tpu_torch.train.loop import Trainer as trainer_cls

    argv = argv if argv is not None else sys.argv[1:]
    subcommand, config_path, ckpt_path, device, overrides = parse_args(argv)
    precision = overrides.pop("precision", "bf16")
    if precision not in PRECISIONS:
        raise SystemExit(f"--precision {precision!r}: one of "
                         f"{sorted(PRECISIONS)}")
    cfg = load_config(config_path, overrides)
    multihost.initialize_from_env(device=device)
    import torch
    trainer = trainer_cls(cfg, device=device, compute_dtype=getattr(
        torch, PRECISIONS[precision]))
    if multihost.is_main():
        print(f"log_dir: {trainer.log_dir}", flush=True)
    try:
        state = (trainer.load_checkpoint(ckpt_path) if ckpt_path
                 else trainer.init_state())
        if subcommand == "fit":
            return trainer, trainer.fit(state)
        scores = (trainer.validate(state) if subcommand == "validate"
                  else trainer.test(state))
    finally:
        trainer.close()
    if multihost.is_main():
        print("precision={:.4f} recall={:.4f} fmeasure={:.4f}".format(
            *scores))
    return trainer, scores


def main_complete(argv: list[str] | None = None):
    from plankassembly_tpu_torch.train.loop import Trainer
    return main(argv, Trainer)


def main_visible(argv: list[str] | None = None):
    from plankassembly_tpu_torch.train.loop import VisibleTrainer
    return main(argv, VisibleTrainer)


def main_sideface(argv: list[str] | None = None):
    from plankassembly_tpu_torch.train.loop import SidefaceTrainer
    return main(argv, SidefaceTrainer)


def main_raster(argv: list[str] | None = None):
    from plankassembly_tpu_torch.train.raster_loop import RasterTrainer
    return main(argv, RasterTrainer)


if __name__ == "__main__":
    main()
