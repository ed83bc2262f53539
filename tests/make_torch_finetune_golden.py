#!/usr/bin/env python
"""Write the JAX package's fine-tune of the released flagship checkpoint,
for the PyTorch port to be held against over many steps.

  python tests/make_torch_finetune_golden.py [--cache DIR]

Runs the JAX package's own path on the CPU:

1. `tools/export_checkpoint.py import` turns
   `checkpoints/gqa_complete_ep221.npz` into an orbax checkpoint with a
   fresh Adam state (the step stays the release's, 65000);
2. `plankassembly_tpu/cli.py fit --ckpt_path <that checkpoint>` with
   `configs/train_synthetic_gqa.yaml` and the overrides in `OVERRIDES`:
   B=8, dropout 0 (the two packages' dropout bits differ outside the
   training kernel), LR 1e-4, 3 epochs of the 64 training drawings
   (`fixtures/train64.json.gz`, 8 steps an epoch, AUG_RATIO 0.1 as
   published), a validation on the 64 serving drawings
   (`fixtures/serve64.json.gz`, made again with their `svgs`, which the
   JAX dataset parses on every read) after every epoch through
   ``decode_impl xla`` with ``kv_quant true``, float32 compute. numpy's
   global RNG, which the JAX dataset's augmentation draws from, is seeded
   with `seed_everything` first, as the reference's Lightning
   `seed_everything` seeds it.

and writes plankassembly_tpu_torch/fixtures/finetune_jax_golden.npz:
every step's loss and accuracy (`metrics.jsonl`, logged every step),
every validation's P/R/F1, the same run's losses and validation F1 in
bfloat16 compute (JAX's own bf16 trajectory beside its f32 one, which
states what bf16 alone moves), the programs of the last validation (decoded
again from the `last` checkpoint, one row per serving drawing in name
order), the epoch and step in the `best` and `last` checkpoints' meta,
and for each parameter leaf after the last step its L2 norm and its dot
with the probe `tests/make_torch_train_golden.py::leaf_probe` draws. It
also stores the protocol (`overrides`, `port_overrides`) so that a run of
the port can repeat it. This script imports JAX and the JAX package, so
it lives with the tests; the port only reads the file.
"""
import argparse
import functools
import glob
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from tests.make_torch_train_golden import leaf_probe, make_info  # noqa: E402

FIXTURES = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
CKPT = os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.npz")
CONFIG = os.path.join(ROOT, "configs", "train_synthetic_gqa.yaml")
SEED = 2022
# the protocol's overrides of the published config, both packages
OVERRIDES = {
    "model.hparams.BATCH_SIZE": "8",
    "model.hparams.MODEL.DROPOUT": "0",
    "model.hparams.LR": "1e-4",
    "trainer.max_epochs": "3",
    "trainer.check_val_every_n_epoch": "1",
    "trainer.log_every_n_steps": "1",
    "trainer.kv_quant": "true",
}
# the validation decode of each package: JAX's `xla` with int8 cross K/V,
# the port's `persistent` (int8 cross K/V built in)
JAX_DECODE = {"trainer.decode_impl": "xla"}
PORT_DECODE = {"trainer.decode_impl": "persistent"}


def unpack(infos_by_split: dict, root: str) -> dict:
    """Write every info JSON under `root`/infos and one split file per
    split; returns {split: path of its .txt}."""
    infos_dir = os.path.join(root, "infos")
    os.makedirs(infos_dir, exist_ok=True)
    splits = {}
    for split, infos in infos_by_split.items():
        names = []
        for info in infos:
            with open(os.path.join(infos_dir, f"{info['name']}.json"),
                      "w") as f:
                json.dump(info, f)
            names.append(f"{info['name']}.json")
        splits[split] = os.path.join(root, f"{split}.txt")
        with open(splits[split], "w") as f:
            f.write("".join(n + "\n" for n in names))
    return splits


def data_overrides(root: str, splits: dict) -> dict:
    return {"model.hparams.ROOT": os.path.join(root, "infos"),
            "model.hparams.DATASETS_TRAIN": splits["train"],
            "model.hparams.DATASETS_VALID": splits["valid"],
            "model.hparams.DATASETS_TEST": splits["valid"]}


def load_fixture(name: str) -> list:
    with gzip.open(os.path.join(FIXTURES, name), "rt") as f:
        return json.load(f)


def serving_infos(workdir: str) -> list:
    """The 64 serving drawings with their `svgs`, which the JAX dataset
    parses on every read (the serving fixture leaves them out): made again
    by `make_info`, every other field equal to the fixture's."""
    fixture = load_fixture("serve64.json.gz")
    infos = [make_info(int(i["name"][3:]), workdir) for i in fixture]
    for info, ref in zip(infos, fixture):
        if {k: v for k, v in info.items() if k != "svgs"} != ref:
            raise SystemExit(f"{info['name']} differs from the fixture")
    return infos


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", default=None,
                    help="JAX persistent compilation cache directory")
    args = ap.parse_args()
    t0 = time.perf_counter()

    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.cache:
        jax.config.update("jax_compilation_cache_dir", args.cache)
    import jax.numpy as jnp

    from plankassembly_tpu import cli
    from plankassembly_tpu.config import load_config
    from plankassembly_tpu.train import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        splits = unpack({"train": load_fixture("train64.json.gz"),
                         "valid": serving_infos(tmp)}, tmp)
        imported = os.path.join(tmp, "imported", "ckpt")
        subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "export_checkpoint.py"),
                        "import", "--npz", CKPT, "--out", imported,
                        "--lr", OVERRIDES["model.hparams.LR"]],
                       check=True, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": ROOT})
        overrides = {**OVERRIDES, **JAX_DECODE, **data_overrides(tmp, splits),
                     "trainer.default_root_dir": os.path.join(tmp, "runs"),
                     "trainer.accelerator": "cpu"}
        def fit(tag, compute_dtype):
            """(step records, validation records, run dir) of one fit."""
            argv = ["fit", "--config", CONFIG, "--ckpt_path", imported]
            for k, v in {**overrides, "trainer.default_root_dir":
                         os.path.join(tmp, "runs", tag)}.items():
                argv += [f"--{k}", v]
            np.random.seed(SEED)
            cli.main(functools.partial(Trainer, compute_dtype=compute_dtype),
                     argv)
            run = glob.glob(os.path.join(tmp, "runs", tag, "version_*"))[0]
            with open(os.path.join(run, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            return ([r for r in recs if "train/loss" in r],
                    [r for r in recs if "val/fmeasure" in r], run)

        t_fit = time.perf_counter()
        steps, vals, run = fit("f32", jnp.float32)
        fit_s = time.perf_counter() - t_fit
        # JAX's own bf16 run of the protocol, beside the f32 golden: how far
        # bfloat16 compute alone moves the trajectory
        steps16, vals16, _ = fit("bf16", jnp.bfloat16)
        meta = {}
        for tag in ("best", "last"):
            with open(os.path.join(run, "checkpoints",
                                   f"{tag}.meta.json")) as f:
                meta[tag] = json.load(f)

        # the last validation's programs, decoded again from `last`
        cfg = load_config(CONFIG, overrides)
        trainer = Trainer(cfg, log_dir=os.path.join(tmp, "eval"),
                          compute_dtype=jnp.float32)
        state = trainer.load_checkpoint(os.path.join(run, "checkpoints",
                                                     "last"))
        programs = {}
        for batch in trainer.val_dataloader():
            _, out = trainer._decode_batch(state, batch)
            samples = np.asarray(out["samples"])
            for i, name in enumerate(batch["name"]):
                if batch["sample_valid"][i]:
                    programs[name] = samples[i]
        names = sorted(programs)

        paths, leaves = zip(*jax.tree_util.tree_leaves_with_path(
            state.params))
        norms, probes = [], []
        for i, leaf in enumerate(leaves):
            w = np.asarray(leaf, np.float64)
            norms.append(np.sqrt(np.sum(w * w)))
            probes.append(np.sum(w * leaf_probe(i, w.shape).astype(
                np.float64)))

    out = {
        "overrides": np.array([f"{k}={v}" for k, v in OVERRIDES.items()]),
        "jax_decode": np.array([f"{k}={v}" for k, v in JAX_DECODE.items()]),
        "port_decode": np.array([f"{k}={v}" for k, v in
                                 PORT_DECODE.items()]),
        "seed": np.int64(SEED),
        "import_step": np.int64(steps[0]["step"] - 1),
        "step": np.array([r["step"] for r in steps]),
        "epoch": np.array([r["epoch"] for r in steps]),
        "loss": np.array([r["train/loss"] for r in steps], np.float64),
        "accuracy": np.array([r["train/accuracy"] for r in steps],
                             np.float64),
        "val_step": np.array([r["step"] for r in vals]),
        "val_epoch": np.array([r["epoch"] for r in vals]),
        "val_precision": np.array([r["val/precision"] for r in vals]),
        "val_recall": np.array([r["val/recall"] for r in vals]),
        "val_fmeasure": np.array([r["val/fmeasure"] for r in vals]),
        "names": np.array(names),
        "programs": np.stack([programs[n] for n in names]).astype(np.int32),
        "leaf_names": np.array(["/".join(p.key for p in path)
                                for path in paths]),
        "leaf_norm": np.array(norms),
        "leaf_probe": np.array(probes),
        **{f"{tag}_{k}": np.int64(meta[tag][k]) for tag in meta
           for k in ("epoch", "step")},
        "best_fmeasure": np.float64(meta["best"]["metrics"]["val/fmeasure"]),
        "loss_bf16": np.array([r["train/loss"] for r in steps16],
                              np.float64),
        "val_fmeasure_bf16": np.array([r["val/fmeasure"] for r in vals16]),
        "fit_seconds": np.float64(fit_s),
    }
    np.savez_compressed(os.path.join(FIXTURES, "finetune_jax_golden.npz"),
                        **out)
    for r in steps:
        print(f"step {r['step']} epoch {r['epoch']} loss "
              f"{r['train/loss']:.6f} acc {r['train/accuracy']:.6f}")
    rel16 = np.abs(out["loss_bf16"] - out["loss"]) / out["loss"]
    print("JAX bf16 against f32, loss relative: "
          + " ".join(f"{x:.1e}" for x in rel16)
          + "; val F1 bf16 " + " ".join(f"{x:.6f}" for x in
                                        out["val_fmeasure_bf16"]))
    for r in vals:
        print(f"val epoch {r['epoch']} step {r['step']} P "
              f"{r['val/precision']:.6f} R {r['val/recall']:.6f} F1 "
              f"{r['val/fmeasure']:.6f}")
    print(f"meta {meta}; fit {fit_s:.1f} s; done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
