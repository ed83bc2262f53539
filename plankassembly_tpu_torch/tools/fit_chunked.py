"""Run a long `fit` as a chain of bounded-lifetime processes
(`tools/fit_chunked.py` of the JAX package, for the port's trainers).

  python -m plankassembly_tpu_torch.tools.fit_chunked --trainer complete \\
      --config configs/train_synthetic_gqa.yaml \\
      --total-epochs 200 --epochs-per-chunk 20 --root-dir runs \\
      [--ckpt_path <checkpoint to start from>] [-- extra trainer flags]

Each chunk is a fresh `python -m plankassembly_tpu_torch.trainer_<name>
fit` of `--epochs-per-chunk` epochs under `--root-dir`; every chunk after
the first resumes from the previous chunk's `checkpoints/last`, so a
process's host memory is bounded by one chunk's growth. The semantics are
the JAX tool's: the step counter and the parameters and Adam moments
carry over, while the epoch counter restarts at 0 in every chunk and the
loader is seeded anew (its shuffle and augmentation start over), so keep
`--epochs-per-chunk` a multiple of `trainer.check_val_every_n_epoch` to
keep the validation and checkpoint cadence. The flags after `--` go to
every chunk verbatim (e.g. `--device cpu`, `--precision f32`,
`--trainer.log_every_n_steps 1`). A chunk that fails, or writes no
`last`, stops the run with a non-zero exit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

TRAINERS = ("complete", "visible", "sideface", "raster")
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_chunk(cmd: list[str]) -> tuple[int, str | None]:
    """Run one chunk, echoing its output; (exit code, the run directory
    its trainer printed as `log_dir: ...`)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
    log_dir = None
    with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                          env=env) as proc:
        for line in proc.stdout:
            sys.stdout.write(line)
            if log_dir is None and line.startswith("log_dir: "):
                log_dir = line[len("log_dir: "):].strip()
        rc = proc.wait()
    sys.stdout.flush()
    return rc, log_dir


def last_logged(log_dir: str) -> dict:
    """The last train-step record of a run's `metrics.jsonl` ({} if none)."""
    last = {}
    path = os.path.join(log_dir, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if "train/loss" in rec:
                    last = rec
    return last


def main(argv: list[str] | None = None) -> str:
    """Run every chunk; returns the final `last` checkpoint's path."""
    ap = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools.fit_chunked",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--trainer", choices=TRAINERS, default="complete",
                    help="the modality: python -m "
                         "plankassembly_tpu_torch.trainer_<name>")
    ap.add_argument("--config", required=True)
    ap.add_argument("--total-epochs", type=int, required=True)
    ap.add_argument("--epochs-per-chunk", type=int, default=20)
    ap.add_argument("--root-dir", required=True,
                    help="--trainer.default_root_dir of every chunk")
    ap.add_argument("--ckpt_path", default=None,
                    help="checkpoint the first chunk starts from (a "
                         "training checkpoint or a released .npz)")
    ap.add_argument("extra", nargs="*",
                    help="flags after -- for every chunk's trainer")
    args = ap.parse_args(argv)
    if args.total_epochs < 1 or args.epochs_per_chunk < 1:
        ap.error("--total-epochs and --epochs-per-chunk must be >= 1")

    ckpt = args.ckpt_path
    done = chunk = 0
    while done < args.total_epochs:
        n = min(args.epochs_per_chunk, args.total_epochs - done)
        cmd = [sys.executable, "-m",
               f"plankassembly_tpu_torch.trainer_{args.trainer}", "fit",
               "--config", args.config,
               "--trainer.default_root_dir", args.root_dir,
               "--trainer.max_epochs", str(n)]
        if ckpt:
            cmd += ["--ckpt_path", ckpt]
        cmd += args.extra
        print(f"[fit_chunked] chunk {chunk}: epochs {done}..{done + n} "
              f"(resume={ckpt})", flush=True)
        t0 = time.perf_counter()
        rc, log_dir = run_chunk(cmd)
        if rc != 0:
            raise SystemExit(f"[fit_chunked] chunk {chunk} failed with "
                             f"rc={rc}")
        if log_dir is None:
            raise SystemExit(f"[fit_chunked] chunk {chunk} printed no "
                             "log_dir")
        ckpt = os.path.join(log_dir, "checkpoints", "last")
        if not os.path.isfile(ckpt + ".pt"):
            raise SystemExit(f"[fit_chunked] chunk {chunk} wrote no 'last' "
                             f"checkpoint at {ckpt}.pt")
        rec = last_logged(log_dir)
        print(f"[fit_chunked] chunk {chunk} done in "
              f"{time.perf_counter() - t0:.1f} s: step {rec.get('step')}, "
              f"host_rss_mb {rec.get('host_rss_mb')}, run {log_dir}",
              flush=True)
        done += n
        chunk += 1
    print(f"[fit_chunked] done: {done} epochs over {chunk} processes; "
          f"final checkpoint {ckpt}", flush=True)
    return ckpt


if __name__ == "__main__":
    main()
