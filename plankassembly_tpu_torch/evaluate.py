"""Offline metrics of dumped prediction JSONs, without JAX: the port's
counterpart of the root `evaluate.py`, with the same arguments and output.

  python -m plankassembly_tpu_torch.evaluate --data_path <dataset> --exp_path <run>

Dequantizes each `<exp_path>/pred_jsons/<name>.json` prediction, matches
it against the continuous ground-truth coords of
`<data_path>/infos/<name>.json` (the bbox row dropped from both), writes
the per-sample scores to `<exp_path>/metrics.json` and prints the
macro-averaged precision, recall and F1 x100. Empty predictions are
skipped, as the reference does.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from plankassembly_tpu_torch.metrics import (
    build_criterion, hungarian_match_host,
)
from plankassembly_tpu_torch.tokens import dequantize_values


def main(args) -> tuple[float, float, float]:
    pred_dir = os.path.join(args.exp_path, "pred_jsons")
    criterion = build_criterion()
    metrics = {}
    for filename in sorted(os.listdir(pred_dir)):
        if not filename.endswith(".json"):
            continue
        name = filename.split(".")[0]
        with open(os.path.join(pred_dir, filename)) as f:
            pred_data = json.load(f)
        with open(os.path.join(args.data_path, "infos", filename)) as f:
            gt_data = json.load(f)
        pred = np.array(pred_data["prediction"])
        if len(pred) == 0:
            continue
        pred = dequantize_values(pred, args.num_bits)
        gt = np.array(gt_data["coords"])
        prec, rec, f1 = hungarian_match_host(pred[1:], gt[1:], args.threshold)
        criterion.update(prec, rec, f1)
        metrics[name] = {"precision": prec, "recall": rec, "fmeasure": f1}

    with open(os.path.join(args.exp_path, "metrics.json"), "w") as f:
        json.dump(metrics, f)
    prec, rec, f1 = criterion.compute()
    print("%10s %0.3f" % ("prec", prec * 100))
    print("%10s %0.3f" % ("rec", rec * 100))
    print("%10s %0.3f" % ("f1", f1 * 100))
    return prec, rec, f1


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.evaluate",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_path", metavar="DIR",
                        default="data/data/complete",
                        help="dataset source root.")
    parser.add_argument("--exp_path", type=str,
                        default="lightning_logs/version_X", help="log path.")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--num_bits", type=int, default=9)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
