"""Generate a synthetic cabinet dataset: shape-program model JSONs + splits
(the port's counterpart of `tools/generate_models.py`, the same files).

  python -m plankassembly_tpu_torch.tools.generate_models --root data --count 100 [--seed 0]

Writes `<root>/model/syn<seed>.json` ({"planks", "attach"}, the contract
of the reference's render scripts, `dataset/render_complete_svg.py:27-30`)
for seeds seed .. seed+count-1, and `<root>/splits/{train,valid,test,
train_sideface}.txt`, a permutation by `np.random.default_rng(seed)`.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from plankassembly_tpu_torch.factory.synthetic import (
    generate_cabinet, validate_program,
)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(os.path.join(args.root, "model"), exist_ok=True)
    os.makedirs(os.path.join(args.root, "splits"), exist_ok=True)

    names = []
    for i in range(args.count):
        planks, attach = generate_cabinet(seed=args.seed + i)
        validate_program(planks, attach)
        name = f"syn{args.seed + i:06d}"
        with open(os.path.join(args.root, "model", f"{name}.json"), "w") as f:
            json.dump({"planks": planks.tolist(),
                       "attach": attach.tolist()}, f)
        names.append(name)

    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(names))
    n_test = max(1, int(len(names) * args.test_frac))
    n_valid = max(1, int(len(names) * args.valid_frac))
    test = [names[i] for i in order[:n_test]]
    valid = [names[i] for i in order[n_test:n_test + n_valid]]
    train = [names[i] for i in order[n_test + n_valid:]]

    for split, items in (("train", train), ("valid", valid), ("test", test),
                         ("train_sideface", train)):
        with open(os.path.join(args.root, "splits", f"{split}.txt"), "w") as f:
            f.write("".join(f"{n}.json\n" for n in items))
    print(f"wrote {len(names)} models: {len(train)} train / "
          f"{len(valid)} valid / {len(test)} test")
    return names


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools.generate_models",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default="data", help="dataset root")
    parser.add_argument("--count", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--test_frac", type=float, default=0.1)
    parser.add_argument("--valid_frac", type=float, default=0.1)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
