"""Export predicted STL meshes from dumped prediction JSONs (the port's
counterpart of `tools/build_pred_mesh.py`, a port of
`misc/build_pred_mesh.py`: dequantize, then mesh).

  python -m plankassembly_tpu_torch.tools.build_pred_mesh --exp_path <run>

Reads `<exp_path>/pred_jsons/*.json` (`Trainer.test`'s output); writes
`<exp_path>/pred_meshes/<name>.stl`.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from plankassembly_tpu_torch.io.mesh import build_mesh, export_stl
from plankassembly_tpu_torch.tokens import dequantize_values


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(os.path.join(args.exp_path, "pred_meshes"), exist_ok=True)
    filenames = os.listdir(os.path.join(args.exp_path, "pred_jsons"))
    count = 0
    for filename in filenames:
        if not filename.endswith(".json"):
            continue
        with open(os.path.join(args.exp_path, "pred_jsons", filename)) as f:
            infos = json.load(f)
        coords = dequantize_values(np.array(infos["prediction"]))
        verts, faces = build_mesh(coords)
        export_stl(os.path.join(args.exp_path, "pred_meshes",
                                filename.replace(".json", ".stl")),
                   verts, faces)
        count += 1
    print(f"exported {count} predicted meshes")
    return count


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools.build_pred_mesh",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--exp_path", type=str,
                        default="lightning_logs/version_X")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
