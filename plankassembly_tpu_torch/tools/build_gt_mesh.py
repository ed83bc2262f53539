"""Export ground-truth STL meshes of the test split (the port's
counterpart of `tools/build_gt_mesh.py`, a port of `misc/build_gt_mesh.py`).

  python -m plankassembly_tpu_torch.tools.build_gt_mesh --data_path data

Reads `<data_path>/splits/test.txt` and each sample's
`<data_path>/data/complete/infos/<name>.json`; writes
`<data_path>/mesh/<name>.stl`.
"""
from __future__ import annotations

import argparse
import json
import os

from plankassembly_tpu_torch.io.mesh import build_mesh, export_stl


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(os.path.join(args.data_path, "mesh"), exist_ok=True)
    with open(os.path.join(args.data_path, "splits", "test.txt")) as f:
        names = [line.rstrip().split(".")[0] for line in f]

    for name in names:
        with open(os.path.join(args.data_path, "data/complete", "infos",
                               f"{name}.json")) as f:
            infos = json.load(f)
        verts, faces = build_mesh(infos["coords"])
        export_stl(os.path.join(args.data_path, "mesh", f"{name}.stl"),
                   verts, faces)
    print(f"exported {len(names)} GT meshes")
    return len(names)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools.build_gt_mesh",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_path", type=str, default="data")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
