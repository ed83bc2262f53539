"""Pack rendered SVGs + shape programs into per-sample info JSONs, the
dataset contract of the runtime datasets (the port's counterpart of
`tools/prepare_info.py`, byte-identical files).

  python -m plankassembly_tpu_torch.tools.prepare_info --data_path data --data_type complete

Port of `dataset/prepare_info.py:37-70`: parse the three view SVGs back
(skipping red/deleted lines), store line bounds + geojson linestrings +
views/types, and the shape program as coords (= planks/scale, rounded to
3 decimals) + attach pointers, into `<data_path>/data/<data_type>/infos/
<name>.json` (`--name` one sample; else every sample of the splits the
render tool rendered).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
from functools import partial

import numpy as np

from plankassembly_tpu_torch.data import geometry as geo
from plankassembly_tpu_torch.data.loader import parse_splits_list
from plankassembly_tpu_torch.io.svg import parse_svg


def prepare_annotation(name, args):
    with open(os.path.join(args.data_path, "model", f"{name}.json")) as f:
        infos = json.loads(f.read())

    svgs, types, views = [], [], []
    for v_i, view in enumerate(["f", "t", "s"]):
        svg_path = os.path.join(args.data_path, "data", args.data_type,
                                "svgs", f"{name}_{view}.svg")
        lines, line_types = parse_svg(svg_path)
        svgs.extend(lines)
        types.extend(line_types)
        views.extend([v_i] * len(lines))

    bounds = [geo.bounds(line).tolist() for line in svgs]
    geojson = [geo.to_geojson(line) for line in svgs]

    coords = np.array(infos["planks"]) / args.scale
    coords = np.round(coords, decimals=args.decimals).tolist()

    out = os.path.join(args.data_path, "data", args.data_type, "infos",
                       f"{name}.json")
    with open(out, "w") as f:
        json.dump({
            "name": name,
            "lines": bounds,
            "views": views,
            "types": types,
            "svgs": geojson,
            "coords": coords,
            "attach": infos["attach"],
        }, f)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(os.path.join(args.data_path, "data", args.data_type, "infos"),
                exist_ok=True)
    if args.name:
        prepare_annotation(args.name, args)
        return [args.name]
    if "noise" in args.data_type:
        split_files = [os.path.join(args.data_path, "splits", "test.txt")]
    else:
        split_files = [os.path.join(args.data_path, "splits", s)
                       for s in ("train.txt", "valid.txt", "test.txt")]
    names = [f.split(".")[0] for f in parse_splits_list(split_files)]
    if args.max_workers > 1:
        # process fan-out as the reference's process_map
        # (`dataset/prepare_info.py:85-87`)
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                max_workers=args.max_workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(partial(prepare_annotation, args=args), names,
                          chunksize=64))
    else:
        for name in names:
            prepare_annotation(name, args)
    print(f"wrote {len(names)} info JSONs -> {args.data_type}/infos")
    return names


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools.prepare_info",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_path", metavar="DIR", default="data")
    parser.add_argument("--data_type", type=str, default="complete")
    parser.add_argument("--name", type=str, default="")
    parser.add_argument("--scale", default=1280, type=float)
    parser.add_argument("--decimals", type=int, default=3)
    parser.add_argument("--max_workers", type=int,
                        default=min(16, os.cpu_count() or 1),
                        help="process fan-out (the reference uses 16; "
                        "serial when 1)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
