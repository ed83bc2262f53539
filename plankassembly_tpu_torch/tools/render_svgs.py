"""Render three-view SVG drawings from shape-program model JSONs (the
port's counterpart of `tools/render_svgs.py`, the same files).

  python -m plankassembly_tpu_torch.tools.render_svgs --root data --data_type complete

One tool covers the reference's three render scripts via --data_type:
  complete  -> `dataset/render_complete_svg.py` (visible + hidden lines)
  visible   -> `dataset/render_visible_svg.py` (hidden filtered, chains merged)
  noise_XX  -> `dataset/render_noisy_svg.py` (per-sample seeded corruption,
               noise encoded as stroke color; XX = percent, e.g. noise_05)
  visible_noise_XX -> the same corruption applied to visible-only
               drawings (the reference only corrupts complete drawings)

complete and visible render the train, valid and test splits; the noisy
variants the test split only, sample i of it corrupted by
`np.random.RandomState(i)`. Projection and hidden-line removal are
`factory/projection.py`'s. Writes `<root>/data/<data_type>/svgs/
<name>_{f,t,s}.svg`; `--max_workers` > 1 renders in that many processes,
with the same files.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os

import numpy as np

from plankassembly_tpu_torch.data.loader import parse_splits_list
from plankassembly_tpu_torch.factory.projection import (
    VIEWS, postprocess_complete, postprocess_visible, project_boxes,
)
from plankassembly_tpu_torch.io.svg import render_svg

SCALE = 1280.0


def add_noises(lines, noise_ratio, noise_length, rng):
    """Deterministic test-set corruption (`render_noisy_svg.py:17-56`).
    Returns noise types: 0 clean, 1 deleted, 2 shortened."""
    num_select = int(np.ceil(len(lines) * noise_ratio))
    indices = rng.permutation(len(lines))[:num_select]
    noise_types = [0] * len(lines)
    for index in indices:
        if rng.random() > 0.5:
            noise_types[index] = 1  # delete
        else:
            line = np.asarray(lines[index], dtype=float)
            length = float(np.linalg.norm(line[1] - line[0]))
            noise = float(np.round(rng.random() * noise_length, 3))
            if length <= noise:
                noise_types[index] = 1
            else:
                d = (line[1] - line[0]) / length
                if rng.random() > 0.5:
                    line = np.stack([line[0], line[1] - d * noise])
                else:
                    line = np.stack([line[0] + d * noise, line[1]])
                lines[index] = line
                noise_types[index] = 2
    return lines, noise_types


def render_three_views(task):
    index, name, args = task
    try:
        with open(os.path.join(args.root, "model", f"{name}.json")) as f:
            annos = json.loads(f.read())

        boxes = np.array(annos["planks"], dtype=float).reshape(-1, 6)[1:]
        boxes = boxes / SCALE  # `dataset/data_utils.py:49-60`

        noisy = "noise" in args.data_type
        if noisy:
            rng = np.random.RandomState(index)  # per-sample determinism

        visible_base = args.data_type.split("_noise")[0] == "visible"
        for view in VIEWS:
            lines, types = project_boxes(boxes, view, args.decimals)
            if visible_base:
                lines, types = postprocess_visible(lines, types)
            else:
                lines, types = postprocess_complete(lines, types)
            if noisy:
                lines, noise_types = add_noises(
                    list(lines), args.noise_ratio, args.noise_length, rng)
            else:
                noise_types = None
            out = os.path.join(args.root, "data", args.data_type, "svgs",
                               f"{name}_{view}.svg")
            render_svg(out, lines, types, noise_types, args.line_width)
    except Exception as exc:  # per-sample isolation (`render_complete_svg.py:40-41`)
        print(f"{name} failed, due to: {exc}")


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(os.path.join(args.root, "data", args.data_type, "svgs"),
                exist_ok=True)
    if "noise" in args.data_type:
        split_files = [os.path.join(args.root, "splits", "test.txt")]
    else:
        split_files = [os.path.join(args.root, "splits", s)
                       for s in ("train.txt", "valid.txt", "test.txt")]
    info_files = parse_splits_list(split_files)
    names = [f.split(".")[0] for f in info_files]
    tasks = [(index, name, args) for index, name in enumerate(names)]
    if args.max_workers > 1:
        # process fan-out as the reference's 16-worker process_map
        # (`dataset/render_complete_svg.py:52-54`); a sample's failure
        # stays inside render_three_views in either mode
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                max_workers=args.max_workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(render_three_views, tasks, chunksize=64))
    else:
        for task in tasks:
            render_three_views(task)
    print(f"rendered {len(names)} models -> {args.data_type}/svgs")
    return names


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools.render_svgs",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", metavar="DIR", default="data")
    parser.add_argument("--data_type", type=str, default="complete",
                        help="complete / visible / noise_05 / noise_10 / "
                        "visible_noise_05 ...")
    parser.add_argument("--noise_ratio", type=float, default=None,
                        help="defaults from data_type suffix (noise_05->0.05)")
    parser.add_argument("--noise_length", type=float, default=0.02)
    parser.add_argument("--line_width", type=float, default=0.5)
    parser.add_argument("--decimals", type=int, default=3)
    parser.add_argument("--max_workers", type=int,
                        default=min(16, os.cpu_count() or 1),
                        help="process fan-out (the reference uses 16; "
                        "serial when 1)")
    args = parser.parse_args(argv)
    if args.noise_ratio is None and "noise_" in args.data_type:
        args.noise_ratio = int(args.data_type.rsplit("_", 1)[1]) / 100.0
    return args


if __name__ == "__main__":
    main()
