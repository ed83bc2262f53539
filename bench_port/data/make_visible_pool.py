"""Write the visible-lines drawing pool: bench_port/data/visible_serve64.json.gz
and visible_train64.json.gz.

  python3 bench_port/data/make_visible_pool.py

The same 128 cabinets as the complete pool (serve64.json.gz: seeds
900000-900063; train64.json.gz: 910000-910063), each from the port's
`factory/synthetic.py::generate_cabinet(seed)` (max_planks 20), projected
to the three views and kept as visible lines only, the path of
`tools/render_svgs.py --data_type visible` and `tools/prepare_info.py
--data_type visible`: `project_boxes`, `postprocess_visible`, the SVG
written and parsed back, each line's bounds. A drawing holds `name`,
`lines`, `views` and `types`, as a request sends them. The files are
written byte for byte alike on every run (gzip without a time stamp), and
the script imports the port only.
"""
from __future__ import annotations

import gzip
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
HALVES = {"visible_serve64.json.gz": range(900000, 900064),
          "visible_train64.json.gz": range(910000, 910064)}


def visible_drawing(seed: int, workdir: str) -> dict:
    from plankassembly_tpu_torch.data import geometry as geo
    from plankassembly_tpu_torch.factory.projection import (
        VIEWS, postprocess_visible, project_boxes,
    )
    from plankassembly_tpu_torch.factory.synthetic import SCALE, generate_cabinet
    from plankassembly_tpu_torch.io.svg import parse_svg, render_svg

    planks, _ = generate_cabinet(seed, max_planks=20)
    boxes = planks[1:] / SCALE
    lines, views, types = [], [], []
    for v_i, view in enumerate(VIEWS):
        segs, kinds = postprocess_visible(*project_boxes(boxes, view, 3))
        path = os.path.join(workdir, f"{view}.svg")
        render_svg(path, segs, kinds)
        parsed, parsed_types = parse_svg(path)
        lines += [geo.bounds(s).tolist() for s in parsed]
        types += parsed_types
        views += [v_i] * len(parsed)
    return {"name": f"syn{seed}", "lines": lines, "views": views,
            "types": types}


def encode(drawings: list[dict]) -> bytes:
    """The file's bytes: compact JSON, gzip with mtime 0."""
    raw = json.dumps(drawings, separators=(",", ":")).encode()
    return gzip.compress(raw, compresslevel=9, mtime=0)


def build() -> dict[str, bytes]:
    """Each file's name and bytes."""
    with tempfile.TemporaryDirectory() as tmp:
        return {name: encode([visible_drawing(s, tmp) for s in seeds])
                for name, seeds in HALVES.items()}


def main():
    for name, blob in build().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(blob)
        print(f"wrote {name}: {len(blob)} bytes")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    main()
