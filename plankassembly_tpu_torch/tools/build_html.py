"""Sortable HTML gallery of a test run: input SVGs, metrics, predicted and
ground-truth 3D GLB viewers (the port's counterpart of `tools/build_html.py`,
a port of `misc/build_html.py` with html4vision replaced by a
self-contained page using <model-viewer>).

  python -m plankassembly_tpu_torch.tools.build_html --data_path data --exp_path <run>

Reads `<data_path>/splits/test.txt`, `<exp_path>/metrics.json` (written by
`python -m plankassembly_tpu_torch.evaluate`) and
`<exp_path>/pred_jsons/`; writes `<exp_path>/{pred_mesh,gt_mesh}/<name>.glb`
and `<exp_path>/index.html`, one row per drawing (at most 300, in the
order of numpy's global shuffle, as the JAX tool).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from plankassembly_tpu_torch.io.mesh import build_mesh, export_glb

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>PlankAssembly results</title>
<script type="module" src="https://unpkg.com/@google/model-viewer/dist/model-viewer.min.js"></script>
<style>
table {{border-collapse: collapse; font-family: sans-serif;}}
th, td {{border: 1px solid #ccc; padding: 4px 8px; text-align: center;}}
th {{position: sticky; top: 0; background: #eee; cursor: pointer;}}
img, model-viewer {{width: 256px; height: 256px;}}
</style></head><body>
<table id="t"><thead><tr>
<th>ID</th><th>Front</th><th>Top</th><th>Side</th>
<th>Precision</th><th>Recall</th><th>F1</th><th>Predict</th><th>GT</th>
</tr></thead><tbody>
{rows}
</tbody></table>
<script>
document.querySelectorAll('th').forEach((th, i) => th.addEventListener('click', () => {{
  const tb = document.querySelector('tbody');
  Array.from(tb.rows).sort((a, b) => {{
    const x = a.cells[i].innerText, y = b.cells[i].innerText;
    const nx = parseFloat(x), ny = parseFloat(y);
    return isNaN(nx) ? x.localeCompare(y) : nx - ny;
  }}).forEach(r => tb.appendChild(r));
}}));
</script></body></html>
"""

_ROW = """<tr><td>{name}</td>
<td><img src="svgs/{name}_f.svg"></td>
<td><img src="svgs/{name}_t.svg"></td>
<td><img src="svgs/{name}_s.svg"></td>
<td>{prec:.2f}</td><td>{rec:.2f}</td><td>{f1:.2f}</td>
<td><model-viewer src="pred_mesh/{name}.glb" camera-controls></model-viewer></td>
<td><model-viewer src="gt_mesh/{name}.glb" camera-controls></model-viewer></td>
</tr>"""


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(os.path.join(args.exp_path, "pred_mesh"), exist_ok=True)
    os.makedirs(os.path.join(args.exp_path, "gt_mesh"), exist_ok=True)
    with open(os.path.join(args.data_path, "splits", "test.txt")) as f:
        test_names = [line.rstrip().split(".")[0] for line in f]
    np.random.shuffle(test_names)

    with open(os.path.join(args.exp_path, "metrics.json")) as f:
        metrics = json.load(f)

    rows = []
    for name in test_names[:300]:
        pred_json = os.path.join(args.exp_path, "pred_jsons", f"{name}.json")
        if not os.path.exists(pred_json) or name not in metrics:
            continue
        with open(pred_json) as f:
            results = json.load(f)
        for key, folder in (("prediction", "pred_mesh"),
                            ("groundtruth", "gt_mesh")):
            verts, faces = build_mesh(results[key]) if results[key] else \
                (np.zeros((0, 3)), np.zeros((0, 3), np.int64))
            export_glb(os.path.join(args.exp_path, folder, f"{name}.glb"),
                       verts, faces)
        rows.append(_ROW.format(
            name=name,
            prec=round(metrics[name]["precision"], 4) * 100,
            rec=round(metrics[name]["recall"], 4) * 100,
            f1=round(metrics[name]["fmeasure"], 4) * 100))

    with open(os.path.join(args.exp_path, "index.html"), "w") as f:
        f.write(_PAGE.format(rows="\n".join(rows)))
    print(f"wrote gallery with {len(rows)} rows -> index.html")
    return len(rows)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools.build_html",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_path", metavar="DIR", default="data")
    parser.add_argument("--exp_path", type=str,
                        default="lightning_logs/version_X")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
