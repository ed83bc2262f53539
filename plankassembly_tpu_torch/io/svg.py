"""SVG line-drawing writer/parser (a copy of `plankassembly_tpu/io/svg.py`,
which replaces svgwrite / svgpathtools).

Emits the same document structure the reference writes
(`dataset/data_utils.py:208-224`, `dataset/render_noisy_svg.py:72-99`):
viewBox "-1 -1 2 2", one <line> per segment, hidden lines dashed, noise
encoded as stroke color (red = deleted, blue = shortened). The parser
implements the subset `prepare_info.parse_svg` relies on
(`dataset/prepare_info.py:14-34`): skip red lines, line type from presence
of stroke-dasharray.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

_NOISE_COLOR = {0: "black", 1: "red", 2: "blue"}


def render_svg(path: str, lines, line_types, noise_types=None,
               line_width: float = 0.5):
    """Write a three-view drawing SVG. lines: iterable of (2, 2) arrays."""
    parts = [
        '<?xml version="1.0" encoding="utf-8" ?>',
        '<svg baseProfile="full" version="1.1" viewBox="-1 -1 2 2" '
        'xmlns="http://www.w3.org/2000/svg">',
        "<defs><style>.vectorEffectClass {vector-effect: "
        "non-scaling-stroke;}</style></defs>",
    ]
    if noise_types is None:
        noise_types = [0] * len(lines)
    for line, line_type, noise_type in zip(lines, line_types, noise_types):
        line = np.asarray(line, dtype=float)
        (x1, y1), (x2, y2) = line[0], line[-1]
        attrs = (f'x1="{x1}" y1="{y1}" x2="{x2}" y2="{y2}" fill="none" '
                 f'class="vectorEffectClass" '
                 f'stroke="{_NOISE_COLOR[noise_type]}" '
                 f'stroke-width="{line_width}"')
        if line_type == 1:
            dash = line_width * 10
            attrs += f' stroke-dasharray="{dash},{dash}"'
        parts.append(f"<line {attrs} />")
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))


def parse_svg(path: str):
    """Parse a drawing SVG back into (lines, line_types), skipping red
    (deleted) lines. Returns lists of ((2,2) float arrays, int)."""
    tree = ET.parse(path)
    root = tree.getroot()
    ns = {"svg": "http://www.w3.org/2000/svg"}
    lines, types = [], []
    elems = root.findall(".//svg:line", ns) or root.findall(".//line")
    for el in elems:
        if el.get("stroke") == "red":
            continue  # deleted by noise (`prepare_info.py:24-25`)
        p = np.array([[float(el.get("x1")), float(el.get("y1"))],
                      [float(el.get("x2")), float(el.get("y2"))]])
        lines.append(p)
        types.append(int(el.get("stroke-dasharray") is not None))
    return lines, types
