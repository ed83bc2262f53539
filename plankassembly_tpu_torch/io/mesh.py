"""Minimal mesh builder/exporter (a copy of `plankassembly_tpu/io/mesh.py`,
which replaces trimesh).

Builds box meshes from shape programs and exports binary STL and GLB —
the two formats the reference viz uses (`misc/mesh_utils.py:29-45`,
`misc/build_pred_mesh.py:27-30`, `misc/build_html.py:34-38`).
"""
from __future__ import annotations

import json
import struct

import numpy as np

# unit-box triangulation (12 tris, outward normals)
_BOX_VERTS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=np.float64)
_BOX_FACES = np.array([
    [0, 2, 1], [0, 3, 2],  # z=0
    [4, 5, 6], [4, 6, 7],  # z=1
    [0, 1, 5], [0, 5, 4],  # y=0
    [3, 6, 2], [3, 7, 6],  # y=1
    [0, 7, 3], [0, 4, 7],  # x=0
    [1, 2, 6], [1, 6, 5],  # x=1
], dtype=np.int64)


def build_mesh(planks) -> tuple[np.ndarray, np.ndarray]:
    """Union of box meshes from a shape program, skipping row 0 (bbox)
    (`misc/mesh_utils.py:29-37`). Returns (vertices (V,3), faces (F,3))."""
    planks = np.asarray(planks, dtype=np.float64).flatten().reshape(-1, 6)
    verts_all, faces_all = [], []
    offset = 0
    for plank in planks[1:]:
        lo, hi = plank[:3], plank[3:]
        v = _BOX_VERTS * (hi - lo) + lo
        verts_all.append(v)
        faces_all.append(_BOX_FACES + offset)
        offset += 8
    if not verts_all:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    return np.concatenate(verts_all), np.concatenate(faces_all)


def export_stl(path: str, vertices: np.ndarray, faces: np.ndarray):
    """Binary STL writer."""
    tris = vertices[faces]  # (F, 3, 3)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norm > 0, n / np.where(norm == 0, 1, norm), 0)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(faces)))
        for i in range(len(faces)):
            f.write(struct.pack("<3f", *n[i]))
            for v in tris[i]:
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))


def export_glb(path: str, vertices: np.ndarray, faces: np.ndarray,
               base_color=(0.8, 0.8, 0.85, 0.6)):
    """Minimal GLB (glTF 2.0 binary) writer — enough for 3D viewers."""
    verts = np.asarray(vertices, dtype=np.float32)
    idx = np.asarray(faces, dtype=np.uint32).reshape(-1)

    vbuf = verts.tobytes()
    ibuf = idx.tobytes()
    pad = (-len(vbuf)) % 4
    vbuf += b"\0" * pad
    bin_chunk = vbuf + ibuf
    bin_chunk += b"\0" * ((-len(bin_chunk)) % 4)

    vmin = verts.min(axis=0).tolist() if len(verts) else [0, 0, 0]
    vmax = verts.max(axis=0).tolist() if len(verts) else [0, 0, 0]
    gltf = {
        "asset": {"version": "2.0", "generator": "plankassembly_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": list(base_color), "metallicFactor": 0.0},
            "alphaMode": "BLEND", "doubleSided": True}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(verts),
             "type": "VEC3", "min": vmin, "max": vmax},
            {"bufferView": 1, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(verts) * 12,
             "target": 34962},
            {"buffer": 0, "byteOffset": len(vbuf), "byteLength": len(idx) * 4,
             "target": 34963},
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)

    total = 12 + 8 + len(js) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(js), b"JSON"))
        f.write(js)
        f.write(struct.pack("<I4s", len(bin_chunk), b"BIN\0"))
        f.write(bin_chunk)
