"""ctypes binding of the repository's native geometry library
(`native/libplankgeom.so`, built from `native/geometry.cpp` by
`tools/build_native.py`), as `plankassembly_tpu/factory/native.py` binds
it: the projection's noding and hidden-line classification
(`node_classify`), its longest-first cover dedupe (`dedupe_covers`) and the
polyline rasterizer (`rasterize`). Each returns None when the library (or
its `pa_rasterize`) is absent, and its caller then takes the numpy path
(`factory/projection.py`, `data/raster.py`), which computes the same
result. This is host code, not a GPU kernel.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    """The library at `<repository>/native/libplankgeom.so`, loaded once,
    or None."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native",
        "libplankgeom.so")
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.pa_node_classify.restype = ctypes.c_int
    lib.pa_node_classify.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.pa_dedupe_covers.restype = ctypes.c_int
    lib.pa_dedupe_covers.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    if hasattr(lib, "pa_rasterize"):
        lib.pa_rasterize.restype = ctypes.c_int
        lib.pa_rasterize.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_float),
        ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def node_classify(segs: np.ndarray, depths: np.ndarray, rects: np.ndarray,
                  rect_near: np.ndarray):
    """(atomic segments (M, 4), hidden (M,) bool) of the noded view, or
    None if the library is absent; raises RuntimeError when the library
    reports an overflow or bad input."""
    lib = _load()
    if lib is None:
        return None
    segs = np.ascontiguousarray(segs, dtype=np.float64).reshape(-1, 4)
    depths = np.ascontiguousarray(depths, dtype=np.float64)
    rects = np.ascontiguousarray(rects, dtype=np.float64).reshape(-1, 4)
    rect_near = np.ascontiguousarray(rect_near, dtype=np.float64)

    max_out = max(64, len(segs) * (len(segs) + 4))
    out_segs = np.empty((max_out, 4), dtype=np.float64)
    out_hidden = np.empty(max_out, dtype=np.uint8)
    n = lib.pa_node_classify(
        _dptr(segs), len(segs), _dptr(depths), _dptr(rects), len(rects),
        _dptr(rect_near), _dptr(out_segs),
        out_hidden.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_out)
    if n < 0:
        raise RuntimeError("pa_node_classify overflow or bad input")
    return out_segs[:n].copy(), out_hidden[:n].astype(bool)


def dedupe_covers(segs: np.ndarray, types: np.ndarray):
    """Keep-mask (n,) bool of the longest-first cover dedupe, or None if
    the library is absent."""
    lib = _load()
    if lib is None:
        return None
    segs = np.ascontiguousarray(segs, dtype=np.float64).reshape(-1, 4)
    types = np.ascontiguousarray(types, dtype=np.int32)
    keep = np.empty(len(segs), dtype=np.uint8)
    lib.pa_dedupe_covers(
        _dptr(segs), types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(segs), keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.astype(bool)


def rasterize(lines, intensities, image_size: int, supersample: int = 2,
              world_extent: float = 1.0):
    """The C++ polyline rasterizer: (size, size) float32, or None if the
    library is absent or lacks `pa_rasterize`."""
    lib = _load()
    if lib is None or not hasattr(lib, "pa_rasterize"):
        return None
    pts_list, offsets = [], [0]
    for line in lines:
        arr = np.ascontiguousarray(line, dtype=np.float64).reshape(-1, 2)
        pts_list.append(arr)
        offsets.append(offsets[-1] + len(arr))
    if not pts_list:
        return np.zeros((image_size, image_size), np.float32)
    pts = np.concatenate(pts_list)
    offsets = np.asarray(offsets, dtype=np.int32)
    inten = np.ascontiguousarray(intensities, dtype=np.float64)
    out = np.zeros((image_size, image_size), dtype=np.float32)
    lib.pa_rasterize(
        _dptr(pts), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(lines), _dptr(inten), image_size, supersample,
        ctypes.c_double(world_extent),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
