"""ctypes bindings for the native C++ runtime library (libptruntime.so).

The reference's host runtime is C++ (scene parsing `src/scene.cpp`, BVH
construction `src/pathtrace.cu:23-111`, PNG encoding via stb). This module
loads this framework's C++ equivalents when built (see native/src and
native/build.sh) and exposes ``available()`` so every caller has a pure
Python/NumPy fallback — tests and rendering never require the native build.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libptruntime.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.pt_write_png.restype = ctypes.c_int
        lib.pt_write_png.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.pt_png_defilter.restype = ctypes.c_int
        lib.pt_png_defilter.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # raw [h, 1+stride], in place
            ctypes.c_int,  # height
            ctypes.c_int,  # stride (bytes)
            ctypes.c_int,  # bytes per pixel
        ]
        lib.pt_build_bvh.restype = ctypes.c_int
        lib.pt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # mins [n,3]
            ctypes.POINTER(ctypes.c_float),  # maxs [n,3]
            ctypes.c_int,  # n
            ctypes.c_int,  # leaf_size
            ctypes.POINTER(ctypes.c_float),  # out node bounds [2n, 6]
            ctypes.POINTER(ctypes.c_int),  # out left/subtree_end/start/count
            ctypes.POINTER(ctypes.c_int),  # out prim order [n]
        ]
        lib.pt_build_alias.restype = ctypes.c_int
        lib.pt_build_alias.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # p [n], sums to 1
            ctypes.c_int64,  # n
            ctypes.POINTER(ctypes.c_double),  # out stay-prob [n]
            ctypes.POINTER(ctypes.c_int32),  # out alias partner [n]
        ]
        lib.pt_count_obj.restype = ctypes.c_int
        lib.pt_count_obj.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pt_load_obj.restype = ctypes.c_int
        lib.pt_load_obj.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def write_png(path: str, image: np.ndarray) -> str:
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not built")
    image = np.ascontiguousarray(image, np.uint8)
    h, w, c = image.shape
    if not path.endswith(".png"):
        path = path + ".png"
    rc = lib.pt_write_png(
        path.encode(),
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w,
        h,
        c,
    )
    if rc != 0:
        raise RuntimeError(f"native PNG write failed ({rc})")
    return path


def png_defilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> bool:
    """Reverse PNG scanline filters in place. `raw` is a contiguous uint8
    [height, 1+stride] array (filter byte + payload per row). Returns True
    on success, False if the native lib is unavailable or hit an unknown
    filter type (caller falls back to the NumPy path)."""
    lib = _load()
    if lib is None:
        return False
    assert raw.dtype == np.uint8 and raw.flags["C_CONTIGUOUS"]
    rc = lib.pt_png_defilter(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), height, stride, bpp
    )
    return rc == 0


def build_bvh(mins: np.ndarray, maxs: np.ndarray, leaf_size: int = 1):
    """Native median-split BVH build. Returns (bounds_min, bounds_max, left,
    right, start, count, order) flattened arrays, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = mins.shape[0]
    max_nodes = max(2 * n, 1)
    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    node_bounds = np.zeros((max_nodes, 6), np.float32)
    node_meta = np.zeros((max_nodes, 4), np.int32)
    order = np.zeros(n, np.int32)
    count = lib.pt_build_bvh(
        mins.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        maxs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        leaf_size,
        node_bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        node_meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if count <= 0:
        return None
    return (
        node_bounds[:count, :3].copy(),
        node_bounds[:count, 3:].copy(),
        node_meta[:count, 0].copy(),
        node_meta[:count, 1].copy(),
        node_meta[:count, 2].copy(),
        node_meta[:count, 3].copy(),
        order,
    )


def build_alias(p: np.ndarray):
    """Native Vose alias-table build for a normalized distribution `p`.
    Returns (prob f64[n], alias i32[n]) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(p, np.float64)
    n = p.size
    prob = np.empty(n, np.float64)
    alias = np.empty(n, np.int32)
    rc = lib.pt_build_alias(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        prob.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        alias.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        return None
    return prob, alias


def load_obj_triangles(path: str) -> Optional[np.ndarray]:
    """Native OBJ triangle-soup load; returns (T, 3, 3) float32 or None."""
    lib = _load()
    if lib is None:
        return None
    nv = ctypes.c_int64(0)
    nt = ctypes.c_int64(0)
    if lib.pt_count_obj(path.encode(), ctypes.byref(nv), ctypes.byref(nt)) != 0:
        return None
    tris = np.zeros((max(int(nt.value), 1), 3, 3), np.float32)
    got = lib.pt_load_obj(
        path.encode(), tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(nt.value),
    )
    if got < 0:
        return None
    return tris[:got]


def ensure_built(verbose: bool = False) -> bool:
    """Compile libptruntime.so with the system toolchain if missing."""
    global _TRIED
    if available():
        return True
    import subprocess

    script = os.path.join(os.path.dirname(__file__), "build.sh")
    try:
        subprocess.run(
            ["sh", script],
            check=True,
            capture_output=not verbose,
        )
    except Exception:
        return False
    _TRIED = False  # force a reload attempt
    return available()
