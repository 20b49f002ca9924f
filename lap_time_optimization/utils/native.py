"""ctypes bindings for the native host-side geometry kernels.

The shared library (`native/lto_geometry.cpp`) is built on demand with the
system toolchain and cached; every entry point has a numpy fallback so the
framework runs identically without a compiler (tests assert exact parity
between the native and fallback paths).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "lto_geometry.cpp")
_CACHE_DIR = os.environ.get(
    "LTO_NATIVE_CACHE", os.path.expanduser("~/.cache/lto_native")
)
_LIB_PATH = os.path.join(_CACHE_DIR, "liblto_geometry.so")

_lib = None
_tried = False


def _build() -> str | None:
    if not os.path.isfile(_SRC):
        return None
    os.makedirs(_CACHE_DIR, exist_ok=True)
    if os.path.isfile(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
        return _LIB_PATH
    for flags in (["-fopenmp"], []):  # openmp optional
        cmd = ["g++", "-O3", "-fPIC", "-shared", *flags, "-o", _LIB_PATH, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            return _LIB_PATH
        except Exception:
            continue
    return None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("LTO_DISABLE_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.lto_nearest_distances.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.lto_filter_corners.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def nearest_distances(path_xy: np.ndarray, boundary_xy: np.ndarray) -> np.ndarray:
    """min-distance from each path point (2, n) to the boundary samples (2, m)."""
    path_xy = np.ascontiguousarray(path_xy, dtype=np.float64)
    boundary_xy = np.ascontiguousarray(boundary_xy, dtype=np.float64)
    lib = _load()
    n, m = path_xy.shape[1], boundary_xy.shape[1]
    if lib is not None:
        out = np.empty(n, dtype=np.float64)
        lib.lto_nearest_distances(
            _dp(path_xy[0]), _dp(path_xy[1]), n,
            _dp(boundary_xy[0]), _dp(boundary_xy[1]), m,
            _dp(out),
        )
        return out
    # numpy fallback (O(n*m) pairwise, chunked to bound memory)
    out = np.empty(n, dtype=np.float64)
    chunk = max(1, 2_000_000 // max(m, 1))
    for i in range(0, n, chunk):
        dx = path_xy[0, i : i + chunk, None] - boundary_xy[0][None, :]
        dy = path_xy[1, i : i + chunk, None] - boundary_xy[1][None, :]
        out[i : i + chunk] = np.sqrt(np.min(dx * dx + dy * dy, axis=1))
    return out


def filter_corners_shifted(mask: np.ndarray, dists: np.ndarray, length: float, proximity: float) -> np.ndarray:
    """Morphology on an already roll-shifted mask; native or numpy fallback."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    dists = np.ascontiguousarray(dists, dtype=np.float64)
    lib = _load()
    if lib is not None:
        out = mask.copy()
        lib.lto_filter_corners(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _dp(dists),
            len(out), float(length), float(proximity),
        )
        return out.astype(bool)
    from lap_time_optimization.utils import corners as c

    out = c._merge_short_straights(mask.astype(bool), dists, proximity)
    return c._drop_short_corners(out, dists, length)
