"""Optional native (C++) host-side helpers.

The reference keeps its BVH builder in a separate native project (SURVEY
§2, TODO.txt); ours lives in ``bvh_builder.cpp``, compiled to a shared
library and loaded via ctypes. Everything degrades gracefully to the NumPy
implementations when the library hasn't been built (run ``make -C
tpu_pathtracer/native``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _build(src_dir: str, path: str) -> bool:
    """Compile the builder on demand (about two seconds with g++). Quiet
    no-op on any failure — callers fall back to NumPy."""
    src = os.path.join(src_dir, "bvh_builder.cpp")
    # build to a per-pid temp name + atomic rename: a concurrent process
    # (parallel tests, test + bench) must never CDLL a half-written .so
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(
            ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17",
             "-shared", "-o", tmp, src],
            capture_output=True, timeout=120)
        if r.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, path)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    src_dir = os.path.dirname(__file__)
    path = os.path.join(src_dir, "libbvh_builder.so")
    src = os.path.join(src_dir, "bvh_builder.cpp")
    stale = (os.path.exists(path) and os.path.exists(src)
             and os.path.getmtime(path) < os.path.getmtime(src))
    if (not os.path.exists(path) or stale) and not _build(src_dir, path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.bvh_build_order.restype = ctypes.c_int
        lib.bvh_build_order.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # tri mins [T*3]
            ctypes.POINTER(ctypes.c_float),  # tri maxs [T*3]
            ctypes.c_int,                    # T
            ctypes.c_int,                    # num_leaves
            ctypes.c_int,                    # prims_per_leaf
            ctypes.POINTER(ctypes.c_longlong),  # out slots [num_leaves*P]
        ]
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


def available() -> bool:
    """True when the compiled builder is loaded (building it on first
    use); False means :func:`~tpu_pathtracer.ops.bvh.build_bvh` runs
    the NumPy median split instead."""
    return _load() is not None


def native_build_order(tri_min: np.ndarray, tri_max: np.ndarray,
                       num_leaves: int, prims_per_leaf: int):
    """SAH-binned partition order from the C++ builder, or None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(tri_min, np.float32)
    hi = np.ascontiguousarray(tri_max, np.float32)
    T = lo.shape[0]
    out = np.full(num_leaves * prims_per_leaf, -1, np.int64)
    rc = lib.bvh_build_order(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T,
        num_leaves, prims_per_leaf,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    if rc != 0:
        return None
    return out
