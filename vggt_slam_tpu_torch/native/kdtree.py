"""ctypes binding of the host KD-tree (counterpart of
vggt_slam_tpu/native/kdtree.py), built by g++ at first use into
<repo>/build/vggt_slam_tpu_torch/; without a compiler `available()` is
False and callers take scipy's cKDTree.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np

from vggt_slam_tpu_torch.native import build_library, paths

_SRC, _LIB = paths("kdtree")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library(_SRC, _LIB))
    lib.kdtree_build.restype = ctypes.c_void_p
    lib.kdtree_build.argtypes = [ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int32]
    lib.kdtree_query.restype = None
    lib.kdtree_query.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    lib.kdtree_free.restype = None
    lib.kdtree_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class KDTree:
    """3-D nearest-neighbour index over (N, 3) float32 points."""

    def __init__(self, points: np.ndarray):
        lib = _load()
        self._pts = np.ascontiguousarray(points, dtype=np.float32)
        if self._pts.ndim != 2 or self._pts.shape[1] != 3:
            raise ValueError(f"points must be (N, 3), got {self._pts.shape}")
        self._lib = lib
        self._handle = lib.kdtree_build(_fptr(self._pts),
                                        np.int32(self._pts.shape[0]))

    def query(self, queries: np.ndarray):
        """(dists (M,), indices (M,)) of the nearest stored point."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != 3:
            raise ValueError(f"queries must be (M, 3), got {q.shape}")
        m = q.shape[0]
        dists = np.empty(m, dtype=np.float32)
        idx = np.empty(m, dtype=np.int32)
        self._lib.kdtree_query(
            self._handle, _fptr(q), np.int32(m), _fptr(dists),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return dists, idx

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.kdtree_free(self._handle)
            self._handle = None
