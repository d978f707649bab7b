"""ctypes binding of graph-based segmentation (native/felzenszwalb.cpp),
the port's counterpart of vggt_slam_tpu/native/felzenszwalb.py. The
library is built with g++ at first use into
<repo>/build/vggt_slam_tpu_torch/; `available()` says whether it loads."""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np

from vggt_slam_tpu_torch.native import build_library, paths

_SRC, _LIB = paths("felzenszwalb")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library(_SRC, _LIB))
    lib.felzenszwalb_segment.restype = ctypes.c_int32
    lib.felzenszwalb_segment.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_float, ctypes.c_int32, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def segment(image: np.ndarray, k: float = 100.0, min_size: int = 100,
            sigma: float = 0.8) -> tuple[np.ndarray, int]:
    """Segment an (H, W, C) float image into connected regions: (labels
    (H, W) int32 with ids 0..n-1, n). A larger `k` gives larger regions;
    edge weights are colour distances in the image's units (pass [0, 255]
    images for the published k values)."""
    lib = _load()
    img = np.ascontiguousarray(image, dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    labels = np.empty((H, W), dtype=np.int32)
    n = lib.felzenszwalb_segment(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        np.int32(H), np.int32(W), np.int32(C), np.float32(k),
        np.int32(min_size), np.float32(sigma),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n < 0:
        raise ValueError(f"bad image shape {image.shape}")
    return labels, int(n)
