"""Binary PCD point-cloud writer (a copy of the PCD writer of
vggt_slam_tpu/data/pcd.py): x y z + PCL packed float rgb."""
from __future__ import annotations

import os

import numpy as np


def pack_rgb(colors: np.ndarray) -> np.ndarray:
    """(N, 3) float [0, 1] or uint8 -> (N,) float32 PCL packed RGB."""
    c = np.asarray(colors)
    if c.dtype != np.uint8:
        c = np.clip(c * 255.0 if c.max() <= 1.0 + 1e-6 else c, 0,
                    255).astype(np.uint8)
    packed = (c[:, 0].astype(np.uint32) << 16) | \
        (c[:, 1].astype(np.uint32) << 8) | c[:, 2].astype(np.uint32)
    return packed.view(np.float32)


def write_pcd(path: str, points, colors=None) -> None:
    """Write (N, 3) points (+ optional (N, 3) colors) as binary PCD."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = pts.shape[0]
    rgb = colors is not None
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {'x y z rgb' if rgb else 'x y z'}\n"
        f"SIZE {'4 4 4 4' if rgb else '4 4 4'}\n"
        f"TYPE {'F F F F' if rgb else 'F F F'}\n"
        f"COUNT {'1 1 1 1' if rgb else '1 1 1'}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        "DATA binary\n")
    data = np.concatenate([pts, pack_rgb(colors)[:, None]], axis=1) \
        if rgb else pts
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(data, dtype=np.float32).tobytes())
