"""Binary PCD point clouds (a copy of the writer and the binary reader of
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


def read_pcd(path: str):
    """A binary .pcd as write_pcd writes it -> ((N, 3) float32 points,
    (N, 3) uint8 colors or None)."""
    with open(path, "rb") as f:
        header = {}
        while "DATA" not in header:
            line = f.readline().decode(errors="replace").strip()
            if line and not line.startswith("#"):
                key, _, val = line.partition(" ")
                header[key] = val
        if header["DATA"] != "binary":
            raise ValueError(f"{path}: only binary PCD is read")
        fields = header["FIELDS"].split()
        n = int(header["POINTS"])
        data = np.frombuffer(f.read(4 * n * len(fields)), dtype=np.float32
                             ).reshape(n, len(fields))
    colors = None
    if "rgb" in fields:
        packed = data[:, fields.index("rgb")].copy().view(np.uint32)
        colors = np.stack([(packed >> s) & 0xFF for s in (16, 8, 0)],
                          axis=-1).astype(np.uint8)
    return data[:, :3], colors
