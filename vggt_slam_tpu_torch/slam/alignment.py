"""COLMAP parsing + host-side Sim(3) alignment helpers, the port's copy of
vggt_slam_tpu/slam/alignment.py: COLMAP images.txt to camera centers,
Umeyama least squares, RMSE (numpy, for the map and the evals).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


def _quat_wxyz_to_rotmat(qw, qx, qy, qz) -> np.ndarray:
    q = np.array([qw, qx, qy, qz], dtype=np.float64)
    q = q / (np.linalg.norm(q) + 1e-12)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def parse_colmap_images_txt(images_txt_path: str) -> Dict[str, np.ndarray]:
    """COLMAP images.txt -> {image basename: camera center (3,) world}.

    Format per image (two lines): `IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID
    NAME` then a POINTS2D line (skipped). Pose is world->cam, so
    C = -R^T t (reference alignment.py:24-57).
    """
    centers: Dict[str, np.ndarray] = {}
    with open(images_txt_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 10:
                continue
            try:
                qw, qx, qy, qz = map(float, parts[1:5])
                tx, ty, tz = map(float, parts[5:8])
                name = parts[9]
            except ValueError:
                continue
            R_cw = _quat_wxyz_to_rotmat(qw, qx, qy, qz)
            t_cw = np.array([tx, ty, tz], dtype=np.float64)
            centers[name.split("/")[-1]] = (-R_cw.T @ t_cw).astype(np.float64)
    return centers


@dataclass
class Sim3:
    s: float
    R: np.ndarray
    t: np.ndarray

    def as_matrix(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = self.s * self.R
        T[:3, 3] = self.t
        return T


def umeyama_sim3_np(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Umeyama least-squares: dst ~= s R src + t. Returns (s, R, t)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 3:
        raise ValueError(f"src/dst must be Nx3 same shape; {src.shape} vs {dst.shape}")
    n = src.shape[0]
    if n < 3:
        raise ValueError(
            f"Sim(3) Umeyama is underdetermined with {n} point pair(s); "
            "3+ non-collinear pairs required")
    mu_s, mu_d = src.mean(0), dst.mean(0)
    X, Y = src - mu_s, dst - mu_d
    cov = (Y.T @ X) / n
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    s = float((S * np.diag(D)).sum() / ((X * X).sum() / n + 1e-12)) \
        if with_scale else 1.0
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def umeyama_sim3(src, dst, with_scale: bool = True) -> Sim3:
    """Reference-API variant returning a Sim3 dataclass (alignment.py:73)."""
    s, R, t = umeyama_sim3_np(src, dst, with_scale)
    return Sim3(s=s, R=R, t=t)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))
