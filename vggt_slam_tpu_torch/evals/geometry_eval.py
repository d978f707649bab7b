"""Dense geometry evaluation on the host: chamfer metrics and a
point-to-point ICP refinement (the port's copy of
vggt_slam_tpu/evals/geometry_eval.py; numpy and scipy). Nearest
neighbours come from the native KD-tree (native/kdtree.py) where g++ is
found, else from scipy's cKDTree."""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from vggt_slam_tpu_torch.native import kdtree as _native


def nn_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """For each src point, the distance to its nearest dst point."""
    if _native.available():
        d, _ = _native.KDTree(np.asarray(dst, np.float32)).query(
            np.asarray(src, np.float32))
        return d.astype(np.float64)
    tree = cKDTree(np.asarray(dst, dtype=np.float32))
    d, _ = tree.query(np.asarray(src, dtype=np.float32), k=1, workers=-1)
    return d


def chamfer(a: np.ndarray, b: np.ndarray) -> dict:
    """Accuracy (a->b), completeness (b->a), chamfer means + RMSE variants."""
    d_ab = nn_distances(a, b)
    d_ba = nn_distances(b, a)
    r_ab = np.sqrt((d_ab ** 2).mean())
    r_ba = np.sqrt((d_ba ** 2).mean())
    return {
        "accuracy": float(d_ab.mean()),
        "completeness": float(d_ba.mean()),
        "chamfer": float(0.5 * (d_ab.mean() + d_ba.mean())),
        "rmse_accuracy": float(r_ab),
        "rmse_completeness": float(r_ba),
        "chamfer_rmse": float(0.5 * (r_ab + r_ba)),
    }


def icp_point_to_point(src: np.ndarray, dst: np.ndarray,
                       max_corr_dist: float, iters: int = 30,
                       T_init: np.ndarray | None = None) -> np.ndarray:
    """Rigid ICP (fixed correspondence radius, SVD update); returns the
    4x4 transform src -> dst."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    T = np.eye(4) if T_init is None else np.asarray(T_init, dtype=np.float64)
    tree = cKDTree(dst)
    cur = (T[:3, :3] @ src.T).T + T[:3, 3]
    prev_err = np.inf
    for _ in range(iters):
        d, idx = tree.query(cur, k=1, workers=-1,
                            distance_upper_bound=max_corr_dist)
        ok = np.isfinite(d)
        if ok.sum() < 10:
            break
        p = cur[ok]
        q = dst[idx[ok]]
        mu_p, mu_q = p.mean(0), q.mean(0)
        U, _, Vt = np.linalg.svd((p - mu_p).T @ (q - mu_q))
        D = np.eye(3)
        D[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ D @ U.T
        t = mu_q - R @ mu_p
        dT = np.eye(4)
        dT[:3, :3] = R
        dT[:3, 3] = t
        T = dT @ T
        cur = (R @ cur.T).T + t
        err = float(np.mean(d[ok]))
        if abs(prev_err - err) < 1e-9:
            break
        prev_err = err
    return T


def backproject_depth(depth: np.ndarray, K: np.ndarray, c2w: np.ndarray,
                      max_depth: float = 10.0, stride: int = 1) -> np.ndarray:
    """Depth image (H, W) -> world points (N, 3); zero and far depths
    dropped."""
    H, W = depth.shape
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    if stride > 1:
        u, v, depth = u[::stride, ::stride], v[::stride, ::stride], \
            depth[::stride, ::stride]
    z = depth.astype(np.float64)
    ok = (z > 0) & (z < max_depth) & np.isfinite(z)
    x = (u[ok] - K[0, 2]) / K[0, 0] * z[ok]
    y = (v[ok] - K[1, 2]) / K[1, 1] * z[ok]
    cam = np.stack([x, y, z[ok]], axis=-1)
    return (c2w[:3, :3] @ cam.T).T + c2w[:3, 3]
