"""Sim(3) point-cloud registration (counterpart of
vggt_slam_tpu/tools/align_points.py): a coarse fit on the card (RMS-radius
scale, centroids, the best of 24 principal-axis assignments by NN
distance), then ICP (evals/geometry_eval). dst ~= s R src + t.

    python -m vggt_slam_tpu_torch.tools.align_points --source A.pcd \
        --target B.pcd [--device cpu]
"""
from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from vggt_slam_tpu_torch.data.pcd import read_pcd
from vggt_slam_tpu_torch.evals.geometry_eval import (icp_point_to_point,
                                                     nn_distances)
from vggt_slam_tpu_torch.utils.device import resolve_device


def _principal_axes(pts: torch.Tensor) -> torch.Tensor:
    return torch.linalg.svd(pts - pts.mean(0), full_matrices=False).Vh


def coarse_align(src: np.ndarray, dst: np.ndarray, device="cuda"):
    """(s, R, t) from scale, centroids and principal axes; the axis signs
    and order by the subsample's mean NN distance."""
    dev = resolve_device(device)
    S, D = (torch.tensor(np.asarray(x, np.float32), device=dev)
            for x in (src, dst))
    mu_s, mu_d = S.mean(0), D.mean(0)
    rs = ((S - mu_s) ** 2).sum(1).mean().sqrt()
    rd = ((D - mu_d) ** 2).sum(1).mean().sqrt()
    s = rd / (rs + 1e-12)
    A, B = _principal_axes(S), _principal_axes(D)
    sub = S[torch.as_tensor(np.random.default_rng(0).choice(
        len(src), min(2000, len(src)), replace=False), device=dev)]
    best = (np.inf, None)
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product([1.0, -1.0], repeat=3):
            R = (B[list(perm)] * torch.tensor(signs, device=dev)[:, None]).T @ A
            if torch.linalg.det(R) < 0:
                continue
            t = mu_d - s * (R @ mu_s)
            moved = s * (sub - mu_s) @ R.T + mu_d
            err = float(np.mean(nn_distances(moved.cpu().numpy(), dst)))
            if err < best[0]:
                best = (err, (float(s), R.cpu().numpy(), t.cpu().numpy()))
    return best[1]


def register_point_clouds(src: np.ndarray, dst: np.ndarray,
                          icp_dist: float | None = None, device="cuda"):
    """Coarse fit, then ICP. Returns (s, R, t) with dst ~= s R src + t."""
    s, R, t = coarse_align(src, dst, device)
    scaled = s * (R @ np.asarray(src).T).T + t
    if icp_dist is None:
        icp_dist = 2.0 * float(np.median(nn_distances(
            scaled[:: max(1, len(scaled) // 2000)], dst)))
    T = icp_point_to_point(scaled, dst, max_corr_dist=max(icp_dist, 1e-6))
    return s, T[:3, :3] @ R, T[:3, :3] @ t + T[:3, 3]


def main(argv=None):
    p = argparse.ArgumentParser(description="Register two point clouds (Sim3)")
    p.add_argument("--source", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--max_points", type=int, default=50000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    src, _ = read_pcd(args.source)
    dst, _ = read_pcd(args.target)
    rng = np.random.default_rng(0)
    if len(src) > args.max_points:
        src = src[rng.choice(len(src), args.max_points, replace=False)]
    if len(dst) > args.max_points:
        dst = dst[rng.choice(len(dst), args.max_points, replace=False)]
    s, R, t = register_point_clouds(src, dst, device=args.device)
    aligned = s * (R @ src.T).T + t
    rmse = float(np.sqrt((nn_distances(aligned, dst) ** 2).mean()))
    print(f"scale: {s:.6f}")
    print(f"R:\n{np.round(R, 6)}")
    print(f"t: {np.round(t, 6)}")
    print(f"post-ICP NN RMSE: {rmse:.6f}")
    return s, R, t, rmse


if __name__ == "__main__":
    main()
