"""Absolute trajectory error (ATE) in the evo_ape style, the port's copy of
vggt_slam_tpu/evals/ate.py: associate TUM trajectories by timestamp, align
with Umeyama Sim(3) (`evo_ape tum gt est -as`), report translation RMSE.

    python -m vggt_slam_tpu_torch.evals.ate groundtruth.txt poses.txt
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vggt_slam_tpu_torch.slam.alignment import umeyama_sim3_np


def load_tum(path: str) -> np.ndarray:
    """TUM file -> (N, 8) rows [t, x, y, z, qx, qy, qz, qw], sorted by t."""
    data = np.loadtxt(path)
    data = data.reshape(-1, 8) if data.ndim == 1 else data
    return data[np.argsort(data[:, 0])]


def associate(t_ref: np.ndarray, t_est: np.ndarray,
              max_diff: float = 0.02) -> tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (evo/TUM-tools semantics)."""
    i = np.searchsorted(t_ref, t_est)
    i = np.clip(i, 1, len(t_ref) - 1)
    left = t_ref[i - 1]
    right = t_ref[i]
    pick = np.where(np.abs(t_est - left) <= np.abs(t_est - right), i - 1, i)
    diff = np.abs(t_ref[pick] - t_est)
    ok = diff <= max_diff
    # one-to-one: keep best est per ref index
    best: dict[int, int] = {}
    for e_idx in np.where(ok)[0]:
        r_idx = int(pick[e_idx])
        if r_idx not in best or diff[e_idx] < diff[best[r_idx]]:
            best[r_idx] = int(e_idx)
    ref_idx = np.array(sorted(best.keys()), dtype=int)
    est_idx = np.array([best[r] for r in ref_idx], dtype=int)
    return ref_idx, est_idx


@dataclass
class ATEResult:
    rmse: float
    mean: float
    median: float
    std: float
    max: float
    min: float
    n_pairs: int
    scale: float


def ate(gt_tum: np.ndarray, est_tum: np.ndarray, align_scale: bool = True,
        max_diff: float = 0.02) -> ATEResult:
    """Sim(3)-aligned translation ATE between two TUM trajectories."""
    ri, ei = associate(gt_tum[:, 0], est_tum[:, 0], max_diff)
    if len(ri) < 3:
        raise ValueError(f"only {len(ri)} associated pairs (need >= 3)")
    gt = gt_tum[ri, 1:4]
    est = est_tum[ei, 1:4]
    s, R, t = umeyama_sim3_np(est, gt, with_scale=align_scale)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return ATEResult(
        rmse=float(np.sqrt(np.mean(err ** 2))), mean=float(err.mean()),
        median=float(np.median(err)), std=float(err.std()),
        max=float(err.max()), min=float(err.min()), n_pairs=len(err),
        scale=float(s))


def ate_from_files(gt_path: str, est_path: str, align_scale: bool = True,
                   max_diff: float = 0.02) -> ATEResult:
    return ate(load_tum(gt_path), load_tum(est_path), align_scale, max_diff)


def main():
    import argparse

    p = argparse.ArgumentParser(
        description="TUM ATE (evo_ape tum gt est -as equivalent)")
    p.add_argument("gt")
    p.add_argument("est")
    p.add_argument("--no_scale", action="store_true")
    p.add_argument("--max_diff", type=float, default=0.02)
    args = p.parse_args()
    r = ate_from_files(args.gt, args.est, align_scale=not args.no_scale,
                       max_diff=args.max_diff)
    print(f"rmse {r.rmse:.6f}  mean {r.mean:.6f}  median {r.median:.6f}  "
          f"std {r.std:.6f}  min {r.min:.6f}  max {r.max:.6f}  "
          f"pairs {r.n_pairs}  scale {r.scale:.4f}")


if __name__ == "__main__":
    main()
