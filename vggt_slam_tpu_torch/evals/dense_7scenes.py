"""7-Scenes dense geometry evaluation (counterpart of
vggt_slam_tpu/evals/dense_7scenes.py), on the host: the ground-truth cloud
backprojects the 16-bit mm depth PNGs (read_png_unchanged, 65535 invalid)
at 392x518 (resize_nearest); the estimated TUM trajectory is associated
and Sim(3)-aligned; the same transform and an ICP take the estimated
cloud; chamfer RMSEs score accuracy and completeness. A sequence holds
frame-XXXXXX.{color.png, depth.png, pose.txt (4x4 cam->world)}.

    python -m vggt_slam_tpu_torch.evals.dense_7scenes --seq_dir DIR \
        --est_tum POSES.txt (--frame_output_dir DIR | --est_pcd PCD)
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from vggt_slam_tpu_torch.evals.ate import associate, ate, load_tum
from vggt_slam_tpu_torch.evals.geometry_eval import (backproject_depth,
                                                     chamfer,
                                                     icp_point_to_point)
from vggt_slam_tpu_torch.slam.alignment import umeyama_sim3_np

# the Kinect intrinsics of 7-Scenes, rescaled below to the eval resolution
K_7SCENES = np.array([[585.0, 0.0, 320.0],
                      [0.0, 585.0, 240.0],
                      [0.0, 0.0, 1.0]])
EVAL_HW = (392, 518)


def vggt_resize_K(K: np.ndarray, src_hw=(480, 640), dst_hw=EVAL_HW):
    sy = dst_hw[0] / src_hw[0]
    sx = dst_hw[1] / src_hw[1]
    K2 = K.copy()
    K2[0] *= sx
    K2[1] *= sy
    return K2


def load_7scenes(seq_dir: str, stride: int = 10, max_depth: float = 4.0,
                 point_stride: int = 4):
    """The ground-truth world cloud and TUM rows of a 7-Scenes dump."""
    import torch

    from vggt_slam_tpu_torch.data.images import (read_png_unchanged,
                                                 resize_nearest)
    from vggt_slam_tpu_torch.ops.lie import rotmat_to_quat

    depth_files = sorted(glob.glob(os.path.join(seq_dir, "*.depth.png")))
    pts_all, c2ws, frame_ids = [], [], []
    K = vggt_resize_K(K_7SCENES)
    for dpath in depth_files[::stride]:
        stem = dpath[: -len(".depth.png")]
        pose_path = stem + ".pose.txt"
        if not os.path.exists(pose_path):
            continue
        c2w = np.loadtxt(pose_path).reshape(4, 4)
        depth = read_png_unchanged(dpath).astype(np.float32)
        depth[depth == 65535] = 0
        depth /= 1000.0
        depth = resize_nearest(depth, EVAL_HW[1], EVAL_HW[0])
        pts_all.append(backproject_depth(depth, K, c2w, max_depth=max_depth,
                                         stride=point_stride))
        c2ws.append(c2w)
        frame_ids.append(float(os.path.basename(stem).split("-")[-1]))

    c2ws = np.asarray(c2ws)      # one batched conversion, in float64
    qs = rotmat_to_quat(torch.from_numpy(c2ws[:, :3, :3])).numpy()
    rows = [[fid, *c2w[:3, 3], q[1], q[2], q[3], q[0]]
            for fid, c2w, q in zip(frame_ids, c2ws, qs)]
    return np.concatenate(pts_all, axis=0), np.asarray(rows)


def evaluate_sequence(seq_dir: str, est_tum_path: str,
                      frame_output_dir: str | None = None,
                      est_pcd_path: str | None = None,
                      max_gt_points: int = 2_000_000,
                      max_est_points: int = 2_000_000,
                      icp_dist: float = 0.10,
                      gt_stride: int = 10) -> dict:
    gt_pts, gt_tum = load_7scenes(seq_dir, stride=gt_stride)
    est_tum = load_tum(est_tum_path)
    traj = ate(gt_tum, est_tum, align_scale=True, max_diff=0.5)

    # the estimated cloud: the frame outputs' masked point maps, or a pcd
    if frame_output_dir:
        from vggt_slam_tpu_torch.tools.visualize_results import \
            load_frame_outputs
        pcs, masks, _, _ = load_frame_outputs(frame_output_dir)
        est_pts = np.concatenate([pm[m] for pm, m in zip(pcs, masks)], axis=0)
    elif est_pcd_path:
        from vggt_slam_tpu_torch.data.pcd import read_pcd
        est_pts, _ = read_pcd(est_pcd_path)
    else:
        raise ValueError("need frame_output_dir or est_pcd_path")

    rng = np.random.default_rng(0)
    if len(gt_pts) > max_gt_points:
        gt_pts = gt_pts[rng.choice(len(gt_pts), max_gt_points, replace=False)]
    if len(est_pts) > max_est_points:
        est_pts = est_pts[rng.choice(len(est_pts), max_est_points,
                                     replace=False)]

    # the trajectory's Sim(3) (as ate() fits it) on the cloud, then ICP
    ri, ei = associate(gt_tum[:, 0], est_tum[:, 0], max_diff=0.5)
    s, R, t = umeyama_sim3_np(est_tum[ei, 1:4], gt_tum[ri, 1:4])
    est_aligned = s * (R @ est_pts.T).T + t
    T = icp_point_to_point(est_aligned[:: max(1, len(est_aligned) // 200000)],
                           gt_pts, max_corr_dist=icp_dist)
    est_refined = (T[:3, :3] @ est_aligned.T).T + T[:3, 3]

    metrics = chamfer(est_refined, gt_pts)
    metrics.update(ate_rmse=traj.rmse, ate_pairs=traj.n_pairs,
                   align_scale=float(s))
    return metrics


def main(argv=None):
    p = argparse.ArgumentParser(description="7-Scenes dense geometry eval")
    p.add_argument("--seq_dir", required=True)
    p.add_argument("--est_tum", required=True)
    p.add_argument("--frame_output_dir", default=None)
    p.add_argument("--est_pcd", default=None)
    p.add_argument("--icp_dist", type=float, default=0.10)
    p.add_argument("--gt_stride", type=int, default=10,
                   help="use every Nth GT depth frame")
    args = p.parse_args(argv)
    m = evaluate_sequence(args.seq_dir, args.est_tum,
                          frame_output_dir=args.frame_output_dir,
                          est_pcd_path=args.est_pcd, icp_dist=args.icp_dist,
                          gt_stride=args.gt_stride)
    for k, v in m.items():
        print(f"{k}: {v:.6f}" if isinstance(v, float) else f"{k}: {v}")
    return m


if __name__ == "__main__":
    main()
