"""Global map: submap registry, retrieval search, homography write-back
and writers (counterpart of vggt_slam_tpu/slam/map.py, without the
semantic voxel map and the COLMAP alignment)."""
from __future__ import annotations

import os

import numpy as np
import torch

from vggt_slam_tpu_torch.data.pcd import write_pcd
from vggt_slam_tpu_torch.ops import lie


class GraphMap:
    def __init__(self):
        self.submaps: dict = {}

    def get_num_submaps(self) -> int:
        return len(self.submaps)

    def add_submap(self, submap) -> None:
        self.submaps[submap.get_id()] = submap

    def get_largest_key(self) -> int:
        return max(self.submaps) if self.submaps else -1

    def get_submap(self, id):
        return self.submaps[id]

    def get_latest_submap(self):
        return self.get_submap(self.get_largest_key())

    def get_submaps(self):
        return self.submaps.values()

    def ordered_submaps_by_key(self):
        for k in sorted(self.submaps):
            yield self.submaps[k]

    def retrieve_best_score_frame(self, query_vector, current_submap_id,
                                  ignore_last_submap: bool = True):
        """Lowest-L2 frame over older submaps, skipping the current and
        (optionally) the previous one -> (score, submap id, frame)."""
        best = (1000.0, 0, 0)
        q = np.asarray(query_vector, dtype=np.float32).reshape(-1)
        for key, submap in self.submaps.items():
            if key == current_submap_id or (ignore_last_submap
                                            and key == current_submap_id - 1):
                continue
            emb = np.asarray(submap.get_all_retrieval_vectors(), np.float32)
            if emb.size == 0:
                continue
            scores = np.linalg.norm(emb - q[None, :], axis=1)
            i = int(np.argmin(scores))
            if scores[i] < best[0]:
                best = (float(scores[i]), key, i)
        return best

    def get_frames_from_loops(self, loops):
        return [self.submaps[lp.detected_submap_id]
                .get_frame_at_index(lp.detected_submap_frame)
                for lp in loops]

    def update_submap_homographies(self, graph) -> None:
        for key, submap in self.submaps.items():
            submap.set_reference_homography(graph.get_homography(key))

    def write_poses_to_file(self, file_name: str) -> None:
        """TUM format: frame_id x y z qx qy qz qw."""
        parent = os.path.dirname(file_name)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(file_name, "w") as f:
            for submap in self.ordered_submaps_by_key():
                poses = submap.get_all_poses_world(
                    ignore_loop_closure_frames=True)
                frame_ids = submap.get_frame_ids()
                assert len(poses) == len(frame_ids), \
                    "Number of poses and frame ids do not match"
                qs = lie.rotmat_to_quat(
                    torch.as_tensor(poses[:, :3, :3])).numpy()
                for fid, pose, q in zip(frame_ids, poses, qs):
                    x, y, z = pose[0:3, 3]
                    row = [float(fid), x, y, z, q[1], q[2], q[3], q[0]]
                    f.write(" ".join(f"{v:.8f}" for v in row) + "\n")

    def save_framewise_pointclouds(self, dir_name: str) -> None:
        os.makedirs(dir_name, exist_ok=True)
        for submap in self.ordered_submaps_by_key():
            pcs, fids, masks = submap.get_points_list_in_world_frame(
                ignore_loop_closure_frames=True)
            for fid, pc, mask in zip(fids, pcs, masks):
                np.savez(os.path.join(dir_name, f"{fid}.npz"),
                         pointcloud=pc, mask=mask)

    def save_frame_outputs(self, output_dir: str,
                           ignore_loop_closure_frames: bool = True) -> None:
        """Per-frame world point map, extrinsic and intrinsic npz files."""
        os.makedirs(output_dir, exist_ok=True)
        for submap in self.ordered_submaps_by_key():
            if submap.pointclouds is None or submap.H_world_map is None:
                continue
            pcs, fids, masks = submap.get_points_list_in_world_frame(
                ignore_loop_closure_frames=ignore_loop_closure_frames)
            extr = submap.get_all_poses_world(
                ignore_loop_closure_frames=ignore_loop_closure_frames)
            intr = submap.vggt_intrinsics
            names = submap.frame_names
            for idx in range(min(len(pcs), len(extr))):
                if names is not None and idx < len(names):
                    filename = os.path.splitext(str(names[idx]))[0] + ".npz"
                else:
                    filename = f"{fids[idx]}.npz"
                np.savez(os.path.join(output_dir, filename),
                         point_map_world=pcs[idx], conf_mask=masks[idx],
                         extrinsic_world=extr[idx],
                         intrinsic=intr[idx] if intr is not None else None)

    def write_points_to_file(self, file_name: str) -> None:
        if not self.submaps:
            write_pcd(file_name, np.zeros((0, 3), np.float32),
                      np.zeros((0, 3), np.uint8))
            return
        pts = np.concatenate([s.get_points_in_world_frame().reshape(-1, 3)
                              for s in self.ordered_submaps_by_key()])
        colors = np.concatenate([s.get_points_colors()
                                 for s in self.ordered_submaps_by_key()])
        if colors.max() > 1.0:
            colors = colors / 255.0
        write_pcd(file_name, pts, colors)
