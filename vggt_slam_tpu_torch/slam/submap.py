"""Per-submap store: poses, frames, point maps, confidences, retrieval
vectors (counterpart of vggt_slam_tpu/slam/submap.py, without the semantic
voxel export). Storage is host numpy; the SL(4) pose readout and the
world-frame point transform run in torch f64 on the host."""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from vggt_slam_tpu_torch.ops import geometry, lie


def _f64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


class Submap:
    def __init__(self, submap_id: int):
        self.submap_id = submap_id
        self.H_world_map = None       # (4, 4)
        self.poses = None             # (S, 4, 4) cam->submap
        self.frames = None            # (S, 3, H, W) float [0, 1]
        self.vggt_intrinsics = None
        self.retrieval_vectors = None
        self.colors = None            # (S, H, W, 3) uint8
        self.conf = None              # (S, H, W)
        self.conf_masks = None
        self.conf_threshold = None
        self.pointclouds = None       # (S, H, W, 3)
        self.last_non_loop_frame_index = None
        self.frame_ids = None
        self.frame_names = None
        self.frame_id_to_name = None

    def add_all_poses(self, poses) -> None:
        self.poses = np.asarray(poses)

    def add_all_points(self, points, colors, conf, conf_threshold_percentile,
                       intrinsics) -> None:
        self.pointclouds = np.asarray(points)
        self.colors = np.asarray(colors)
        self.conf = np.asarray(conf)
        self.conf_threshold = float(np.percentile(self.conf,
                                                  conf_threshold_percentile))
        self.vggt_intrinsics = np.asarray(intrinsics)

    def add_all_frames(self, frames) -> None:
        self.frames = np.asarray(frames)

    def set_frame_ids(self, file_paths) -> None:
        """Numeric frame ids from file names (the first number in each)."""
        ids, names, id_to_name = [], [], {}
        for path in file_paths:
            filename = os.path.basename(path)
            m = re.search(r"\d+(?:\.\d+)?", filename)
            if not m:
                raise ValueError(f"No number found in image name: {filename}")
            fid = float(m.group())
            ids.append(fid)
            names.append(filename)
            id_to_name[str(fid)] = filename
        self.frame_ids, self.frame_names = ids, names
        self.frame_id_to_name = id_to_name

    def set_last_non_loop_frame_index(self, idx: int) -> None:
        self.last_non_loop_frame_index = idx

    def set_reference_homography(self, H_world_map) -> None:
        self.H_world_map = np.asarray(H_world_map)

    def set_all_retrieval_vectors(self, vecs) -> None:
        self.retrieval_vectors = np.asarray(vecs)

    def set_conf_masks(self, conf_masks) -> None:
        self.conf_masks = np.asarray(conf_masks)

    def get_id(self) -> int:
        return self.submap_id

    def get_conf_threshold(self) -> float:
        return self.conf_threshold

    def get_frame_at_index(self, index: int):
        return self.frames[index]

    def get_last_non_loop_frame_index(self):
        return self.last_non_loop_frame_index

    def get_all_frames(self):
        return self.frames

    def get_all_retrieval_vectors(self):
        return self.retrieval_vectors

    def get_reference_homography(self):
        return self.H_world_map

    def get_frame_pointcloud(self, pose_index: int):
        return self.pointclouds[pose_index]

    def get_pose_subframe(self, pose_index: int):
        return np.linalg.inv(self.poses[pose_index])

    def get_frame_ids(self):
        return self.frame_ids

    def get_all_poses_world(self, ignore_loop_closure_frames: bool = False):
        """World SE(3) poses through the optimized SL(4)."""
        poses = geometry.poses_world_from_submap(
            _f64(self.vggt_intrinsics), _f64(self.poses),
            _f64(self.H_world_map)).numpy()
        if ignore_loop_closure_frames and \
                self.last_non_loop_frame_index is not None:
            poses = poses[: self.last_non_loop_frame_index + 1]
        return poses

    def filter_data_by_confidence(self, data, stride: int = 1):
        if stride == 1:
            return data[self.conf >= self.conf_threshold]
        conf_sub = self.conf[:, ::stride, ::stride]
        return data[:, ::stride, ::stride, ...][conf_sub
                                                >= self.conf_threshold]

    def _to_world(self, pts_flat):
        return lie.apply_homography(_f64(self.H_world_map),
                                    _f64(pts_flat)).numpy()

    def get_points_in_world_frame(self, stride: int = 1):
        pts = self.filter_data_by_confidence(self.pointclouds, stride)
        return self._to_world(pts.reshape(-1, 3))

    def get_points_colors(self, stride: int = 1):
        return self.filter_data_by_confidence(self.colors,
                                              stride).reshape(-1, 3)

    def get_points_list_in_world_frame(self,
                                       ignore_loop_closure_frames=False):
        """Per-frame world point maps, frame ids and confidence masks."""
        end = self.pointclouds.shape[0]
        if ignore_loop_closure_frames and \
                self.last_non_loop_frame_index is not None:
            end = min(end, self.last_non_loop_frame_index + 1)
        pts = self.pointclouds[:end]
        world = self._to_world(pts.reshape(-1, 3)).reshape(pts.shape)
        ids = [self.frame_ids[i] if self.frame_ids is not None
               and i < len(self.frame_ids) else i for i in range(end)]
        masks = [self.conf_masks[i] >= self.conf_threshold
                 for i in range(end)]
        return list(world), ids, masks
