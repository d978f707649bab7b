"""Global map: submap registry, retrieval search, homography write-back,
writers, the semantic voxel map and the COLMAP Sim(3) alignment
(counterpart of vggt_slam_tpu/slam/map.py). The voxel map's per-submap
filters run on the host as the reference's; its voxelization and
contributor sets on the device."""
from __future__ import annotations

import os

import numpy as np
import torch

from vggt_slam_tpu_torch.data.pcd import write_pcd
from vggt_slam_tpu_torch.ops import lie
from vggt_slam_tpu_torch.ops.voxel import unique_rows, voxel_coords
from vggt_slam_tpu_torch.semantic.voxel_map import SemanticVoxel, \
    SemanticVoxelMap
from vggt_slam_tpu_torch.slam.alignment import parse_colmap_images_txt, \
    rmse, umeyama_sim3_np
from vggt_slam_tpu_torch.utils.device import resolve_device


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

    # -- semantic voxel map --------------------------------------------------

    def semantic_points(self, voxel_size: float, stride: int = 1,
                        ignore_loop_closure_frames: bool = True,
                        device="cuda"):
        """The world points the semantic map averages, per submap with
        embeddings: confidence >= its threshold, finite, inside the 0.5-99.5
        percentile box (host), in a 3x-voxel cell of >= 10 points
        (`device`); loop frames skipped. Returns (points (N, 3), features,
        pair (N,), pairs, frame name maps), points None where none is left."""
        if voxel_size <= 0.0:
            raise ValueError("voxel_size must be > 0")
        if stride < 1:
            raise ValueError("stride must be >= 1")
        device = resolve_device(device)
        all_pts, all_feats, all_pairs, pairs = [], [], [], []
        frame_name_maps = {}
        for submap in self.ordered_submaps_by_key():
            if submap.semantic_embeddings is None or \
                    submap.pointclouds is None or submap.conf is None or \
                    submap.conf_threshold is None or \
                    submap.H_world_map is None:
                continue
            end = submap.pointclouds.shape[0]
            if ignore_loop_closure_frames and \
                    submap.last_non_loop_frame_index is not None:
                end = min(end, submap.last_non_loop_frame_index + 1)
            s = slice(None, None, stride)
            pts = submap.pointclouds[:end, s, s]
            sem = submap.semantic_embeddings[:end, s, s]
            mask = submap.conf[:end, s, s] >= submap.conf_threshold
            if not mask.any():
                continue
            sid = int(submap.get_id())
            pair = len(pairs) + np.broadcast_to(
                np.arange(end)[:, None, None], mask.shape)[mask]
            pairs += [(sid, str(submap.frame_ids[i])) for i in range(end)]
            pts, sem = submap._to_world(pts[mask]).astype(np.float32), \
                sem[mask]
            # the rows kept; the embeddings are gathered once, at the end
            keep = np.flatnonzero(np.isfinite(pts).all(1)
                                  & np.isfinite(sem).all(1))
            pts = pts[keep]
            if len(keep):
                k = _in_percentile_box(pts)
                pts, keep = pts[k], keep[k]
            if len(keep):
                k = _dense(pts, voxel_size, device)
                pts, keep = pts[k], keep[k]
            if not len(keep):
                continue
            all_pts.append(pts)
            all_feats.append(sem[keep].astype(np.float32, copy=False))
            all_pairs.append(pair[keep])
            if submap.frame_id_to_name is not None:
                frame_name_maps[str(sid)] = dict(submap.frame_id_to_name)
        if not all_pts:
            return None, None, None, pairs, frame_name_maps
        return (np.concatenate(all_pts), np.concatenate(all_feats),
                np.concatenate(all_pairs), pairs, frame_name_maps)

    def build_semantic_voxel_map(self, voxel_size: float, stride: int = 1,
                                 ignore_loop_closure_frames: bool = True,
                                 deduplicate_contributors: bool = True,
                                 device="cuda") -> SemanticVoxelMap:
        """The voxel means of `semantic_points` on `device`, voxels in
        np.unique's order, with each voxel's contributors (submap id, frame
        id): sorted and unique, or one per point in point order."""
        dev = resolve_device(device)
        pts, feats, pair, pairs, frame_name_maps = self.semantic_points(
            voxel_size, stride, ignore_loop_closure_frames, dev)
        if pts is None:
            vox = SemanticVoxel(float(voxel_size),
                                np.zeros((0, 3), np.float32),
                                np.zeros((0, 0), np.float32), [])
            return SemanticVoxelMap(vox, frame_name_maps=frame_name_maps)

        unique_coords, inverse, counts = unique_rows(voxel_coords(
            torch.from_numpy(pts).to(dev), float(voxel_size)))
        V = counts.shape[0]
        feats = torch.from_numpy(feats).to(dev)
        feat_sum = feats.new_zeros((V, feats.shape[1])).index_add_(
            0, inverse, feats)
        feat_avg = (feat_sum.double() / counts[:, None]).cpu().numpy()
        centers = (unique_coords.cpu().numpy().astype(np.float32) + 0.5) \
            * float(voxel_size)

        # contributors: (voxel, pair rank) keys, pairs ranked as sorted()
        # orders their (int, str) tuples
        names = sorted(set(pairs))
        index = {p: i for i, p in enumerate(names)}
        rank = torch.as_tensor([index[p] for p in pairs], device=dev)
        point_rank = rank[torch.from_numpy(pair).to(dev)]
        if deduplicate_contributors:
            keys = torch.unique(inverse * len(names) + point_rank)
            vox, ranks = keys // len(names), keys % len(names)
        else:
            by_voxel = torch.sort(inverse, stable=True).indices
            vox, ranks = inverse[by_voxel], point_rank[by_voxel]
        bounds = torch.searchsorted(
            vox, torch.arange(V + 1, device=dev)).tolist()
        flat = [names[r] for r in ranks.tolist()]
        contributors = [flat[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        vox = SemanticVoxel(float(voxel_size), centers, feat_avg,
                            contributors)
        return SemanticVoxelMap(vox, frame_name_maps=frame_name_maps)

    # -- global alignment ----------------------------------------------------

    def apply_similarity_transform(self, T_world_from_pred) -> None:
        """Left-multiply every submap's homography by a 4x4 T (f64)."""
        T = np.asarray(T_world_from_pred, dtype=np.float64)
        if T.shape != (4, 4):
            raise ValueError(f"T_world_from_pred must be 4x4, got {T.shape}")
        for submap in self.ordered_submaps_by_key():
            H = submap.get_reference_homography()
            if H is None:
                continue
            submap.set_reference_homography((T @ H).astype(np.float64))

    def align_scale_to_colmap(self, colmap_images_txt: str,
                              with_scale: bool = True,
                              ignore_loop_closure_frames: bool = True
                              ) -> np.ndarray:
        """Umeyama Sim(3) (or SE(3)) from the camera centres to COLMAP's,
        matched by image basename, applied to the map; returns T."""
        gt_centers = parse_colmap_images_txt(colmap_images_txt)
        pred_pts, gt_pts = [], []
        for submap in self.ordered_submaps_by_key():
            poses = submap.get_all_poses_world(
                ignore_loop_closure_frames=ignore_loop_closure_frames)
            if poses is None:
                continue
            names = submap.frame_names
            if names is None:
                id_to_name = submap.frame_id_to_name
                names = [id_to_name[str(f)] for f in submap.get_frame_ids()]
            if len(names) != poses.shape[0]:
                print(f"can't align submap {submap.get_id()}: "
                      f"{len(names)} names vs {poses.shape[0]} poses")
                continue
            for name, pose in zip(names, poses):
                base = str(name).split("/")[-1]
                if base in gt_centers:
                    pred_pts.append(pose[:3, 3].astype(np.float64))
                    gt_pts.append(gt_centers[base])
        if len(pred_pts) < 3:
            raise RuntimeError(
                f"Need >=3 matched frames for alignment; got {len(pred_pts)}.")
        pred = np.stack(pred_pts)
        gt = np.stack(gt_pts)
        before = rmse(pred, gt)
        s, R, t = umeyama_sim3_np(pred, gt, with_scale=with_scale)
        T = np.eye(4)
        T[:3, :3] = s * R
        T[:3, 3] = t
        after = rmse((s * (R @ pred.T)).T + t[None, :], gt)
        print(f"[align] matched frames: {len(pred_pts)}")
        print(f"[align] RMSE before: {before:.4f}  after: {after:.4f}")
        print(f"[align] scale: {s:.6f}")
        self.apply_similarity_transform(T)
        return T


def _in_percentile_box(pts):
    lo = np.percentile(pts, 0.5, axis=0)
    hi = np.percentile(pts, 99.5, axis=0)
    return (pts >= lo).all(1) & (pts <= hi).all(1)


def _dense(pts, voxel_size, device):
    """In a cell of 3 voxels a side holding >= 10 points."""
    _, inverse, counts = unique_rows(voxel_coords(
        torch.from_numpy(pts).to(device), float(voxel_size) * 3.0))
    return (counts[inverse] >= 10).cpu().numpy()
