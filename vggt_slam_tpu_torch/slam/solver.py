"""SLAM orchestration per submap (counterpart of vggt_slam_tpu/slam/solver.py):
`dispatch_predictions` (loop detection, the forward queued on the device,
outputs copied to pinned host memory), `collect_predictions` (waits,
decodes cameras), `add_points` (SL(4) RANSAC or Sim(3) registration,
factors, loop factors); RANSAC and the pose graph on the solver's device.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from vggt_slam_tpu_torch.data.images import load_and_preprocess_images
from vggt_slam_tpu_torch.ops import geometry
from vggt_slam_tpu_torch.ops.homography import ransac_projective
from vggt_slam_tpu_torch.slam.graph import PoseGraph
from vggt_slam_tpu_torch.slam.keyframe import FrameTracker
from vggt_slam_tpu_torch.slam.loop_closure import ImageRetrieval
from vggt_slam_tpu_torch.slam.map import GraphMap
from vggt_slam_tpu_torch.slam.submap import Submap


def _start_host_copy(v):
    """Queue a device->pinned-host copy of a CUDA tensor behind the work
    that produces it; returns (host tensor, event) or the tensor itself."""
    if not isinstance(v, torch.Tensor) or v.device.type != "cuda":
        return v
    if v.dtype not in (torch.float32, torch.float64):
        v = v.float()
    host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
    host.copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _finish_host_copy(item) -> np.ndarray:
    if isinstance(item, tuple):
        host, event = item
        event.synchronize()
        return host.numpy()
    if isinstance(item, torch.Tensor):
        return item.detach().float().cpu().numpy()
    return np.asarray(item)


class Solver:
    def __init__(self, init_conf_threshold: float = 25.0,
                 use_point_map: bool = False, use_sim3: bool = False,
                 viewer=None, retrieval: ImageRetrieval | None = None,
                 vis_stride: int = 1, vis_point_size: float = 0.001,
                 seed: int = 0, keyframe_backend: str = "auto",
                 loop_inlier_thresh: float = 0.0, device="cpu"):
        self.device = torch.device(device)
        self.viewer = viewer
        self.vis_stride = vis_stride
        self.vis_point_size = vis_point_size
        if keyframe_backend == "auto":
            # The torch tracker on a CUDA device, whose machine may have no
            # OpenCV; host cv2 on the CPU, as the reference's auto.
            keyframe_backend = ("torch" if self.device.type == "cuda"
                                else "cv2")
        self.init_conf_threshold = init_conf_threshold
        self.use_point_map = use_point_map
        self.use_sim3 = use_sim3
        self.loop_inlier_thresh = loop_inlier_thresh
        self.detected_loop_count = 0     # retrieval hits given to the gate
        self.rejected_loop_count = 0
        self._seq_reg_fracs: list[float] = []
        self.flow_tracker = FrameTracker(backend=keyframe_backend,
                                         device=self.device)
        self.map = GraphMap()
        self.graph = PoseGraph("se3" if use_sim3 else "sl4",
                               device=self.device)
        self.image_retrieval = retrieval if retrieval is not None \
            else ImageRetrieval(device=self.device)
        self.current_working_submap: Submap | None = None
        self.first_edge = True
        self.prior_pcd = None
        self.prior_conf = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.timer = None   # optional utils.profiling.StageTimer
        # Host-driven device work (keyframe gate, RANSAC, pose graph) runs on
        # its own stream so it overlaps the queued forward of the next
        # submap instead of waiting behind it.
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def side_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _stage(self, name: str):
        return (self.timer.stage(name) if self.timer is not None
                else contextlib.nullcontext())

    # -- perception ---------------------------------------------------------

    def run_predictions(self, image_names, model_fn, max_loops: int,
                        semantic_embeddings=None, names=None) -> dict:
        """Dispatch + collect for one submap (the serial flow)."""
        return self.collect_predictions(self.dispatch_predictions(
            image_names, model_fn, max_loops, semantic_embeddings, names))

    def dispatch_predictions(self, image_names, model_fn, max_loops: int,
                             semantic_embeddings=None, names=None,
                             new_id=None, previous_in_map: bool = True):
        """Loop detection and the forward's dispatch.

        `image_names`: image paths or a preloaded (S, 3, H, W) float array
        in [0, 1] (then `names` gives frame names). In the pipelined loop
        the previous submap is not in the map yet: pass its id + 1 as
        `new_id` and previous_in_map=False."""
        if isinstance(image_names, (list, tuple)):
            images = load_and_preprocess_images(list(image_names))
            names = list(image_names)
        else:
            images = np.asarray(image_names, dtype=np.float32)
            if names is None:
                names = [f"{i}.png" for i in range(images.shape[0])]
        if new_id is None:
            new_id = self.map.get_largest_key() + 1
        new_submap = Submap(new_id)
        new_submap.add_all_frames(images)
        new_submap.set_frame_ids(names)
        with self._stage("retrieval"):
            new_submap.set_all_retrieval_vectors(
                self.image_retrieval.get_all_submap_embeddings(new_submap))
            detected_loops = self.image_retrieval.find_loop_closures(
                self.map, new_submap, max_loop_closures=max_loops,
                skip_last=previous_in_map)
        retrieved = self.map.get_frames_from_loops(detected_loops)
        new_submap.set_last_non_loop_frame_index(images.shape[0] - 1)
        if retrieved:
            images = np.concatenate(
                [images, np.stack([np.asarray(f) for f in retrieved])])
            new_submap.add_all_frames(images)
        if semantic_embeddings is not None:
            new_submap.add_all_semantic_embeddings(self._fit_semantics(
                semantic_embeddings, images))
        self.current_working_submap = new_submap
        outputs = {k: _start_host_copy(v)
                   for k, v in model_fn(images).items()}
        return {"outputs": outputs, "images": images,
                "detected_loops": detected_loops, "submap": new_submap}

    @staticmethod
    def _fit_semantics(sem, images):
        """(S, h, w, d) embeddings -> bilinear (antialiased) resize to the
        image grid, zero rows for appended loop frames."""
        sem = np.asarray(sem, dtype=np.float32)
        if sem.ndim != 4:
            raise ValueError(
                f"semantic_embeddings must be (S,H,W,d), got {sem.shape}")
        hw = tuple(images.shape[-2:])
        if sem.shape[1:3] != hw:
            sem = F.interpolate(torch.from_numpy(sem).permute(0, 3, 1, 2),
                                size=hw, mode="bilinear",
                                align_corners=False, antialias=True
                                ).permute(0, 2, 3, 1).numpy()
        if images.shape[0] != sem.shape[0]:
            padded = np.zeros((images.shape[0],) + sem.shape[1:], np.float32)
            padded[: sem.shape[0]] = sem
            sem = padded
        return sem

    def collect_predictions(self, pending: dict) -> dict:
        """Wait for the forward's outputs on the host and decode cameras."""
        images = pending["images"]
        predictions = {}
        for k, v in pending["outputs"].items():
            a = _finish_host_copy(v)
            if k in ("world_points_cf", "unproj_points_cf"):
                predictions[k.replace("_cf", "")] = np.moveaxis(a, 0, -1)
            else:
                predictions[k] = a
        if "extrinsic" not in predictions:
            extr, intr = geometry.pose_encoding_to_extri_intri(
                torch.as_tensor(predictions["pose_enc"]), images.shape[-2:])
            predictions["extrinsic"] = extr.numpy()
            predictions["intrinsic"] = intr.numpy()
        predictions["images"] = images
        predictions["detected_loops"] = pending["detected_loops"]
        predictions["submap"] = pending["submap"]
        return predictions

    # -- registration -------------------------------------------------------

    def _ransac(self, X1, X2, weights=None, return_inlier_frac=False):
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        H, count = ransac_projective(
            dev(X1), dev(X2), None if weights is None else dev(weights),
            generator=self._gen)
        H = H.cpu().numpy().astype(np.float64)
        if return_inlier_frac:
            n = (float(np.sum(np.asarray(weights, np.float32)))
                 if weights is not None else float(len(X1)))
            return H, float(count) / max(n, 1.0)
        return H

    def add_points(self, pred_dict: dict) -> None:
        images = pred_dict["images"]
        extrinsics_cam = pred_dict["extrinsic"]
        intrinsics_cam = pred_dict["intrinsic"]
        detected_loops = pred_dict["detected_loops"]

        with self._stage("ap_unpack"):
            if self.use_point_map:
                world_points = np.asarray(pred_dict["world_points"],
                                          np.float64)
                conf = np.asarray(pred_dict["world_points_conf"])
            elif "unproj_points" in pred_dict:
                world_points = pred_dict["unproj_points"]
                conf = np.asarray(pred_dict["depth_conf"])
            else:
                depth = torch.as_tensor(
                    np.asarray(pred_dict["depth"], np.float64))
                world_points = geometry.unproject_depth_map_to_point_map(
                    depth, torch.as_tensor(np.asarray(extrinsics_cam,
                                                      np.float64)),
                    torch.as_tensor(np.asarray(intrinsics_cam, np.float64))
                ).numpy()
                conf = np.asarray(pred_dict["depth_conf"])
        with self._stage("ap_colors"):
            colors = (np.transpose(images, (0, 2, 3, 1)) * 255).astype(
                np.uint8)
        with self._stage("ap_poses"):
            # Host SE(3) inverse (R^T, -R^T t): tiny, and a device round
            # trip here would wait behind the next submap's forward.
            E = np.asarray(extrinsics_cam, np.float64)
            Rt = np.transpose(E[:, :3, :3], (0, 2, 1))
            cam_to_world = np.tile(np.eye(4), (E.shape[0], 1, 1))
            cam_to_world[:, :3, :3] = Rt
            cam_to_world[:, :3, 3] = -np.einsum("nij,nj->ni", Rt, E[:, :3, 3])

        sub = pred_dict.get("submap") or self.current_working_submap
        new_id = sub.get_id()

        if self.first_edge:
            self.first_edge = False
            self.prior_pcd = world_points[-1].reshape(-1, 3)
            self.prior_conf = conf[-1].reshape(-1)
            H_w_submap = np.eye(4)
            self.graph.add_homography(new_id, H_w_submap)
            self.graph.add_prior_factor(new_id, H_w_submap,
                                        self.graph.anchor_noise)
        else:
            prior_id = self.map.get_largest_key()
            prior_submap = self.map.get_submap(prior_id)
            with self._stage("ap_mask"):
                current_pts = world_points[0].reshape(-1, 3)
                thr = prior_submap.get_conf_threshold()
                good_mask = self.prior_conf > thr * (
                    conf[0].reshape(-1) > thr).astype(conf.dtype)
            if self.use_sim3:
                idx = prior_submap.get_last_non_loop_frame_index()
                T_prior = np.eye(4)
                T_prior[:3, :] = prior_submap.poses[idx][0:3, :]
                T_inv = np.linalg.inv(T_prior)
                prior_in_cam = (T_inv[:3, :3] @ self.prior_pcd[good_mask].T
                                ).T + T_inv[:3, 3]
                scale_factor = float(np.mean(
                    np.linalg.norm(prior_in_cam, axis=1)
                    / (np.linalg.norm(current_pts[good_mask], axis=1)
                       + 1e-12)))
                H_relative = T_prior.copy()
                world_points = world_points * scale_factor
                cam_to_world[:, 0:3, 3] *= scale_factor
            else:
                with self._stage("ap_ransac"):
                    H_relative = self._ransac(
                        current_pts, self.prior_pcd,
                        weights=good_mask.astype(np.float32))
            H_w_submap = prior_submap.get_reference_homography() @ H_relative
            if self.loop_inlier_thresh > 0:
                with self._stage("ap_gate_ref"):
                    _, seq_frac = self._ransac(current_pts, self.prior_pcd,
                                               return_inlier_frac=True)
                self._seq_reg_fracs.append(seq_frac)
            non_lc = sub.get_last_non_loop_frame_index()
            self.prior_pcd = world_points[non_lc].reshape(-1, 3)
            self.prior_conf = conf[non_lc].reshape(-1)
            self.graph.add_homography(new_id, H_w_submap)
            self.graph.add_between_factor(prior_id, new_id, H_relative,
                                          self.graph.relative_noise)

        sub.set_reference_homography(H_w_submap)
        sub.add_all_poses(cam_to_world)
        with self._stage("ap_submap_store"):
            sub.add_all_points(world_points, colors, conf,
                               self.init_conf_threshold, intrinsics_cam)
            sub.set_conf_masks(conf)

        self.detected_loop_count += len(detected_loops)
        for index, loop in enumerate(detected_loops):
            self._add_loop(sub, loop, index)
        self.map.add_submap(sub)

    def _add_loop(self, sub, loop, index: int) -> None:
        """One loop-closure factor, subject to the geometric gate."""
        loop_index = sub.get_last_non_loop_frame_index() + index + 1
        det = self.map.get_submap(loop.detected_submap_id)
        inlier_frac = None
        pts_det = det.get_frame_pointcloud(
            loop.detected_submap_frame).reshape(-1, 3)
        pts_query = sub.get_frame_pointcloud(loop_index).reshape(-1, 3)
        if self.use_sim3:
            H_rel_lc = np.linalg.inv(det.get_pose_subframe(
                loop.detected_submap_frame)) @ sub.get_pose_subframe(
                loop_index)
            if self.loop_inlier_thresh > 0:
                _, inlier_frac = self._ransac(pts_query, pts_det,
                                              return_inlier_frac=True)
        else:
            with self._stage("ap_loop_ransac"):
                H_rel_lc, inlier_frac = self._ransac(
                    pts_query, pts_det, return_inlier_frac=True)
        gate_ref = (float(np.median(self._seq_reg_fracs))
                    if self._seq_reg_fracs else None)
        if (self.loop_inlier_thresh > 0 and inlier_frac is not None
                and gate_ref is not None and gate_ref > 0
                and inlier_frac < self.loop_inlier_thresh * gate_ref):
            self.rejected_loop_count += 1
            return
        self.graph.add_between_factor(loop.detected_submap_id,
                                      loop.query_submap_id, H_rel_lc,
                                      self.graph.relative_noise)
        self.graph.increment_loop_closure()

    # -- viewer pass-throughs (no-ops without a viewer) ---------------------

    def set_submap_point_cloud(self, submap):
        if self.viewer is None:
            return
        self.viewer.add_point_cloud(
            submap.get_points_in_world_frame(stride=self.vis_stride),
            submap.get_points_colors(stride=self.vis_stride),
            name=str(submap.get_id()), point_size=self.vis_point_size)

    def set_submap_poses(self, submap):
        if self.viewer is None:
            return
        self.viewer.add_frames(submap.get_all_poses_world(),
                               submap.get_all_frames(), submap.get_id())

    def update_all_submap_vis(self):
        for submap in self.map.get_submaps():
            self.set_submap_point_cloud(submap)
            self.set_submap_poses(submap)

    def update_latest_submap_vis(self):
        submap = self.map.get_latest_submap()
        self.set_submap_point_cloud(submap)
        self.set_submap_poses(submap)

    def export_3d_scene(self, output_path: str = "output.glb"):
        if self.viewer is None:
            raise RuntimeError("no viewer attached")
        return self.viewer.export(output_path)
