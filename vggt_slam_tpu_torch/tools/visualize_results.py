"""Offline view of saved SLAM results (counterpart of
vggt_slam_tpu/tools/visualize_results.py): result.pcd, frame_output point
maps and extrinsics, the TUM pose log, a pose file with its images and a
semantic voxel directory, cropped to a percentile box and drawn in viser
(the voxel layer beside the cloud, on its own server or the same one).
--headless, or no viser, prints statistics only. Images: load_image and
resize_linear (no OpenCV).

    python -m vggt_slam_tpu_torch.tools.visualize_results --pcd_path PCD \
        [--frame_output_dir DIR] [--pose_log TXT] [--poses_path TXT \
        --image_folder DIR] [--voxel_dir DIR [--side_by_side]] [--headless]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from vggt_slam_tpu_torch.data.pcd import read_pcd


def percentile_bbox_crop(points: np.ndarray, colors: np.ndarray | None,
                         lo_pct: float = 0.5, hi_pct: float = 99.5):
    """Drop points outside the [lo, hi] percentile box per axis."""
    lo = np.percentile(points, lo_pct, axis=0)
    hi = np.percentile(points, hi_pct, axis=0)
    mask = (points >= lo).all(axis=1) & (points <= hi).all(axis=1)
    return points[mask], (colors[mask] if colors is not None else None)


def load_frame_outputs(frame_output_dir: str):
    """frame_output/*.npz -> (point maps, confidence masks, extrinsics,
    names)."""
    pts, masks, extr, names = [], [], [], []
    for path in sorted(glob.glob(os.path.join(frame_output_dir, "*.npz"))):
        d = np.load(path, allow_pickle=True)
        pts.append(d["point_map_world"])
        masks.append(d["conf_mask"])
        extr.append(d["extrinsic_world"])
        names.append(os.path.splitext(os.path.basename(path))[0])
    return pts, masks, extr, names


def load_tum_poses(path: str) -> np.ndarray:
    """TUM log -> (N, 8) [t x y z qx qy qz qw]."""
    return np.loadtxt(path).reshape(-1, 8)


def load_pose_file(path: str):
    """Lines "frame_id x y z qx qy qz qw" -> ((N, 3, 4) cam2world, frame-id
    strings); comments and malformed lines are skipped."""
    from vggt_slam_tpu_torch.slam.alignment import _quat_wxyz_to_rotmat

    extr, ids = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8 or parts[0].startswith("#"):
                continue
            try:
                x, y, z, qx, qy, qz, qw = map(float, parts[1:8])
            except ValueError:
                continue
            T = np.eye(4)
            T[:3, :3] = _quat_wxyz_to_rotmat(qw, qx, qy, qz)
            T[:3, 3] = (x, y, z)
            extr.append(T[:3, :])
            ids.append(parts[0])
    if not extr:
        raise ValueError(f"no valid poses in {path}")
    return np.stack(extr, axis=0), ids


def load_matched_images(image_folder: str, frame_ids=None):
    """(N, 3, H, W) float images in [0, 1] matched to `frame_ids` by file
    stem, else in sorted order (with a warning where only some stems
    match); mixed sizes resized to the first frame's. None when nothing
    loads."""
    from vggt_slam_tpu_torch.data.images import load_image, resize_linear

    files = sorted(
        p for p in glob.glob(os.path.join(image_folder, "*"))
        if p.lower().endswith((".jpg", ".jpeg", ".png")))
    if not files:
        return None
    if frame_ids:
        by_stem = {os.path.splitext(os.path.basename(p))[0]: p for p in files}
        matched = [by_stem[fid] for fid in frame_ids if fid in by_stem]
        if len(matched) == len(frame_ids):
            files = matched
        elif matched:
            # sorted order may pair frustums with the wrong images even
            # where the counts agree
            print(f"WARNING: only {len(matched)}/{len(frame_ids)} frame ids "
                  "matched image filename stems; falling back to sorted "
                  "file order (frustum textures may be misassigned)")
    imgs = []
    for p in files:
        try:
            img = load_image(p)
        except (OSError, ValueError, RuntimeError):   # cv2.imread's None
            continue
        imgs.append(img[..., ::-1].transpose(2, 0, 1).astype(np.float32)
                    / 255.0)
    if not imgs:
        return None
    if len({im.shape for im in imgs}) > 1:
        _, h, w = imgs[0].shape
        imgs = [im if im.shape[1:] == (h, w) else
                resize_linear(im.transpose(1, 2, 0), w, h).transpose(2, 0, 1)
                for im in imgs]
    return np.stack(imgs, axis=0)


def main(argv=None):
    p = argparse.ArgumentParser(description="Visualize saved SLAM results")
    p.add_argument("--pcd_path", default=None)
    p.add_argument("--frame_output_dir", default=None)
    p.add_argument("--pose_log", default=None)
    p.add_argument("--poses_path", default=None,
                   help="'frame_id x y z qx qy qz qw' lines")
    p.add_argument("--image_folder", default=None,
                   help="the frustums' images, by --poses_path's ids")
    p.add_argument("--voxel_dir", default=None)
    p.add_argument("--crop_percentile", type=float, default=99.5)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--voxel_port", type=int, default=8081)
    p.add_argument("--voxel_x_offset", type=float, default=0.0)
    p.add_argument("--side_by_side", action="store_true",
                   help="offset the voxels by the cloud's X extent")
    p.add_argument("--voxel_render_mode", default="points",
                   choices=["points", "cubes"])
    p.add_argument("--voxel_color_mode", default="pca",
                   choices=["pca", "first3", "ones"])
    p.add_argument("--voxel_max_voxels", type=int, default=20000)
    p.add_argument("--point_size", type=float, default=0.003)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--headless", action="store_true",
                   help="print stats only (as without viser)")
    args = p.parse_args(argv)

    points = colors = None
    x_extent = 0.0
    if args.pcd_path:
        points, colors = read_pcd(args.pcd_path)
        n0 = points.shape[0]
        points, colors = percentile_bbox_crop(
            points, colors, 100 - args.crop_percentile, args.crop_percentile)
        print(f"pcd: {n0} points -> {points.shape[0]} after bbox crop")
        if points.shape[0]:
            x_extent = float(points[:, 0].max() - points[:, 0].min())
        if args.stride > 1:
            points = points[::args.stride]
            colors = colors[::args.stride] if colors is not None else None

    extr = None
    if args.frame_output_dir:
        pts_list, masks, extr, names = load_frame_outputs(
            args.frame_output_dir)
        print(f"frame_output: {len(pts_list)} frames "
              f"(e.g. {names[:3]}), point map {pts_list[0].shape}")
        if points is None and pts_list:
            stacked = [pm[m] for pm, m in zip(pts_list, masks)]
            points = np.concatenate(stacked, axis=0)
            print(f"merged frame point maps: {points.shape[0]} points")

    if args.pose_log:
        tum = load_tum_poses(args.pose_log)
        length = np.linalg.norm(np.diff(tum[:, 1:4], axis=0), axis=1).sum()
        print(f"pose log: {tum.shape[0]} poses, "
              f"trajectory length {length:.2f}")

    pose_extr = pose_images = None
    if args.poses_path:
        pose_extr, frame_ids = load_pose_file(args.poses_path)
        print(f"poses: {pose_extr.shape[0]} cam2world frames")
        if args.image_folder:
            pose_images = load_matched_images(args.image_folder, frame_ids)
            if pose_images is not None:
                print(f"images: {pose_images.shape[0]} matched")

    vm = None
    if args.voxel_dir:
        from vggt_slam_tpu_torch.semantic.voxel_map import SemanticVoxelMap
        vm = SemanticVoxelMap.load_from_directory(args.voxel_dir)
        print(f"voxel map: {vm.get_centers_world().shape[0]} voxels, "
              f"dim {vm.get_features().shape[-1]}")

    try:
        import viser  # noqa: F401
        has_viser = not args.headless
    except ImportError:
        has_viser = False
        print("(viser not installed - headless stats only)")

    if not has_viser:
        return

    from vggt_slam_tpu_torch.viz.viser_viewer import ViserViewer, show_voxels
    viewer = ViserViewer(port=args.port)
    if points is not None:
        viewer.add_point_cloud(points, colors if colors is not None else
                               np.full_like(points, 180, dtype=np.uint8),
                               name="result", point_size=args.point_size)
    import viser.transforms as viser_tf
    if extr:
        for i, T in enumerate(extr):
            Tw = viser_tf.SE3.from_matrix(np.asarray(T)[:3, :4])
            viewer.server.scene.add_frame(
                f"traj/frame_{i}", wxyz=Tw.rotation().wxyz,
                position=Tw.translation(), axes_length=0.05, axes_radius=0.002)
    if pose_extr is not None:
        if pose_images is not None and len(pose_images) == len(pose_extr):
            viewer.add_frames(pose_extr, pose_images, submap_id=0,
                              image_scale=0.5)
        else:
            for i, T in enumerate(pose_extr):
                Tw = viser_tf.SE3.from_matrix(np.asarray(T)[:3, :4])
                f = viewer.server.scene.add_frame(
                    f"pose_{i}", wxyz=Tw.rotation().wxyz,
                    position=Tw.translation(), axes_length=0.05,
                    axes_radius=0.002, origin_radius=0.002)
                f.visible = viewer.gui_show_frames.value
    if vm is not None:
        x_off = args.voxel_x_offset
        if args.side_by_side and x_off == 0.0:
            x_off = x_extent + 1e-3
            print(f"side-by-side: offsetting voxels by +X={x_off:.3f}")
        # one server when the ports are equal, a second one otherwise
        same = args.voxel_port == args.port
        show_voxels(vm, port=args.voxel_port, keep_alive=False,
                    x_offset=x_off, render_mode=args.voxel_render_mode,
                    color_mode=args.voxel_color_mode,
                    max_voxels=args.voxel_max_voxels,
                    server=viewer.server if same else None)
    print("Viser running. Press Enter to exit...")
    try:
        input()
    except (KeyboardInterrupt, EOFError):
        pass


if __name__ == "__main__":
    main()
