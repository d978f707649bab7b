"""2D occupancy and trajectory navigability (counterpart of
vggt_slam_tpu/tools/occupancy.py): an (x, y) grid of a point cloud on the
card (blocked where a cell's z range passes --height_thresh, points over
--ceiling_z dropped), a COLMAP trajectory's cells unblocked, its segments
sampled at half-cell steps on the card; --visualize draws it in viser.

    python -m vggt_slam_tpu_torch.tools.occupancy --pcd_path P \
        --colmap_images_txt T --path_txt L [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from vggt_slam_tpu_torch.data.pcd import read_pcd
from vggt_slam_tpu_torch.ops.voxel import unique_rows, voxel_coords
from vggt_slam_tpu_torch.slam.alignment import _quat_wxyz_to_rotmat
from vggt_slam_tpu_torch.utils.device import resolve_device


def get_T_zup_from_xleft_ydown_zin() -> np.ndarray:
    """Dataset frame (x left, y down, z inward) -> right-handed z-up."""
    T = np.eye(4)
    T[:3, :3] = [[-1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, -1.0, 0.0]]
    return T


def apply_T_world(T: np.ndarray, pts_xyz: np.ndarray) -> np.ndarray:
    pts = np.asarray(pts_xyz, dtype=np.float64)
    return (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)


def parse_colmap_images_txt_poses(images_txt_path: str) -> Dict[str, np.ndarray]:
    """COLMAP images.txt -> {basename: cam2world (4, 4)}."""
    poses: Dict[str, np.ndarray] = {}
    with open(images_txt_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 10 or parts[0].startswith("#"):
                continue
            try:
                qw, qx, qy, qz, tx, ty, tz = map(float, parts[1:8])
            except ValueError:
                continue
            R_cw = _quat_wxyz_to_rotmat(qw, qx, qy, qz)
            T = np.eye(4)
            T[:3, :3] = R_cw.T
            T[:3, 3] = -R_cw.T @ np.array([tx, ty, tz])
            poses[parts[9].split("/")[-1]] = T
    return poses


def load_path_list(path_txt: str) -> List[str]:
    with open(path_txt) as f:
        return [os.path.basename(s.strip()) for s in f if s.strip()]


def _code(keys: torch.Tensor) -> torch.Tensor:
    """(..., 2) int64 cell keys -> one int64 each, ordered as the rows."""
    if keys.numel() and keys.abs().max() >= 2 ** 31:
        raise ValueError("occupancy cell keys beyond 32 bits")
    return (keys[..., 0] << 32) + keys[..., 1] + (1 << 31)


def build_occupancy_from_pointcloud(points_xyz: np.ndarray, voxel_size: float,
                                    ceiling_z: float, height_thresh: float,
                                    device="cuda"):
    """On `device`: (centers (M, 3), is_blocked (M,), cell_keys (M, 2) in
    np.unique's order, minz (M,)) as numpy."""
    pts = torch.as_tensor(np.asarray(points_xyz, np.float32),
                          device=resolve_device(device))
    pts = pts[torch.isfinite(pts).all(1)]
    pts = pts[pts[:, 2] <= ceiling_z]
    if pts.shape[0] == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0,), bool),
                np.zeros((0, 2), np.int64), np.zeros((0,), np.float32))
    uniq, inv, _ = unique_rows(voxel_coords(pts[:, :2], voxel_size))
    z, m = pts[:, 2], uniq.shape[:1]
    minz = z.new_full(m, torch.inf).scatter_reduce_(0, inv, z, "amin")
    maxz = z.new_full(m, -torch.inf).scatter_reduce_(0, inv, z, "amax")
    centers = torch.cat([((uniq.double() + 0.5) * voxel_size).float(),
                         (minz + voxel_size * 0.5)[:, None]], 1)
    return tuple(a.cpu().numpy() for a in (
        centers, (maxz - minz) > height_thresh, uniq, minz))


def _samples(traj_pts, voxel_size: float, dev):
    """Each consecutive pair's XY line at half-cell steps, on `dev`:
    p0 + (p1 - p0) * t in float32 (t as np.linspace's), segment ids."""
    p = np.asarray(traj_pts, np.float32).reshape(-1, 3)
    n = [max(2, int(np.ceil(float(np.linalg.norm(b[:2] - a[:2]))
                            / (voxel_size * 0.5))) + 1)
         for a, b in zip(p[:-1], p[1:])]
    n_t = torch.tensor(n, dtype=torch.int64, device=dev)
    seg = torch.repeat_interleave(torch.arange(len(n), device=dev), n_t)
    i = torch.arange(int(sum(n)), device=dev) - (n_t.cumsum(0) - n_t)[seg]
    m = (n_t[seg] - 1).double()
    t = torch.where(i == m, 1.0, i * (1.0 / m)).float()[:, None]
    p0, p1 = (torch.as_tensor(a[:, :2], device=dev)[seg]
              for a in (p[:-1], p[1:]))
    return p0 + (p1 - p0) * t, seg


def _lookup(cells: dict, keys: torch.Tensor, default, dtype):
    """The dict's value at each (M, 2) key, `default` where it has none."""
    table = torch.tensor(list(cells) or [(0, 0)], dtype=torch.int64,
                         device=keys.device)
    vals = torch.tensor(list(cells.values()) or [default], dtype=dtype,
                        device=keys.device)
    code, order = torch.sort(_code(table))
    q = _code(keys)
    idx = torch.searchsorted(code, q).clamp(max=code.shape[0] - 1)
    found = (code[idx] == q) & bool(cells)
    return torch.where(found, vals[order[idx]], default)


def _navigable(traj_pts, voxel_size, blocked_cells, unknown_is_free, dev):
    xy, seg = _samples(traj_pts, voxel_size, dev)
    bad = _lookup(blocked_cells, voxel_coords(xy, voxel_size),
                  not unknown_is_free, torch.bool)
    n_bad = torch.zeros(len(traj_pts) - 1, dtype=torch.int64,
                        device=dev).index_add_(0, seg, bad.long())
    return (n_bad == 0).tolist()


def segment_is_navigable(p0, p1, voxel_size: float,
                         blocked_cells: Dict[Tuple[int, int], bool],
                         unknown_is_free: bool = True,
                         device="cuda") -> bool:
    """Straight-line XY navigability by sampling occupancy cells."""
    return _navigable(np.stack([np.asarray(p, np.float32).reshape(3)
                                for p in (p0, p1)]), voxel_size,
                      blocked_cells, unknown_is_free,
                      resolve_device(device))[0]


def segment_sample_overlay(traj_pts: np.ndarray, voxel_size: float,
                           blocked_cells: Dict[Tuple[int, int], bool],
                           cell_center_z: Dict[Tuple[int, int], float],
                           floor_z: float, unknown_is_free: bool = False,
                           device="cuda"):
    """(sample dots (M, 3) f32 at their cell's z + 0.2, colours (M, 3) f32
    purple where blocked and green where free, navigable list); a dot's
    cell is keyed in float64, as the reference's."""
    dev, vs = resolve_device(device), float(voxel_size)
    xy, _ = _samples(traj_pts, vs, dev)
    keys = voxel_coords(xy.double(), vs)
    blk = _lookup(blocked_cells, keys, not unknown_is_free, torch.bool)
    zc = _lookup(cell_center_z, keys, floor_z + vs * 0.5, torch.float64)
    cols = torch.tensor([[0.0, 1.0, 0.0], [0.6, 0.0, 0.8]], device=dev)
    return (torch.cat([xy, (zc + 0.2).float()[:, None]], 1).cpu().numpy(),
            cols[blk.long()].cpu().numpy(),
            _navigable(traj_pts, vs, blocked_cells, unknown_is_free, dev))


@dataclass
class NavigabilityResult:
    details: List[bool]
    navigability: bool


def _prepare_scene(pcd_path: str, colmap_images_txt: str, path_txt: str,
                   voxel_size: float, ceiling_z: float, height_thresh: float,
                   transform_to_zup: bool, device="cuda") -> dict:
    """The cloud (z-up), its grid, the trajectory restricted to the path
    list (same transform), the cells under it unblocked."""
    for p in (pcd_path, colmap_images_txt, path_txt):
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    pts, colors = read_pcd(pcd_path)
    T_zup = get_T_zup_from_xleft_ydown_zin()
    if transform_to_zup:
        pts = apply_T_world(T_zup, pts)
    centers, blocked, cell_keys, _ = build_occupancy_from_pointcloud(
        pts, voxel_size, ceiling_z, height_thresh, device)
    keys = [(int(k[0]), int(k[1])) for k in cell_keys]
    blocked_cells = dict(zip(keys, map(bool, blocked)))
    cell_center_z = dict(zip(keys, map(float, centers[:, 2])))

    poses_by_name = parse_colmap_images_txt_poses(colmap_images_txt)
    path_names = load_path_list(path_txt)
    traj_T = [poses_by_name[n] for n in path_names if n in poses_by_name]
    if len(traj_T) < len(path_names):
        print(f"[warn] Missing {len(path_names) - len(traj_T)}/"
              f"{len(path_names)} images from COLMAP.")
    if len(traj_T) < 2:
        raise RuntimeError("Need at least 2 poses from path.txt.")
    traj = np.stack(traj_T)
    if transform_to_zup:
        traj = T_zup[None] @ traj
    traj_pts = traj[:, :3, 3].astype(np.float32)

    cell_index = {k: i for i, k in enumerate(keys)}
    n_unblocked = 0
    for p in traj_pts:
        key = (int(np.floor(p[0] / voxel_size)),
               int(np.floor(p[1] / voxel_size)))
        if key in cell_index and blocked_cells.get(key, False):
            blocked[cell_index[key]] = blocked_cells[key] = False
            n_unblocked += 1
    if n_unblocked:
        print(f"Unblocked {n_unblocked} occupancy cells under trajectory.")
    return dict(pts=pts, colors=colors, centers=centers, blocked=blocked,
                cell_keys=cell_keys, blocked_cells=blocked_cells,
                cell_center_z=cell_center_z, traj=traj, traj_pts=traj_pts)


def _report(nav) -> None:
    nav = np.asarray(nav)
    print(f"segments: {nav.size}  navigable: {int(nav.sum())}  "
          f"blocked: {int(nav.size - nav.sum())}  overall: {bool(nav.all())}")


def compute_navigability(pcd_path: str, colmap_images_txt: str, path_txt: str,
                         voxel_size: float = 0.2, ceiling_z: float = 1.0,
                         height_thresh: float = 0.2,
                         unknown_is_free: bool = False,
                         transform_to_zup: bool = True,
                         device="cuda") -> NavigabilityResult:
    dev = resolve_device(device)
    scene = _prepare_scene(pcd_path, colmap_images_txt, path_txt,
                           voxel_size, ceiling_z, height_thresh,
                           transform_to_zup, dev)
    details = _navigable(scene["traj_pts"], voxel_size,
                         scene["blocked_cells"], unknown_is_free, dev)
    _report(details)
    return NavigabilityResult(details, bool(np.all(details)))


def visualize_occupancy(args) -> None:
    """Viser: cells (gray free, red blocked), the raw points under the
    ceiling, the trajectory (orange; start blue, end green), optional
    camera frames and frusta, the segments' sample dots."""
    import viser
    import viser.transforms as viser_tf

    scene = _prepare_scene(args.pcd_path, args.colmap_images_txt,
                           args.path_txt, args.voxel_size, args.ceiling_z,
                           args.height_thresh, not args.no_zup_transform,
                           args.device)
    cvis, bvis = scene["centers"], scene["blocked"]
    pts, colors, traj_pts = scene["pts"], scene["colors"], scene["traj_pts"]
    server = viser.ViserServer(host="0.0.0.0", port=int(args.port))
    vs = args.voxel_size
    if cvis.shape[0] > args.max_cubes:
        print(f"[warn] subsampling cells {cvis.shape[0]} -> {args.max_cubes}")
        idx = np.random.choice(cvis.shape[0], args.max_cubes, replace=False)
        cvis, bvis = cvis[idx], bvis[idx]
    cell_colors = np.full((cvis.shape[0], 3), 0.8, np.float32)
    cell_colors[bvis] = (1.0, 0.0, 0.0)
    cloud = server.scene.add_point_cloud
    cloud("occupancy/cells", points=cvis, colors=cell_colors,
          point_size=float(vs * 0.8), point_shape="rounded")
    zmask = pts[:, 2] <= args.ceiling_z
    vpts = pts[zmask][::args.vis_stride]
    if colors is not None:
        vcols = np.asarray(colors)[zmask][::args.vis_stride]
        if vcols.dtype != np.uint8 and vcols.max() <= 1.0:
            vcols = (vcols * 255).astype(np.uint8)
    else:
        vcols = np.full((vpts.shape[0], 3), 160, np.uint8)
    cloud("occupancy/points", points=vpts, colors=vcols,
          point_size=float(vs * 0.5), point_shape="rounded")
    tcols = np.tile(np.array([1.0, 0.5, 0.0], np.float32),
                    (traj_pts.shape[0], 1))
    tcols[0], tcols[-1] = (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)
    cloud("trajectory/points", points=traj_pts, colors=tcols,
          point_size=float(args.traj_point_size), point_shape="diamond")
    if args.show_camera_frames:
        for i, T in enumerate(scene["traj"]):
            Tw = viser_tf.SE3.from_matrix(np.asarray(T)[:3, :])
            server.scene.add_frame(
                f"trajectory/frame_{i}", wxyz=Tw.rotation().wxyz,
                position=Tw.translation(), axes_length=0.05,
                axes_radius=0.002, origin_radius=0.002)
            server.scene.add_camera_frustum(
                f"trajectory/frustum_{i}", fov=1.0, aspect=1.0, scale=0.08,
                wxyz=Tw.rotation().wxyz, position=Tw.translation(),
                color=tuple(float(v) for v in tcols[i]))
    floor_z = float(np.percentile(pts[:, 2], 1)) if pts.shape[0] else 0.0
    seg_pts, seg_cols, navigable = segment_sample_overlay(
        traj_pts, vs, scene["blocked_cells"], scene["cell_center_z"],
        floor_z, args.unknown_is_free, args.device)
    if seg_pts.shape[0]:
        cloud("trajectory/segments", points=seg_pts, colors=seg_cols,
              point_size=float(max(args.segment_point_size, vs * 0.4)),
              point_shape="circle")
    _report(navigable)
    print(f"Visualization ready: http://localhost:{args.port}  "
          "Press Enter to exit...")
    try:
        input()
    except (KeyboardInterrupt, EOFError):
        pass


def main(argv=None):
    p = argparse.ArgumentParser(description="Occupancy + navigability")
    for name in ("pcd_path", "colmap_images_txt", "path_txt"):
        p.add_argument(f"--{name}", type=str, required=True)
    for name, v in (("voxel_size", 0.2), ("ceiling_z", 1.0),
                    ("height_thresh", 0.2), ("traj_point_size", 0.1),
                    ("segment_point_size", 0.01)):
        p.add_argument(f"--{name}", type=float, default=v)
    for name in ("unknown_is_free", "no_zup_transform", "visualize",
                 "show_camera_frames"):
        p.add_argument(f"--{name}", action="store_true")
    p.add_argument("--port", type=int, default=8090)
    p.add_argument("--max_cubes", type=int, default=60000)
    p.add_argument("--vis_stride", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.visualize:
        return visualize_occupancy(args)
    res = compute_navigability(
        args.pcd_path, args.colmap_images_txt, args.path_txt,
        args.voxel_size, args.ceiling_z, args.height_thresh,
        args.unknown_is_free, not args.no_zup_transform, args.device)
    print(f"Navigability: {res.navigability}")
    return res


if __name__ == "__main__":
    main()
