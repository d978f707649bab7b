"""Viser viewer (optional; counterpart of vggt_slam_tpu/viz/viser_viewer.py):
`ViserViewer` (per-submap camera frames and frustums from a fixed random
palette, a show/hide checkbox, point-cloud layers) and `show_voxels`.
Importing it needs viser; frustum images shrink by resize_area.
"""
from __future__ import annotations

import numpy as np

import viser
import viser.transforms as viser_tf

from vggt_slam_tpu_torch.data.images import resize_area


class ViserViewer:
    def __init__(self, port: int = 8080, rng=None):
        """`rng`: the palette's np.random.RandomState (default: numpy's
        global generator, as the reference)."""
        print(f"Starting viser server on port {port}")
        self.server = viser.ViserServer(host="0.0.0.0", port=port)
        self.server.gui.configure_theme(titlebar_content=None,
                                        control_layout="collapsible")
        self.gui_show_frames = self.server.gui.add_checkbox(
            "Show Cameras", initial_value=True)
        self.gui_show_frames.on_update(self._on_update_show_frames)
        self.submap_frames: dict[int, list] = {}
        self.submap_frustums: dict[int, list] = {}
        self.random_colors = (np.random if rng is None else rng).randint(
            0, 256, size=(250, 3), dtype=np.uint8)

    def add_point_cloud(self, points, colors, name: str, point_size: float):
        if colors is not None and colors.dtype != np.uint8 \
                and colors.max() <= 1.0:
            colors = (colors * 255).astype(np.uint8)
        self.server.scene.add_point_cloud(
            name="pcd_" + name, points=np.asarray(points),
            colors=np.asarray(colors), point_size=point_size,
            point_shape="circle")

    def add_frames(self, extrinsics: np.ndarray, images_: np.ndarray,
                   submap_id: int, image_scale: float = 0.5) -> None:
        images_ = np.asarray(images_)
        self.submap_frames.setdefault(submap_id, [])
        self.submap_frustums.setdefault(submap_id, [])
        for img_id in range(extrinsics.shape[0]):
            T_wc = viser_tf.SE3.from_matrix(extrinsics[img_id][:3, :4])
            frame_name = f"submap_{submap_id}/frame_{img_id}"
            frame_axis = self.server.scene.add_frame(
                frame_name, wxyz=T_wc.rotation().wxyz,
                position=T_wc.translation(), axes_length=0.05,
                axes_radius=0.002, origin_radius=0.002)
            frame_axis.visible = self.gui_show_frames.value
            self.submap_frames[submap_id].append(frame_axis)

            img = (images_[img_id].transpose(1, 2, 0) * 255).astype(np.uint8)
            h, w = img.shape[:2]
            fov = 2 * np.arctan2(h / 2, 1.1 * h)
            frustum = self.server.scene.add_camera_frustum(
                f"{frame_name}/frustum", fov=fov, aspect=w / h, scale=0.05,
                image=resize_area(img, int(w * image_scale),
                                  int(h * image_scale)),
                line_width=3.0, color=self.random_colors[submap_id % 250])
            frustum.visible = self.gui_show_frames.value
            self.submap_frustums[submap_id].append(frustum)

    def _on_update_show_frames(self, _) -> None:
        visible = self.gui_show_frames.value
        for handles in (*self.submap_frames.values(),
                        *self.submap_frustums.values()):
            for h in handles:
                h.visible = visible

    def export(self, output_path: str):
        raise NotImplementedError("use viz.glb.GLBExporter for file export")


def show_voxels(voxel_map, port: int = 8081, name: str = "semantic_voxels",
                point_size: float = 0.01, color_mode: str = "pca",
                max_voxels: int | None = 20000, query_voxel_indices=None,
                base_color=(0.75, 0.75, 0.75), highlight_color=(1.0, 0.0, 0.0),
                keep_alive: bool = True, x_offset: float = 0.0,
                render_mode: str = "points", cube_opacity: float = 0.5,
                server=None):
    """Render a SemanticVoxelMap in viser as one point cloud ("points") or a
    translucent box a voxel ("cubes"), coloured "pca", "first3", "ones" or
    "query" (`query_voxel_indices` highlighted); at most `max_voxels`, drawn
    with numpy's global generator; `x_offset` shifts the layer; `server`
    reuses a server. Returns (server, handle)."""
    points = voxel_map.get_centers_world().astype(np.float32).copy()
    points[:, 0] += x_offset
    feats = voxel_map.get_features().astype(np.float32)
    orig = np.arange(points.shape[0])
    if max_voxels is not None and points.shape[0] > max_voxels:
        idx = np.random.choice(points.shape[0], max_voxels, replace=False)
        points, feats, orig = points[idx], feats[idx], orig[idx]

    if color_mode == "query":
        colors = np.tile(np.asarray(base_color, np.float32),
                         (points.shape[0], 1))
        if query_voxel_indices:
            qset = set(int(i) for i in query_voxel_indices)
            mask = np.array([int(i) in qset for i in orig])
            colors[mask] = np.asarray(highlight_color, np.float32)
    elif color_mode == "ones":
        colors = np.ones((points.shape[0], 3), np.float32)
    elif color_mode == "first3":
        colors = voxel_map.features_to_rgb(feats[:, :3])
    else:
        colors = voxel_map.features_to_rgb(feats)

    if server is None:
        server = viser.ViserServer(host="0.0.0.0", port=port)
    if render_mode == "cubes":
        size = float(voxel_map.get_voxel_size())
        handle = [server.scene.add_box(
            name=f"{name}/voxel_{i}",
            position=tuple(float(v) for v in points[i]),
            dimensions=(size, size, size),
            color=tuple(float(v) for v in colors[i][:3]),
            opacity=cube_opacity) for i in range(points.shape[0])]
    elif render_mode == "points":
        handle = server.scene.add_point_cloud(
            name=name, points=points, colors=colors, point_size=point_size,
            point_shape="circle")
    else:
        raise ValueError(f"unknown render_mode {render_mode!r}")
    if keep_alive:
        print(f"Viser server on port {port}. Press Enter to exit...")
        try:
            input()
        except (KeyboardInterrupt, EOFError):
            pass
    return server, handle
