"""Viser viewer (optional dependency), the port's counterpart of
vggt_slam_tpu/viz/viser_viewer.py's `ViserViewer`: per-submap camera
frames and image frustums coloured from a fixed random palette, a global
show/hide checkbox, and point-cloud layers. Importing this module needs
viser; the SLAM loop runs headless without it. The frustum images are
shrunk by data/images.resize_area (OpenCV's INTER_AREA, no OpenCV)."""
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
