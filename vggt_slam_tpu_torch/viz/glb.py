"""Binary glTF 2.0 (GLB) export of point clouds and camera axes, the
port's copy of vggt_slam_tpu/viz/glb.py (numpy only; byte-equal output):
one buffer, a POINTS primitive (positions + vertex colours) and a LINES
primitive for the camera axes."""
from __future__ import annotations

import json
import struct

import numpy as np

_COMP_F32 = 5126
_COMP_U8 = 5121


class GLBExporter:
    def __init__(self):
        self.points: list[np.ndarray] = []
        self.colors: list[np.ndarray] = []
        self.lines: list[np.ndarray] = []       # (N, 2, 3) segments
        self.line_colors: list[np.ndarray] = []

    def add_point_cloud(self, points, colors=None) -> None:
        pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        if colors is None:
            colors = np.full((pts.shape[0], 3), 200, np.uint8)
        else:
            colors = np.asarray(colors)
            if colors.dtype != np.uint8:
                scale = 255.0 if colors.max() <= 1.0 + 1e-6 else 1.0
                colors = np.clip(colors * scale, 0, 255).astype(np.uint8)
        self.points.append(pts)
        self.colors.append(colors.reshape(-1, 3))

    def add_camera_pose(self, pose_c2w, axis_length: float = 0.1) -> None:
        """RGB axis segments for one cam->world pose, (4, 4) or (3, 4)."""
        T = np.asarray(pose_c2w, dtype=np.float32)
        o = T[:3, 3]
        axes = T[:3, :3] * axis_length
        cols = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
        for k in range(3):
            self.lines.append(np.stack([o, o + axes[:, k]])[None])
            self.line_colors.append(np.tile(cols[k], (2, 1))[None])

    def export(self, path: str) -> str:
        buffers = bytearray()
        buffer_views, accessors, meshes, nodes = [], [], [], []

        def add_view(data: bytes, target=None):
            while len(buffers) % 4:           # 4-byte alignment
                buffers.append(0)
            view = {"buffer": 0, "byteOffset": len(buffers),
                    "byteLength": len(data)}
            buffers.extend(data)
            if target:
                view["target"] = target
            buffer_views.append(view)
            return len(buffer_views) - 1

        def add_accessor(view, comp_type, count, type_str, mn=None, mx=None,
                         normalized=False):
            acc = {"bufferView": view, "componentType": comp_type,
                   "count": count, "type": type_str}
            if mn is not None:
                acc["min"] = mn
                acc["max"] = mx
            if normalized:
                acc["normalized"] = True
            accessors.append(acc)
            return len(accessors) - 1

        def add_primitive(pts, cols, mode):
            v = add_view(pts.astype(np.float32).tobytes(), 34962)
            pa = add_accessor(v, _COMP_F32, len(pts), "VEC3",
                              pts.min(0).tolist(), pts.max(0).tolist())
            cv = add_view(np.ascontiguousarray(cols, np.uint8).tobytes(),
                          34962)
            ca = add_accessor(cv, _COMP_U8, len(cols), "VEC3",
                              normalized=True)
            meshes.append({"primitives": [{
                "attributes": {"POSITION": pa, "COLOR_0": ca},
                "mode": mode}]})
            nodes.append({"mesh": len(meshes) - 1})

        if self.points:
            add_primitive(np.concatenate(self.points),
                          np.concatenate(self.colors), mode=0)   # POINTS
        if self.lines:
            add_primitive(np.concatenate(self.lines).reshape(-1, 3),
                          np.concatenate(self.line_colors).reshape(-1, 3),
                          mode=1)                                # LINES
        gltf = {
            "asset": {"version": "2.0", "generator": "vggt-slam-tpu"},
            "scene": 0,
            "scenes": [{"nodes": list(range(len(nodes)))}],
            "nodes": nodes,
            "meshes": meshes,
            "accessors": accessors,
            "bufferViews": buffer_views,
            "buffers": [{"byteLength": len(buffers)}],
        }
        js = json.dumps(gltf).encode()
        while len(js) % 4:
            js += b" "
        while len(buffers) % 4:
            buffers.append(0)
        total = 12 + 8 + len(js) + 8 + len(buffers)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, total))
            f.write(struct.pack("<II", len(js), 0x4E4F534A))
            f.write(js)
            f.write(struct.pack("<II", len(buffers), 0x004E4942))
            f.write(bytes(buffers))
        return path


class TrimeshViewer(GLBExporter):
    """API-compatible alias of the reference's gradio TrimeshViewer."""
