"""Semantic voxel map (counterpart of vggt_slam_tpu/semantic/voxel_map.py):
the integer-coordinate index, position lookups, dot-product top-k,
latest-frame provenance, and the same files (semantic_voxels.npz,
frame_names.json), readable by either package.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class SemanticVoxel:
    voxel_size: float
    centers_world: np.ndarray          # (N, 3)
    features: np.ndarray               # (N, d)
    contributors: list                 # per voxel: [(submap id, frame id)]


class SemanticVoxelMap:
    def __init__(self, voxels: SemanticVoxel, frame_name_maps: dict):
        self.voxels = voxels
        self.voxel_size = float(voxels.voxel_size)
        self.frame_name_maps = frame_name_maps
        self._voxel_coords = self._centers_to_voxel_coords(
            voxels.centers_world, self.voxel_size)
        self._coord_to_index = {(int(c[0]), int(c[1]), int(c[2])): i
                                for i, c in enumerate(self._voxel_coords)}

    def get_voxels(self) -> SemanticVoxel:
        return self.voxels

    def get_voxel_size(self) -> float:
        return self.voxel_size

    def get_centers_world(self) -> np.ndarray:
        return self.voxels.centers_world

    def get_features(self) -> np.ndarray:
        return self.voxels.features

    def get_contributors(self):
        return self.voxels.contributors

    def resolve_contributor(self, submap_id: int, frame_id: str):
        return self.frame_name_maps[str(submap_id)][str(frame_id)]

    @staticmethod
    def _centers_to_voxel_coords(centers_world, voxel_size):
        # centers = (coord + 0.5) * voxel_size
        if not len(centers_world):
            return np.zeros((0, 3), np.int64)
        return np.floor(centers_world / voxel_size - 0.5 + 1e-4).astype(
            np.int64)

    @staticmethod
    def _position_to_voxel_coord(position_world, voxel_size):
        c = np.floor(np.asarray(position_world, np.float32).reshape(3)
                     / voxel_size).astype(np.int64)
        return int(c[0]), int(c[1]), int(c[2])

    def get_index_at_position(self, position_world):
        return self._coord_to_index.get(
            self._position_to_voxel_coord(position_world, self.voxel_size))

    def get_features_at_position(self, position_world):
        idx = self.get_index_at_position(position_world)
        return None if idx is None else self.voxels.features[idx]

    def get_voxel_coord_at_index(self, index: int):
        return self._voxel_coords[index]

    def get_contributors_at_position(self, position_world):
        idx = self.get_index_at_position(position_world)
        return None if idx is None else self.voxels.contributors[idx]

    def query_with_embedding(self, qe: np.ndarray, top_k: int = 1):
        """Top-k voxels by dot product: (indices, coords, similarities)."""
        feats = np.asarray(self.voxels.features, dtype=np.float32)
        sims = feats @ np.asarray(qe, dtype=np.float32).reshape(-1)
        top_k = min(top_k, sims.shape[0])
        idx = np.argpartition(-sims, top_k - 1)[:top_k]
        idx = idx[np.argsort(-sims[idx])]
        return idx.tolist(), self._voxel_coords[idx], sims[idx].tolist()

    def get_latest_frame_at_voxel(self, voxel_index: int):
        """(frame name, submap id, frame id) of the largest contributor."""
        submap_id, frame_id = sorted(self.voxels.contributors[voxel_index],
                                     key=lambda x: (x[0], x[1]),
                                     reverse=True)[0]
        return (self.resolve_contributor(submap_id, frame_id), submap_id,
                frame_id)

    def save_to_directory(self, directory_path: str) -> None:
        os.makedirs(directory_path, exist_ok=True)
        contrib_arr = np.empty(len(self.voxels.contributors), dtype=object)
        for i, c in enumerate(self.voxels.contributors):
            contrib_arr[i] = c
        np.savez_compressed(
            os.path.join(directory_path, "semantic_voxels.npz"),
            voxel_size=np.float32(self.voxel_size),
            centers_world=self.voxels.centers_world.astype(np.float32),
            features=self.voxels.features.astype(np.float32),
            contributors=contrib_arr)
        with open(os.path.join(directory_path, "frame_names.json"), "w") as f:
            json.dump(self.frame_name_maps, f, indent=2)

    @staticmethod
    def load_from_directory(directory_path: str) -> "SemanticVoxelMap":
        # the contributors are a pickled object array: load only maps this
        # program (or the reference) wrote
        data = np.load(os.path.join(directory_path, "semantic_voxels.npz"),
                       allow_pickle=True)
        json_path = os.path.join(directory_path, "frame_names.json")
        frame_name_maps = {}
        if os.path.exists(json_path):
            with open(json_path) as f:
                frame_name_maps = json.load(f)
        vox = SemanticVoxel(
            voxel_size=float(data["voxel_size"]),
            centers_world=data["centers_world"], features=data["features"],
            contributors=[list(c) for c in data["contributors"].tolist()])
        return SemanticVoxelMap(vox, frame_name_maps=frame_name_maps)

    @staticmethod
    def features_to_rgb(features: np.ndarray,
                        max_points_for_pca: int = 20000) -> np.ndarray:
        """(N, d) -> (N, 3) RGB in [0, 1]; the first 3 principal
        components for d > 3 (fitted on at most `max_points_for_pca` rows
        drawn from numpy's global generator)."""
        x = np.asarray(features, dtype=np.float32)
        n, d = x.shape
        if n == 0:
            return np.zeros((0, 3), np.float32)
        if d == 3:
            y = x
        elif d == 1:
            y = np.repeat(x, 3, axis=1)
        elif d == 2:
            y = np.concatenate([x, np.zeros((n, 1), np.float32)], axis=1)
        else:
            fit = x if n <= max_points_for_pca else \
                x[np.random.choice(n, max_points_for_pca, replace=False)]
            fit = fit - fit.mean(axis=0, keepdims=True)
            _, _, vt = np.linalg.svd(fit, full_matrices=False)
            y = (x - x.mean(axis=0, keepdims=True)) @ vt[:3].T
        y_min = y.min(axis=0, keepdims=True)
        y_ptp = np.ptp(y, axis=0, keepdims=True) + 1e-8
        return np.clip((y - y_min) / y_ptp, 0.0, 1.0).astype(np.float32)

    def visualize(self, port: int = 8081, **kwargs):
        """`viz.viser_viewer.show_voxels`; a no-op with a message where
        viser is absent."""
        try:
            import viser  # noqa: F401
        except ImportError:
            print("[semantic_voxel] viser not installed; skipping "
                  "visualization")
            return None, None
        from vggt_slam_tpu_torch.viz.viser_viewer import show_voxels
        return show_voxels(self, port=port, **kwargs)
