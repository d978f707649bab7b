"""Pose-graph front API (counterpart of vggt_slam_tpu/slam/graph.py): the
reference's GTSAM wrapper's methods on ops/pose_graph.py; `optimize()`
pads to power-of-two capacities (floors 64 nodes, 128 factors, 4 priors)
and solves on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from vggt_slam_tpu_torch.ops import lie, pose_graph as pg_ops

_DEFAULT_SIGMAS = {"sl4": (0.05, 1e-6), "se3": (0.1, 1e-6),
                   "sim3": (0.1, 1e-6)}


def _next_pow2(n: int, floor: int) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


class PoseGraph:
    """Factor graph over one manifold ("sl4", "se3" or "sim3")."""

    def __init__(self, manifold: str = "sl4", dtype=np.float64,
                 device="cpu"):
        if manifold not in lie.MANIFOLD_DOF:
            raise ValueError(f"unknown manifold {manifold}")
        self.manifold = manifold
        self.dof = lie.MANIFOLD_DOF[manifold]
        self.dtype = dtype
        self.device = torch.device(device)
        rel, anc = _DEFAULT_SIGMAS[manifold]
        self.relative_noise = np.full(self.dof, rel, dtype=dtype)
        self.anchor_noise = np.full(self.dof, anc, dtype=dtype)
        self._key_to_idx: dict[int, int] = {}
        self._values: list[np.ndarray] = []
        self._between: list = []
        self._priors: list = []
        self.initialized_nodes: set[int] = set()
        self.num_loop_closures = 0

    def _canonicalize(self, H) -> np.ndarray:
        H = np.asarray(H, dtype=self.dtype)
        if self.manifold == "sl4":
            det = np.linalg.det(H)
            H = H / (np.sign(det) * np.abs(det) ** 0.25)
        return H

    def add_homography(self, key: int, global_h) -> None:
        """Insert a node; duplicates are ignored."""
        if key in self._key_to_idx:
            return
        self._key_to_idx[key] = len(self._values)
        self._values.append(self._canonicalize(global_h))
        self.initialized_nodes.add(key)

    def add_between_factor(self, key1: int, key2: int, relative_h,
                           noise=None):
        if key1 not in self._key_to_idx or key2 not in self._key_to_idx:
            raise ValueError(f"Both poses {key1} and {key2} must exist "
                             "before adding a factor.")
        noise = self.relative_noise if noise is None else np.asarray(
            noise, self.dtype)
        self._between.append((self._key_to_idx[key1], self._key_to_idx[key2],
                              self._canonicalize(relative_h), 1.0 / noise))

    def add_prior_factor(self, key: int, global_h, noise=None):
        if key not in self._key_to_idx:
            raise ValueError(f"Trying to add prior factor for key {key} but "
                             "it is not in the graph.")
        noise = self.anchor_noise if noise is None else np.asarray(
            noise, self.dtype)
        self._priors.append((self._key_to_idx[key],
                             self._canonicalize(global_h), 1.0 / noise))

    def _build_arrays(self) -> pg_ops.GraphArrays:
        n = len(self._values)
        N = _next_pow2(n, 64)
        E = _next_pow2(max(len(self._between), 1), 128)
        P = _next_pow2(max(len(self._priors), 1), 4)
        dt = self.dtype
        values = np.tile(np.eye(4, dtype=dt), (N, 1, 1))
        values[:n] = np.stack(self._values)
        node_mask = np.arange(N) < n

        def factors(items, cap, n_idx):
            idx = np.zeros((n_idx, cap), np.int64)
            meas = np.tile(np.eye(4, dtype=dt), (cap, 1, 1))
            si = np.ones((cap, self.dof), dt)
            for k, item in enumerate(items):
                idx[:, k] = item[:n_idx]
                meas[k], si[k] = item[n_idx], item[n_idx + 1]
            return idx, meas, si, np.arange(cap) < len(items)

        bidx, bmeas, bsi, bmask = factors(self._between, E, 2)
        pidx, pmeas, psi, pmask = factors(self._priors, P, 1)

        def t(a):
            return torch.as_tensor(a, device=self.device)

        return pg_ops.GraphArrays(
            values=t(values), node_mask=t(node_mask), bet_i=t(bidx[0]),
            bet_j=t(bidx[1]), bet_meas=t(bmeas), bet_sqrt_info=t(bsi),
            bet_mask=t(bmask), pri_node=t(pidx[0]), pri_meas=t(pmeas),
            pri_sqrt_info=t(psi), pri_mask=t(pmask))

    def optimize(self) -> float:
        """LM-optimize all node values in place; returns 0.5*||r||^2."""
        if not self._values:
            return 0.0
        values, err = pg_ops.optimize(self._build_arrays(),
                                      manifold=self.manifold)
        values = values.cpu().numpy()
        for k in range(len(self._values)):
            self._values[k] = values[k]
        return float(err)

    def get_homography(self, node_id: int) -> np.ndarray:
        return np.array(self._values[self._key_to_idx[node_id]])

    def increment_loop_closure(self) -> None:
        self.num_loop_closures += 1

    def get_num_loops(self) -> int:
        return self.num_loop_closures
