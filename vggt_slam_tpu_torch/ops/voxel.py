"""Voxelization: the mean of per-point features over occupied voxels
(counterpart of vggt_slam_tpu/ops/voxel.py). `voxelize_np` is the exact
host path (voxels in `np.unique(axis=0)` order); `voxelize_device` the
static-capacity path on the tensors' device (three stable sorts give the
lexsort order, runs of equal coordinates become segments, sums by
`index_add_`). On CUDA the sums are atomic adds, so its means agree with
`voxelize_np` within `mean_tolerance`.
"""
from __future__ import annotations

import numpy as np
import torch

SENTINEL = 1 << 24      # an invalid point's coordinate: it sorts last


def voxelize_np(points: np.ndarray, feats: np.ndarray, voxel_size: float):
    """Exact voxel mean: (centers (V, 3) f32, feat_means (V, d), inverse
    (N,) point -> voxel)."""
    coords = np.floor(points / voxel_size).astype(np.int64)
    unique_coords, inverse = np.unique(coords, axis=0, return_inverse=True)
    V = unique_coords.shape[0]
    feat_sum = np.zeros((V, feats.shape[-1]), dtype=np.float32)
    counts = np.zeros((V,), dtype=np.int64)
    np.add.at(feat_sum, inverse, feats.astype(np.float32))
    np.add.at(counts, inverse, 1)
    feat_avg = feat_sum / counts[:, None]
    centers = (unique_coords.astype(np.float32) + 0.5) * voxel_size
    return centers.astype(np.float32), feat_avg, inverse


def mean_tolerance(counts: np.ndarray, feats: np.ndarray) -> np.ndarray:
    """Per voxel, the most two f32 voxel means of the same points can
    differ when their sums run in any two orders: each sum of n terms is
    off by at most (n - 1) 2^-24 sum|x|, and the f32 division rounds once
    more, so (2 n - 1) 2^-24 max|feat|."""
    return (2.0 * counts - 1.0) * 2.0 ** -24 * float(np.abs(feats).max())


def voxel_coords(points: torch.Tensor, voxel_size: float,
                 dtype=torch.int64) -> torch.Tensor:
    """floor(points / voxel_size) as integers, with the division rounded as
    numpy rounds it (a CUDA tensor divided by a Python float is multiplied
    by its reciprocal instead)."""
    size = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    return torch.floor(points / size).to(dtype)


def lexsort_rows(coords: torch.Tensor) -> torch.Tensor:
    """The permutation that orders (N, k) integer rows lexicographically,
    ties in input order (np.lexsort of the columns, last key first)."""
    order = torch.arange(coords.shape[0], device=coords.device)
    for col in range(coords.shape[1] - 1, -1, -1):
        order = order[torch.sort(coords[order, col], stable=True).indices]
    return order


def segment_ids(rows_sorted: torch.Tensor) -> torch.Tensor:
    """0-based run index of each row of lexicographically sorted rows."""
    new_seg = torch.ones(rows_sorted.shape[0], dtype=torch.int64,
                         device=rows_sorted.device)
    new_seg[1:] = (rows_sorted[1:] != rows_sorted[:-1]).any(1)
    return torch.cumsum(new_seg, 0) - 1


def unique_rows(rows: torch.Tensor):
    """np.unique(rows, axis=0, return_inverse=True, return_counts=True) on
    the rows' device: (unique rows in lexicographic order, inverse,
    counts)."""
    order = lexsort_rows(rows)
    rows_s = rows[order]
    seg = segment_ids(rows_s)
    inverse = torch.empty_like(seg)
    inverse[order] = seg
    counts = torch.bincount(seg)
    unique = rows.new_empty((counts.shape[0], rows.shape[1]))
    unique[seg] = rows_s
    return unique, inverse, counts


def voxelize_device(points: torch.Tensor, feats: torch.Tensor,
                    mask: torch.Tensor, voxel_size: float, capacity: int):
    """Masked voxel mean with a static output size: points (N, 3), feats (N,
    d), mask (N,); the first `capacity` voxels in coordinate order. Returns
    centers (capacity, 3) f32, feat_mean (capacity, d), counts (capacity,) in
    feats' dtype and num_voxels (); entries past num_voxels are zero."""
    coords = voxel_coords(points, voxel_size, torch.int32)
    coords = torch.where(mask.bool()[:, None], coords,
                         torch.full_like(coords, SENTINEL))
    order = lexsort_rows(coords)
    coords_s, feats_s = coords[order], feats[order]
    valid_s = coords_s[:, 0] != SENTINEL
    seg_id = segment_ids(coords_s)
    in_cap = (seg_id < capacity) & valid_s
    seg_id = torch.where(in_cap, seg_id, capacity)      # overflow bucket
    w = in_cap.to(feats.dtype)
    feat_sum = feats.new_zeros((capacity + 1, feats.shape[1])).index_add_(
        0, seg_id, feats_s * w[:, None])[:capacity]
    counts = feats.new_zeros(capacity + 1).index_add_(0, seg_id, w)[:capacity]
    coord_max = torch.full((capacity + 1, 3), torch.iinfo(torch.int32).min,
                           dtype=torch.int32, device=coords.device)
    coord_max.scatter_reduce_(
        0, seg_id[:, None].expand(-1, 3),
        torch.where(in_cap[:, None], coords_s, -SENTINEL), "amax")
    occupied = counts > 0
    feat_mean = feat_sum / torch.clamp(counts, min=1.0)[:, None] \
        * occupied[:, None]
    centers = (coord_max[:capacity].float() + 0.5) * voxel_size
    centers = torch.where(occupied[:, None], centers, 0.0)
    return centers, feat_mean, counts, occupied.sum().to(torch.int32)
