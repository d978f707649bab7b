"""Batched 3D projective homography estimation, DLT + RANSAC (counterpart
of vggt_slam_tpu/ops/homography.py): 300 five-point hypotheses solved with
one batched SVD, the reference's identity fallbacks, mask-weighted inlier
scoring and argmax selection, all on the points' device."""
from __future__ import annotations

import torch

from vggt_slam_tpu_torch.ops.lie import apply_homography


def build_dlt_system(X_src: torch.Tensor, X_dst: torch.Tensor):
    """(..., N, 3) pairs -> (..., 3N, 16) DLT rows for dst ~ H src."""
    src_h = torch.cat([X_src, torch.ones_like(X_src[..., :1])], dim=-1)
    zeros = torch.zeros_like(src_h)
    xp, yp, zp = X_dst[..., 0:1], X_dst[..., 1:2], X_dst[..., 2:3]
    rows = torch.stack([
        torch.cat([-src_h, zeros, zeros, xp * src_h], dim=-1),
        torch.cat([zeros, -src_h, zeros, yp * src_h], dim=-1),
        torch.cat([zeros, zeros, -src_h, zp * src_h], dim=-1)], dim=-2)
    return rows.reshape(rows.shape[:-3] + (rows.shape[-3] * 3, 16))


def estimate_3d_homography(X_src: torch.Tensor, X_dst: torch.Tensor):
    """(B, N, 3) pairs -> (B, 4, 4) unit-det homographies; identity where
    the estimate is degenerate (rank-deficient DLT, H33 ~ 0, det < 1e-4,
    non-finite)."""
    A = build_dlt_system(X_src, X_dst)
    _, sv, vh = torch.linalg.svd(A, full_matrices=True)
    H = vh[..., -1, :].reshape(A.shape[:-2] + (4, 4))
    bad_null = sv[..., 14] < 1e-6 * sv[..., 0]
    h33 = H[..., 3, 3]
    bad_h33 = (h33.abs() < 1e-12) | bad_null
    H = H / torch.where(bad_h33, 1.0, h33)[..., None, None]
    det = torch.linalg.det(H)
    bad_det = torch.isnan(det) | (det < 1e-4)
    H = H / (torch.where(bad_det, 1.0, det) ** 0.25)[..., None, None]
    eye = torch.eye(4, dtype=H.dtype, device=H.device).expand(H.shape)
    bad = (bad_h33 | bad_det)[..., None, None]
    H = torch.where(bad | ~torch.isfinite(H), eye, H)
    finite = torch.isfinite(H).all(-1, keepdim=True).all(-2, keepdim=True)
    return torch.where(finite, H, eye)


def sample_indices(weights: torch.Tensor, generator: torch.Generator,
                   max_iter: int = 300, sample_size: int = 5):
    """(max_iter, sample_size) point indices drawn with replacement with
    probability proportional to `weights` (jax.random.choice's role)."""
    p = weights / weights.sum().clamp_min(1e-12)
    return torch.multinomial(p, max_iter * sample_size, replacement=True,
                             generator=generator).view(max_iter, sample_size)


def ransac_projective(X1, X2, weights=None, *, generator=None, indices=None,
                      threshold: float = 0.01, max_iter: int = 300,
                      sample_size: int = 5):
    """RANSAC SL(4): H with X2 ~ H X1 from (N, 3) matched points; samples from
    `generator` or injected `indices` (max_iter, sample_size). Returns (H (4,
    4), the inlier count weighted by `weights`)."""
    if X1.dtype not in (torch.float32, torch.float64):
        X1 = X1.float()
    X2 = X2.to(X1.dtype)
    n = X1.shape[0]
    w = (torch.ones(n, dtype=X1.dtype, device=X1.device) if weights is None
         else weights.to(X1.dtype))
    if indices is None:
        indices = sample_indices(w, generator, max_iter, sample_size)
    H_ests = estimate_3d_homography(X1[indices], X2[indices])
    err = torch.linalg.norm(apply_homography(H_ests, X1[None]) - X2[None],
                            dim=-1)
    err = torch.where(torch.isfinite(err), err, torch.inf)
    inliers = ((err < threshold) * w[None]).sum(-1)
    best = inliers.argmax()
    return H_ests[best], inliers[best]
