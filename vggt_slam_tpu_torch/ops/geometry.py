"""Camera geometry (counterpart of vggt_slam_tpu/ops/geometry.py): pose
encodings (9,) = [t, quat wxyz, fov_h, fov_w], depth unprojection on
integer (u, v), P-matrix decomposition; world->camera (3, 4) [R|t]
extrinsics, fx = W / (2 tan(fov_w / 2)), principal point (W/2, H/2).
"""
from __future__ import annotations

import torch

from vggt_slam_tpu_torch.ops import lie


def pose_encoding_to_extri_intri(pose_enc: torch.Tensor, image_hw):
    """(..., 9) -> extrinsic (..., 3, 4), intrinsic (..., 3, 3)."""
    H, W = image_hw
    t = pose_enc[..., 0:3]
    R = lie.quat_to_rotmat(pose_enc[..., 3:7])
    extrinsic = torch.cat([R, t[..., None]], dim=-1)
    fy = (H / 2.0) / torch.tan(pose_enc[..., 7] / 2.0)
    fx = (W / 2.0) / torch.tan(pose_enc[..., 8] / 2.0)
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    intrinsic = torch.stack(
        [fx, zeros, torch.full_like(fx, W / 2.0),
         zeros, fy, torch.full_like(fx, H / 2.0),
         zeros, zeros, ones], dim=-1).reshape(pose_enc.shape[:-1] + (3, 3))
    return extrinsic, intrinsic


def _pixels(H, W, like, channel_first):
    u = torch.arange(W, dtype=like.dtype, device=like.device)
    v = torch.arange(H, dtype=like.dtype, device=like.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv, torch.ones_like(uu)],
                       dim=0 if channel_first else -1)


def unproject_depth_map_to_point_map(depth, extrinsic, intrinsic):
    """Depth (S, H, W[, 1]) -> (S, H, W, 3) points in the frame-0 world."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    S, H, W = depth.shape
    pix = _pixels(H, W, depth, channel_first=False)        # (H, W, 3)
    rays = torch.einsum("sij,hwj->shwi", torch.linalg.inv_ex(intrinsic)[0],
                        pix)
    cam = rays * depth[..., None]
    R = extrinsic[..., :3, :3]
    t = extrinsic[..., :3, 3]
    return torch.einsum("sji,shwj->shwi", R, cam - t[:, None, None, :])


def unproject_depth_map_to_point_map_cf(depth, extrinsic, intrinsic):
    """Channel-first unprojection: (3, S, H, W) world points."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    S, H, W = depth.shape
    pix = _pixels(H, W, depth, channel_first=True)         # (3, H, W)
    # inv_ex: no singularity check, so no wait for the device
    rays = torch.einsum("sij,jhw->ishw", torch.linalg.inv_ex(intrinsic)[0],
                        pix)
    cam = rays * depth[None]
    R = extrinsic[..., :3, :3]
    t = extrinsic[..., :3, 3]
    return torch.einsum("sji,jshw->ishw", R, cam - t.T[:, :, None, None])


def rq_decomposition(M: torch.Tensor):
    """M = K R with K upper-triangular (positive diagonal), R orthonormal,
    batched via the flipped-QR trick."""
    n = M.shape[-1]
    J = torch.flip(torch.eye(n, dtype=M.dtype, device=M.device), dims=(0,))
    Q, R = torch.linalg.qr((J @ M).transpose(-1, -2))
    K = J @ R.transpose(-1, -2) @ J
    Rot = J @ Q.transpose(-1, -2)
    d = torch.sign(torch.diagonal(K, dim1=-2, dim2=-1))
    d = torch.where(d == 0, 1.0, d)
    D = d[..., None, :] * torch.eye(n, dtype=M.dtype, device=M.device)
    return K @ D, D.transpose(-1, -2) @ Rot


def decompose_projection_matrix(P: torch.Tensor):
    """(..., 3, 4) -> (K, R, C homogeneous (..., 4)), as
    cv2.decomposeProjectionMatrix."""
    M = P[..., :3, :3]
    K, R = rq_decomposition(M)
    C3 = -torch.linalg.solve(M, P[..., :3, 3][..., None])[..., 0]
    return K, R, torch.cat([C3, torch.ones_like(C3[..., :1])], dim=-1)


def poses_world_from_submap(intrinsics, cam2world, H_world_map):
    """World SE(3) cam->world poses (S, 4, 4) of a submap after the SL(4)
    solve: decompose P_i = K_i (T_i)^-1[:3] H^-1."""
    S = cam2world.shape[0]
    world2cam = lie.se3_inverse(cam2world)[:, :3, :]
    P = intrinsics @ world2cam @ torch.linalg.inv(H_world_map)
    _, R, C = decompose_projection_matrix(P)
    pose = torch.eye(4, dtype=cam2world.dtype,
                     device=cam2world.device).repeat(S, 1, 1)
    pose[:, :3, :3] = torch.linalg.inv(R)
    pose[:, :3, 3] = C[..., :3] / C[..., 3:]
    return pose

