"""VGGT: one forward per submap emits poses, depth and confidences
(counterpart of vggt_slam_tpu/models/vggt/model.py).

Output dict (post-squeeze contract of the reference):
    pose_enc           (S, 9)
    depth              (S, H, W, 1)
    depth_conf         (S, H, W)
    world_points_cf    (3, S, H, W)   point head only
    world_points_conf  (S, H, W)      point head only
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vggt_slam_tpu_torch.models.vggt.aggregator import Aggregator
from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
from vggt_slam_tpu_torch.models.vggt.heads import CameraHead, DPTHead, \
    activate_depth, activate_points


class VGGT(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        self.aggregator = Aggregator(cfg)
        self.camera_head = CameraHead(cfg)
        if cfg.enable_depth_head:
            self.depth_head = DPTHead(cfg, out_channels=2)
        if cfg.enable_point_head:
            self.point_head = DPTHead(cfg, out_channels=4)

    def forward(self, images: torch.Tensor, valid_frames=None) -> dict:
        cfg = self.cfg
        H, W = images.shape[-2:]
        captured = self.aggregator(images, valid_frames)
        out = {"pose_enc": self.camera_head(captured[cfg.agg_depth - 1],
                                            valid_frames)}
        if cfg.enable_depth_head:
            out["depth"], out["depth_conf"] = activate_depth(
                self.depth_head(captured, (H, W)))
        if cfg.enable_point_head:
            out["world_points_cf"], out["world_points_conf"] = \
                activate_points(self.point_head(captured, (H, W)))
        return out


_CF_KEYS = ("world_points_cf", "unproj_points_cf")


def make_bucketed_model_fn(model: VGGT, bucket_size: int,
                           as_numpy: bool = True,
                           with_unprojection: bool = False, device="cuda"):
    """Prediction callable with static-shape submap bucketing: an (S, 3, H, W)
    batch with S <= bucket_size is padded to bucket_size frames with
    valid_frames=S (padding masked out of every cross-frame softmax) and
    outputs sliced back, on `device` (the card unless the CPU is asked for).
    `with_unprojection` also decodes `extrinsic` (S, 3, 4), `intrinsic` (S,
    3, 3) and world points `unproj_points_cf` (3, S, H, W) in the same
    forward. `as_numpy=False` returns device tensors without waiting; True
    gives numpy, channel-first maps as (S, H, W, 3) without `_cf`."""
    from vggt_slam_tpu_torch.ops import geometry
    from vggt_slam_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    model.to(device)

    @torch.inference_mode()
    def model_fn(images):
        imgs = torch.as_tensor(np.asarray(images, dtype=np.float32))
        S = imgs.shape[0]
        if S < bucket_size:
            pad = torch.zeros((bucket_size - S,) + tuple(imgs.shape[1:]))
            imgs = torch.cat([imgs, pad])
        imgs = imgs.to(device, non_blocking=True)
        out = dict(model(imgs, S))
        if with_unprojection and "depth" in out:
            extr, intr = geometry.pose_encoding_to_extri_intri(
                out["pose_enc"], imgs.shape[-2:])
            out["extrinsic"], out["intrinsic"] = extr, intr
            out["unproj_points_cf"] = \
                geometry.unproject_depth_map_to_point_map_cf(
                    out["depth"][..., 0], extr, intr)
        out = {k: (v[:, :S] if k in _CF_KEYS else v[:S])
               for k, v in out.items()}
        if not as_numpy:
            return out
        host = {}
        for k, v in out.items():
            a = v.float().cpu().numpy()
            if k in _CF_KEYS:
                host[k.replace("_cf", "")] = np.moveaxis(a, 0, -1)
            else:
                host[k] = a
        return host

    return model_fn
