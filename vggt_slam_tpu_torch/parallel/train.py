"""VGGT training step on one device (counterpart of vggt_slam_tpu/parallel/
train.py `vggt_loss`, `make_train_step`, `make_dryrun_batch`): pose
encoding regression plus confidence-weighted depth and point regression
(conf |err| - alpha log conf), as the reference; its mesh shardings,
ZeRO-1 and GPipe are not ported yet.
"""
from __future__ import annotations

import torch


def vggt_loss(model, batch: dict) -> torch.Tensor:
    """Scalar f32 loss of `model` (a VGGT) on a batch dict of tensors:
    images (S, 3, H, W), pose_enc_gt (S, 9), depth_gt (S, H, W) and, with
    the point head, points_gt (S, H, W, 3)."""
    cfg = model.cfg
    out = model(batch["images"])
    loss = torch.mean((out["pose_enc"] - batch["pose_enc_gt"]) ** 2)
    if cfg.enable_depth_head:
        err = torch.abs(out["depth"][..., 0] - batch["depth_gt"])
        conf = out["depth_conf"]
        loss = loss + torch.mean(conf * err - 0.2 * torch.log(conf))
    if cfg.enable_point_head:
        err = torch.linalg.norm(
            torch.movedim(out["world_points_cf"], 0, -1) - batch["points_gt"],
            dim=-1)
        conf = out["world_points_conf"]
        loss = loss + torch.mean(conf * err - 0.2 * torch.log(conf))
    return loss


def make_train_step(model, optimizer=None):
    """-> (train_step, optimizer): train_step(batch) runs a forward, backward
    and update of `model` in place on its device and returns the loss as a
    0-d device tensor (no sync). The default optimizer is the reference's
    optax.adamw(1e-4, weight_decay=0.05), betas (0.9, 0.999), eps 1e-8."""
    if optimizer is None:
        optimizer = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                      weight_decay=0.05)
    device = next(model.parameters()).device

    def train_step(batch):
        batch = {k: torch.as_tensor(v).to(device, non_blocking=True)
                 for k, v in batch.items()}
        optimizer.zero_grad(set_to_none=True)
        loss = vggt_loss(model, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step, optimizer


def make_dryrun_batch(cfg, n_frames: int, image_hw, device="cpu",
                      seed: int = 0) -> dict:
    """A shape-only batch: uniform images, zero poses and points, unit
    depth (the reference's make_dryrun_batch, whose `cfg` it takes and
    ignores as well; its jax.random images are drawn here from a torch
    generator)."""
    H, W = image_hw
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "images": torch.rand((n_frames, 3, H, W), generator=g,
                             device=device),
        "pose_enc_gt": torch.zeros((n_frames, 9), device=device),
        "depth_gt": torch.ones((n_frames, H, W), device=device),
        "points_gt": torch.zeros((n_frames, H, W, 3), device=device),
    }
