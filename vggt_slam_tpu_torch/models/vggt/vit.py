"""DINOv2-style ViT encoder (counterpart of vggt_slam_tpu/models/vggt/vit.py):
patch tokens (and CLS for SALAD), register tokens, positions resized
bilinearly to the grid (antialiased when shrinking, as jax.image.resize),
LayerScale blocks, no rope.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
from vggt_slam_tpu_torch.models.vggt.modules import Block, Conv, \
    LayerNorm, run_block

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_pos_embed(pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(1, g, g, C) -> (1, h, w, C), bilinear with half-pixel centers and
    an antialiasing kernel when downsampling (jax.image.resize)."""
    if pos.shape[1:3] == (h, w):
        return pos
    out = F.interpolate(pos.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


class DinoViT(nn.Module):
    def __init__(self, cfg: VGGTConfig, return_cls: bool = False):
        super().__init__()
        self.cfg = cfg
        self.return_cls = return_cls
        g = cfg.img_size // cfg.patch_size
        self.patch_embed = Conv(3, cfg.enc_dim, cfg.patch_size,
                                stride=cfg.patch_size, dtype=cfg.dtype)
        self.pos_embed = nn.Parameter(torch.empty(1, g, g, cfg.enc_dim))
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.enc_dim))
        if cfg.enc_num_registers:
            self.register_tokens = nn.Parameter(
                torch.empty(1, cfg.enc_num_registers, cfg.enc_dim))
        for i in range(cfg.enc_depth):
            self.add_module(f"block_{i}", Block(
                cfg.enc_dim, cfg.enc_heads, cfg.enc_mlp_ratio,
                layerscale=cfg.enc_layerscale, dtype=cfg.dtype,
                attn_impl=cfg.attn_impl, ln_eps=1e-6))
        self.norm = LayerNorm(cfg.enc_dim, 1e-6)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, 3, H, W) in [0, 1] -> patch tokens (B, h*w, enc_dim),
        or (patch tokens, the final CLS token (B, enc_dim)) with
        `return_cls`."""
        cfg = self.cfg
        B, _, H, W = images.shape
        h, w = cfg.patch_grid(H, W)
        mean = torch.tensor(_IMAGENET_MEAN, dtype=images.dtype,
                            device=images.device).view(1, 3, 1, 1)
        std = torch.tensor(_IMAGENET_STD, dtype=images.dtype,
                           device=images.device).view(1, 3, 1, 1)
        x = self.patch_embed((images - mean) / std)       # (B, C, h, w)
        x = x.flatten(2).transpose(1, 2)                   # (B, h*w, C)
        pos = resize_pos_embed(self.pos_embed, h, w)
        x = x + pos.reshape(1, h * w, cfg.enc_dim).to(x.dtype)
        special = [self.cls_token.to(x.dtype).expand(B, -1, -1)]
        if cfg.enc_num_registers:
            special.append(self.register_tokens.to(x.dtype).expand(B, -1, -1))
        x = torch.cat(special + [x], dim=1)
        for i in range(cfg.enc_depth):
            x = run_block(getattr(self, f"block_{i}"), cfg.remat, x)
        x = self.norm(x).to(cfg.dtype)
        patches = x[:, 1 + cfg.enc_num_registers:]
        return (patches, x[:, 0]) if self.return_cls else patches
