"""VGGT output heads (counterpart of vggt_slam_tpu/models/vggt/heads.py).

Camera head: the camera tokens are refined over `cam_iterations`; each
embeds the current 9-D pose encoding, gates an AdaLN modulation with a
residual, runs a small self-attention trunk over the S frames (kernel 1
with the bucket's valid_len; flash_grad under training) and adds a
predicted delta. DPT head: the shared LayerNorm, 1x1 projections plus the
UV sin/cos embedding, learned resizes, coarse-to-fine fusion with residual
conv units and align-corners upsampling, a channel-first (C, S, H, W) f32
output. Tensors are NCHW here (the reference's NHWC); outputs match.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
from vggt_slam_tpu_torch.models.vggt.modules import Block, Conv, Dense, \
    LayerNorm, Mlp


class CameraHead(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        dim = 2 * cfg.agg_dim
        self.token_norm = LayerNorm(dim, 1e-5)
        self.empty_pose_tokens = nn.Parameter(torch.empty(1, 1, 9))
        self.embed_pose = Dense(9, dim, cfg.dtype)
        self.modulation = Dense(dim, 3 * dim, cfg.dtype)
        for i in range(cfg.cam_trunk_depth):
            self.add_module(f"trunk_{i}", Block(
                dim, cfg.agg_heads, cfg.agg_mlp_ratio, layerscale=0.01,
                dtype=cfg.dtype, attn_impl=cfg.attn_impl))
        self.trunk_norm = LayerNorm(dim, 1e-5)
        self.pose_branch = Mlp(dim, dim // 2, 9, cfg.dtype)
        self.adaln_norm = LayerNorm(dim, 1e-6, use_scale=False,
                                    use_bias=False)

    def forward(self, tokens_last: torch.Tensor, valid_frames=None):
        """(S, N, 2*agg_dim) final aggregator tokens -> (S, 9) f32."""
        cfg = self.cfg
        S = tokens_last.shape[0]
        cam = self.token_norm(tokens_last[:, 0, :]).to(cfg.dtype)[None]
        pred0 = self.empty_pose_tokens.to(cfg.dtype).expand(1, S, 9)
        pred = None
        for _ in range(cfg.cam_iterations):
            # the next iteration's input carries no gradient (the
            # reference's stop_gradient)
            inp = pred0 if pred is None else pred.detach().to(cfg.dtype)
            m = self.modulation(F.silu(self.embed_pose(inp)))
            shift, scale, gate = m.chunk(3, dim=-1)
            h = gate * (self.adaln_norm(cam).to(cfg.dtype) * (1 + scale)
                        + shift)
            h = h + cam
            for i in range(cfg.cam_trunk_depth):
                h = getattr(self, f"trunk_{i}")(h, valid_len=valid_frames)
            delta = self.pose_branch(self.trunk_norm(h).to(cfg.dtype)).float()
            pred = delta if pred is None else pred + delta
        return pred[0]


def _uv_grid(w: int, h: int, aspect: float, device) -> torch.Tensor:
    """Aspect-corrected UV grid (h, w, 2) in [-span, span]."""
    diag = (aspect * aspect + 1.0) ** 0.5
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = torch.linspace(-span_x * (w - 1) / w, span_x * (w - 1) / w, w,
                        device=device)
    ys = torch.linspace(-span_y * (h - 1) / h, span_y * (h - 1) / h, h,
                        device=device)
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                       dim=-1)


def _sincos_embed(dim: int, pos: torch.Tensor, omega0: float = 100.0):
    omega = torch.arange(dim // 2, dtype=torch.float32,
                         device=pos.device) / (dim / 2.0)
    omega = 1.0 / (omega0 ** omega)
    out = pos[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)


def uv_pos_embed(w: int, h: int, aspect: float, dim: int, device):
    """(dim, h, w) channel-first embedding: sincos(u) || sincos(v)."""
    grid = _uv_grid(w, h, aspect, device).reshape(-1, 2)
    emb = torch.cat([_sincos_embed(dim // 2, grid[:, 0]),
                     _sincos_embed(dim // 2, grid[:, 1])], dim=-1)
    return emb.reshape(h, w, dim).permute(2, 0, 1)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize with align_corners=True on (S, C, h, w)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


class _ConvTransposeUp(nn.Module):
    """ConvTranspose2d with kernel == stride, kernel stored (k, k, in, out)
    with torch semantics (no flip)."""

    def __init__(self, cin: int, cout: int, k: int, dtype):
        super().__init__()
        self.k = k
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(k, k, cin, cout))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        w = self.kernel.permute(2, 3, 0, 1).to(self.dtype)
        return F.conv_transpose2d(x.to(self.dtype), w,
                                  self.bias.to(self.dtype), stride=self.k)


class _ResidualConvUnit(nn.Module):
    def __init__(self, features: int, dtype):
        super().__init__()
        self.conv1 = Conv(features, features, 3, padding=1, dtype=dtype)
        self.conv2 = Conv(features, features, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _FeatureFusion(nn.Module):
    def __init__(self, features: int, dtype, has_skip: bool):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = _ResidualConvUnit(features, dtype)
        self.resConfUnit2 = _ResidualConvUnit(features, dtype)
        self.out_conv = Conv(features, features, 1, dtype=dtype)

    def forward(self, x0, skip=None, out_hw=None):
        x = x0
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if out_hw is None:
            out_hw = (2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(resize_bilinear_align_corners(x, out_hw))


class _Conv1x1CF(nn.Module):
    """1x1 conv emitted channel-first: (S, K, H, W) -> (C, S, H, W) f32."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(1, 1, cin, cout))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        y = torch.einsum("skhw,kc->cshw", x.float(), self.kernel[0, 0])
        return y + self.bias[:, None, None, None]


class DPTHead(nn.Module):
    """Dense prediction head over captured aggregator depths; returns raw
    predictions channel-first (out_channels, S, H, W) f32."""

    def __init__(self, cfg: VGGTConfig, out_channels: int):
        super().__init__()
        self.cfg = cfg
        n = len(cfg.dpt_layers)
        cin = 2 * cfg.agg_dim
        dt = cfg.dtype
        self.norm = LayerNorm(cin, 1e-5)
        for li in range(n):
            oc = cfg.dpt_out_channels[li]
            self.add_module(f"projects_{li}", Conv(cin, oc, 1, dtype=dt))
            spec = li + 4 - n
            if spec == 0:
                self.resize_0 = _ConvTransposeUp(oc, oc, 4, dt)
            elif spec == 1:
                self.resize_1 = _ConvTransposeUp(oc, oc, 2, dt)
            elif spec == 3:
                self.resize_3 = Conv(oc, oc, 3, stride=2, padding=1, dtype=dt)
            self.add_module(f"layer_rn_{li}", Conv(
                oc, cfg.dpt_features, 3, padding=1, dtype=dt, use_bias=False))
            self.add_module(f"refinenet{li + 1}", _FeatureFusion(
                cfg.dpt_features, dt, has_skip=li < n - 1))
        f = cfg.dpt_features
        self.output_conv1 = Conv(f, f // 2, 3, padding=1, dtype=dt)
        self.output_conv2_0 = Conv(f // 2, 32, 3, padding=1, dtype=dt)
        self.output_conv2_2 = _Conv1x1CF(32, out_channels)

    def forward(self, captured: dict, image_hw) -> torch.Tensor:
        cfg = self.cfg
        H, W = image_hw
        h, w = cfg.patch_grid(H, W)
        ns = captured["patch_start"]
        n = len(cfg.dpt_layers)

        def add_pos(x):
            pe = uv_pos_embed(x.shape[3], x.shape[2], W / H, x.shape[1],
                              x.device)
            return x + (0.1 * pe[None]).to(x.dtype)

        feats = []
        for li, d in enumerate(cfg.dpt_layers):
            t = captured[d][:, ns:, :]                        # (S, P, 2C)
            S = t.shape[0]
            t = self.norm(t).to(cfg.dtype)
            x = t.transpose(1, 2).reshape(S, t.shape[-1], h, w)
            x = add_pos(getattr(self, f"projects_{li}")(x))
            spec = li + 4 - n
            if spec == 0:
                x = self.resize_0(x)
            elif spec == 1:
                x = self.resize_1(x)
            elif spec == 3:
                x = self.resize_3(x)
            feats.append(getattr(self, f"layer_rn_{li}")(x))

        path = None
        for li in reversed(range(n)):
            out_hw = feats[li - 1].shape[2:4] if li > 0 else None
            fusion = getattr(self, f"refinenet{li + 1}")
            path = fusion(feats[li] if path is None else path,
                          None if path is None else feats[li], out_hw)

        x = self.output_conv1(path)
        x = add_pos(resize_bilinear_align_corners(x, (H, W)))
        x = F.relu(self.output_conv2_0(x))
        return self.output_conv2_2(x)


def activate_depth(raw_cf: torch.Tensor):
    """raw (2, S, H, W) -> depth (S, H, W, 1) > 0, conf (S, H, W) >= 1."""
    depth = torch.exp(raw_cf[0].clamp(-10.0, 10.0))[..., None]
    conf = 1.0 + torch.exp(raw_cf[1].clamp(-10.0, 10.0))
    return depth, conf


def activate_points(raw_cf: torch.Tensor):
    """raw (4, S, H, W) -> points (3, S, H, W) via sign-expm1, conf >= 1."""
    xyz = raw_cf[0:3]
    pts = torch.sign(xyz) * torch.expm1(xyz.abs().clamp(0.0, 10.0))
    conf = 1.0 + torch.exp(raw_cf[3].clamp(-10.0, 10.0))
    return pts, conf
