"""Alternating-attention aggregator, the VGGT multi-view trunk
(counterpart of vggt_slam_tpu/models/vggt/aggregator.py).

Each frame's encoder patch tokens are prepended with a camera token and
register tokens (frame 0 has its own), then `agg_depth` pairs of frame
attention (within each frame, rope + qk-norm; kernel 1) and global
attention (all frames jointly; kernel 2 with merged K/V) run. The per-depth
outputs the heads consume are concat(frame_out, global_out).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
from vggt_slam_tpu_torch.models.vggt.modules import Block, Dense, \
    rope_2d_angles, run_block
from vggt_slam_tpu_torch.models.vggt.vit import DinoViT


def merge_indices(P: int, stride: int, device):
    """Kept (dst) and merged (src) patch indices of a frame, on `device`."""
    dst = np.arange(0, P, stride)
    src = np.setdiff1d(np.arange(P), dst)
    return (torch.as_tensor(dst, device=device),
            torch.as_tensor(src, device=device))


def sim_merge(x0: torch.Tensor, ns: int, dst_patch, src_patch, dtype):
    """FastVGGT's similarity merge of the K/V set (reference aggregator.py
    :113-159) from global block 0's input tokens x0 (S, N, C): each dropped
    patch token of frames 1.. merges into its most cosine-similar kept token
    of its frame (f32 assignment). Returns the merge matrix M (S-1, Pd, P) in
    `dtype` (mean-pool weights) and the (n_kv,) f32 log-count bias in
    frame-major K/V order."""
    S, N, _ = x0.shape
    P = N - ns
    Pd = dst_patch.shape[0]
    dev = x0.device
    xf = x0[1:].float()
    dst = xf[:, ns + dst_patch]
    src = xf[:, ns + src_patch]
    dn = dst / (torch.linalg.norm(dst, dim=-1, keepdim=True) + 1e-6)
    sn = src / (torch.linalg.norm(src, dim=-1, keepdim=True) + 1e-6)
    sim = torch.einsum("fsc,fdc->fsd", sn, dn)
    a = sim.argmax(-1)                                   # (S-1, Ps)
    A_t = (a[:, None, :] == torch.arange(Pd, device=dev)[None, :, None]
           ).float()                                     # (S-1, Pd, Ps)
    cnt = A_t.sum(2) + 1.0                               # (S-1, Pd)
    M = torch.zeros(S - 1, Pd, P, device=dev)
    M[:, :, dst_patch] = torch.eye(Pd, device=dev)
    M[:, :, src_patch] = A_t
    M_scaled = (M * (1.0 / cnt)[..., None]).to(dtype)
    rows = torch.cat([torch.zeros(S - 1, ns, device=dev), torch.log(cnt)],
                     dim=1)
    bias = torch.cat([torch.zeros(N, device=dev), rows.reshape(-1)])
    return M_scaled, bias


class Aggregator(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = DinoViT(cfg)
        if cfg.enc_dim != cfg.agg_dim:
            self.input_proj = Dense(cfg.enc_dim, cfg.agg_dim, cfg.dtype)
        self.camera_token = nn.Parameter(torch.empty(2, 1, cfg.agg_dim))
        self.register_token = nn.Parameter(
            torch.empty(2, cfg.num_register_tokens, cfg.agg_dim))
        for d in range(cfg.agg_depth):
            self.add_module(f"frame_block_{d}", Block(
                cfg.agg_dim, cfg.agg_heads, cfg.agg_mlp_ratio,
                layerscale=cfg.agg_layerscale, dtype=cfg.dtype,
                attn_impl=cfg.attn_impl, qk_norm=cfg.agg_qk_norm))
            self.add_module(f"global_block_{d}", Block(
                cfg.agg_dim, cfg.agg_heads, cfg.agg_mlp_ratio,
                layerscale=cfg.agg_layerscale, dtype=cfg.dtype,
                attn_impl=cfg.attn_impl, qk_norm=cfg.agg_qk_norm,
                softmax_mode=cfg.global_softmax,
                qk_int8=cfg.global_qk_int8))

    def forward(self, images: torch.Tensor,
                valid_frames: int | None = None) -> Dict:
        """images (S, 3, H, W) in [0, 1]. Frames at index >= valid_frames
        are bucket padding, masked out of every global softmax.

        Returns {depth: (S, ns + P, 2*agg_dim)} for the captured depths
        (cfg.dpt_layers and the last) plus "patch_start" = ns."""
        cfg = self.cfg
        S, _, H, W = images.shape
        h, w = cfg.patch_grid(H, W)
        P = h * w
        ns = cfg.tokens_per_frame_special
        N = ns + P
        dev = images.device
        global_valid = None if valid_frames is None else valid_frames * N

        # Host-built index tensors go to the device before any work is
        # queued: a copy issued later would wait for the queued forward.
        sel = torch.tensor([0] + [1] * (S - 1), device=dev)
        merged = cfg.global_kv_stride > 1 and S > 1
        if merged:
            r = cfg.global_kv_stride
            dst_patch, src_patch = merge_indices(P, r, dev)
            per_frame = np.concatenate([np.arange(ns),
                                        ns + np.arange(0, P, r)])
            kv_index = torch.as_tensor(np.concatenate(
                [np.arange(N)] + [f * N + per_frame for f in range(1, S)]),
                device=dev)

        x = self.patch_embed(images)                       # (S, P, enc_dim)
        if cfg.enc_dim != cfg.agg_dim:
            x = self.input_proj(x)
        special = torch.cat([self.camera_token, self.register_token],
                            dim=1)[sel]                    # (S, ns, C)
        x = torch.cat([special.to(x.dtype), x], dim=1)     # (S, N, C)

        # Full-length rope tables, 1-based patch positions (position 0,
        # identity rotation, is the special tokens'), frame-major tiling.
        yy, xx = torch.meshgrid(
            torch.arange(1, h + 1, dtype=torch.float32, device=dev),
            torch.arange(1, w + 1, dtype=torch.float32, device=dev),
            indexing="ij")
        positions = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)
        head_dim = cfg.agg_dim // cfg.agg_heads
        cos_p, sin_p = rope_2d_angles(positions, head_dim, cfg.rope_base)
        cos = torch.cat([torch.ones(ns, head_dim // 2, device=dev), cos_p])
        sin = torch.cat([torch.zeros(ns, head_dim // 2, device=dev), sin_p])
        cos_g = cos.repeat(S, 1)
        sin_g = sin.repeat(S, 1)

        # Global K/V set: all of frame 0, then per later frame its special
        # tokens and one slot per `stride` patch tokens (merged or strided).
        kv_valid = global_valid
        cos_kv = sin_kv = None
        kv_map = None
        merge_sim = merged and cfg.global_merge == "sim"
        merge = {}
        if merged:
            cos_kv = cos_g[kv_index]
            sin_kv = sin_g[kv_index]
            if valid_frames is not None:
                kv_valid = N + (max(valid_frames, 1) - 1) * len(per_frame)

            def kv_map(xg):
                """(1, S*N, C) tokens -> (1, n_kv, C) merged K/V source."""
                if not merge_sim:
                    return xg[:, kv_index]
                x_ = xg.reshape(S, N, -1)
                pooled = torch.bmm(merge["M"].to(x_.dtype), x_[1:, ns:])
                rest = torch.cat([x_[1:, :ns], pooled], dim=1)
                return torch.cat([x_[0], rest.reshape(-1, x_.shape[-1])]
                                 )[None]

        captured: Dict = {}
        capture_set = set(cfg.dpt_layers) | {cfg.agg_depth - 1}
        for d in range(cfg.agg_depth):
            x = run_block(getattr(self, f"frame_block_{d}"), cfg.remat, x,
                          cos, sin)
            frame_out = x
            if merge_sim and d == 0:
                merge["M"], merge["bias"] = sim_merge(
                    x, ns, dst_patch, src_patch, cfg.dtype)
            xg = x.reshape(1, S * N, cfg.agg_dim)
            global_block = getattr(self, f"global_block_{d}")
            # As the reference, global blocks are not checkpointed when
            # K/V merging is on.
            if merged:
                xg = global_block(
                    xg, cos_g, sin_g, valid_len=global_valid, kv_map=kv_map,
                    kv_valid_len=kv_valid, kv_rope_cos=cos_kv,
                    kv_rope_sin=sin_kv, kv_bias=merge.get("bias"))
            else:
                xg = run_block(global_block, cfg.remat, xg, cos_g, sin_g,
                               valid_len=global_valid)
            x = xg.reshape(S, N, cfg.agg_dim)
            if d in capture_set:
                captured[d] = torch.cat([frame_out, x], dim=-1)
        captured["patch_start"] = ns
        return captured
