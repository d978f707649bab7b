"""VGGT model configuration (counterpart of vggt_slam_tpu/models/vggt/
config.py): a DINOv2 ViT-L/14 encoder feeding 24 alternating frame/global
attention blocks, a camera head and DPT heads. `tiny()` is a CPU-testable
configuration with identical structure."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    img_size: int = 518
    patch_size: int = 14

    # DINOv2-style image encoder (ViT-L/14 with registers)
    enc_dim: int = 1024
    enc_depth: int = 24
    enc_heads: int = 16
    enc_mlp_ratio: int = 4
    enc_num_registers: int = 4
    enc_layerscale: float = 1e-5

    # Alternating-attention aggregator
    agg_dim: int = 1024
    agg_depth: int = 24          # pairs of (frame, global) blocks
    agg_heads: int = 16
    agg_mlp_ratio: int = 4
    agg_layerscale: float = 0.01
    agg_qk_norm: bool = True
    num_register_tokens: int = 4  # per-frame register tokens (+1 camera)
    rope_base: float = 100.0

    # Camera head
    cam_trunk_depth: int = 4
    cam_iterations: int = 4

    # DPT heads
    dpt_layers: Tuple[int, ...] = (4, 11, 17, 23)
    dpt_features: int = 256
    dpt_out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)

    # Compute: "flash" runs the CUDA kernels on the card (their plain
    # versions on the CPU); "flash_grad" is the differentiable training
    # path (qk-norm and rope in torch ops, then the forward kernels with
    # stats and the two backward kernels); "chunked" is the plain
    # reference everywhere.
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "flash"
    enable_point_head: bool = True
    enable_depth_head: bool = True

    # Global-attention K/V token merging: keys/values keep frame 0 and one
    # slot per `global_kv_stride` patch tokens of the other frames; "sim"
    # merges dropped tokens into their most similar kept token of the same
    # frame (FastVGGT), "stride" drops them.
    global_kv_stride: int = 1
    global_merge: str = "sim"
    # "static": the global blocks' softmax shifts by a precomputed logit
    # bound instead of the running max (kernel 2); "online": running max.
    global_softmax: str = "static"
    # int8 QK^T in the global blocks (flash only, multi-block key sets):
    # q and k are quantized after rope with per-(batch, head) scales, and
    # the qk-norm then runs outside the kernel (reference config.py:75-86).
    global_qk_int8: bool = False
    # Activation checkpointing (training): the encoder, frame and global
    # blocks recompute their activations in the backward pass. Global
    # blocks skip it when K/V merging is on, as in the reference.
    remat: bool = False

    @property
    def tokens_per_frame_special(self) -> int:
        return 1 + self.num_register_tokens

    def patch_grid(self, H: int, W: int) -> tuple[int, int]:
        return H // self.patch_size, W // self.patch_size

    @staticmethod
    def vggt_1b(**overrides) -> "VGGTConfig":
        """Full-size configuration matching facebook/VGGT-1B."""
        return VGGTConfig(**overrides)

    @staticmethod
    def small(**overrides) -> "VGGTConfig":
        base = dict(
            enc_dim=128, enc_depth=4, enc_heads=4,
            agg_dim=128, agg_depth=6, agg_heads=4,
            cam_trunk_depth=2, cam_iterations=4,
            dpt_layers=(1, 3, 5), dpt_features=64,
            dpt_out_channels=(64, 128, 128),
        )
        base.update(overrides)
        return VGGTConfig(**base)

    @staticmethod
    def small64(**overrides) -> "VGGTConfig":
        base = dict(enc_heads=2, agg_heads=2)
        base.update(overrides)
        return VGGTConfig.small(**base)

    @staticmethod
    def small256(**overrides) -> "VGGTConfig":
        base = dict(
            enc_dim=256, enc_depth=4, enc_heads=4,
            agg_dim=256, agg_depth=6, agg_heads=4,
            cam_trunk_depth=2, cam_iterations=4,
            dpt_layers=(1, 3, 5), dpt_features=64,
            dpt_out_channels=(64, 128, 128),
        )
        base.update(overrides)
        return VGGTConfig(**base)

    @staticmethod
    def tiny(**overrides) -> "VGGTConfig":
        base = dict(
            img_size=56, patch_size=14,
            enc_dim=32, enc_depth=2, enc_heads=2,
            agg_dim=32, agg_depth=4, agg_heads=2,
            cam_trunk_depth=2, cam_iterations=2,
            dpt_layers=(1, 3), dpt_features=16, dpt_out_channels=(16, 32),
            dtype=torch.float32,
        )
        base.update(overrides)
        return VGGTConfig(**base)
