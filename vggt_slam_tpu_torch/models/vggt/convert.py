"""Weights for the port's VGGT: flat flax checkpoints and seeded random
initialisation (counterpart of vggt_slam_tpu/models/vggt/convert.py:26-69).

The port's modules keep the flax parameter names and layouts, so a flax
path "params/aggregator/frame_block_0/attn/qkv/kernel" is the state-dict
key "aggregator.frame_block_0.attn.qkv.kernel". The flax conventions the
weights assume carry over unchanged: single-swap rope with the quarter
permutation already folded into q/k, tanh GELU, (k, k, in, out)
ConvTranspose kernels with torch semantics.
"""
from __future__ import annotations

import numpy as np
import torch

from vggt_slam_tpu_torch.models.vggt.modules import lecun_std


def flax_key_to_torch(path: str) -> str:
    if path.startswith("params/"):
        path = path[len("params/"):]
    return path.replace("/", ".")


def torch_key_to_flax(name: str) -> str:
    """The inverse of `flax_key_to_torch`."""
    return "params/" + name.replace(".", "/")


def save_checkpoint(state_dict: dict, path: str) -> None:
    """A state dict -> the reference's flat npz (keys = flax paths, f32),
    which `load_checkpoint` here and in the reference both read."""
    np.savez(path, **{torch_key_to_flax(k): v.detach().float().cpu().numpy()
                      for k, v in state_dict.items()})


def load_flax_params(flat: dict, device="cpu") -> dict:
    """{flax path: array} -> state dict of f32 tensors on `device`."""
    return {flax_key_to_torch(k): torch.as_tensor(
        np.array(v, dtype=np.float32), device=device)
        for k, v in flat.items()}


def load_checkpoint(npz_path: str, device="cpu") -> dict:
    """A reference flat npz checkpoint (keys = flax paths) -> state dict."""
    with np.load(npz_path) as data:
        return load_flax_params({k: data[k] for k in data.files}, device)


def _init_value(name: str, shape, generator, device, model_owner):
    """One parameter drawn as the reference's flax initialisers draw it."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        std = lecun_std(shape)
        return torch.randn(shape, generator=generator, device=device) * std
    if leaf in ("pos_embed", "cls_token", "register_tokens", "camera_token",
                "register_token"):
        return torch.randn(shape, generator=generator, device=device) * 0.02
    if leaf == "gamma":
        return torch.full(shape, model_owner.init_value, device=device)
    if leaf == "scale":
        return torch.ones(shape, device=device)
    if leaf in ("bias", "empty_pose_tokens"):
        return torch.zeros(shape, device=device)
    raise KeyError(f"no initialiser for parameter {name}")


def init_params(cfg, generator: torch.Generator, device) -> dict:
    """Seeded random weights for VGGT(cfg), drawn directly on `device` (the
    1B model's 4.8 GB never cross the host): lecun-normal kernels, N(0,
    0.02) tokens and position embeddings, LayerScale at its init value,
    unit LayerNorm scales, zero biases. Returns the state dict."""
    from vggt_slam_tpu_torch.models.vggt.model import VGGT

    with torch.device("meta"):
        model = VGGT(cfg)
    owners = dict(model.named_modules())
    sd = {}
    for name, p in model.named_parameters():
        owner = owners[name.rsplit(".", 1)[0]] if "." in name else model
        sd[name] = _init_value(name, tuple(p.shape), generator, device, owner)
    return sd
