"""SigLIP's two towers in PyTorch (counterpart of
vggt_slam_tpu/models/siglip.py), as `transformers.SiglipModel` computes
them, from models/clip.py's pieces: the encoders of a `--clip_model_dir`
whose config.json says model_type "siglip".

  * vision: a patch conv with bias, learned positions, no class token,
    pre-LN blocks, a post-LayerNorm, then a pooling head (a learned probe
    attends over the tokens; LayerNorm and a residual MLP).
  * text: non-causal pre-LN blocks, a final LayerNorm pooled at the last
    position, a biased head. Tanh GELU, LayerNorm eps 1e-6.

Self-attention in both towers runs `flash_single` on bf16 q, k and v (its
own head_dim**-0.5 is SigLIP's scale) in the f32 module, as CLIP's vision
tower does; `attn_impl="plain"` takes the plain f32 path, and the head's
one-query cross-attention is always plain. Parameters keep the flax names
and layouts (`clip.load_flax_params`).
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vggt_slam_tpu_torch.models import clip as C
from vggt_slam_tpu_torch.models.clip import load_flax_params  # noqa: F401
from vggt_slam_tpu_torch.models.vggt.modules import Conv, Dense, LayerNorm

# SiglipImageProcessor: rescale by 1/255, then mean and std 0.5
IMAGE_MEAN = (0.5, 0.5, 0.5)
IMAGE_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp: int = 3072
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_mlp: int = 3072
    vocab_size: int = 32000
    context_length: int = 64
    projection_size: int = 768     # the text head's width: vision_width
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @staticmethod
    def base_patch16_224(**kw) -> "SigLIPConfig":
        """google/siglip-base-patch16-224 (the family's default)."""
        return SigLIPConfig(**kw)

    @staticmethod
    def from_hf_dir(model_dir: str, **kw) -> "SigLIPConfig":
        """The config of a transformers checkpoint directory's config.json."""
        with open(os.path.join(model_dir, "config.json")) as f:
            hf = json.load(f)
        if hf.get("model_type") != "siglip":
            raise ValueError(f"{model_dir} is model_type="
                             f"{hf.get('model_type')!r}, not a SigLIP "
                             "checkpoint")
        v, t = hf["vision_config"], hf["text_config"]
        return SigLIPConfig(
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 16),
            vision_width=v.get("hidden_size", 768),
            vision_layers=v.get("num_hidden_layers", 12),
            vision_heads=v.get("num_attention_heads", 12),
            vision_mlp=v.get("intermediate_size", 3072),
            text_width=t.get("hidden_size", 768),
            text_layers=t.get("num_hidden_layers", 12),
            text_heads=t.get("num_attention_heads", 12),
            text_mlp=t.get("intermediate_size", 3072),
            vocab_size=t.get("vocab_size", 32000),
            context_length=t.get("max_position_embeddings", 64),
            projection_size=t.get("projection_size",
                                  t.get("hidden_size", 768)),
            **kw)

    def to_hf_dict(self) -> dict:
        """The config.json that `from_hf_dir` reads back to this config."""
        return {"model_type": "siglip", "vision_config": {
            "image_size": self.image_size, "patch_size": self.patch_size,
            "hidden_size": self.vision_width,
            "num_hidden_layers": self.vision_layers,
            "num_attention_heads": self.vision_heads,
            "intermediate_size": self.vision_mlp}, "text_config": {
            "hidden_size": self.text_width,
            "num_hidden_layers": self.text_layers,
            "num_attention_heads": self.text_heads,
            "intermediate_size": self.text_mlp,
            "vocab_size": self.vocab_size,
            "max_position_embeddings": self.context_length,
            "projection_size": self.projection_size}}

    @staticmethod
    def tiny_test(**kw) -> "SigLIPConfig":
        """A small config for parity tests (not a released model)."""
        base = dict(image_size=32, patch_size=8, vision_width=24,
                    vision_layers=2, vision_heads=2, vision_mlp=48,
                    text_width=16, text_layers=2, text_heads=2, text_mlp=32,
                    vocab_size=64, context_length=12, projection_size=24)
        base.update(kw)
        return SigLIPConfig(**base)

    @property
    def vision_grid(self) -> int:
        return self.image_size // self.patch_size


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# CLIP's projections; self-attention on flash_single, cross-attention plain
SigLIPAttention = C.CLIPAttention


class SigLIPBlock(C.CLIPBlock):
    """CLIP's pre-LN block with the tanh GELU."""

    def __init__(self, dim, heads, mlp_dim, ln_eps, dtype=torch.float32,
                 attn_impl: str = "flash"):
        super().__init__(dim, heads, mlp_dim, ln_eps, dtype, attn_impl,
                         gelu_tanh)


def _blocks(owner, n, *args):
    for i in range(n):
        owner.add_module(f"block_{i}", SigLIPBlock(*args))
    return [getattr(owner, f"block_{i}") for i in range(n)]


class SigLIPPoolingHead(nn.Module):
    """A learned probe attends over the tokens; LayerNorm, residual MLP."""

    def __init__(self, cfg: SigLIPConfig):
        super().__init__()
        w, self.dtype = cfg.vision_width, cfg.dtype
        self.probe = nn.Parameter(torch.empty(1, 1, w))
        self.attn = SigLIPAttention(w, cfg.vision_heads, cfg.dtype)
        self.ln = LayerNorm(w, cfg.ln_eps)
        self.fc1 = Dense(w, cfg.vision_mlp, cfg.dtype)
        self.fc2 = Dense(cfg.vision_mlp, w, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        probe = self.probe.to(x.dtype).expand(x.shape[0], 1, -1)
        r = self.attn(probe, False, kv=x)
        h = self.ln(r).to(self.dtype)
        return (r + self.fc2(gelu_tanh(self.fc1(h))))[:, 0]


class SigLIPVisionTower(nn.Module):
    def __init__(self, cfg: SigLIPConfig, attn_impl: str = "flash"):
        super().__init__()
        self.cfg = cfg
        w = cfg.vision_width
        self.patch_embed = Conv(3, w, cfg.patch_size, stride=cfg.patch_size,
                                dtype=cfg.dtype)
        self.pos_embed = nn.Parameter(torch.empty(cfg.vision_grid ** 2, w))
        self.blocks = _blocks(self, cfg.vision_layers, w, cfg.vision_heads,
                              cfg.vision_mlp, cfg.ln_eps, cfg.dtype,
                              attn_impl)
        self.post_ln = LayerNorm(w, cfg.ln_eps)
        self.head = SigLIPPoolingHead(cfg)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) SigLIP-normalized images -> (B, width) pooled."""
        x = self.patch_embed(images.permute(0, 3, 1, 2))    # (B, w, g, g)
        x = x.flatten(2).transpose(1, 2) + self.pos_embed.to(self.cfg.dtype)
        for blk in self.blocks:
            x = blk(x, causal=False)
        return self.head(self.post_ln(x).to(self.cfg.dtype))


class SigLIPTextTower(nn.Module):
    def __init__(self, cfg: SigLIPConfig, attn_impl: str = "flash"):
        super().__init__()
        self.cfg = cfg
        w = cfg.text_width
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, w))
        self.pos_embed = nn.Parameter(torch.empty(cfg.context_length, w))
        self.blocks = _blocks(self, cfg.text_layers, w, cfg.text_heads,
                              cfg.text_mlp, cfg.ln_eps, cfg.dtype, attn_impl)
        self.final_ln = LayerNorm(w, cfg.ln_eps)
        self.head = Dense(w, cfg.projection_size, cfg.dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, L) int64 token ids -> (B, projection_size), pooled at the
        last position (ids pad to the full context)."""
        dt = self.cfg.dtype
        x = self.token_embedding[ids].to(dt) + \
            self.pos_embed[:ids.shape[1]].to(dt)
        for blk in self.blocks:
            x = blk(x, causal=False)
        return self.head(self.final_ln(x)[:, -1].to(dt))


class SigLIP(nn.Module):
    """Both towers; the methods mirror transformers' get_*_features."""

    def __init__(self, cfg: SigLIPConfig, attn_impl: str = "flash"):
        super().__init__()
        self.cfg = cfg
        self.vision = SigLIPVisionTower(cfg, attn_impl)
        self.text = SigLIPTextTower(cfg, attn_impl)
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.logit_bias = nn.Parameter(torch.empty(()))

    def set_attn_impl(self, attn_impl: str) -> None:
        """"flash" (the kernel on CUDA tensors) or "plain", both towers."""
        for m in self.modules():
            if isinstance(m, SigLIPAttention):
                m.attn_impl = attn_impl

    def encode_image(self, images, normalize: bool = True):
        feats = self.vision(images)
        return C._unit(feats) if normalize else feats

    def encode_text(self, ids, normalize: bool = True):
        feats = self.text(ids)
        return C._unit(feats) if normalize else feats

    def forward(self, images, ids):
        """(sigmoid logits_per_image, image features, text features)."""
        img = self.encode_image(images)
        txt = self.encode_text(ids)
        scale = torch.exp(self.logit_scale).to(img.dtype)
        return img @ txt.T * scale + self.logit_bias, img, txt


def preprocess_images(images, image_size: int) -> torch.Tensor:
    """`clip.preprocess_images` with SigLIP's mean and std."""
    return C.preprocess_images(images, image_size, IMAGE_MEAN, IMAGE_STD)


_HEAD = "vision_model.head.attention"
_PACKED = tuple(f"{_HEAD}.in_proj_{kind}" for kind in ("weight", "bias"))
_SCALARS = ("logit_scale", "logit_bias")


def _torch_names(cfg: SigLIPConfig) -> list[tuple[str, str]]:
    """(port key, transformers key) of SigLIP(cfg)'s parameters; the head's
    q, k, v as `convert_torch_state_dict` unpacks in_proj."""
    ve, te = "vision_model.embeddings", "text_model.embeddings"
    names = [("vision.patch_embed.kernel", f"{ve}.patch_embedding.weight"),
             ("vision.patch_embed.bias", f"{ve}.patch_embedding.bias"),
             ("vision.pos_embed", f"{ve}.position_embedding.weight")]
    C.name_blocks(names, "vision", "vision_model", cfg.vision_layers)
    C.name_ln(names, "vision.post_ln", "vision_model.post_layernorm")
    names.append(("vision.head.probe", "vision_model.head.probe"))
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        C.name_dense(names, f"vision.head.attn.{proj}", f"{_HEAD}.{proj}")
    C.name_ln(names, "vision.head.ln", "vision_model.head.layernorm")
    C.name_dense(names, "vision.head.fc1", "vision_model.head.mlp.fc1")
    C.name_dense(names, "vision.head.fc2", "vision_model.head.mlp.fc2")
    names += [("text.token_embedding", f"{te}.token_embedding.weight"),
              ("text.pos_embed", f"{te}.position_embedding.weight")]
    C.name_blocks(names, "text", "text_model", cfg.text_layers)
    C.name_ln(names, "text.final_ln", "text_model.final_layer_norm")
    C.name_dense(names, "text.head", "text_model.head")
    return names + [(k, k) for k in _SCALARS]


def param_shapes(cfg: SigLIPConfig) -> dict:
    return C.module_shapes(SigLIP, cfg)


def torch_layout(cfg: SigLIPConfig) -> dict:
    """{transformers key: shape} of a `SiglipModel` state dict at cfg."""
    W = cfg.vision_width
    out = {k: s for k, s in C.layout_of(_torch_names(cfg),
                                        param_shapes(cfg)).items()
           if not k.startswith((f"{_HEAD}.q_", f"{_HEAD}.k_",
                                f"{_HEAD}.v_"))}
    out.update({_PACKED[0]: (3 * W, W), _PACKED[1]: (3 * W,)})
    out.update({k: (1,) for k in _SCALARS})
    return out


def init_torch_state_dict(cfg: SigLIPConfig, generator: torch.Generator,
                          std: float = 0.02, logit_std: float = 3.0) -> dict:
    """`clip.seeded` weights in `SiglipModel`'s layout: in_proj's q and k
    thirds drawn as q_proj, the probe N(0, 1), logit_scale log(10) and
    logit_bias -10 (the reference's init)."""
    out = C.seeded(torch_layout(cfg), generator, std, logit_std)
    W = cfg.vision_width
    out[_PACKED[0]][:2 * W] *= (logit_std / W) ** 0.5 / std
    out["vision_model.head.probe"] /= std
    dev = generator.device
    out["logit_scale"] = torch.full((1,), float(np.log(10.0)), device=dev)
    out["logit_bias"] = torch.full((1,), -10.0, device=dev)
    return out


def convert_torch_state_dict(sd: dict, cfg: SigLIPConfig) -> dict:
    """A `SiglipModel` state dict -> the port's (`clip.convert_by_names`):
    the head's in_proj split into q, k, v; the logits' (1,) -> ()."""
    W = cfg.vision_width
    sd = dict(sd)
    for key, shape in zip(_PACKED + _SCALARS, ((3 * W, W), (3 * W,),
                                               (1,), (1,))):
        if key not in sd:
            raise KeyError(f"SigLIP converter: missing checkpoint key {key}")
        t = torch.as_tensor(sd.pop(key))
        if tuple(t.shape) != shape:
            raise ValueError(f"SigLIP converter: {key} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if key in _SCALARS:
            sd[key] = t.reshape(())
            continue
        for i, p in enumerate(("q_proj", "k_proj", "v_proj")):
            sd[f"{_HEAD}.{p}.{key.rsplit('_', 1)[1]}"] = t[i * W:(i + 1) * W]
    return C.convert_by_names(sd, _torch_names(cfg), param_shapes(cfg),
                              "SigLIP")


def load_torch_checkpoint(model_dir: str, cfg: SigLIPConfig) -> dict:
    return convert_torch_state_dict(C.read_checkpoint(model_dir), cfg)


def make_encoders(model_dir: str, cfg: SigLIPConfig | None = None,
                  max_batch: int = 64, device="cuda"):
    """`clip.encoders` on a SigLIP checkpoint directory (with its
    spiece.model) on `device`: 12 flash_single a chunk of crops or texts at
    base."""
    from vggt_slam_tpu_torch.models.siglip_tokenizer import SigLIPTokenizer
    from vggt_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if cfg is None:
        cfg = SigLIPConfig.from_hf_dir(model_dir)
    sd = load_torch_checkpoint(model_dir, cfg)
    tokenizer = SigLIPTokenizer.from_dir(model_dir, cfg.context_length)
    with torch.device("meta"):
        model = SigLIP(cfg)
    return C.encoders(model, sd, tokenizer, dev, cfg.projection_size,
                      cfg.image_size, max_batch, IMAGE_MEAN, IMAGE_STD)
