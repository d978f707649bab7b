"""CLIP's towers in PyTorch (counterpart of vggt_slam_tpu/models/clip.py), as
`transformers.CLIPModel` computes them (default
`openai/clip-vit-base-patch32`). Vision: a patch conv, a class token,
learned positions, pre-LN blocks, post-LN on the class token, a
projection; its attention runs `flash_single` on bf16 q, k, v in the f32
module (`attn_impl="plain"`: the plain f32 path). Text: causal pre-LN
blocks (plain: the kernel masks only a key suffix), a final LN pooled at
the largest id (end of text), a projection. Quick-gelu, LN eps 1e-5.
Parameters keep the flax names and layouts (`load_flax_params`); a
transformers checkpoint converts as the reference's does, read without
transformers or safetensors (`read_safetensors`).
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vggt_slam_tpu_torch.models.vggt.modules import Conv, Dense, LayerNorm
from vggt_slam_tpu_torch.ops import attention as attn_ops

# CLIP's image normalization constants (transformers CLIPImageProcessor).
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp: int = 3072
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    text_mlp: int = 2048
    vocab_size: int = 49408
    context_length: int = 77
    projection_dim: int = 512
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @staticmethod
    def base_patch32(**kw) -> "CLIPConfig":
        """openai/clip-vit-base-patch32 (the reference's default)."""
        return CLIPConfig(**kw)

    @staticmethod
    def base_patch16(**kw) -> "CLIPConfig":
        return CLIPConfig(patch_size=16, **kw)

    @staticmethod
    def large_patch14(**kw) -> "CLIPConfig":
        return CLIPConfig(patch_size=14, vision_width=1024, vision_layers=24,
                          vision_heads=16, vision_mlp=4096, text_width=768,
                          text_layers=12, text_heads=12, text_mlp=3072,
                          projection_dim=768, **kw)

    @staticmethod
    def from_hf_dir(model_dir: str, **kw) -> "CLIPConfig":
        """The config of a transformers checkpoint directory's config.json."""
        with open(os.path.join(model_dir, "config.json")) as f:
            hf = json.load(f)
        if hf.get("model_type") != "clip":
            raise ValueError(f"{model_dir} is model_type="
                             f"{hf.get('model_type')!r}, not a CLIP "
                             "checkpoint (models.siglip reads SigLIP)")
        v, t = hf["vision_config"], hf["text_config"]
        return CLIPConfig(
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 32),
            vision_width=v.get("hidden_size", 768),
            vision_layers=v.get("num_hidden_layers", 12),
            vision_heads=v.get("num_attention_heads", 12),
            vision_mlp=v.get("intermediate_size", 3072),
            text_width=t.get("hidden_size", 512),
            text_layers=t.get("num_hidden_layers", 12),
            text_heads=t.get("num_attention_heads", 8),
            text_mlp=t.get("intermediate_size", 2048),
            vocab_size=t.get("vocab_size", 49408),
            context_length=t.get("max_position_embeddings", 77),
            projection_dim=hf.get("projection_dim", 512),
            **kw)

    def to_hf_dict(self) -> dict:
        """The config.json that `from_hf_dir` reads back to this config
        (transformers' layout)."""
        return {"model_type": "clip", "projection_dim": self.projection_dim,
                "vision_config": {
                    "image_size": self.image_size,
                    "patch_size": self.patch_size,
                    "hidden_size": self.vision_width,
                    "num_hidden_layers": self.vision_layers,
                    "num_attention_heads": self.vision_heads,
                    "intermediate_size": self.vision_mlp},
                "text_config": {
                    "hidden_size": self.text_width,
                    "num_hidden_layers": self.text_layers,
                    "num_attention_heads": self.text_heads,
                    "intermediate_size": self.text_mlp,
                    "vocab_size": self.vocab_size,
                    "max_position_embeddings": self.context_length}}

    @staticmethod
    def tiny_test(**kw) -> "CLIPConfig":
        """A small config for parity tests (not a released model)."""
        base = dict(image_size=32, patch_size=8, vision_width=24,
                    vision_layers=2, vision_heads=2, vision_mlp=48,
                    text_width=16, text_layers=2, text_heads=2, text_mlp=32,
                    vocab_size=64, context_length=12, projection_dim=20)
        base.update(kw)
        return CLIPConfig(**base)

    @property
    def vision_grid(self) -> int:
        return self.image_size // self.patch_size


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """Multi-head self-attention with CLIP's q/k/v/out projections."""

    def __init__(self, dim: int, heads: int, dtype=torch.float32,
                 attn_impl: str = "flash"):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(dim, dim, dtype))

    def forward(self, x: torch.Tensor, causal: bool,
                kv: torch.Tensor | None = None) -> torch.Tensor:
        """Self-attention over x, or (plain) x's queries over kv."""
        y = x if kv is None else kv
        q, k, v = self.q_proj(x), self.k_proj(y), self.v_proj(y)
        if causal or self.attn_impl == "plain" or kv is not None:
            o = self._plain(q, k, v, causal)
        else:
            # the kernel takes bf16: an f32 module casts in and back out
            cast = q.device.type == "cuda" and q.dtype != torch.bfloat16
            if cast:
                q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            o = attn_ops.flash_single(q.contiguous(), k.contiguous(),
                                      v.contiguous(), num_heads=self.heads)
            if cast:
                o = o.to(self.dtype)
        return self.out_proj(o)

    def _plain(self, q, k, v, causal):
        b, n, c = q.shape
        hd = c // self.heads

        def split(t):
            return t.view(b, -1, self.heads, hd).transpose(1, 2)

        logits = torch.matmul(split(q) * hd ** -0.5,
                              split(k).transpose(-1, -2)).float()
        if causal:
            above = torch.ones(n, n, dtype=torch.bool,
                               device=q.device).triu(1)
            logits = logits.masked_fill(above, float("-inf"))
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.matmul(p, split(v)).transpose(1, 2).reshape(b, n, c)


class CLIPBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int, ln_eps: float,
                 dtype=torch.float32, attn_impl: str = "flash",
                 act=quick_gelu):
        super().__init__()
        self.dtype = dtype
        self.act = act
        self.ln1 = LayerNorm(dim, ln_eps)
        self.attn = CLIPAttention(dim, heads, dtype, attn_impl)
        self.ln2 = LayerNorm(dim, ln_eps)
        self.fc1 = Dense(dim, mlp_dim, dtype)
        self.fc2 = Dense(mlp_dim, dim, dtype)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        x = x + self.attn(self.ln1(x).to(self.dtype), causal)
        h = self.ln2(x).to(self.dtype)
        return x + self.fc2(self.act(self.fc1(h)))


def _blocks(owner, n, *args):
    for i in range(n):
        owner.add_module(f"block_{i}", CLIPBlock(*args))
    return [getattr(owner, f"block_{i}") for i in range(n)]


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, attn_impl: str = "flash"):
        super().__init__()
        self.cfg = cfg
        w = cfg.vision_width
        self.patch_embed = Conv(3, w, cfg.patch_size, stride=cfg.patch_size,
                                dtype=cfg.dtype, use_bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.pos_embed = nn.Parameter(torch.empty(1 + cfg.vision_grid ** 2,
                                                  w))
        self.pre_ln = LayerNorm(w, cfg.ln_eps)
        self.blocks = _blocks(self, cfg.vision_layers, w, cfg.vision_heads,
                              cfg.vision_mlp, cfg.ln_eps, cfg.dtype,
                              attn_impl)
        self.post_ln = LayerNorm(w, cfg.ln_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) CLIP-normalized images -> (B, width) pooled CLS."""
        x = self.patch_embed(images.permute(0, 3, 1, 2))    # (B, w, g, g)
        x = x.flatten(2).transpose(1, 2)                   # (B, g*g, w)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = self.pre_ln(x).to(self.cfg.dtype)
        for blk in self.blocks:
            x = blk(x, causal=False)
        return self.post_ln(x[:, 0])


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.text_width
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, w))
        self.pos_embed = nn.Parameter(torch.empty(cfg.context_length, w))
        self.blocks = _blocks(self, cfg.text_layers, w, cfg.text_heads,
                              cfg.text_mlp, cfg.ln_eps, cfg.dtype)
        self.final_ln = LayerNorm(w, cfg.ln_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, L) int64 token ids -> (B, width) at the first EOT (the
        largest id; right-padding with EOT is harmless under the causal
        mask)."""
        dt = self.cfg.dtype
        x = self.token_embedding[ids].to(dt) + \
            self.pos_embed[:ids.shape[1]].to(dt)
        for blk in self.blocks:
            x = blk(x, causal=True)
        x = self.final_ln(x)
        return x[torch.arange(len(ids), device=ids.device),
                 ids.argmax(dim=-1)]


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class CLIP(nn.Module):
    """Both towers; the methods mirror transformers' get_*_features."""

    def __init__(self, cfg: CLIPConfig, attn_impl: str = "flash"):
        super().__init__()
        self.cfg = cfg
        self.vision = CLIPVisionTower(cfg, attn_impl)
        self.text = CLIPTextTower(cfg)
        self.visual_projection = Dense(cfg.vision_width, cfg.projection_dim,
                                       cfg.dtype, use_bias=False)
        self.text_projection = Dense(cfg.text_width, cfg.projection_dim,
                                     cfg.dtype, use_bias=False)
        self.logit_scale = nn.Parameter(torch.empty(()))

    def set_attn_impl(self, attn_impl: str) -> None:
        """"flash" (the kernel on CUDA tensors) or "plain" for the vision
        tower's attention."""
        for m in self.vision.modules():
            if isinstance(m, CLIPAttention):
                m.attn_impl = attn_impl

    def encode_image(self, images, normalize: bool = True):
        feats = self.visual_projection(self.vision(images).to(self.cfg.dtype))
        return _unit(feats) if normalize else feats

    def encode_text(self, ids, normalize: bool = True):
        feats = self.text_projection(self.text(ids).to(self.cfg.dtype))
        return _unit(feats) if normalize else feats

    def forward(self, images, ids):
        """(logits_per_image, image features, text features)."""
        img = self.encode_image(images)
        txt = self.encode_text(ids)
        return img @ txt.T * torch.exp(self.logit_scale).to(img.dtype), \
            img, txt


def preprocess_images(images, image_size: int, mean=IMAGE_MEAN,
                      std=IMAGE_STD) -> torch.Tensor:
    """(N, 3, H, W) or (N, H, W, 3) float [0, 1] (numpy or a tensor) -> (x -
    mean) / std as (N, S, S, 3) f32 on the input's device, resized bilinearly
    (antialiased when shrinking, as jax.image.resize) where not S x S."""
    x = torch.as_tensor(images, dtype=torch.float32)
    if x.ndim != 4:
        raise ValueError(f"expected (N, ., ., .) images, got "
                         f"{tuple(x.shape)}")
    if x.shape[1] == 3 and x.shape[-1] != 3:
        x = x.permute(0, 2, 3, 1)
    if tuple(x.shape[1:3]) != (image_size, image_size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(image_size,
                                                       image_size),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    return (x - torch.tensor(mean, device=x.device)) / \
        torch.tensor(std, device=x.device)


# Weights: the JAX package's tree, transformers checkpoints

def load_flax_params(module: nn.Module, tree: Mapping):
    """The JAX package's parameters (the nested dict under "params" of
    `model.init`, leaves numpy or jax arrays) into `module`, strictly."""
    from vggt_slam_tpu_torch.models.vggt import convert as C

    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(tree, "")
    module.load_state_dict(C.load_flax_params(flat), strict=True)
    return module


def name_ln(names, p, t):
    names.extend([(f"{p}.scale", f"{t}.weight"), (f"{p}.bias", f"{t}.bias")])


def name_dense(names, p, t, bias=True):
    names.append((f"{p}.kernel", f"{t}.weight"))
    if bias:
        names.append((f"{p}.bias", f"{t}.bias"))


def name_blocks(names, p, t, n):
    """The (port key, transformers key) pairs of n pre-LN blocks."""
    for i in range(n):
        pi, ti = f"{p}.block_{i}", f"{t}.encoder.layers.{i}"
        name_ln(names, f"{pi}.ln1", f"{ti}.layer_norm1")
        name_ln(names, f"{pi}.ln2", f"{ti}.layer_norm2")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            name_dense(names, f"{pi}.attn.{proj}", f"{ti}.self_attn.{proj}")
        name_dense(names, f"{pi}.fc1", f"{ti}.mlp.fc1")
        name_dense(names, f"{pi}.fc2", f"{ti}.mlp.fc2")


def _torch_names(cfg: CLIPConfig) -> list[tuple[str, str]]:
    """(port key, transformers key) of every parameter of CLIP(cfg)."""
    ve, te = "vision_model.embeddings", "text_model.embeddings"
    names = [("vision.patch_embed.kernel", f"{ve}.patch_embedding.weight"),
             ("vision.class_embedding", f"{ve}.class_embedding"),
             ("vision.pos_embed", f"{ve}.position_embedding.weight")]
    name_ln(names, "vision.pre_ln", "vision_model.pre_layrnorm")  # [sic]
    name_blocks(names, "vision", "vision_model", cfg.vision_layers)
    name_ln(names, "vision.post_ln", "vision_model.post_layernorm")
    names += [("text.token_embedding", f"{te}.token_embedding.weight"),
              ("text.pos_embed", f"{te}.position_embedding.weight")]
    name_blocks(names, "text", "text_model", cfg.text_layers)
    name_ln(names, "text.final_ln", "text_model.final_layer_norm")
    name_dense(names, "visual_projection", "visual_projection", bias=False)
    name_dense(names, "text_projection", "text_projection", bias=False)
    names.append(("logit_scale", "logit_scale"))
    return names


def module_shapes(cls, cfg) -> dict:
    """{port key: shape} of cls(cfg), built on the meta device."""
    with torch.device("meta"):
        model = cls(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def param_shapes(cfg: CLIPConfig) -> dict:
    return module_shapes(CLIP, cfg)


def _is_conv(port_key: str) -> bool:
    return port_key.endswith("patch_embed.kernel")


def layout_of(names, shapes) -> dict:
    """{transformers key: shape}: the converter's names and layouts run
    backwards."""
    out = {}
    for pk, tk in names:
        s = shapes[pk]
        if _is_conv(pk):            # (kh, kw, in, out) -> (out, in, kh, kw)
            s = (s[3], s[2], s[0], s[1])
        elif pk.endswith(".kernel"):
            s = s[::-1]
        out[tk] = s
    return out


def torch_layout(cfg: CLIPConfig) -> dict:
    """{transformers key: shape} of a `CLIPModel` state dict at cfg (the
    position_ids buffers aside)."""
    return layout_of(_torch_names(cfg), param_shapes(cfg))


def seeded(layout: dict, generator: torch.Generator, std: float,
           logit_std: float) -> dict:
    """Seeded weights of a {transformers key: shape} layout on the generator's
    device: N(0, std), LayerNorm weights 1 + N(0, std), q_proj/k_proj weights
    N(0, logit_std / width), so that attention logits spread by about
    logit_std."""
    out = {}
    for tk, shape in layout.items():
        scale = std
        if tk.endswith(("q_proj.weight", "k_proj.weight")):
            scale = (logit_std / shape[1]) ** 0.5
        t = torch.randn(shape, generator=generator,
                        device=generator.device) * scale
        if "norm" in tk and tk.endswith(".weight"):
            t += 1.0
        out[tk] = t
    return out


def init_torch_state_dict(cfg: CLIPConfig, generator: torch.Generator,
                          std: float = 0.02, logit_std: float = 3.0) -> dict:
    """`seeded` weights in transformers' `CLIPModel` layout (no weights
    ship); logit_scale log(1 / 0.07), CLIP's init."""
    out = seeded(torch_layout(cfg), generator, std, logit_std)
    out["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)),
                                      device=generator.device)
    return out


def convert_by_names(sd: dict, names, shapes, family: str) -> dict:
    """A transformers state dict -> the port's f32 tensors by (port key,
    transformers key) `names`, strictly: a missing key, a wrong shape or an
    unconsumed key but `*.position_ids` raises, naming it. Linear weights and
    the patch conv take the flax layouts."""
    out = {}
    for pk, tk in names:
        if tk not in sd:
            raise KeyError(f"{family} converter: missing checkpoint key {tk}")
        t = torch.as_tensor(sd[tk]).to(torch.float32)
        if _is_conv(pk) and t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        elif pk.endswith(".kernel") and t.dim() == 2:
            t = t.T
        if tuple(t.shape) != shapes[pk]:
            raise ValueError(f"{family} converter: {tk} gives {pk} the "
                             f"shape {tuple(t.shape)}, expected {shapes[pk]}")
        out[pk] = t
    consumed = {tk for _, tk in names}
    leftover = sorted(k for k in sd if k not in consumed
                      and not k.endswith(".position_ids"))
    if leftover:
        raise KeyError(f"{family} converter: unexpected unconsumed "
                       f"checkpoint keys: {leftover[:8]}"
                       f"{'...' if len(leftover) > 8 else ''}")
    return out


def convert_torch_state_dict(sd: dict, cfg: CLIPConfig) -> dict:
    """A `CLIPModel` state dict -> the port's (`convert_by_names`)."""
    return convert_by_names(sd, _torch_names(cfg), param_shapes(cfg), "CLIP")


# the weights' dtypes, and I64 for the position_ids older checkpoints hold
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64}


def read_safetensors(path: str) -> dict:
    """A .safetensors file -> {name: CPU tensor}: an 8-byte header length, a
    JSON header of dtypes, shapes and offsets, the raw buffers."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(_SAFETENSORS_DTYPES)}")
        dt = _SAFETENSORS_DTYPES[info["dtype"]]
        b, e = info["data_offsets"]
        t = torch.frombuffer(data, dtype=torch.uint8, count=e - b,
                             offset=b) if e > b else \
            torch.empty(0, dtype=torch.uint8)
        out[name] = t.view(dt).reshape(info["shape"])
    return out


def read_checkpoint(model_dir: str) -> dict:
    """The state dict of a local transformers checkpoint directory:
    `model.safetensors` first, else `pytorch_model.bin`."""
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no pytorch_model.bin or model.safetensors under {model_dir}")


def load_torch_checkpoint(model_dir: str, cfg: CLIPConfig) -> dict:
    return convert_torch_state_dict(read_checkpoint(model_dir), cfg)


def encoders(model, sd, tokenizer, dev, dim, image_size, max_batch,
             mean=IMAGE_MEAN, std=IMAGE_STD):
    """The embedder's pair on `model` (built on meta) with state dict `sd`:
    `encode_crops((N, 3, H, W) or (N, H, W, 3) [0, 1])`, `encode_text(list of
    str)` -> L2-normalized (N, dim) float32 numpy, chunks of `max_batch` on
    `dev`; both carry `.model`."""
    model.load_state_dict({k: v.to(dev).contiguous() for k, v in sd.items()},
                          assign=True)
    model.eval()

    @torch.no_grad()
    def chunked(fn, batch):
        if len(batch) == 0:
            return np.zeros((0, dim), np.float32)
        return np.concatenate([
            fn(torch.from_numpy(batch[i:i + max_batch]).to(dev)).float()
            .cpu().numpy() for i in range(0, len(batch), max_batch)])

    def encode_crops(crops) -> np.ndarray:
        return chunked(lambda x: model.encode_image(
            preprocess_images(x, image_size, mean, std)),
            np.ascontiguousarray(crops, np.float32))

    def encode_text(texts: list[str]) -> np.ndarray:
        return chunked(model.encode_text, tokenizer(texts))

    encode_crops.model = encode_text.model = model
    return encode_crops, encode_text


def make_encoders(model_dir: str, cfg: CLIPConfig | None = None,
                  max_batch: int = 64, device="cuda"):
    """`encoders` on a CLIP checkpoint directory on `device` (the card unless
    the CPU is asked for): 12 flash_single a chunk of crops at ViT-B."""
    from vggt_slam_tpu_torch.models.clip_tokenizer import CLIPTokenizer
    from vggt_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if cfg is None:
        cfg = CLIPConfig.from_hf_dir(model_dir)
    sd = load_torch_checkpoint(model_dir, cfg)
    with torch.device("meta"):
        model = CLIP(cfg)
    return encoders(model, sd, CLIPTokenizer.from_dir(model_dir,
                                                      cfg.context_length),
                    dev, cfg.projection_dim, cfg.image_size, max_batch)
