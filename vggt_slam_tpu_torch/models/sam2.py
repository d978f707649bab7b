"""SAM2's image model in PyTorch (counterpart of
vggt_slam_tpu/models/sam2.py): the Hiera trunk and FPN neck, the prompt
encoder and the two-way mask decoder of `sam2.1_hiera_base_plus`, with the
converter of the public `sam2.1_hiera_*.pt` naming.

Tensors are NHWC. Parameters keep the flax names and layouts (the
transposed convs' kernels flipped in space, as the reference's converter
does), so the JAX package's parameters load by a rename
(`load_flax_params`). The module computes in its parameters' dtype
(`.double()` gives the float64 check); attention is plain torch, as the
reference's XLA einsums (no kernel: head dims 56 and 16); tanh GELUs. A
prompt batch broadcasts the batch-1 image features.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from collections.abc import Mapping
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_gelu = functools.partial(F.gelu, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    embed_dim: int = 112
    num_heads: int = 2                 # stage 1; doubles per stage
    stages: Tuple[int, ...] = (2, 3, 16, 3)
    global_att_blocks: Tuple[int, ...] = (12, 16, 20)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (14, 14)
    q_stride: int = 2
    dim_mul: float = 2.0
    head_mul: float = 2.0
    mlp_ratio: float = 4.0
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    d_model: int = 256
    img_size: int = 1024
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        return tuple(int(e) - 1 for e in np.cumsum(self.stages))

    @property
    def backbone_channels(self) -> Tuple[int, ...]:
        return tuple(int(self.embed_dim * self.dim_mul ** i)
                     for i in range(len(self.stages)))

    @property
    def embed_grid(self) -> int:
        return self.img_size // (self.patch_stride * self.q_stride ** 2)

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1

    @staticmethod
    def base_plus(**kw) -> "SAM2Config":
        return SAM2Config(**kw)

    @staticmethod
    def tiny_test(**kw) -> "SAM2Config":
        """The reference's CPU-test config: the same topology, toy dims."""
        base = dict(embed_dim=8, num_heads=1, stages=(1, 2, 2, 1),
                    global_att_blocks=(4,), window_spec=(2, 2, 2, 2),
                    window_pos_embed_bkg_spatial_size=(2, 2), d_model=16,
                    img_size=64, decoder_heads=2, decoder_mlp_dim=32)
        return SAM2Config(**{**base, **kw})


def block_schedule(cfg: SAM2Config):
    """(dim, dim_out, heads, window, q_stride) of each trunk block. The
    stage's first block keeps the previous stage's window and q-pools."""
    dim, heads, stage, out = cfg.embed_dim, cfg.num_heads, 0, []
    ends = cfg.stage_ends
    for i in range(sum(cfg.stages)):
        ws = 0 if i in cfg.global_att_blocks else cfg.window_spec[stage]
        dim_out, qs = dim, 0
        if i - 1 in ends:
            dim_out, heads = int(dim * cfg.dim_mul), int(heads * cfg.head_mul)
            stage, qs = stage + 1, cfg.q_stride
        out.append((dim, dim_out, heads, ws, qs))
        dim = dim_out
    return out


def _p(*shape):
    return nn.Parameter(torch.empty(*shape))


class Dense(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.kernel, self.bias = _p(din, dout), _p(dout)

    def forward(self, x):
        return x @ self.kernel + self.bias


class Conv(nn.Module):
    """flax nn.Conv on NHWC."""

    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.kernel, self.bias = _p(k, k, cin, cout), _p(cout)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        if self.kernel.shape[0] == 1:
            return x @ self.kernel[0, 0] + self.bias
        return F.conv2d(x.permute(0, 3, 1, 2), self.kernel.permute(3, 2, 0, 1),
                        self.bias, self.stride, self.padding
                        ).permute(0, 2, 3, 1)


class ConvT(nn.Module):
    """flax nn.ConvTranspose, kernel 2, stride 2, VALID, on NHWC: pixel
    (2i + a, 2j + b) is x[i, j] @ kernel[1 - a, 1 - b] (the kernel holds
    torch's weight flipped in space)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.kernel, self.bias = _p(2, 2, cin, cout), _p(cout)

    def forward(self, x):
        B, H, W, _ = x.shape
        y = torch.einsum("bhwi,xyio->bhxwyo", x, self.kernel.flip(0, 1))
        return y.reshape(B, 2 * H, 2 * W, -1) + self.bias


class LayerNorm(nn.Module):
    """flax nn.LayerNorm (`scale`), or LayerNorm2d (`weight`) on NHWC."""

    def __init__(self, dim, eps=1e-6, weight="scale"):
        super().__init__()
        self.register_parameter(weight, _p(dim))
        self.bias, self.w, self.eps = _p(dim), weight, eps

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], getattr(self, self.w),
                            self.bias, self.eps)


class MLP(nn.Module):
    """Linear layers `layers_{i}`, the activation between them."""

    def __init__(self, din, hidden, dout, n, act=F.relu, sigmoid=False):
        super().__init__()
        dims = [din] + [hidden] * (n - 1) + [dout]
        self.layers = [Dense(a, b) for a, b in zip(dims, dims[1:])]
        for i, m in enumerate(self.layers):
            self.add_module(f"layers_{i}", m)
        self.act, self.sigmoid = act, sigmoid

    def forward(self, x):
        for i, m in enumerate(self.layers):
            x = m(x) if i == 0 else m(self.act(x))
        return torch.sigmoid(x) if self.sigmoid else x


def _sdpa(q, k, v):
    """(B, H, Nq, D) attention over (B, H, Nk, D); batch dims broadcast."""
    logits = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.softmax(logits, dim=-1) @ v


def _window_partition(x, ws):
    B, H, W, C = x.shape
    x = F.pad(x, (0, 0, 0, (-W) % ws, 0, (-H) % ws))
    Hp, Wp = x.shape[1:3]
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.transpose(2, 3).reshape(-1, ws, ws, C), (Hp, Wp)


def _window_unpartition(wins, ws, pad_hw, hw):
    Hp, Wp = pad_hw
    B = wins.shape[0] // ((Hp // ws) * (Wp // ws))
    x = wins.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).transpose(2, 3)
    return x.reshape(B, Hp, Wp, -1)[:, :hw[0], :hw[1]]


def _max_pool(x, s):   # (B, H, W, C), MaxPool2d(s, s) flooring
    B, H, W, C = x.shape
    x = x[:, :H // s * s, :W // s * s]
    return x.reshape(B, H // s, s, W // s, s, C).amax(dim=(2, 4))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 weights of jax.image.resize's bicubic along one
    axis: Keys' cubic, a = -0.5 (stretched when shrinking), at (i + 0.5) n_in /
    n_out - 0.5, renormalised over the taps inside the input (torch's bicubic:
    a = -0.75, edges clamped)."""
    s = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x = np.abs(s[:, None] - np.arange(n_in)[None]) / max(n_in / n_out, 1.0)
    w = np.where(x >= 1, ((-0.5 * x + 2.5) * x - 4) * x + 2,
                 (1.5 * x - 2.5) * x * x + 1) * (x < 2)
    tot = w.sum(1, keepdims=True)
    w = np.where(np.abs(tot) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1), 0)
    return w * ((s >= -0.5) & (s <= n_in - 0.5))[:, None]


def resize_bicubic(x, h: int, w: int):
    """(B, H, W, C) -> (B, h, w, C) as jax.image.resize(..., "bicubic")."""
    my, mx = (torch.from_numpy(resize_matrix(n, m)).to(x)
              for n, m in ((x.shape[1], h), (x.shape[2], w)))
    return torch.einsum("yh,bhwc,xw->byxc", my, x, mx)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim, dim_out, heads, q_stride=0):
        super().__init__()
        self.qkv, self.proj = Dense(dim, 3 * dim_out), Dense(dim_out, dim_out)
        self.heads, self.q_stride = heads, q_stride

    def forward(self, x):
        B, H, W, _ = x.shape
        q, k, v = self.qkv(x).reshape(B, H * W, 3, self.heads, -1).unbind(2)
        if self.q_stride:
            q = _max_pool(q.reshape(B, H, W, -1), self.q_stride)
            H, W = q.shape[1:3]
            q = q.reshape(B, H * W, self.heads, -1)
        o = _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return self.proj(o.transpose(1, 2).reshape(B, H, W, -1))


class MultiScaleBlock(nn.Module):
    """Pre-norm windowed attention. At a stage's first block the skip
    projects norm1(x) and max-pools it, and q-pooling halves the grid
    inside each window."""

    def __init__(self, dim, dim_out, heads, window, q_stride, mlp_ratio):
        super().__init__()
        self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim_out)
        self.attn = MultiScaleAttention(dim, dim_out, heads, q_stride)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2, _gelu)
        if dim != dim_out:
            self.proj = Dense(dim, dim_out)
        self.window, self.q_stride = window, q_stride

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if hasattr(self, "proj"):
            shortcut = self.proj(x)
            if self.q_stride:
                shortcut = _max_pool(shortcut, self.q_stride)
        ws, hw = self.window, x.shape[1:3]
        if ws:
            x, pad_hw = _window_partition(x, ws)
        x = self.attn(x)
        if self.q_stride and ws:
            ws, hw = ws // self.q_stride, shortcut.shape[1:3]
            pad_hw = tuple(n + (-n) % ws for n in hw)
        if ws:
            x = _window_unpartition(x, ws, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class Hiera(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        C, w0 = cfg.embed_dim, cfg.window_spec[0]
        self.patch_embed = Conv(3, C, cfg.patch_kernel, cfg.patch_stride,
                                cfg.patch_padding)
        self.pos_embed = _p(1, *cfg.window_pos_embed_bkg_spatial_size, C)
        self.pos_embed_window = _p(1, w0, w0, C)
        self.blocks = []
        for i, (d, do, h, ws, qs) in enumerate(block_schedule(cfg)):
            self.blocks.append(MultiScaleBlock(d, do, h, ws, qs,
                                               cfg.mlp_ratio))
            self.add_module(f"blocks_{i}", self.blocks[-1])
        self.ends = cfg.stage_ends

    def forward(self, x):
        """(B, H, W, 3) normalized -> each stage's output, high-res first."""
        x = self.patch_embed(x)
        h, w = x.shape[1:3]
        w0 = self.pos_embed_window.shape[1]
        x = x + (resize_bicubic(self.pos_embed, h, w)
                 + self.pos_embed_window.tile(1, h // w0, w // w0, 1))
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.ends:
                outs.append(x)
        return outs


class FpnNeck(nn.Module):
    """1x1 laterals to d_model (convs_0 on the lowest resolution); 2x
    nearest top-down adds only from stride 32 to 16 (sam2.1)."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        chans = cfg.backbone_channels
        for i, c in enumerate(chans[::-1]):
            self.add_module(f"convs_{i}", Conv(c, cfg.d_model, 1))

    def forward(self, xs):
        n, prev, outs = len(xs) - 1, None, [None] * len(xs)
        for i in range(n, -1, -1):
            prev = getattr(self, f"convs_{n - i}")(xs[i]) + (
                prev.repeat_interleave(2, 1).repeat_interleave(2, 2)
                if i == n - 1 else 0)
            outs[i] = prev
        return outs


class PromptEncoder(nn.Module):
    """Point labels: -1 pad, 0 negative, 1 positive, 2 and 3 box corners;
    pixel coordinates in the model's square input frame."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        d, self.cfg = cfg.d_model, cfg
        self.pe_gaussian = _p(2, d // 2)
        self.point_embeddings = _p(4, d)
        self.not_a_point_embed, self.no_mask_embed = _p(1, d), _p(1, d)
        self.mask_conv0, self.mask_ln0 = Conv(1, 4, 2, 2), LayerNorm(
            4, weight="weight")
        self.mask_conv1, self.mask_ln1 = Conv(4, 16, 2, 2), LayerNorm(
            16, weight="weight")
        self.mask_conv2 = Conv(16, d, 1)

    def _pe(self, coords01):
        c = 2.0 * math.pi * ((2.0 * coords01 - 1.0) @ self.pe_gaussian)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def dense_pe(self):
        g = self.cfg.embed_grid
        ar = (torch.arange(g).to(self.pe_gaussian) + 0.5) / g
        yy, xx = torch.meshgrid(ar, ar, indexing="ij")
        return self._pe(torch.stack([xx, yy], dim=-1))

    def embed_points(self, points, labels, pad=True):
        """points (P, N, 2) pixel xy, labels (P, N) -> (P, N(+1), d)."""
        if pad:
            points = F.pad(points, (0, 0, 0, 1))
            labels = F.pad(labels, (0, 1), value=-1)
        pe = self._pe((points + 0.5) / self.cfg.img_size)
        lab = labels[..., None]
        pe = torch.where(lab == -1, self.not_a_point_embed[0], pe)
        for i in range(4):
            pe = torch.where(lab == i, pe + self.point_embeddings[i], pe)
        return pe

    def embed_boxes(self, boxes):
        """(P, 4) xyxy pixels -> (P, 2, d)."""
        labels = torch.tensor([[2, 3]], device=boxes.device)
        return self.embed_points(boxes.reshape(-1, 2, 2),
                                 labels.expand(len(boxes), 2), pad=False)

    def embed_masks(self, masks):
        """(P, 4g, 4g, 1) -> (P, g, g, d)."""
        x = _gelu(self.mask_ln0(self.mask_conv0(masks)))
        return self.mask_conv2(_gelu(self.mask_ln1(self.mask_conv1(x))))

    def no_mask_dense(self, batch):
        g = self.cfg.embed_grid
        return self.no_mask_embed.reshape(1, 1, 1, -1).expand(batch, g, g, -1)


class DecoderAttention(nn.Module):
    def __init__(self, dim, heads, downsample=1):
        super().__init__()
        di = dim // downsample
        self.q_proj, self.k_proj = Dense(dim, di), Dense(dim, di)
        self.v_proj, self.out_proj = Dense(dim, di), Dense(di, dim)
        self.heads = heads

    def forward(self, q, k, v):
        def split(t):
            return t.unflatten(-1, (self.heads, -1)).transpose(1, 2)

        o = _sdpa(split(self.q_proj(q)), split(self.k_proj(k)),
                  split(self.v_proj(v)))
        return self.out_proj(o.transpose(1, 2).flatten(2))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SAM2Config, skip_first_layer_pe: bool):
        super().__init__()
        d, h = cfg.d_model, cfg.decoder_heads
        self.self_attn = DecoderAttention(d, h)
        self.cross_attn_token_to_image = DecoderAttention(d, h, 2)
        self.cross_attn_image_to_token = DecoderAttention(d, h, 2)
        self.mlp = MLP(d, cfg.decoder_mlp_dim, d, 2)
        for i in range(1, 5):
            self.add_module(f"norm{i}", LayerNorm(d, 1e-5))
        self.skip = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            queries + query_pe, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        keys = self.norm4(keys + self.cross_attn_image_to_token(
            k, queries + query_pe, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.layers = [TwoWayAttentionBlock(cfg, i == 0)
                       for i in range(cfg.decoder_depth)]
        for i, m in enumerate(self.layers):
            self.add_module(f"layers_{i}", m)
        self.final_attn_token_to_image = DecoderAttention(
            cfg.d_model, cfg.decoder_heads, 2)
        self.norm_final_attn = LayerNorm(cfg.d_model, 1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(
                queries + point_embedding, keys + image_pe, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    """The two-way decoder with SAM2's object-score token and head, the
    sigmoid IoU head and the high-res skips."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        d, M = cfg.d_model, cfg.num_mask_tokens
        self.transformer = TwoWayTransformer(cfg)
        self.obj_score_token, self.iou_token = _p(1, d), _p(1, d)
        self.mask_tokens = _p(M, d)
        self.upscale_dc1, self.upscale_dc2 = ConvT(d, d // 4), ConvT(
            d // 4, d // 8)
        self.upscale_ln = LayerNorm(d // 4, weight="weight")
        self.hyper = [MLP(d, d, d // 8, 3) for _ in range(M)]
        for i, m in enumerate(self.hyper):
            self.add_module(f"hyper_mlps_{i}", m)
        self.iou_head = MLP(d, d, M, 3, sigmoid=True)
        self.obj_score_head = MLP(d, d, 1, 3)

    def forward(self, image_embed, image_pe, sparse, dense, feat_s0,
                feat_s1):
        """image_embed, dense (1 or P, g, g, d), image_pe (g, g, d), sparse
        (P, T, d), feat_s0 (1 or P, 4g, 4g, d/8), feat_s1 (.., 2g, 2g, d/4)
        -> (masks (P, M, 4g, 4g), iou (P, M), obj (P, 1))."""
        P, M = sparse.shape[0], self.mask_tokens.shape[0]
        out = torch.cat([self.obj_score_token, self.iou_token,
                         self.mask_tokens])
        tokens = torch.cat([out.expand(P, -1, -1), sparse], dim=1)
        g = image_embed.shape[1]
        src = (image_embed + dense).flatten(1, 2)
        hs, src = self.transformer(src, image_pe.reshape(1, g * g, -1),
                                   tokens)
        up = _gelu(self.upscale_ln(
            self.upscale_dc1(src.reshape(P, g, g, -1)) + feat_s1))
        up = _gelu(self.upscale_dc2(up) + feat_s0)
        hyper = torch.stack([m(hs[:, 2 + i]) for i, m in
                             enumerate(self.hyper)], dim=1)
        masks = torch.einsum("pmc,pxyc->pmxy", hyper, up)
        return masks, self.iou_head(hs[:, 1]), self.obj_score_head(hs[:, 0])


class SAM2ImageModel(nn.Module):
    """Embed an image once (`embed_image`), then decode any batch of point
    prompts (`decode_points`, three masks a point)."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg, d = cfg, cfg.d_model
        self.trunk, self.neck = Hiera(cfg), FpnNeck(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)
        self.no_mem_embed = _p(1, 1, d)
        self.conv_s0, self.conv_s1 = Conv(d, d // 8, 1), Conv(d, d // 4, 1)

    def embed_image(self, image):
        """(B, S, S, 3), normalized with ImageNet's mean and std as if it
        were in [0, 1] -> image_embed (stride 16, plus no_mem_embed),
        feat_s0 and feat_s1 (strides 4 and 8, projected)."""
        image = image.to(self.no_mem_embed)
        mean = image.new_tensor([0.485, 0.456, 0.406])
        std = image.new_tensor([0.229, 0.224, 0.225])
        s0, s1, s16 = self.neck(self.trunk((image - mean) / std))[:3]
        return {"image_embed": s16 + self.no_mem_embed[0, 0],
                "feat_s0": self.conv_s0(s0), "feat_s1": self.conv_s1(s1)}

    def decode_points(self, feats, points, labels=None):
        """Batch-1 features, (P, 2) pixel xy (labels default positive) ->
        (masks (P, 3, 4g, 4g) logits, iou (P, 3), obj (P, 1))."""
        pe = self.prompt_encoder
        if labels is None:
            labels = torch.ones(len(points), dtype=torch.long,
                                device=points.device)
        sparse = pe.embed_points(points[:, None].to(self.no_mem_embed),
                                 labels[:, None])
        masks, iou, obj = self.mask_decoder(
            feats["image_embed"], pe.dense_pe(), sparse, pe.no_mask_dense(1),
            feats["feat_s0"], feats["feat_s1"])
        return masks[:, 1:], iou[:, 1:], obj

    def forward(self, image, points, labels=None):
        return self.decode_points(self.embed_image(image), points, labels)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

# checkpoint keys of SAM2's video memory, which the image model does not run
VIDEO_ONLY = ("memory_attention.", "memory_encoder.", "obj_ptr_",
              "mask_downsample.", "maskmem_tpos_enc", "no_mem_pos_enc",
              "no_obj_embed_spatial", "no_obj_ptr")


def checkpoint_names(cfg: SAM2Config) -> list:
    """(port key, public key, layout) of every parameter: "T" Linear, "conv"
    (out, in, kh, kw), "convt" ConvTranspose2d flipped in space, "nchw" a (1,
    C, h, w) embedding, "cat" four (1, d) embeddings."""
    names = []

    def add(p, t, how=""):
        names.append((p, t, how))

    def dense(p, t, how="T"):
        add(f"{p}.kernel", f"{t}.weight", how)
        add(f"{p}.bias", f"{t}.bias")

    def ln(p, t, w="scale"):
        add(f"{p}.{w}", f"{t}.weight")
        add(f"{p}.bias", f"{t}.bias")

    def mlp(p, t, n):
        for i in range(n):
            dense(f"{p}.layers_{i}", f"{t}.layers.{i}")

    tp = "image_encoder.trunk"
    dense("trunk.patch_embed", f"{tp}.patch_embed.proj", "conv")
    add("trunk.pos_embed", f"{tp}.pos_embed", "nchw")
    add("trunk.pos_embed_window", f"{tp}.pos_embed_window", "nchw")
    for i, (dim, dim_out, *_) in enumerate(block_schedule(cfg)):
        p, t = f"trunk.blocks_{i}", f"{tp}.blocks.{i}"
        ln(f"{p}.norm1", f"{t}.norm1")
        ln(f"{p}.norm2", f"{t}.norm2")
        dense(f"{p}.attn.qkv", f"{t}.attn.qkv")
        dense(f"{p}.attn.proj", f"{t}.attn.proj")
        mlp(f"{p}.mlp", f"{t}.mlp", 2)
        if dim != dim_out:
            dense(f"{p}.proj", f"{t}.proj")
    for i in range(len(cfg.stages)):
        dense(f"neck.convs_{i}", f"image_encoder.neck.convs.{i}.conv", "conv")
    pp, pe = "sam_prompt_encoder", "prompt_encoder"
    add(f"{pe}.pe_gaussian",
        f"{pp}.pe_layer.positional_encoding_gaussian_matrix")
    add(f"{pe}.point_embeddings", f"{pp}.point_embeddings", "cat")
    add(f"{pe}.not_a_point_embed", f"{pp}.not_a_point_embed.weight")
    add(f"{pe}.no_mask_embed", f"{pp}.no_mask_embed.weight")
    for j, i in enumerate((0, 3, 6)):
        dense(f"{pe}.mask_conv{j}", f"{pp}.mask_downscaling.{i}", "conv")
    for j, i in enumerate((1, 4)):
        ln(f"{pe}.mask_ln{j}", f"{pp}.mask_downscaling.{i}", "weight")
    mp, md = "sam_mask_decoder", "mask_decoder"

    def attn(p, t):
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{p}.{n}", f"{t}.{n}")

    for i in range(cfg.decoder_depth):
        p, t = f"{md}.transformer.layers_{i}", f"{mp}.transformer.layers.{i}"
        for n in ("self_attn", "cross_attn_token_to_image",
                  "cross_attn_image_to_token"):
            attn(f"{p}.{n}", f"{t}.{n}")
        mlp(f"{p}.mlp", f"{t}.mlp", 2)
        for n in range(1, 5):
            ln(f"{p}.norm{n}", f"{t}.norm{n}")
    n = "final_attn_token_to_image"
    attn(f"{md}.transformer.{n}", f"{mp}.transformer.{n}")
    n = "norm_final_attn"
    ln(f"{md}.transformer.{n}", f"{mp}.transformer.{n}")
    for n in ("obj_score_token", "iou_token", "mask_tokens"):
        add(f"{md}.{n}", f"{mp}.{n}.weight")
    dense(f"{md}.upscale_dc1", f"{mp}.output_upscaling.0", "convt")
    ln(f"{md}.upscale_ln", f"{mp}.output_upscaling.1", "weight")
    dense(f"{md}.upscale_dc2", f"{mp}.output_upscaling.3", "convt")
    mlp(f"{md}.iou_head", f"{mp}.iou_prediction_head", 3)
    mlp(f"{md}.obj_score_head", f"{mp}.pred_obj_score_head", 3)
    for i in range(cfg.num_mask_tokens):
        mlp(f"{md}.hyper_mlps_{i}", f"{mp}.output_hypernetworks_mlps.{i}", 3)
    add("no_mem_embed", "no_mem_embed")
    dense("conv_s0", f"{mp}.conv_s0", "conv")
    dense("conv_s1", f"{mp}.conv_s1", "conv")
    return names


def param_shapes(cfg: SAM2Config) -> dict:
    """{port key: shape} of SAM2ImageModel(cfg), built on the meta device."""
    with torch.device("meta"):
        model = SAM2ImageModel(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _from_torch(t, how):
    return {"T": lambda: t.T, "conv": lambda: t.permute(2, 3, 1, 0),
            "convt": lambda: t.flip(2, 3).permute(2, 3, 0, 1),
            "nchw": lambda: t.permute(0, 2, 3, 1)}.get(how, lambda: t)()


def _to_torch(t, how):
    return {"T": lambda: t.T, "conv": lambda: t.permute(3, 2, 0, 1),
            "convt": lambda: t.permute(2, 3, 0, 1).flip(2, 3),
            "nchw": lambda: t.permute(0, 3, 1, 2)}.get(how, lambda: t)()


def convert_torch_state_dict(sd: Mapping, cfg: SAM2Config) -> dict:
    """A public SAM2 state dict (tensors or numpy) -> the port's f32 tensors,
    as strict as the reference's: a missing key, a wrong shape or an unconsumed
    key outside the video memory raises, naming it."""
    shapes, out, used = param_shapes(cfg), {}, set()

    def take(k):
        if k not in sd:
            raise KeyError(f"SAM2 converter: missing checkpoint key {k}")
        used.add(k)
        v = sd[k]
        return (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                ).to(torch.float32)

    for pk, tk, how in checkpoint_names(cfg):
        t = torch.cat([take(f"{tk}.{i}.weight") for i in range(4)]) \
            if how == "cat" else _from_torch(take(tk), how)
        if tuple(t.shape) != shapes[pk]:
            raise ValueError(f"SAM2 converter: {tk} gives {pk} the shape "
                             f"{tuple(t.shape)}, expected {shapes[pk]}")
        out[pk] = t.contiguous()
    left = sorted(k for k in sd if k not in used
                  and not any(k.startswith(p) or p in k for p in VIDEO_ONLY))
    if left:
        raise KeyError("SAM2 converter: unexpected unconsumed checkpoint "
                       f"keys (naming drift?): {left[:10]}")
    return out


def to_torch_state_dict(sd: Mapping, cfg: SAM2Config) -> dict:
    """The port's state dict -> the public checkpoint's names and layouts
    (the converter run backwards)."""
    out = {}
    for pk, tk, how in checkpoint_names(cfg):
        if how == "cat":
            out.update({f"{tk}.{i}.weight": sd[pk][i:i + 1].clone()
                        for i in range(4)})
        else:
            out[tk] = _to_torch(sd[pk], how).contiguous()
    return out


def init_state_dict(cfg: SAM2Config, seed: int = 0, device="cpu") -> dict:
    """Seeded weights on `device`: kernels N(0, 1 / fan_in), the patch kernel
    255 times smaller (the AMG feeds 0-255 pixels), LayerNorm weights 1 + N(0,
    0.02), biases and embeddings N(0, 0.02), tokens and the Fourier matrix N(0,
    1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, shape in param_shapes(cfg).items():
        leaf = k.rsplit(".", 1)[-1]
        t = torch.randn(shape, generator=g, device=device)
        if leaf == "kernel":
            t /= math.sqrt(math.prod(shape[:-1])) * (
                255 if k == "trunk.patch_embed.kernel" else 1)
        elif leaf in ("scale", "weight"):
            t = 1 + 0.02 * t
        elif leaf == "bias" or "pos_embed" in k or "no_mem" in k:
            t *= 0.02
        out[k] = t
    return out


def load_flax_params(module: nn.Module, tree: Mapping):
    """The JAX package's parameters (`model.init`'s tree, with or without
    its "params" root; numpy or jax leaves) into `module`, strictly."""
    tree = tree.get("params", tree)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = torch.as_tensor(np.array(v, np.float32))

    walk(tree, "")
    module.load_state_dict(flat, strict=True)
    return module


def build_model(cfg: SAM2Config, state_dict: Mapping, device="cpu"):
    """SAM2ImageModel(cfg) holding `state_dict` on `device`, in eval mode."""
    with torch.device("meta"):
        model = SAM2ImageModel(cfg)
    model.load_state_dict({k: torch.as_tensor(v).to(device, torch.float32)
                           for k, v in state_dict.items()}, assign=True)
    return model.eval()
