"""Transformer building blocks shared by the VGGT encoder, aggregator and
heads (counterpart of vggt_slam_tpu/models/vggt/modules.py).

Parameters keep the flax names and layouts of the reference so a flat
checkpoint keyed by flax path loads with a plain rename (models/vggt/
convert.py): Dense kernels are (in, out), conv kernels (kh, kw, in, out),
LayerNorm params `scale`/`bias`. Parameters stay f32; compute runs in the
config dtype, and LayerNorms in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vggt_slam_tpu_torch.ops import attention as attn_ops


def rope_2d_angles(positions: torch.Tensor, head_dim: int, base: float):
    """Rotary angles for (N, 2) float (y, x) positions -> (cos, sin), each
    (N, head_dim // 2): half the pairs rotate with y, half with x."""
    d_axis = head_dim // 4
    freq = 1.0 / (base ** (torch.arange(d_axis, dtype=torch.float32,
                                        device=positions.device) / d_axis))
    ang = torch.cat([positions[:, 0:1] * freq[None], positions[:, 1:2]
                     * freq[None]], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotary embedding on (..., N, D) with (N, D/2) tables, in x's dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos.to(x.dtype)
    s = sin.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _param(*shape):
    return nn.Parameter(torch.empty(*shape))


class Dense(nn.Module):
    """flax nn.Dense: y = x @ kernel + bias, computed in `dtype`."""

    def __init__(self, din: int, dout: int, dtype=torch.float32,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(din, dout)
        self.bias = _param(dout) if use_bias else None

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """flax nn.LayerNorm in f32 (returns f32)."""

    def __init__(self, dim: int, eps: float = 1e-5, use_scale: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.scale = _param(dim) if use_scale else None
        self.bias = _param(dim) if use_bias else None

    def forward(self, x):
        return F.layer_norm(x.float(), (self.dim,), self.scale, self.bias,
                            self.eps)


class Conv(nn.Module):
    """flax nn.Conv on NCHW tensors with an HWIO kernel."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.kernel = _param(k, k, cin, cout)
        self.bias = _param(cout) if use_bias else None

    def forward(self, x):
        w = self.kernel.permute(3, 2, 0, 1).to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), w, b, stride=self.stride,
                        padding=self.padding)


class Mlp(nn.Module):
    def __init__(self, din: int, hidden: int, dout: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(din, hidden, dtype)
        self.fc2 = Dense(hidden, dout, dtype)

    def forward(self, x):
        # tanh-approximate GELU, as the reference.
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.init_value = init_value
        self.gamma = _param(dim)

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class _LNParams(nn.Module):
    """qk-norm parameters (`scale`, `bias`), applied by the attention."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = _param(dim)
        self.bias = _param(dim)


class _FusedQKV(nn.Module):
    def __init__(self, dim: int, use_bias: bool):
        super().__init__()
        self.kernel = _param(dim, 3 * dim)
        self.bias = _param(3 * dim) if use_bias else None


class Attention(nn.Module):
    """Multi-head self-attention with optional 2D rope, qk-norm and a merged
    key/value set: `rope_cos`/`rope_sin` full-length (N, head_dim // 2) tables;
    `kv_map` maps (B, N, C) tokens to the (B, n_kv, C) key/value source.
    qk-norm runs before rope, both inside the kernel on the flash path, except
    with `qk_int8` (scales taken before the LN): then the LN runs outside."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 attn_impl: str = "flash", qkv_bias: bool = True,
                 qk_norm: bool = False, ln_eps: float = 1e-5,
                 softmax_mode: str = "online", qk_int8: bool = False):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.ln_eps = ln_eps
        self.softmax_mode = softmax_mode
        self.qk_int8 = qk_int8
        self.qkv = _FusedQKV(dim, qkv_bias)
        if qk_norm:
            self.q_norm = _LNParams(dim // num_heads)
            self.k_norm = _LNParams(dim // num_heads)
        self.qk_norm = qk_norm
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x, rope_cos=None, rope_sin=None, valid_len=None,
                kv_map=None, kv_valid_len=None, kv_rope_cos=None,
                kv_rope_sin=None, kv_bias=None):
        B, N, C = x.shape
        H = self.num_heads
        Dh = C // H
        w = self.qkv.kernel.to(self.dtype)
        kv_src = x if kv_map is None else kv_map(x)
        q = torch.matmul(x, w[:, :C])
        k = torch.matmul(kv_src, w[:, C:2 * C])
        v = torch.matmul(kv_src, w[:, 2 * C:])
        if self.qkv.bias is not None:
            b = self.qkv.bias.to(self.dtype)
            q = q + b[:C]
            k = k + b[C:2 * C]
            v = v + b[2 * C:]
        Nk = k.shape[1]
        if kv_map is None:
            kv_rope_cos, kv_rope_sin = rope_cos, rope_sin
            kv_valid_len = valid_len

        flash = self.attn_impl == "flash"
        qk_ln = None
        if self.qk_norm:
            params = (self.q_norm.scale, self.q_norm.bias, self.k_norm.scale,
                      self.k_norm.bias)
            if flash and rope_cos is not None and not self.qk_int8:
                qk_ln = params
            else:
                q = attn_ops.ln_fast(q.view(B, N, H, Dh), params[0],
                                     params[1], self.ln_eps).view(B, N, C)
                k = attn_ops.ln_fast(k.view(B, Nk, H, Dh), params[2],
                                     params[3], self.ln_eps).view(B, Nk, C)
        rope_q = rope_k = None
        if rope_cos is not None:
            if flash:
                rope_q = (rope_cos, rope_sin)
                rope_k = (kv_rope_cos, kv_rope_sin)
            else:
                q = apply_rope(q.view(B, N, H, Dh).transpose(1, 2), rope_cos,
                               rope_sin).transpose(1, 2).reshape(B, N, C)
                k = apply_rope(k.view(B, Nk, H, Dh).transpose(1, 2),
                               kv_rope_cos, kv_rope_sin
                               ).transpose(1, 2).reshape(B, Nk, C)
        # The CUDA kernels take bf16: an f32 module (SALAD's backbone) gives
        # them bf16 q, k, v and casts the output back.
        cast = flash and q.device.type == "cuda" and q.dtype != torch.bfloat16
        if cast:
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        out = attn_ops.attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            impl=self.attn_impl, valid_len=kv_valid_len, rope_q=rope_q,
            rope_k=rope_k, kv_bias=kv_bias, softmax=self.softmax_mode,
            qk_ln=qk_ln, qk_ln_eps=self.ln_eps, num_heads=H,
            qk_int8=self.qk_int8)
        return self.proj(out.to(self.dtype) if cast else out)


class Block(nn.Module):
    """Pre-norm transformer block with optional LayerScale."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 layerscale=None, dtype=torch.float32,
                 attn_impl: str = "flash", qk_norm: bool = False,
                 ln_eps: float = 1e-5, softmax_mode: str = "online",
                 qk_int8: bool = False):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, ln_eps)
        self.attn = Attention(dim, num_heads, dtype, attn_impl,
                              qk_norm=qk_norm, ln_eps=ln_eps,
                              softmax_mode=softmax_mode, qk_int8=qk_int8)
        self.norm2 = LayerNorm(dim, ln_eps)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim, dtype)
        if layerscale is not None:
            self.ls1 = LayerScale(dim, layerscale)
            self.ls2 = LayerScale(dim, layerscale)
        self.layerscale = layerscale

    def forward(self, x, rope_cos=None, rope_sin=None, valid_len=None,
                kv_map=None, kv_valid_len=None, kv_rope_cos=None,
                kv_rope_sin=None, kv_bias=None):
        h = self.norm1(x).to(self.dtype)
        h = self.attn(h, rope_cos, rope_sin, valid_len, kv_map=kv_map,
                      kv_valid_len=kv_valid_len, kv_rope_cos=kv_rope_cos,
                      kv_rope_sin=kv_rope_sin, kv_bias=kv_bias)
        x = x + (self.ls1(h) if self.layerscale is not None else h)
        h = self.norm2(x).to(self.dtype)
        h = self.mlp(h)
        return x + (self.ls2(h) if self.layerscale is not None else h)


def run_block(block, remat: bool, *args, **kw):
    """block(*args, **kw), under activation checkpointing when `remat` and
    autograd records (the reference's nn.remat): the backward pass then
    recomputes the block's activations from its inputs."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False, **kw)
    return block(*args, **kw)


def lecun_std(shape) -> float:
    """Std of flax's lecun_normal for a kernel whose last axis is fan-out."""
    return 1.0 / math.sqrt(math.prod(shape[:-1]))
