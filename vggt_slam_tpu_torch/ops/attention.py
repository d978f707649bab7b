"""Multi-head attention for the VGGT trunk (counterpart of
vggt_slam_tpu/ops/attention.py): plain versions and the CUDA
flash-attention kernels, forward and backward, on packed (B, N, H*D) q, k,
v (the projections' output: no transposes).

* `naive_attention`, `chunked_attention`: plain (B, H, N, D) references
  with a `valid_len` key mask and a per-key `kv_bias`.
* `flash_single` / `flash_single_ref`: `_flash_single_kernel` (exact
  softmax; encoder, frame blocks, camera trunk).
* `flash_multi` / `flash_multi_ref`: `_flash_kernel`'s default composite
  (static-max softmax, qk-LN, rope, kv_bias, valid_len; global blocks).
* `flash_attention`: the reference's selection rule; `attention`
  dispatches by name; `return_stats` gives the row stats (m, l).
* `qk_int8=True`: the reference's int8 QK^T (`int8_scales`, q and k
  quantized after rope, s32 logits, bf16 PV), counted as
  `flash_single_i8` / `flash_multi_i8`; on CUDA the pre-pass computes the
  scales bit for bit (`int8_scales_cuda`).
* `flash_bwd` / `flash_bwd_ref`: one CUDA call for `_flash_bwd_dq_kernel`
  and `_flash_bwd_dkv_kernel`; `FlashAttentionGrad` /
  `flash_attention_grad` pair it with the forward as `impl="flash_grad"`.

A wrapper takes its plain version for CPU tensors only; on CUDA it
launches the kernel (csrc/flash_attention.cu, flash_attention_bwd.cu) or
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30
LOG2E = math.log2(math.e)

# Launches of each CUDA kernel in this process (plain-version calls are not
# counted), one key per TPU kernel: a `flash_bwd` call computes both
# backward kernels' functions and adds one to each of their keys. Read by
# chip_smoke.py to show the main path ran the kernels.
LAUNCHES = {"flash_single": 0, "flash_multi": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "flash_single_i8": 0, "flash_multi_i8": 0}
HEAD_DIMS = (32, 64, 128)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Plain (B, H, N, D) references

def _key_mask(valid_len, nk, device):
    return torch.arange(nk, device=device) < valid_len


def naive_attention(q, k, v, valid_len=None, kv_bias=None):
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          (k * scale).to(v.dtype).float())
    if kv_bias is not None:
        logits = logits + kv_bias.float()[None, None, None, :]
    if valid_len is not None:
        mask = _key_mask(valid_len, k.shape[2], q.device)
        logits = torch.where(mask[None, None, None, :], logits, _NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def chunked_attention(q, k, v, valid_len=None, chunk=1024, kv_bias=None):
    """Memory-bounded attention: full softmax per chunk of queries."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    kmask = None if valid_len is None else _key_mask(valid_len, k.shape[2],
                                                     q.device)
    kf, vf = k.float(), v.float()
    outs = []
    for s in range(0, q.shape[2], chunk):
        logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, s:s + chunk].float(),
                              kf) * scale
        if kv_bias is not None:
            logits = logits + kv_bias.float()[None, None, None, :]
        if kmask is not None:
            logits = torch.where(kmask[None, None, None, :], logits, _NEG_INF)
        w = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype).float(),
                                 vf).to(v.dtype))
    return torch.cat(outs, dim=2)


# Kernel semantics: tile preparation and the plain versions

def ln_fast(x, g, b, eps):
    """Per-row LayerNorm over the last dim with f32 fast-variance stats
    (Var = E[x^2] - E[x]^2 clipped at 0), output in x's dtype - the qk-norm
    of the reference (`_ln_in_kernel`)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float()
            + b.float()).to(x.dtype)


def rope_tables(cos, sin, scale: float):
    """(N, D/2) cos/sin -> full-width (N, D) f32 tables (C, S') with `scale`
    folded in: rope(x) = x*C + [x2|x1]*S'."""
    C = torch.cat([cos, cos], -1).float() * scale
    S = torch.cat([-sin, sin], -1).float() * scale
    return C, S


def _prep(x, num_heads, ln, ln_eps, rope, scale):
    """Packed (B, N, H*D) -> prepared (B, H, N, D) in x's dtype: LN, then
    rope with `scale` in its tables, or without rope a plain scale."""
    B, N, HD = x.shape
    D = HD // num_heads
    t = x.view(B, N, num_heads, D).transpose(1, 2)
    if ln is not None:
        t = ln_fast(t, ln[0], ln[1], ln_eps)
    if rope is not None:
        C, S = rope_tables(rope[0], rope[1], scale)
        tf = t.float()
        sw = torch.cat([tf[..., D // 2:], tf[..., :D // 2]], -1)
        t = (tf * C + sw * S).to(x.dtype)
    elif scale != 1.0:
        t = (t.float() * scale).to(x.dtype)
    return t


def int8_scales(q, k, num_heads, rope: bool):
    """Per-(batch, head) int8 scales of packed q, k (reference
    attention.py:606-629): amax the largest rope pair norm, else the largest
    |x|, at least 1e-6. Returns (3, B*H) f32: 127/amax_q, 127/amax_k (one
    division: a reciprocal and a product can be an ulp off) and amax_q amax_k
    log2(e) / (sqrt(D) 127^2)."""
    B, H = q.shape[0], num_heads
    D = q.shape[2] // H

    def amax(x):
        xf = x.view(B, x.shape[1], H, D).float()
        if rope:
            x1, x2 = xf[..., :D // 2], xf[..., D // 2:]
            xf = torch.sqrt(x1 * x1 + x2 * x2)
        return xf.abs().amax(dim=(1, 3)).clamp_min(1e-6).reshape(-1)

    sq, sk = amax(q), amax(k)
    c127 = torch.full_like(sq, 127.0)
    return torch.stack([c127 / sq, c127 / sk, sq * sk * _dequant(D)])


def _dequant(D):
    """The f32 dequant constant's factor log2(e) / sqrt(D) / 127^2."""
    c_scale = LOG2E / math.sqrt(D)
    return c_scale / (127.0 * 127.0)


def _quant_i8(t, inv):
    """(B, H, N, D) -> int8 grid values in f32 (`_quant_i8`)."""
    B, H = t.shape[:2]
    return torch.round(t.float() * inv.view(B, H, 1, 1)).clamp(-127, 127)


def _check_args(q, k, v, num_heads, rope_q, rope_k, qk_ln, qk_int8=False):
    if q.dim() != 3 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"packed q/k/v expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] % num_heads:
        raise ValueError("H*D not divisible by num_heads")
    if (rope_q is None) != (rope_k is None):
        raise ValueError("rope_q and rope_k go together")
    if qk_ln is not None and rope_q is None:
        raise ValueError("qk_ln requires in-kernel rope (as the reference)")
    if qk_ln is not None and qk_int8:
        raise ValueError("qk_ln and qk_int8 do not go together: the int8 "
                         "scales are taken before the LN (as the reference)")


def _plain(q, k, v, num_heads, valid_len, rope_q, rope_k, kv_bias, qk_ln,
           qk_ln_eps, smax, return_stats=False, qk_int8=False, q_chunk=2048):
    """Shared plain version: `smax` None = the running max (kernel 1), else the
    static bound per (batch, head) (kernel 2); `return_stats` adds (B, H, Nq)
    f32 m, l; `qk_int8` quantizes q, k by `int8_scales` and takes QK^T as an
    exact f32 product of the int8 values."""
    _check_args(q, k, v, num_heads, rope_q, rope_k, qk_ln, qk_int8)
    B, Nq, HD = q.shape
    Nk = k.shape[1]
    H = num_heads
    D = HD // H
    c_scale = LOG2E / math.sqrt(D)
    vl = Nk if valid_len is None else max(0, min(int(valid_len), Nk))
    sc2 = None
    if qk_int8:
        inv_q, inv_k, sc2 = int8_scales(q, k, H, rope_q is not None)
        qp = _quant_i8(_prep(q, H, None, qk_ln_eps, rope_q, 1.0), inv_q)
        kp = _quant_i8(_prep(k, H, None, qk_ln_eps, rope_k, 1.0), inv_k)
        sc2 = sc2.view(B, H, 1, 1)
    else:
        qp = _prep(q, H, None if qk_ln is None else qk_ln[0:2], qk_ln_eps,
                   rope_q, c_scale)
        kp = _prep(k, H, None if qk_ln is None else qk_ln[2:4], qk_ln_eps,
                   rope_k, 1.0).float()
    vf = v.view(B, Nk, H, D).transpose(1, 2).float()
    keep = torch.arange(Nk, device=q.device) < vl
    vf = torch.where(keep[None, None, :, None], vf, 0.0)
    bias = None if kv_bias is None else kv_bias.float() * LOG2E
    out = torch.empty(B, H, Nq, D, dtype=q.dtype, device=q.device)
    m_all = torch.empty(B, H, Nq, dtype=torch.float32, device=q.device)
    l_all = torch.empty_like(m_all)
    for s in range(0, Nq, q_chunk):
        logits = torch.matmul(qp[:, :, s:s + q_chunk].float(),
                              kp.transpose(-1, -2))
        if sc2 is not None:
            logits = logits * sc2
        if bias is not None:
            logits = logits + bias
        logits = torch.where(keep, logits, _NEG_INF)
        if smax is None:
            m = logits.amax(-1, keepdim=True)
        else:
            m = smax.float().view(B, H, 1, 1)
        p = torch.exp2(logits - m)
        if vl < Nk:   # masked keys add nothing to l, in a row of no key too
            p = torch.where(keep, p, 0.0)
        lsum = p.sum(-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vf) / lsum.clamp_min(1e-30)
        out[:, :, s:s + q_chunk] = o.to(q.dtype)
        m_all[:, :, s:s + q_chunk] = m[..., 0]
        l_all[:, :, s:s + q_chunk] = lsum[..., 0]
    out = out.transpose(1, 2).reshape(B, Nq, HD)
    return (out, m_all, l_all) if return_stats else out


def flash_single_ref(q, k, v, *, num_heads, valid_len=None, rope_q=None,
                     rope_k=None, kv_bias=None, qk_ln=None, qk_ln_eps=1e-5,
                     qk_int8=False, return_stats=False):
    """Plain `flash_single`: packed (B, N, H*D) exact softmax attention in f32
    with the kernel's bf16 roundings. `rope_q`/`rope_k`: (cos, sin) (N, D/2);
    `qk_ln`: (gq, bq, gk, bk) per-head-dim LN (needs rope); `kv_bias`: (Nk,)
    natural-log bias; `valid_len`: keys from it on masked; `return_stats`:
    (out, m, l), (B, H, Nq) f32 exp2-domain row max and sum; `qk_int8`: see
    `_plain`."""
    return _plain(q, k, v, num_heads, valid_len, rope_q, rope_k, kv_bias,
                  qk_ln, qk_ln_eps, None, return_stats, qk_int8)


def flash_multi_ref(q, k, v, smax, *, num_heads, valid_len=None,
                    rope_q=None, rope_k=None, kv_bias=None, qk_ln=None,
                    qk_ln_eps=1e-5, qk_int8=False, return_stats=False):
    """Plain version of `flash_multi`: as `flash_single_ref`, but the
    softmax shift is the static per-(batch, head) bound `smax` (B*H,) in the
    exp2 domain instead of the row max (and is the stats' m)."""
    return _plain(q, k, v, num_heads, valid_len, rope_q, rope_k, kv_bias,
                  qk_ln, qk_ln_eps, smax, return_stats, qk_int8)


# CUDA kernel wrappers

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_COMMON = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P,
           _F, _P, _P, _P, _P, _P]
_I8_COMMON = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _P, _P,
              _P, _P, _P]
_SIGNATURES = {
    "flash_single_fwd": (_COMMON + [_P, _P, _P], ctypes.c_int),
    "flash_multi_fwd": (_COMMON + [_P, _P, _P, _P], ctypes.c_int),
    "flash_single_i8_fwd": (_I8_COMMON + [_P, _P, _P], ctypes.c_int),
    "flash_multi_i8_fwd": (_I8_COMMON + [_P, _P, _P, _P], ctypes.c_int),
    "flash_i8_scales": ([_P, _P, _P] + [_I] * 6 + [_F, _P, _P],
                        ctypes.c_int),
    "flash_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "flash_fwd_design_launches": ([ctypes.POINTER(ctypes.c_longlong)], None),
}
_BWD_SIGNATURES = {
    "flash_bwd": ([_P] * 12 + [_I] * 6 + [_F, _F, _P], ctypes.c_int),
    "flash_bwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "flash_bwd_design_launches": ([ctypes.POINTER(ctypes.c_longlong)], None),
    "flash_bwd_scratch_floats": (
        [_I] * 4 + [ctypes.POINTER(ctypes.c_longlong)], None),
}


def kernel_library():
    """Build (if stale) and load csrc/flash_attention.cu."""
    from vggt_slam_tpu_torch.ops import cuda_build
    return cuda_build.load("flash_attention", _SIGNATURES)


def forward_design_launches() -> dict:
    """The forward kernels' launches in this process by design, counted by
    the C launcher at each launch: "tma_wgmma" for flash_fwd_sm90
    (csrc/flash_sm90.cuh), the one design at every head dim."""
    out = (ctypes.c_longlong * 1)()
    kernel_library().flash_fwd_design_launches(out)
    return {"tma_wgmma": out[0]}


def bwd_kernel_library():
    """Build (if stale) and load csrc/flash_attention_bwd.cu."""
    from vggt_slam_tpu_torch.ops import cuda_build
    return cuda_build.load("flash_attention_bwd", _BWD_SIGNATURES)


def bwd_design_launches() -> dict:
    """The backward's launches in this process by design, counted by the C
    launcher at each `flash_bwd` call: "tma_wgmma" for flash_bwd_sm90
    (csrc/flash_bwd_sm90.cuh), the one design at every head dim."""
    out = (ctypes.c_longlong * 1)()
    bwd_kernel_library().flash_bwd_design_launches(out)
    return {"tma_wgmma": out[0]}


def _f32(t, shape, name, device, align=False):
    """t as a contiguous f32 tensor of `shape` on `device`, 16-byte aligned
    with `align` (the TMA map of kv_bias reads it so); t itself where it is
    one already."""
    if t is None:
        return None
    if not (t.dtype is torch.float32 and t.device == device
            and t.is_contiguous() and not (align and t.data_ptr() % 16)):
        t = t.to(device=device, dtype=torch.float32).contiguous()
        if align and t.data_ptr() % 16:
            t = t.clone()
    if t.shape != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    return t


def _check_cuda_tensors(dev, named):
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16 {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _raw_stream(dev):
    """The handle of `dev`'s current CUDA stream: torch's own accessor of
    the raw handle where this build of torch has it (a fraction of a
    microsecond), else through the public Stream object (a few)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _call_on(dev, fn, args):
    """fn(*args, stream) on `dev`'s current stream, with `dev` made the
    current device only where it is not already."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, _raw_stream(dev))
    with torch.cuda.device(dev):
        return fn(*args, _raw_stream(dev))


def _head_dim(HD, num_heads):
    D = HD // num_heads
    if D not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head dim 32, 64 or 128, "
                         f"got {D}")
    return D


def _launch(entry, q, k, v, num_heads, valid_len, rope_q, rope_k, kv_bias,
            qk_ln, qk_ln_eps, smax, return_stats, qk_int8, out=None):
    """Launch `entry` on packed q, k, v; `out` (q's shape and dtype) is
    written in place when given, else allocated."""
    _check_args(q, k, v, num_heads, rope_q, rope_k, qk_ln, qk_int8)
    dev = q.device
    _check_cuda_tensors(dev, (("q", q), ("k", k), ("v", v)))
    B, Nq, HD = q.shape
    Nk = k.shape[1]
    H = num_heads
    D = _head_dim(HD, H)
    vl = Nk if valid_len is None else max(0, min(int(valid_len), Nk))
    if out is None:
        out = torch.empty_like(q)
    else:
        _check_cuda_tensors(dev, (("out", out),))
        if out.shape != q.shape:
            raise ValueError(f"out {tuple(out.shape)} != q {tuple(q.shape)}")
    m = lsum = None
    if return_stats:     # one allocation for both
        m, lsum = torch.empty(2, B, H, Nq, dtype=torch.float32, device=dev)
    if Nq == 0 or B == 0:
        return (out, m, lsum) if return_stats else out
    cq = sq = ck = sk = None
    if rope_q is not None:
        cq = _f32(rope_q[0], (Nq, D // 2), "rope_q cos", dev)
        sq = _f32(rope_q[1], (Nq, D // 2), "rope_q sin", dev)
        ck = _f32(rope_k[0], (Nk, D // 2), "rope_k cos", dev)
        sk = _f32(rope_k[1], (Nk, D // 2), "rope_k sin", dev)
    ln = None   # q's gamma and beta, then k's
    if qk_ln is not None:
        ln = [_f32(t.reshape(-1), (D,), "qk_ln", dev) for t in qk_ln]
    bias = _f32(kv_bias, (Nk,), "kv_bias", dev, align=True)
    # scratch for the k rows with LN and rope applied once per call, or
    # the int8 pre-pass's (`_i8_scratch`)
    if qk_int8:
        scales, k_work = _i8_scratch(B, H, Nq, Nk, D, dev)
        mid = [scales.data_ptr(), _dequant(D)]
    else:
        k_work = torch.empty_like(k) if (ln is not None or ck is not None) \
            else None
        mid = [LOG2E / math.sqrt(D)]
        mid += [None] * 4 if ln is None else [t.data_ptr() for t in ln]
        mid.append(float(qk_ln_eps))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if k_work is None else k_work.data_ptr(), B, H,
            Nq, Nk, D, vl] + mid + [None if bias is None else bias.data_ptr()]
    args += [None if t is None else t.data_ptr() for t in (cq, sq, ck, sk)]
    if smax is not None:
        sm = _f32(smax, (B * H,), "smax", dev)
        args.append(sm.data_ptr())
    args += [None if m is None else m.data_ptr(),
             None if lsum is None else lsum.data_ptr()]
    lib = kernel_library()
    code = _call_on(dev, getattr(lib, entry), args)
    if code != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.flash_error_string(code).decode()}")
    return (out, m, lsum) if return_stats else out


def _i8_scratch(B, H, Nq, Nk, D, dev):
    """The int8 pre-pass's (3, B*H) f32 scales and its int8 work buffer:
    the quantized q and k, then 2 B H + 1 counters."""
    scales = torch.empty(3, B * H, dtype=torch.float32, device=dev)
    work = torch.empty(B * (Nq + Nk) * H * D + 4 * (2 * B * H + 1),
                       dtype=torch.int8, device=dev)
    return scales, work


def int8_scales_cuda(q, k, num_heads, rope: bool):
    """`int8_scales` of CUDA q and k computed by the int8 forward's
    pre-pass (csrc/flash_attention.cu i8_scales_kernel), bit for bit."""
    _check_cuda_tensors(q.device, (("q", q), ("k", k)))
    B, Nq, HD = q.shape
    Nk = k.shape[1]
    D = _head_dim(HD, num_heads)
    scales, work = _i8_scratch(B, num_heads, Nq, Nk, D, q.device)
    lib = kernel_library()
    code = _call_on(q.device, lib.flash_i8_scales,
                    [q.data_ptr(), k.data_ptr(), work.data_ptr(), B,
                     num_heads, Nq, Nk, D, int(rope), _dequant(D),
                     scales.data_ptr()])
    if code != 0:
        raise RuntimeError(f"flash_i8_scales launch failed: "
                           f"{lib.flash_error_string(code).decode()}")
    return scales


def _require_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")


def flash_single(q, k, v, *, num_heads, valid_len=None, rope_q=None,
                 rope_k=None, kv_bias=None, qk_ln=None, qk_ln_eps=1e-5,
                 qk_int8=False, return_stats=False):
    """Exact softmax flash attention (kernel 1), packed (B, N, H*D) layout;
    int8 QK^T with `qk_int8`. CPU tensors take `flash_single_ref`; CUDA
    tensors the CUDA kernel."""
    if q.device.type == "cpu":
        return flash_single_ref(q, k, v, num_heads=num_heads,
                                valid_len=valid_len, rope_q=rope_q,
                                rope_k=rope_k, kv_bias=kv_bias, qk_ln=qk_ln,
                                qk_ln_eps=qk_ln_eps, qk_int8=qk_int8,
                                return_stats=return_stats)
    _require_cuda(q)
    entry = "flash_single_i8_fwd" if qk_int8 else "flash_single_fwd"
    out = _launch(entry, q, k, v, num_heads, valid_len, rope_q, rope_k,
                  kv_bias, qk_ln, qk_ln_eps, None, return_stats, qk_int8)
    LAUNCHES["flash_single_i8" if qk_int8 else "flash_single"] += 1
    return out


def flash_multi(q, k, v, smax, *, num_heads, valid_len=None, rope_q=None,
                rope_k=None, kv_bias=None, qk_ln=None, qk_ln_eps=1e-5,
                qk_int8=False, return_stats=False):
    """Static-max flash attention (kernel 2), packed (B, N, H*D) layout;
    int8 QK^T with `qk_int8`. CPU tensors take `flash_multi_ref`; CUDA
    tensors the CUDA kernel."""
    if q.device.type == "cpu":
        return flash_multi_ref(q, k, v, smax, num_heads=num_heads,
                               valid_len=valid_len, rope_q=rope_q,
                               rope_k=rope_k, kv_bias=kv_bias, qk_ln=qk_ln,
                               qk_ln_eps=qk_ln_eps, qk_int8=qk_int8,
                               return_stats=return_stats)
    _require_cuda(q)
    entry = "flash_multi_i8_fwd" if qk_int8 else "flash_multi_fwd"
    out = _launch(entry, q, k, v, num_heads, valid_len, rope_q, rope_k,
                  kv_bias, qk_ln, qk_ln_eps, smax, return_stats, qk_int8)
    LAUNCHES["flash_multi_i8" if qk_int8 else "flash_multi"] += 1
    return out


# Backward: plain version, CUDA kernel wrappers, autograd Function

def flash_bwd_ref(q, k, v, dout, m, l, delta, *, num_heads, valid_len=None,
                  q_chunk=2048):
    """Plain backward: packed q, k, v, dout, the forward's (B, H, Nq) f32 m, l
    and delta = rowsum(dout * out) -> (dq, dk, dv) in the inputs' dtypes, as
    the reference's kernels: p = exp2(c q.k - m) / max(l, 1e-30), c =
    log2(e)/sqrt(D), zero from valid_len on; dL = p (dout.v - delta) cast to
    the input dtype before its products, p to dout's before dv; f32 sums."""
    B, Nq, HD = q.shape
    Nk = k.shape[1]
    H = num_heads
    D = HD // H
    c_scale = LOG2E / math.sqrt(D)
    inv_sqrt_d = 1.0 / math.sqrt(D)
    vl = Nk if valid_len is None else max(0, min(int(valid_len), Nk))

    def bhnd(t):
        return t.view(B, t.shape[1], H, D).transpose(1, 2).float()

    qh, kh, vh, doh = bhnd(q), bhnd(k), bhnd(v), bhnd(dout)
    keep = torch.arange(Nk, device=q.device) < vl
    w = 1.0 / l.float().clamp_min(1e-30)
    dq = torch.empty(B, H, Nq, D, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, H, Nk, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for s in range(0, Nq, q_chunk):
        sl = slice(s, s + q_chunk)
        s2 = torch.matmul(qh[:, :, sl], kh.transpose(-1, -2)) * c_scale
        p = torch.exp2(s2 - m[:, :, sl, None].float()) * w[:, :, sl, None]
        p = torch.where(keep, p, 0.0)
        dp = torch.matmul(doh[:, :, sl], vh.transpose(-1, -2))
        dl = (p * (dp - delta[:, :, sl, None].float())).to(q.dtype).float()
        dq[:, :, sl] = torch.matmul(dl, kh) * inv_sqrt_d
        dk += torch.matmul(dl.transpose(-1, -2), qh[:, :, sl])
        dv += torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                           doh[:, :, sl])

    def packed(t, n, dtype):
        return t.to(dtype).transpose(1, 2).reshape(B, n, HD)

    return (packed(dq, Nq, q.dtype), packed(dk * inv_sqrt_d, Nk, k.dtype),
            packed(dv, Nk, v.dtype))


def bwd_delta(dout, out, num_heads):
    """delta = rowsum(dout * out) per head, (B, H, Nq) f32: the plain
    version of the backward's pre-pass."""
    B, Nq, HD = out.shape
    return (dout.float() * out.float()).view(B, Nq, num_heads, -1).sum(-1) \
        .transpose(1, 2).contiguous()


def _launch_bwd(q, k, v, dout, out, m, l, num_heads, valid_len, outs):
    """Launch `flash_bwd` into `outs` = (dq, dk, dv)."""
    _check_args(q, k, v, num_heads, None, None, None)
    dev = q.device
    _check_cuda_tensors(dev, (("q", q), ("k", k), ("v", v), ("dout", dout),
                              ("out", out), ("dq", outs[0]),
                              ("dk", outs[1]), ("dv", outs[2])))
    for name, t, like in (("dout", dout, q), ("out", out, q),
                          ("dq", outs[0], q), ("dk", outs[1], k),
                          ("dv", outs[2], v)):
        if t.shape != like.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")
    B, Nq, HD = q.shape
    Nk = k.shape[1]
    H = num_heads
    D = _head_dim(HD, H)
    stats = [_f32(t, (B, H, Nq), name, dev) for name, t in (("m", m),
                                                            ("l", l))]
    vl = Nk if valid_len is None else max(0, min(int(valid_len), Nk))
    if B == 0 or Nq == 0 or Nk == 0:
        for t in outs:
            t.zero_()
        return
    # one allocation for the kernel's scratch, of the sizes it states
    lib = bwd_kernel_library()
    sizes = (ctypes.c_longlong * 2)()
    lib.flash_bwd_scratch_floats(B, H, Nq, D, sizes)
    n_work, n_acc = sizes
    scratch = torch.empty(n_work + n_acc, dtype=torch.float32, device=dev)
    args = [t.data_ptr() for t in (q, k, v, dout, out, *stats, *outs)]
    args += [scratch.data_ptr() + 4 * n_work if n_acc else None,
             scratch.data_ptr(), B, H, Nq, Nk, D, vl, LOG2E / math.sqrt(D),
             1.0 / math.sqrt(D)]
    code = _call_on(dev, lib.flash_bwd, args)
    if code != 0:
        raise RuntimeError(f"flash_bwd launch failed: "
                           f"{lib.flash_bwd_error_string(code).decode()}")


def flash_bwd(q, k, v, dout, out, m, l, *, num_heads, valid_len=None):
    """(dq, dk, dv) of the flash backward (kernels 3 and 4 in one call),
    packed layout, from the forward's output `out` and row stats m, l. CPU
    tensors take `bwd_delta` and `flash_bwd_ref`; CUDA tensors the CUDA
    kernels (csrc/flash_bwd_sm90.cuh)."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, dout, m, l,
                             bwd_delta(dout, out, num_heads),
                             num_heads=num_heads, valid_len=valid_len)
    _require_cuda(q)
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    _launch_bwd(q, k, v, dout, out, m, l, num_heads, valid_len, outs)
    LAUNCHES["flash_bwd_dq"] += 1
    LAUNCHES["flash_bwd_dkv"] += 1
    return outs


class FlashAttentionGrad(torch.autograd.Function):
    """Differentiable flash attention (reference `flash_attention_grad`): the
    forward runs kernel 1 or 2 with stats and saves q, k, v, out, m, l; the
    backward runs `flash_bwd` (under checkpointing on the recomputed stats)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, valid_len, softmax):
        out, m, l = flash_attention(q, k, v, num_heads=num_heads,
                                    valid_len=valid_len, softmax=softmax,
                                    return_stats=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.num_heads = num_heads
        ctx.valid_len = valid_len
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, dout.contiguous(), out, m, l,
                               num_heads=ctx.num_heads,
                               valid_len=ctx.valid_len)
        return dq, dk, dv, None, None, None


def flash_attention_grad(q, k, v, *, num_heads, valid_len=None,
                         softmax="online"):
    """Differentiable flash attention on packed (B, N, H*D) q, k, v that
    arrive with qk-norm and rope already applied (autograd differentiates
    those); softmax scale 1/sqrt(D) inside. Exact attention: no kv_bias."""
    return FlashAttentionGrad.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), num_heads, valid_len,
                                    softmax)


# Selection rule and dispatch

def static_bound(q, k, num_heads, qk_ln=None, kv_bias=None):
    """Per-(batch, head) Cauchy-Schwarz bound on the exp2-domain logits,
    (B*H,) f32 (reference attention.py:557-600). With qk-LN the bound comes
    from the LN params alone: ||y|| <= sqrt(D) max|gamma| + ||beta||."""
    B, Nq, HD = q.shape
    H = num_heads
    D = HD // H
    c_scale = LOG2E / math.sqrt(D)
    if qk_ln is not None:
        def param_bound(g, b):
            return (math.sqrt(D) * g.float().abs().max()
                    + torch.sqrt((b.float() ** 2).sum()))

        gq, bq, gk, bk = qk_ln
        smax = (c_scale * param_bound(gq, bq) * param_bound(gk, bk)
                ).reshape(1).expand(B * H).contiguous()
    else:
        def row_norm_max(x):
            n = x.shape[1]
            sq = x.view(B, n, H, D).float().square().sum(-1)
            return sq.amax(1).sqrt()                      # (B, H)

        smax = (c_scale * row_norm_max(q) * row_norm_max(k)).reshape(-1)
    if kv_bias is not None:
        smax = smax + kv_bias.float().max() * LOG2E
    return smax


def fits_one_block(Nk: int, block_k: int = 2048) -> bool:
    """Whether Nk keys fit one 128-rounded block of at most
    min(block_k, 2304) keys: kernel 1's key sets under the reference's
    selection rule (attention.py:972-979)."""
    return -(-Nk // 128) * 128 <= min(block_k, 2304)


def flash_attention(q, k, v, *, num_heads, valid_len=None, rope_q=None,
                    rope_k=None, kv_bias=None, softmax="online", qk_ln=None,
                    qk_ln_eps=1e-5, qk_int8=False, block_k=2048,
                    return_stats=False):
    """Packed flash attention by the reference's rule (attention.py:972-979):
    keys that fit one 128-rounded block of at most min(block_k, 2304) take
    kernel 1, longer ones kernel 2 under softmax="static" (else kernel 1).
    `return_stats`: (out, m, l). `qk_int8` only where the keys do not fit one
    block (attention.py:549)."""
    if qk_int8 and qk_ln is not None:
        raise ValueError("qk_ln and qk_int8 do not go together")
    Nk = k.shape[1]
    fits = fits_one_block(Nk, block_k)
    kw = dict(num_heads=num_heads, valid_len=valid_len, rope_q=rope_q,
              rope_k=rope_k, kv_bias=kv_bias, qk_ln=qk_ln,
              qk_ln_eps=qk_ln_eps, qk_int8=bool(qk_int8) and not fits,
              return_stats=return_stats)
    if fits or softmax != "static":
        return flash_single(q, k, v, **kw)
    smax = static_bound(q, k, num_heads, qk_ln=qk_ln, kv_bias=kv_bias)
    return flash_multi(q, k, v, smax, **kw)


def attention(q, k, v, impl: str = "flash", valid_len=None, rope_q=None,
              rope_k=None, kv_bias=None, softmax: str = "online",
              qk_ln=None, qk_ln_eps: float = 1e-5, num_heads=None,
              qk_int8: bool = False):
    """Dispatch by name on packed tensors. Only "flash" takes rope and qk_ln
    in-kernel; "naive", "chunked" and "flash_grad" expect them applied.
    `qk_int8` is flash's alone."""
    if num_heads is None:
        raise ValueError("packed layout requires num_heads")
    if impl == "flash":
        return flash_attention(q, k, v, num_heads=num_heads,
                               valid_len=valid_len, rope_q=rope_q,
                               rope_k=rope_k, kv_bias=kv_bias,
                               softmax=softmax, qk_ln=qk_ln,
                               qk_ln_eps=qk_ln_eps, qk_int8=qk_int8)
    if rope_q is not None or qk_ln is not None:
        raise ValueError(f"impl {impl!r} takes pre-applied rope and qk-norm")
    if impl == "flash_grad":
        if kv_bias is not None or qk_int8:
            raise ValueError("flash_grad is exact attention: no kv_bias, "
                             "no qk_int8")
        return flash_attention_grad(q, k, v, num_heads=num_heads,
                                    valid_len=valid_len, softmax=softmax)
    B, Nq, HD = q.shape
    D = HD // num_heads

    def to_bhnd(t):
        return t.view(t.shape[0], t.shape[1], num_heads, D).transpose(1, 2)

    qh, kh, vh = to_bhnd(q), to_bhnd(k), to_bhnd(v)
    if impl == "naive":
        out = naive_attention(qh, kh, vh, valid_len, kv_bias=kv_bias)
    elif impl == "chunked":
        out = chunked_attention(qh, kh, vh, valid_len, kv_bias=kv_bias)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return out.transpose(1, 2).reshape(B, Nq, HD)
