"""Multi-head attention for the VGGT trunk: plain versions and the two
hand-written CUDA flash-attention kernels.

Counterpart of vggt_slam_tpu/ops/attention.py. The packed layout is the
port's kernel layout: q/k/v are (B, N, H*D), the natural output of the
q/k/v projections, so no transposes cross device memory.

* `naive_attention`, `chunked_attention`: plain (B, H, N, D) references
  with the suffix `valid_len` key mask and a per-key `kv_bias`.
* `flash_single` / `flash_single_ref`: the counterpart of the TPU kernel
  `_flash_single_kernel` (exact softmax; encoder, frame blocks, camera
  trunk) and its plain version.
* `flash_multi` / `flash_multi_ref`: the counterpart of `_flash_kernel` in
  its default composite (static-max softmax, qk-LN, rope, kv_bias,
  valid_len; the global blocks) and its plain version.
* `flash_attention`: the selection rule of the reference's
  `flash_attention` plus the static bound; `attention` dispatches by name.

A kernel wrapper runs its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel (csrc/flash_attention.cu) or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30
LOG2E = math.log2(math.e)

# Launches of each CUDA kernel in this process (plain-version calls are not
# counted). Read by chip_smoke.py to show the main path ran the kernels.
LAUNCHES = {"flash_single": 0, "flash_multi": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain (B, H, N, D) references
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Kernel semantics: tile preparation and the plain versions
# ---------------------------------------------------------------------------

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


def _check_args(q, k, v, num_heads, rope_q, rope_k, qk_ln):
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


def _plain(q, k, v, num_heads, valid_len, rope_q, rope_k, kv_bias, qk_ln,
           qk_ln_eps, smax, q_chunk=2048):
    """Shared plain version: `smax` None = exact running max (kernel 1),
    else the static bound per (batch, head) (kernel 2)."""
    _check_args(q, k, v, num_heads, rope_q, rope_k, qk_ln)
    B, Nq, HD = q.shape
    Nk = k.shape[1]
    H = num_heads
    D = HD // H
    c_scale = LOG2E / math.sqrt(D)
    vl = Nk if valid_len is None else max(0, min(int(valid_len), Nk))
    qp = _prep(q, H, None if qk_ln is None else qk_ln[0:2], qk_ln_eps,
               rope_q, c_scale)
    kp = _prep(k, H, None if qk_ln is None else qk_ln[2:4], qk_ln_eps,
               rope_k, 1.0).float()
    vf = v.view(B, Nk, H, D).transpose(1, 2).float()
    keep = torch.arange(Nk, device=q.device) < vl
    vf = torch.where(keep[None, None, :, None], vf, 0.0)
    bias = None if kv_bias is None else kv_bias.float() * LOG2E
    out = torch.empty(B, H, Nq, D, dtype=q.dtype, device=q.device)
    for s in range(0, Nq, q_chunk):
        logits = torch.matmul(qp[:, :, s:s + q_chunk].float(),
                              kp.transpose(-1, -2))
        if bias is not None:
            logits = logits + bias
        logits = torch.where(keep, logits, _NEG_INF)
        if smax is None:
            m = logits.amax(-1, keepdim=True)
        else:
            m = smax.float().view(B, H, 1, 1)
        p = torch.exp2(logits - m)
        denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
        o = torch.matmul(p.to(v.dtype).float(), vf) / denom
        out[:, :, s:s + q_chunk] = o.to(q.dtype)
    return out.transpose(1, 2).reshape(B, Nq, HD)


def flash_single_ref(q, k, v, *, num_heads, valid_len=None, rope_q=None,
                     rope_k=None, kv_bias=None, qk_ln=None, qk_ln_eps=1e-5):
    """Plain version of `flash_single`: packed (B, N, H*D) exact softmax
    attention in f32 with the kernel's bf16 tile roundings.

    `rope_q`/`rope_k`: (cos, sin) tables (N, D/2); `qk_ln`: (gq, bq, gk, bk)
    per-head-dim LayerNorm params (needs rope); `kv_bias`: (Nk,) natural-log
    per-key bias; `valid_len`: keys at or past it are masked."""
    return _plain(q, k, v, num_heads, valid_len, rope_q, rope_k, kv_bias,
                  qk_ln, qk_ln_eps, None)


def flash_multi_ref(q, k, v, smax, *, num_heads, valid_len=None,
                    rope_q=None, rope_k=None, kv_bias=None, qk_ln=None,
                    qk_ln_eps=1e-5):
    """Plain version of `flash_multi`: as `flash_single_ref`, but the
    softmax shift is the static per-(batch, head) bound `smax` (B*H,) in the
    exp2 domain instead of the row max."""
    return _plain(q, k, v, num_heads, valid_len, rope_q, rope_k, kv_bias,
                  qk_ln, qk_ln_eps, smax)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_COMMON = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _F, _P, _P,
           _P, _P, _P]
_SIGNATURES = {
    "flash_single_fwd": (_COMMON + [_P], ctypes.c_int),
    "flash_multi_fwd": (_COMMON + [_P, _P], ctypes.c_int),
    "flash_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def kernel_library():
    """Build (if stale) and load csrc/flash_attention.cu."""
    from vggt_slam_tpu_torch.ops import cuda_build
    return cuda_build.load("flash_attention", _SIGNATURES)


def _f32(t, shape, name, device):
    if t is None:
        return None
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    return t


def _launch(entry, q, k, v, num_heads, valid_len, rope_q, rope_k, kv_bias,
            qk_ln, qk_ln_eps, smax):
    _check_args(q, k, v, num_heads, rope_q, rope_k, qk_ln)
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16 {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Nq, HD = q.shape
    Nk = k.shape[1]
    H = num_heads
    D = HD // H
    if D not in (64, 128):
        raise ValueError(f"the CUDA kernel takes head dim 64 or 128, got {D}")
    vl = Nk if valid_len is None else max(0, min(int(valid_len), Nk))
    out = torch.empty_like(q)
    if Nq == 0 or B == 0:
        return out
    cq = sq = ck = sk = None
    if rope_q is not None:
        cq = _f32(rope_q[0], (Nq, D // 2), "rope_q cos", dev)
        sq = _f32(rope_q[1], (Nq, D // 2), "rope_q sin", dev)
        ck = _f32(rope_k[0], (Nk, D // 2), "rope_k cos", dev)
        sk = _f32(rope_k[1], (Nk, D // 2), "rope_k sin", dev)
    ln = None
    if qk_ln is not None:
        ln = torch.stack([_f32(t.reshape(-1), (D,), "qk_ln", dev)
                          for t in qk_ln])
    bias = _f32(kv_bias, (Nk,), "kv_bias", dev)
    # scratch for the k rows with LN and rope applied once per call
    k_work = torch.empty_like(k) if (ln is not None or ck is not None) \
        else None
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if k_work is None else k_work.data_ptr(), B, H,
            Nq, Nk, D, vl, LOG2E / math.sqrt(D),
            None if ln is None else ln.data_ptr(), float(qk_ln_eps),
            None if bias is None else bias.data_ptr()]
    args += [None if t is None else t.data_ptr() for t in (cq, sq, ck, sk)]
    if entry == "flash_multi_fwd":
        sm = _f32(smax, (B * H,), "smax", dev)
        args.append(sm.data_ptr())
    lib = kernel_library()
    with torch.cuda.device(dev):
        args.append(torch.cuda.current_stream(dev).cuda_stream)
        code = getattr(lib, entry)(*args)
    if code != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.flash_error_string(code).decode()}")
    return out


def flash_single(q, k, v, *, num_heads, valid_len=None, rope_q=None,
                 rope_k=None, kv_bias=None, qk_ln=None, qk_ln_eps=1e-5):
    """Exact softmax flash attention (kernel 1), packed (B, N, H*D) layout.
    CPU tensors take `flash_single_ref`; CUDA tensors the CUDA kernel."""
    if q.device.type == "cpu":
        return flash_single_ref(q, k, v, num_heads=num_heads,
                                valid_len=valid_len, rope_q=rope_q,
                                rope_k=rope_k, kv_bias=kv_bias, qk_ln=qk_ln,
                                qk_ln_eps=qk_ln_eps)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    out = _launch("flash_single_fwd", q, k, v, num_heads, valid_len, rope_q,
                  rope_k, kv_bias, qk_ln, qk_ln_eps, None)
    LAUNCHES["flash_single"] += 1
    return out


def flash_multi(q, k, v, smax, *, num_heads, valid_len=None, rope_q=None,
                rope_k=None, kv_bias=None, qk_ln=None, qk_ln_eps=1e-5):
    """Static-max flash attention (kernel 2), packed (B, N, H*D) layout.
    CPU tensors take `flash_multi_ref`; CUDA tensors the CUDA kernel."""
    if q.device.type == "cpu":
        return flash_multi_ref(q, k, v, smax, num_heads=num_heads,
                               valid_len=valid_len, rope_q=rope_q,
                               rope_k=rope_k, kv_bias=kv_bias, qk_ln=qk_ln,
                               qk_ln_eps=qk_ln_eps)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    out = _launch("flash_multi_fwd", q, k, v, num_heads, valid_len, rope_q,
                  rope_k, kv_bias, qk_ln, qk_ln_eps, smax)
    LAUNCHES["flash_multi"] += 1
    return out


# ---------------------------------------------------------------------------
# Selection rule and dispatch
# ---------------------------------------------------------------------------

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


def flash_attention(q, k, v, *, num_heads, valid_len=None, rope_q=None,
                    rope_k=None, kv_bias=None, softmax="online", qk_ln=None,
                    qk_ln_eps=1e-5, block_k=2048):
    """Packed (B, N, H*D) flash attention with the reference's selection
    rule (attention.py:972-979): key sets that fit one 128-rounded block of
    at most min(block_k, 2304) keys take kernel 1; longer ones take
    kernel 2 under softmax="static". Kernel 1 walks key tiles with a running
    max, so softmax="online" on long key sets runs it too: the same exact
    softmax the reference's online multi-block kernel computes."""
    Nk = k.shape[1]
    fits = -(-Nk // 128) * 128 <= min(block_k, 2304)
    kw = dict(num_heads=num_heads, valid_len=valid_len, rope_q=rope_q,
              rope_k=rope_k, kv_bias=kv_bias, qk_ln=qk_ln,
              qk_ln_eps=qk_ln_eps)
    if fits or softmax != "static":
        return flash_single(q, k, v, **kw)
    smax = static_bound(q, k, num_heads, qk_ln=qk_ln, kv_bias=kv_bias)
    return flash_multi(q, k, v, smax, **kw)


def attention(q, k, v, impl: str = "flash", valid_len=None, rope_q=None,
              rope_k=None, kv_bias=None, softmax: str = "online",
              qk_ln=None, qk_ln_eps: float = 1e-5, num_heads=None):
    """Dispatch by implementation name on packed (B, N, H*D) tensors.

    Only "flash" takes rope and qk_ln in-kernel; "naive" and "chunked"
    expect them pre-applied (they are the plain references)."""
    if num_heads is None:
        raise ValueError("packed layout requires num_heads")
    if impl == "flash":
        return flash_attention(q, k, v, num_heads=num_heads,
                               valid_len=valid_len, rope_q=rope_q,
                               rope_k=rope_k, kv_bias=kv_bias,
                               softmax=softmax, qk_ln=qk_ln,
                               qk_ln_eps=qk_ln_eps)
    if rope_q is not None or qk_ln is not None:
        raise ValueError(f"impl {impl!r} takes pre-applied rope and qk-norm")
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
