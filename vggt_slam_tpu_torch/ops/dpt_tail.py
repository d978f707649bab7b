"""The fused DPT output tail: row upsample + pos-embed + 3x3 conv + ReLU +
1x1 conv in one CUDA kernel (counterpart of vggt_slam_tpu/ops/dpt_tail.py,
whose Pallas `_kernel` it replaces).

As in the reference, the column upsample stays outside (`upsample_columns`,
a matmul with the interpolation matrix) and `DPTHead` does not call the
kernel (csrc/dpt_tail.cu), which writes (cout, S, H, W) f32;
`fused_tail_ref` is its plain version with the same roundings. CPU tensors
take the plain version; a CUDA tensor launches the kernel or raises. w0
comes in `kernel_weights`' layout.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

_TILE = 56
# Launches of the CUDA kernel in this process, read by chip_smoke.py.
LAUNCHES = {"dpt_tail": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dpt_tail_fwd": ([_P] * 7 + [_I] * 7 + [ctypes.c_float, _P],
                     ctypes.c_int),
    "dpt_tail_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "dpt_tail_design_launches": ([ctypes.POINTER(ctypes.c_longlong)], None),
}


def reset_launch_counts() -> None:
    LAUNCHES["dpt_tail"] = 0


def supported(rows_in: int, rows_out: int) -> bool:
    """The reference's geometry gate: rows_in = 8 patch_h (the
    refinenet1-doubled grid), rows_out = 14 patch_h, patch_h % 28 == 0."""
    return (rows_in % _TILE == 0 and rows_out % _TILE == 0
            and rows_in >= 2 * _TILE and 7 * rows_in == 4 * rows_out)


def interp_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) f32 align-corners bilinear weights, two nonzeros per
    row (reference heads.py:133)."""
    pos = np.arange(n_out, dtype=np.float64) * ((n_in - 1)
                                                / max(n_out - 1, 1))
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
    frac = pos - lo
    A = np.zeros((n_out, n_in), np.float32)
    A[np.arange(n_out), lo] = 1.0 - frac
    A[np.arange(n_out), lo + 1] = frac
    return torch.from_numpy(A).to(device)


def upsample_columns(x: torch.Tensor, W: int) -> torch.Tensor:
    """(S, rows, w, C) -> (S, rows, W, C) in x's dtype: the align-corners
    column upsample, an f32 matmul with the interpolation matrix."""
    A = interp_matrix(x.shape[2], W, x.device)
    return torch.matmul(A, x.float()).to(x.dtype)


def _row_taps(rows_in: int, rows_out: int, device):
    ratio = torch.tensor((rows_in - 1) / (rows_out - 1), dtype=torch.float32)
    pf = torch.arange(rows_out, dtype=torch.float32) * ratio
    lo = pf.floor().clamp(0, rows_in - 2)
    frac = (pf - lo).clamp(0.0, 1.0)
    return lo.long().to(device), frac.to(device), float(ratio)


def fused_tail_ref(x, pos, w0, b0, w1, b1) -> torch.Tensor:
    """Plain `fused_tail` with the kernel's roundings: row taps and pos add in
    f32, rounded to x's dtype; the 3x3 conv in f32 on weights rounded to x's
    dtype, plus b0; ReLU rounded; the 1x1 conv likewise, plus b1. With bf16 x
    the products are exact under TF32 too."""
    S, rows_in, W, cin = x.shape
    rows_out = pos.shape[0]
    dt = x.dtype
    lo, frac, _ = _row_taps(rows_in, rows_out, x.device)
    a = x[:, lo].float()
    b = x[:, lo + 1].float()
    u = (a + (b - a) * frac[None, :, None, None]) + pos.to(dt).float()[None]
    del a, b
    u = u.to(dt).float().permute(0, 3, 1, 2)
    h = F.conv2d(u, w0.to(dt).float().permute(3, 2, 0, 1), padding=1)
    del u
    h = torch.relu(h + b0.float()[None, :, None, None]).to(dt).float()
    w1m = w1.reshape(w1.shape[-2], w1.shape[-1]).to(dt).float()
    return (torch.einsum("smhw,mo->oshw", h, w1m)
            + b1.float()[:, None, None, None])


def kernel_library():
    """Build (if stale) and load csrc/dpt_tail.cu."""
    from vggt_slam_tpu_torch.ops import cuda_build
    return cuda_build.load("dpt_tail", _SIGNATURES)


def design_launches() -> dict:
    """The kernel's launches in this process by design, counted by the C
    launcher at each launch: "wgmma_sm90" for dpt_tail_sm90, the one
    design."""
    out = (ctypes.c_longlong * 1)()
    kernel_library().dpt_tail_design_launches(out)
    return {"wgmma_sm90": out[0]}


def kernel_weights(w0: torch.Tensor) -> torch.Tensor:
    """w0 (3, 3, cin, cmid) -> the kernel's B operand (3 cin / 8, 3 cmid, 8)
    bf16: B[(dr, m), (dc, ci)] = w0[dr, dc, ci, m] in chunk-major 8-element
    chunks of k (the no-swizzle core-matrix layout)."""
    cmid = w0.shape[-1]
    w = w0.to(torch.bfloat16).permute(1, 2, 0, 3)     # dc, ci, dr, m
    w = w.reshape(-1, 8, 3 * cmid)                    # k chunk, k % 8, n
    return w.transpose(1, 2).contiguous()


def _launch(x, pos, w0, b0, w1, b1, out=None):
    dev = x.device
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"the CUDA kernel takes contiguous bf16 x, got "
                        f"{x.dtype}")
    S, rows_in, W, cin = x.shape
    rows_out = pos.shape[0]
    kh, kw_, cin_w, cmid = w0.shape
    w1m = w1.reshape(w1.shape[-2], w1.shape[-1])
    cout = w1m.shape[1]
    if tuple(pos.shape) != (rows_out, W, cin) or (kh, kw_, cin_w) != \
            (3, 3, cin) or w1m.shape[0] != cmid:
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, pos "
                         f"{tuple(pos.shape)}, w0 {tuple(w0.shape)}, w1 "
                         f"{tuple(w1.shape)}")
    if cmid != 32 or cin % 32 or not 32 <= cin <= 128 or not 1 <= cout <= 4:
        raise ValueError(f"the CUDA kernel takes cin 32, 64, 96 or 128, "
                         f"cmid 32, cout <= 4; got {cin}, {cmid}, {cout}")
    for name, t in (("pos", pos), ("w0", w0), ("b0", b0), ("w1", w1),
                    ("b1", b1)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    pos_b = pos.to(torch.bfloat16).contiguous()
    w0_b = kernel_weights(w0)
    b0_f = b0.float().contiguous()
    w1t = w1m.to(torch.bfloat16).float().t().contiguous()
    b1_f = b1.float().contiguous()
    if out is None:
        out = torch.empty(cout, S, rows_out, W, dtype=torch.float32,
                          device=dev)
    _, _, ratio = _row_taps(rows_in, rows_out, "cpu")
    lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dpt_tail_fwd(
            x.data_ptr(), pos_b.data_ptr(), w0_b.data_ptr(), b0_f.data_ptr(),
            w1t.data_ptr(), b1_f.data_ptr(), out.data_ptr(), S, rows_in,
            rows_out, W, cin, cmid, cout, ratio, stream)
    if code != 0:
        raise RuntimeError(f"dpt_tail_fwd launch failed: "
                           f"{lib.dpt_tail_error_string(code).decode()}")
    return out


def fused_tail(x, pos, w0, b0, w1, b1) -> torch.Tensor:
    """Fused row upsample + pos + conv3x3 + ReLU + conv1x1, channel-first. x
    (S, rows_in, W, cin) after the column upsample; pos (rows_out, W, cin),
    scaled by 0.1; w0, b0 (3, 3, cin, cmid), (cmid,); w1, b1 (1, 1, cmid, cout)
    or (cmid, cout), (cout,). Returns (cout, S, rows_out, W) f32. CPU tensors
    take `fused_tail_ref`; CUDA tensors the kernel (bf16 x, cin 32 to 128 by
    32, cmid 32, cout <= 4)."""
    rows_in, rows_out = x.shape[1], pos.shape[0]
    if not supported(rows_in, rows_out):
        raise ValueError(f"unsupported rows {rows_in} -> {rows_out}")
    if x.device.type == "cpu":
        return fused_tail_ref(x, pos, w0, b0, w1, b1)
    if x.device.type != "cuda":
        raise ValueError(f"no DPT tail kernel for device {x.device}")
    out = _launch(x, pos, w0, b0, w1, b1)
    LAUNCHES["dpt_tail"] += 1
    return out
