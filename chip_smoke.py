"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # build, check, drive every path
    python3 chip_smoke.py --kernels-only  # build and check the kernels only
    python3 chip_smoke.py --profile       # also profile a forward and a step

Phases, a JSON line each: 1-2 the environment, the CUDA sources built by
one nvcc each, at once; 3-4 every forward and training kernel against its
plain version at VGGT-1B's and the small model's shapes; 5-6 a full-width
forward against plain, the SLAM path at VGGT-1B through `run_slam`; 7-9 a
gradient against plain, 3 training steps, train_tiny; A-D the int8
kernels, the DPT tail, the int8 forward, the --qk_int8 CLI; E-G the probe
scripts with --check; H, S, L the converters, SALAD, loop closure through
the CLI and smoke_loop; on L's sequence V (COLMAP alignment, the viewer
stub, GLB, a trace, host evals), W (the semantic map), P (CLIP), M (SAM2),
N (SigLIP), Q (the semantic evals), R (retrieval_quality, ab_attention),
T (occupancy, undistort, align_points). The last lines are the
`nvidia-smi` line, the kernels JSON and {"ok": true, "device": ...}; a
failure exits non-zero without them. Needs a CUDA device; imports nothing
of JAX, OpenCV or the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from vggt_slam_tpu_torch.ops import attention as A

SEED = 0
N_FRAMES = 40
HW = (392, 518)
BF16_PEAK_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
INT8_PEAK_OPS = 1979e12       # H100 SXM dense int8 tensor-core peak
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}, default=lambda o: o.item()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Phase 3: kernels against their plain versions

def main_path_attention_cases(device):
    """The attention calls of one bucketed VGGT-1B forward (18 frames of 1041
    tokens, K/V merged at stride 16) and of VGGTConfig.small."""

    from vggt_slam_tpu_torch.models.vggt.modules import rope_2d_angles

    g = torch.Generator(device=device).manual_seed(SEED)
    S, N, H = 18, 1041, 16
    valid_frames = 17
    ns, h, w = 5, 28, 37

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device)
                * scale).to(torch.bfloat16)

    yy, xx = torch.meshgrid(torch.arange(1, h + 1, device=device).float(),
                            torch.arange(1, w + 1, device=device).float(),
                            indexing="ij")

    def rope(D):
        cos_p, sin_p = rope_2d_angles(
            torch.stack([yy.reshape(-1), xx.reshape(-1)], -1), D, 100.0)
        return (torch.cat([torch.ones(ns, D // 2, device=device), cos_p]),
                torch.cat([torch.zeros(ns, D // 2, device=device), sin_p]))

    def ln_params(D=64):
        return (1.0 + 0.1 * torch.randn(D, generator=g, device=device),
                0.05 * torch.randn(D, generator=g, device=device),
                1.0 + 0.1 * torch.randn(D, generator=g, device=device),
                0.05 * torch.randn(D, generator=g, device=device))

    cos, sin = rope(64)
    per_frame = ns + len(range(0, h * w, 16))                     # 70
    nk = N + (S - 1) * per_frame                                  # 2231
    kv_idx = torch.cat([torch.arange(N, device=device)] + [
        f * N + torch.cat([torch.arange(ns, device=device),
                           ns + torch.arange(0, h * w, 16, device=device)])
        for f in range(1, S)])
    counts = torch.randint(1, 30, (nk,), generator=g, device=device).float()
    kv_bias = torch.where(torch.arange(nk, device=device) < N, 0.0,
                          torch.log(counts))
    cos_g, sin_g = cos.repeat(S, 1), sin.repeat(S, 1)
    cos32, sin32 = rope(32)
    cos32_g, sin32_g = cos32.repeat(S, 1), sin32.repeat(S, 1)
    hs = 4                                          # VGGTConfig.small
    return [
        dict(name="encoder", kernel="flash_single", launches_per_forward=24,
             q=rnd(S, N, H * 64), k=rnd(S, N, H * 64), v=rnd(S, N, H * 64),
             kw=dict(num_heads=H)),
        dict(name="frame_block", kernel="flash_single",
             launches_per_forward=24,
             q=rnd(S, N, H * 64), k=rnd(S, N, H * 64), v=rnd(S, N, H * 64),
             kw=dict(num_heads=H, rope_q=(cos, sin), rope_k=(cos, sin),
                     qk_ln=ln_params())),
        dict(name="camera_trunk", kernel="flash_single",
             launches_per_forward=16,
             q=rnd(1, S, H * 128), k=rnd(1, S, H * 128),
             v=rnd(1, S, H * 128),
             kw=dict(num_heads=H, valid_len=valid_frames)),
        dict(name="global_block", kernel="flash_multi",
             launches_per_forward=24,
             q=rnd(1, S * N, H * 64), k=rnd(1, nk, H * 64),
             v=rnd(1, nk, H * 64),
             kw=dict(num_heads=H, rope_q=(cos_g, sin_g),
                     rope_k=(cos_g[kv_idx], sin_g[kv_idx]),
                     qk_ln=ln_params(), kv_bias=kv_bias,
                     valid_len=N + (valid_frames - 1) * per_frame)),
        dict(name="small_encoder", kernel="flash_single",
             launches_per_forward=4,
             q=rnd(S, N, hs * 32), k=rnd(S, N, hs * 32), v=rnd(S, N, hs * 32),
             kw=dict(num_heads=hs)),
        dict(name="small_frame_block", kernel="flash_single",
             launches_per_forward=6,
             q=rnd(S, N, hs * 32), k=rnd(S, N, hs * 32), v=rnd(S, N, hs * 32),
             kw=dict(num_heads=hs, rope_q=(cos32, sin32),
                     rope_k=(cos32, sin32), qk_ln=ln_params(32))),
        dict(name="small_global_block", kernel="flash_multi",
             launches_per_forward=6,
             q=rnd(1, S * N, hs * 32), k=rnd(1, nk, hs * 32),
             v=rnd(1, nk, hs * 32),
             kw=dict(num_heads=hs, rope_q=(cos32_g, sin32_g),
                     rope_k=(cos32_g[kv_idx], sin32_g[kv_idx]),
                     qk_ln=ln_params(32), kv_bias=kv_bias,
                     valid_len=N + (valid_frames - 1) * per_frame)),
    ]


@functools.lru_cache(maxsize=None)
def ex2_per_s() -> float:
    """The card's exp2 rate (bench_attention.sfu_rate)."""

    from vggt_slam_tpu_torch.scripts.bench_attention import sfu_rate
    return sfu_rate(torch.device("cuda", 0))[0]


def least_ms(t_tensor, n_exp2, nbytes) -> tuple[float, str, str]:
    """A call's bound from its tensor-core ms, exp2 count and bytes: (ms,
    "operations" or "bytes", the unit that sets it)."""
    terms = {"tensor cores": t_tensor, "exp units": n_exp2 / ex2_per_s() * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    unit = max(terms, key=terms.get)
    return terms[unit], "bytes" if unit == "bytes" else "operations", unit


def attention_bound_ms(case, int8=False) -> tuple[float, str, str]:
    """`least_ms` of the call: bytes read and written once; tensor-core flops
    at the bf16 peak (with `int8`, QK^T's half at the int8 peak); one exp2 a
    valid logit."""
    q, k, v, kw = case["q"], case["k"], case["v"], case["kw"]
    B, Nq, HD = q.shape
    Nk = k.shape[1]
    nk_used = min(kw.get("valid_len") or Nk, Nk)
    half = 2.0 * B * Nq * nk_used * HD                # QK^T or PV, all heads
    nbytes = 2 * (q.numel() + 2 * B * nk_used * HD) + 2 * q.numel()
    for t in (kw.get("rope_q") or ()) + (kw.get("rope_k") or ()):
        nbytes += 4 * t.numel()
    if kw.get("kv_bias") is not None:
        nbytes += 4 * nk_used
    t_ops = (half / (INT8_PEAK_OPS if int8 else BF16_PEAK_FLOPS)
             + half / BF16_PEAK_FLOPS) * 1e3
    return least_ms(t_ops, B * kw["num_heads"] * Nq * nk_used, nbytes)


def sdpa_call(case):
    """One SDPA call computing the same function, where SDPA can (no in-kernel
    LN or rope)."""

    kw = case["kw"]
    if kw.get("rope_q") is not None or kw.get("qk_ln") is not None:
        return None
    H = kw["num_heads"]

    def bhnd(t):
        return t.view(t.shape[0], t.shape[1], H, -1).transpose(1, 2)

    q, k, v = bhnd(case["q"]), bhnd(case["k"]), bhnd(case["v"])
    mask = None
    if kw.get("valid_len") is not None:
        mask = (torch.arange(k.shape[2], device=k.device)
                < kw["valid_len"])[None, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def sdpa_prepared_call(case):
    """SDPA on `_prep`'s q, k (untimed), kv_bias and valid_len as one float
    mask; None where `sdpa_call` applies."""

    kw = case["kw"]
    if kw.get("rope_q") is None and kw.get("qk_ln") is None:
        return None
    H, ln = kw["num_heads"], kw.get("qk_ln")
    q, k, v = case["q"], case["k"], case["v"]
    qp = A._prep(q, H, ln and ln[0:2], 1e-5, kw.get("rope_q"), 1.0)
    kp = A._prep(k, H, ln and ln[2:4], 1e-5, kw.get("rope_k"), 1.0)
    vh = v.view(v.shape[0], v.shape[1], H, -1).transpose(1, 2)
    mask = None
    if kw.get("kv_bias") is not None or kw.get("valid_len") is not None:
        Nk = k.shape[1]
        mask = torch.zeros(Nk, device=q.device)
        if kw.get("kv_bias") is not None:
            mask += kw["kv_bias"].float()
        mask[min(kw.get("valid_len") or Nk, Nk):] = -math.inf
        mask = mask.to(q.dtype)[None, None, None, :]
    return lambda: F.scaled_dot_product_attention(qp, kp, vh, attn_mask=mask)


def launched_design(fn, counts=None) -> str:
    """The one design fn() ran by the C launcher's counts (forward, or
    flash_bwd with `counts` = bwd_design_launches); raises where it ran
    none."""

    counts = counts or A.forward_design_launches
    torch.cuda.synchronize()
    before = counts()
    fn()
    torch.cuda.synchronize()
    ran = {d: n - before[d] for d, n in counts().items()}
    found = [d for d, n in ran.items() if n > 0]
    if len(found) != 1:
        raise AssertionError(f"no single design among the kernels "
                             f"launched: {ran}")
    return found[0]


def forward_calls(launches) -> int:
    """The forward calls among a LAUNCHES count, bf16 and int8: each
    launches flash_fwd_sm90 once."""
    return sum(n for k, n in launches.items()
               if k.startswith(("flash_single", "flash_multi")))


def expect_design(name, D, design):
    """Forward and backward run the Hopper headers at every head dim."""
    want = "tma_wgmma"
    if design != want:
        raise AssertionError(f"{name} (head dim {D}) ran {design}, not "
                             f"{want}")


def _rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt()
                 / (b ** 2).mean().sqrt().clamp_min(1e-30))


# Phase 4: training kernels against their plain versions

TRAINING_CASES = [
    # name, B, N, H, D, valid_len, softmax, launches per 1B training step
    ("encoder_frame", 4, 1041, 16, 64, None, "online", 48),
    ("global", 1, 4164, 16, 64, None, "static", 24),
    ("camera_trunk", 1, 4, 16, 128, None, "online", 16),
    ("global_valid_len", 1, 4164, 16, 64, 3123, "static", 0),
    ("small_global_d32", 1, 4164, 4, 32, None, "static", 0),
    ("small_frame_d32", 4, 1041, 4, 32, None, "online", 0),
]


def takes_static(softmax, N) -> bool:
    """Whether a TRAINING_CASES forward runs flash_multi (static softmax over
    more keys than one block)."""

    return softmax == "static" and not A.fits_one_block(N)


def training_bounds(B, N, H, D, vl):
    """`least_ms` of the forward with stats and of the backward (4 and 10 Nq Nk
    H D flops a batch, one exp2 a valid logit each)."""
    nk = N if vl is None else min(vl, N)
    qd = 2.0 * B * N * H * D           # one bf16 (B, N, H*D) tensor
    kd = 2.0 * B * nk * H * D          # the valid keys of k or v
    st = 4.0 * B * H * N               # one f32 row stat
    work = {
        "fwd": (4, 2 * qd + 2 * kd + 2 * st),        # q,k,v -> out, m, l
        # q, k, v, dO, out, m, l -> dq, dk, dv
        "bwd": (10, 3 * qd + 2 * kd + 2 * st + 3 * qd),
    }
    return {name: least_ms(mult * B * N * nk * H * D / BF16_PEAK_FLOPS * 1e3,
                           B * H * N * nk, nbytes)
            for name, (mult, nbytes) in work.items()}


def check_training_kernels(device):
    """The forward with stats and flash_bwd against their plain versions at
    both models' training shapes; the backward twice (dq's adds vary)."""

    g = torch.Generator(device=device).manual_seed(SEED + 1)
    results = []
    for name, B, N, H, D, vl, softmax, per_step in TRAINING_CASES:
        q, k, v, dout = (torch.randn((B, N, H * D), generator=g,
                                     device=device).to(torch.bfloat16)
                         for _ in range(4))
        kw = dict(num_heads=H, valid_len=vl)
        static = takes_static(softmax, N)
        smax = A.static_bound(q, k, H) if static else None

        def fwd():
            return (A.flash_multi(q, k, v, smax, return_stats=True, **kw)
                    if static else
                    A.flash_single(q, k, v, return_stats=True, **kw))

        def fwd_plain():
            return (A.flash_multi_ref(q, k, v, smax, return_stats=True, **kw)
                    if static else
                    A.flash_single_ref(q, k, v, return_stats=True, **kw))

        out, m, l = fwd()
        torch.cuda.synchronize()
        ref = fwd_plain()
        errs = {"out": float((out.float() - ref[0].float()).abs().max()),
                "m_rel": float(((m - ref[1]).abs()
                                / ref[1].abs().clamp_min(1.0)).max()),
                "l_rel": float(((l - ref[2]).abs() / ref[2]).max())}

        def bwd():
            return A.flash_bwd(q, k, v, dout, out, m, l, **kw)

        def bwd_plain():
            return A.flash_bwd_ref(q, k, v, dout, m, l,
                                   A.bwd_delta(dout, out, H), **kw)

        dq, dk, dv = bwd()
        dq_again = bwd()[0]
        torch.cuda.synchronize()
        refs = bwd_plain()
        for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            scale = float(want.float().abs().max())
            errs[gname] = float((got.float() - want.float()).abs().max())
            errs[gname + "_rel_to_max"] = errs[gname] / max(scale, 1e-30)
        errs["dq_run_to_run"] = float((dq.float() - dq_again.float()).abs()
                                      .max())
        errs["dq_run_to_run_rel_to_max"] = errs["dq_run_to_run"] / max(
            float(refs[0].float().abs().max()), 1e-30)
        if vl is not None:
            errs["masked_dkv_max"] = float(torch.cat(
                [dk[:, vl:], dv[:, vl:]]).float().abs().max())
        finite = all(bool(torch.isfinite(t).all())
                     for t in (out, m, l, dq, dk, dv))
        iters = 10 if N > 100 else 50
        times = {"fwd_ms": cuda_ms(fwd, iters), "bwd_ms": cuda_ms(bwd, iters),
                 "fwd_plain_ms": cuda_ms(fwd_plain, 2),
                 "bwd_plain_ms": cuda_ms(bwd_plain, 2)}
        sdpa = sdpa_fwd = sdpa_bwd = None
        if vl is None:
            # SDPA on the same q, k, v: forward + backward, the forward
            # alone (with grad, as the kernel keeps stats), the backward
            qs, ks, vs = (t.view(B, N, H, D).transpose(1, 2).detach()
                          .requires_grad_() for t in (q, k, v))
            do_h = dout.view(B, N, H, D).transpose(1, 2)

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qs, ks, vs)
                torch.autograd.grad(o, (qs, ks, vs), do_h)

            sdpa = cuda_ms(sdpa_fwd_bwd, iters)
            sdpa_fwd = cuda_ms(
                lambda: F.scaled_dot_product_attention(qs, ks, vs), iters)
            o_saved = F.scaled_dot_product_attention(qs, ks, vs)
            sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
                o_saved, (qs, ks, vs), do_h, retain_graph=True), iters)
            del o_saved
        bounds = training_bounds(B, N, H, D, vl)
        res = dict(variant=name, B=B, N=N, H=H, D=D, valid_len=vl,
                   kernel="flash_multi" if static else "flash_single",
                   design=launched_design(fwd),
                   bwd_design=launched_design(bwd, A.bwd_design_launches),
                   launches_per_1b_step=per_step, errors=errs, **times,
                   kernels_fwd_bwd_ms=times["fwd_ms"] + times["bwd_ms"],
                   sdpa_fwd_bwd_ms=sdpa, sdpa_fwd_ms=sdpa_fwd,
                   sdpa_bwd_ms=sdpa_bwd,
                   bound_ms={k_: b[0] for k_, b in bounds.items()},
                   bound_by={k_: b[1] for k_, b in bounds.items()},
                   bound_unit={k_: b[2] for k_, b in bounds.items()})
        log("training_kernel_check", **res)
        expect_design(name, D, res["design"])
        expect_design(name + " backward", D, res["bwd_design"])
        tol_ok = (errs["out"] <= 2e-2 and errs["m_rel"] <= 1e-3
                  and errs["l_rel"] <= 1e-3
                  and all(errs[n + "_rel_to_max"] <= 2e-2
                          for n in ("dq", "dk", "dv"))
                  and errs["dq_run_to_run_rel_to_max"] <= 2 ** -7
                  and errs.get("masked_dkv_max", 0.0) == 0.0)
        if not finite or not tol_ok:
            raise AssertionError(f"training kernels disagree with their "
                                 f"plain versions at {name}: {errs}")
        results.append(res)
        del q, k, v, dout, out, m, l, ref, dq, dk, dv, dq_again, refs
    return results


def check_kernels(device):
    tol = 2e-2   # bf16 output rounding (2^-9 relative) plus bf16 p
    results = []
    for case in main_path_attention_cases(device):
        kw = case["kw"]
        q, k, v = case["q"], case["k"], case["v"]
        if case["kernel"] == "flash_multi":
            smax = A.static_bound(q, k, kw["num_heads"], qk_ln=kw["qk_ln"],
                                  kv_bias=kw["kv_bias"])

            def kern():
                return A.flash_multi(q, k, v, smax, **kw)

            def plain():
                return A.flash_multi_ref(q, k, v, smax, **kw)
        else:
            def kern():
                return A.flash_single(q, k, v, **kw)

            def plain():
                return A.flash_single_ref(q, k, v, **kw)
        out = kern()
        torch.cuda.synchronize()
        ref = plain().float()
        diff = (out.float() - ref).abs()
        max_abs = float(diff.max())
        max_rel = float((diff / ref.abs().clamp_min(1e-2)).max())
        finite = bool(torch.isfinite(out).all())
        ms = cuda_ms(kern, iters=10)
        plain_ms = cuda_ms(plain, iters=2)
        lib = sdpa_call(case)
        library_ms = cuda_ms(lib, iters=10) if lib is not None else None
        lib = sdpa_prepared_call(case)
        prepared_ms = cuda_ms(lib, iters=10) if lib is not None else None
        bound_ms, bound_by, bound_unit = attention_bound_ms(case)
        res = dict(variant=case["name"], kernel=case["kernel"],
                   design=launched_design(kern),
                   shape_q=list(q.shape), shape_kv=list(k.shape),
                   max_abs_err=max_abs, max_rel_err=max_rel, tol=tol,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   library_prepared_ms=prepared_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_unit=bound_unit,
                   launches_per_forward=case["launches_per_forward"])
        log("kernel_check", **res)
        expect_design(case["name"], q.shape[2] // kw["num_heads"],
                      res["design"])
        if not finite or max_abs > tol:
            raise AssertionError(f"{case['name']}: kernel disagrees with its "
                                 f"plain version (max abs {max_abs})")
        results.append(res)
        del out, ref, diff
    return results


# Phase 4: full-width forward, kernels against the plain attention path

@contextlib.contextmanager
def plain_attention(model=None):
    """The model's attention, forward and backward, through the plain versions
    inside the block."""
    names = ("flash_single", "flash_multi", "flash_bwd")
    saved = [getattr(A, n) for n in names]
    A.flash_single, A.flash_multi = A.flash_single_ref, A.flash_multi_ref

    def bwd_plain(q, k, v, dout, out, m, l, *, num_heads, valid_len=None):
        return A.flash_bwd_ref(q, k, v, dout, m, l,
                               A.bwd_delta(dout, out, num_heads),
                               num_heads=num_heads, valid_len=valid_len)

    A.flash_bwd = bwd_plain
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(A, n, f)


@contextlib.contextmanager
def chunked_attention(model):
    """Run the model's attention on the plain chunked reference path."""
    from vggt_slam_tpu_torch.models.vggt.modules import Attention
    mods = [m for m in model.modules() if isinstance(m, Attention)]
    for m in mods:
        m.attn_impl = "chunked"
    try:
        yield
    finally:
        for m in mods:
            m.attn_impl = "flash"


def check_forward(model, device, frames):
    """A 2-frame VGGT-1B forward through the kernels against the plain versions
    (the check) and the chunked path (reported)."""

    from vggt_slam_tpu_torch.data.images import preprocess_frames
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn

    images = preprocess_frames(frames[:2])
    fn = make_bucketed_model_fn(model, 2, as_numpy=True,
                                with_unprojection=True, device=device)
    out_k = fn(images)
    errs = {}
    for name, ctx in (("plain", plain_attention), ("chunked",
                                                   chunked_attention)):
        with ctx(model):
            out_p = fn(images)
        errs[name] = {}
        for key in ("pose_enc", "depth", "depth_conf"):
            a, b = out_k[key].astype(np.float64), out_p[key]
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"forward output {key}: bad values")
            errs[name][key] = float(np.sqrt(np.mean((a - b) ** 2)
                                            / max(np.mean(b * b), 1e-30)))
    # Relative RMS, not max: 48 random bf16 blocks amplify single-ulp
    # differences to a few percent at the worst pixel (RMS 0.9e-2-1.9e-2).
    tol = 5e-2
    log("forward_check", frames=2, rel_rms_err_vs_plain=errs["plain"],
        rel_rms_err_vs_chunked=errs["chunked"], tol=tol,
        note="relative RMS difference of a full-width bf16 forward; the "
             "check holds the kernels to their plain versions")
    if max(errs["plain"].values()) > tol:
        raise AssertionError(f"forward disagrees with the plain path: "
                             f"{errs}")
    torch.cuda.synchronize()


def profiled(fn):
    """fn() once under torch.profiler: wall ms, device kernel ms by family,
    busy share, the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: operator events carry their kernels' time as well, and
    # a user annotation (such as Optimizer.step) spans kernels on the device
    rows = sorted(((e.key, dev_us(e) / 1e3) for e in prof.key_averages()
                   if "CUDA" in str(e.device_type) and dev_us(e) > 0
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda r: -r[1])
    families = {}
    for name, ms in rows:
        low = name.lower()
        fam = ("attention" if "flash_fwd" in low or "prep_rows" in low
               else "attention_bwd" if any(s in low for s in (
                   "flash_bwd", "bwd_prep", "bwd_dq_kernel"))
               else "matmul" if any(s in low for s in (
                   "gemm", "xmma", "cutlass", "nvjet", "matmul"))
               else "conv" if "conv" in low or "cudnn" in low
               else "optimizer" if "multi_tensor" in low
               else "other")
        families[fam] = families.get(fam, 0.0) + ms
    device_ms = sum(ms for _, ms in rows)
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, families_ms=families,
                top=[[n[:80], ms] for n, ms in rows[:12]])


def profile_forward(model, device, frames):
    """`--profile`: one bucketed 17-frame forward under torch.profiler."""
    from vggt_slam_tpu_torch.data.images import preprocess_frames
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn

    fn = make_bucketed_model_fn(model, 18, as_numpy=False,
                                with_unprojection=True, device=device)
    images = preprocess_frames(frames[:17])
    fn(images)
    log("profile", frames=17, bucket=18, **profiled(lambda: fn(images)))


# Phase 5: the SLAM main path

def synth_frames(n_frames: int, hw=HW, step_px: int = 60, seed: int = SEED):
    """(H, W, 3) uint8 BGR frames of a camera panning over a textured plane
    (tools/synth_sequence.py's scene)."""

    rng = np.random.default_rng(seed)
    H, W = hw
    th, tw = H + 200, W + step_px * n_frames + 200
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, 9, 9))).float()
    tex = F.interpolate(coarse, size=(th, tw), mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0).numpy()
    yy, xx = np.mgrid[0:th, 0:tw]
    for _ in range(max(40, th * tw // 40000)):
        cx, cy = rng.uniform(0, tw), rng.uniform(0, th)
        color = rng.uniform(0, 255, 3)
        r = rng.uniform(18, 70)
        if rng.uniform() < 0.5:
            m = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        else:
            m = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
        tex[m] = color
    tex = tex + rng.normal(0, 18, tex.shape)
    k = np.exp(-0.5 * (np.arange(-4, 5) / 1.5) ** 2)
    k = torch.from_numpy(k / k.sum()).float()
    t = torch.from_numpy(tex).float().permute(2, 0, 1)[:, None]
    t = F.conv2d(F.pad(t, (4, 4, 0, 0), mode="replicate"), k.view(1, 1, 1, 9))
    t = F.conv2d(F.pad(t, (0, 0, 4, 4), mode="replicate"), k.view(1, 1, 9, 1))
    tex = t[:, 0].permute(1, 2, 0).clamp(0, 255).numpy().astype(np.uint8)
    return [np.ascontiguousarray(tex[100:100 + H,
                                     100 + i * step_px:100 + i * step_px + W])
            for i in range(n_frames)]


def drive_main_path(model, device, frames):
    from vggt_slam_tpu_torch.main import parser, run_slam
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn
    from vggt_slam_tpu_torch.utils.profiling import sync

    args = parser.parse_args(["--timing", "--seed", str(SEED)])
    bucket = args.submap_size + args.overlapping_window_size + args.max_loops
    model_fn = make_bucketed_model_fn(model, bucket, as_numpy=False,
                                      with_unprojection=True, device=device)
    A.reset_launch_counts()
    before = A.forward_design_launches()
    t0 = time.perf_counter()
    result = run_slam(args, frames=frames, model_fn=model_fn, device=device)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    designs = {d: n - before[d]
               for d, n in A.forward_design_launches().items()}
    solver = result["solver"]
    n_sub = solver.map.get_num_submaps()
    poses = [p for s in solver.map.ordered_submaps_by_key()
             for p in s.get_all_poses_world()]
    homogs = [solver.graph.get_homography(k)
              for k in sorted(solver.graph.initialized_nodes)]
    finite = bool(all(np.isfinite(p).all() for p in poses)
                  and all(np.isfinite(h).all() for h in homogs))
    stages = {k: {"total_s": v["total_s"], "count": v["count"]}
              for k, v in result["timer"].summary().items()}
    log("main_path", frames=len(frames), submaps=n_sub, poses=len(poses),
        keyframe_backend=[args.keyframe_backend,
                          solver.flow_tracker.backend],
        launches=launches, designs=designs, wall_s=wall,
        fps=len(frames) / wall, stages=stages, all_finite=finite)
    if n_sub < 2:
        raise AssertionError(f"only {n_sub} submap(s) formed")
    if not finite:
        raise AssertionError("non-finite pose or homography")
    if solver.flow_tracker.backend != "torch":   # the default, auto, on CUDA
        raise AssertionError(f"keyframe backend {args.keyframe_backend} ran "
                             f"{solver.flow_tracker.backend} on the card")
    for name in ("flash_single", "flash_multi"):   # inference: forward only
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    if designs != {"tma_wgmma": forward_calls(launches)}:
        raise AssertionError(f"the main path's forward calls {launches} "
                             f"ran {designs} by design")
    return launches


# Phases A-D: the --qk_int8 path and the fused DPT tail

def int8_cases(device):
    """The int8 kernels' shapes: the bucket's global block at both widths, its
    camera-trunk call (D 128, valid_len 17), the training global block."""

    cases = {c["name"]: c for c in main_path_attention_cases(device)}
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    q, k, v = (torch.randn((1, n, 16 * 64), generator=g, device=device)
               .to(torch.bfloat16) for n in (4164, 4164, 4164))
    out = [dict(name="training_global", q=q, k=k, v=v,
                kw=dict(num_heads=16))]
    for name, c in (("slam_global", cases["global_block"]),
                    ("small_global", cases["small_global_block"]),
                    ("camera_trunk", cases["camera_trunk"])):
        kw = {k_: v_ for k_, v_ in c["kw"].items() if k_ != "qk_ln"}
        out.insert(len(out) - 1, dict(name=name, q=c["q"], k=c["k"],
                                      v=c["v"], kw=kw))
    return out


def int8_calls(case, mod=None):
    """{kernel: (call(i8, stats=False) through wrapper module `mod`, its
    plain version)} at an `int8_cases` case."""

    mod = mod or A
    q, k, v, kw = case["q"], case["k"], case["v"], case["kw"]
    smax = A.static_bound(q, k, kw["num_heads"], kv_bias=kw.get("kv_bias"))
    return {
        "flash_multi_i8": (
            lambda i8, st=False: mod.flash_multi(
                q, k, v, smax, qk_int8=i8, return_stats=st, **kw),
            lambda i8, st=False: mod.flash_multi_ref(
                q, k, v, smax, qk_int8=i8, return_stats=st, **kw)),
        "flash_single_i8": (
            lambda i8, st=False: mod.flash_single(
                q, k, v, qk_int8=i8, return_stats=st, **kw),
            lambda i8, st=False: mod.flash_single_ref(
                q, k, v, qk_int8=i8, return_stats=st, **kw))}


INT8_STATS_TOL = 1e-4


def int8_errors(got, ref, ctrl):
    """int8 (out, m, l) against plain `ref` (stats INT8_STATS_TOL relative,
    outputs 1e-2 of max) and the bf16 `ctrl`, whose l must lie 10x away."""

    out, m, l = got
    ref_out = ref[0].float()
    out_tol = 1e-2 * float(ref_out.abs().max())

    def rel(a, b, floor):
        return float(((a - b).abs() / b.abs().clamp_min(floor)).max())

    return dict(
        max_abs_err=float((out.float() - ref_out).abs().max()),
        out_tol=out_tol,
        stats_err=max(rel(m, ref[1], 1.0), rel(l, ref[2], 1e-30)),
        stats_tol=INT8_STATS_TOL,
        bf16_path_l_rel_diff=rel(l, ctrl[2], 1e-30),
        bf16_path_max_abs_diff=float((out.float() - ctrl[0].float())
                                     .abs().max()),
        finite=bool(torch.isfinite(out).all()))


def int8_failure(e):
    """Why an `int8_errors` result fails, or None."""
    if not e["finite"] or e["max_abs_err"] > e["out_tol"]:
        return f"output off its plain version (max abs {e['max_abs_err']})"
    if e["stats_err"] > e["stats_tol"]:
        return f"row stats off their plain version ({e['stats_err']})"
    if e["bf16_path_l_rel_diff"] <= 10 * e["stats_tol"]:
        return (f"row stats as close to the bf16 path as to the int8 one "
                f"({e['bf16_path_l_rel_diff']}): int8 QK^T did not run")
    return None


def check_int8_kernels(device):
    """Phase A: both int8 kernels against plain and the bf16 control, designs,
    the bf16 time; the scales pass bit for bit, timed as CUDA graphs."""

    results = []
    for case in int8_cases(device):
        q, k, v, kw = case["q"], case["k"], case["v"], case["kw"]
        H, rope = kw["num_heads"], kw.get("rope_q") is not None
        D = q.shape[2] // H
        scales = (lambda: A.int8_scales_cuda(q, k, H, rope),
                  lambda: A.int8_scales(q, k, H, rope))
        if not torch.equal(scales[0](), scales[1]()):
            raise AssertionError(f"the int8 scales pass differs from "
                                 f"int8_scales at {case['name']}")
        scales_ms = [graph_ms(f) for f in scales]
        lib = sdpa_call(case)
        library_ms = cuda_ms(lib, iters=10) if lib is not None else None
        bound_ms, bound_by, bound_unit = attention_bound_ms(case, int8=True)
        for name, (kern, plain) in int8_calls(case).items():
            got = kern(True, True)
            torch.cuda.synchronize()
            errs = int8_errors(got, plain(True, True), plain(False, True))
            design = launched_design(lambda: kern(True))
            res = dict(variant=case["name"], kernel=name, D=D, design=design,
                       shape_q=list(q.shape), shape_kv=list(k.shape),
                       valid_len=kw.get("valid_len"), rope=rope, **errs,
                       scales_ms=scales_ms[0], scales_plain_ms=scales_ms[1],
                       ms=cuda_ms(lambda: kern(True), iters=10),
                       bf16_kernel_ms=cuda_ms(lambda: kern(False), iters=10),
                       plain_ms=cuda_ms(lambda: plain(True), iters=2),
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bound_unit=bound_unit)
            log("int8_kernel_check", **res)
            expect_design(f"{name} at {case['name']}", D, design)
            why = int8_failure(errs)
            if why is not None:
                raise AssertionError(f"{name} at {case['name']}: {why}")
            results.append(res)
            del got
    return results


@contextlib.contextmanager
def int8_global(model, softmax):
    """The global blocks with int8 QK^T under `softmax`, as --qk_int8
    [--global_softmax] set them, inside the block."""
    blocks = [getattr(model.aggregator, f"global_block_{d}").attn
              for d in range(model.cfg.agg_depth)]
    saved = [(b.qk_int8, b.softmax_mode) for b in blocks]
    for b in blocks:
        b.qk_int8, b.softmax_mode = True, softmax
    try:
        yield
    finally:
        for b, (i8, sm) in zip(blocks, saved):
            b.qk_int8, b.softmax_mode = i8, sm


def check_int8_forward(model, device, frames):
    """Phases B, C, 18 frames: the bf16 forward (capturing output_conv1's
    input); int8 in both softmax modes against plain. (activations,
    launches per mode, the bf16 designs)."""

    from vggt_slam_tpu_torch.data.images import preprocess_frames
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn

    images = preprocess_frames(frames[:17])
    fn = make_bucketed_model_fn(model, 18, as_numpy=True,
                                with_unprojection=True, device=device)
    def timed():   # (outputs, host ms, designs by count)
        torch.cuda.synchronize()
        before, t0 = A.forward_design_launches(), time.perf_counter()
        out = fn(images)
        ms = (time.perf_counter() - t0) * 1e3
        return out, ms, {d: n - before[d]
                         for d, n in A.forward_design_launches().items()}

    captured = {}
    hook = model.depth_head.output_conv1.register_forward_hook(
        lambda mod, inp, out: captured.update(x=out.detach(),
                                              path=inp[0].detach()))
    try:
        out_bf16, bf16_ms, bf16_designs = timed()
    finally:
        hook.remove()

    def rel_rms(a, b):
        a, b = a.astype(np.float64), b.astype(np.float64)
        return float(np.sqrt(np.mean((a - b) ** 2)
                             / max(np.mean(b * b), 1e-30)))

    keys = ("pose_enc", "depth", "depth_conf")
    tol = 5e-2   # the bf16 forward check's bound (check_forward)
    launches = {}
    for softmax, name in (("static", "flash_multi_i8"),
                          ("online", "flash_single_i8")):
        with int8_global(model, softmax):
            A.reset_launch_counts()
            out_k, ms, designs = timed()
            launches[softmax] = dict(A.LAUNCHES)
            with plain_attention():
                out_p = fn(images)
        errs = {}
        for key in keys:
            if out_k[key].shape != out_p[key].shape or \
                    not np.isfinite(out_k[key]).all():
                raise AssertionError(f"int8 forward output {key}: bad "
                                     f"values")
            errs[key] = rel_rms(out_k[key], out_p[key])
        vs_bf16 = {key: rel_rms(out_k[key], out_bf16[key]) for key in keys}
        log("int8_forward_check", frames=17, bucket=18, softmax=softmax,
            rel_rms_err_vs_plain=errs, tol=tol,
            rel_rms_vs_bf16_forward=vs_bf16, launches=launches[softmax],
            designs=designs, bf16_designs=bf16_designs, forward_ms=ms,
            bf16_forward_ms=bf16_ms,
            note="global blocks with int8 QK^T through the kernels against "
                 "the same forward through their plain versions; the bf16 "
                 "comparison is for information; host ms of one forward")
        if max(errs.values()) > tol:
            raise AssertionError(f"int8 forward ({softmax}) disagrees with "
                                 f"the plain path: {errs}")
        if launches[softmax][name] != model.cfg.agg_depth:   # 24 at 1B
            raise AssertionError(f"{name} launched {launches[softmax][name]}"
                                 f" times in the int8 forward, not one per "
                                 f"global block")
        if designs != bf16_designs:
            raise AssertionError(f"the int8 forward ran designs {designs}, "
                                 f"the bf16 one {bf16_designs}: int8 left "
                                 f"flash_sm90.cuh")
    return captured, launches, bf16_designs


def check_dpt_tail(model, device, captured):
    """Phase B: the DPT tail on the depth head's activations against
    fused_tail_ref and against the head's unfused chain."""

    from vggt_slam_tpu_torch.models.vggt.heads import \
        resize_bilinear_align_corners, uv_pos_embed
    from vggt_slam_tpu_torch.ops import dpt_tail as T

    head = model.depth_head
    xh = captured["x"]                                    # (S, 128, h8, w8)
    S, cin, rows_in, w_in = xh.shape
    H, W = HW
    x = T.upsample_columns(xh.permute(0, 2, 3, 1).contiguous(), W)
    pe = uv_pos_embed(W, H, W / H, cin, device)           # (cin, H, W)
    pos = (0.1 * pe).permute(1, 2, 0).contiguous()
    args = (head.output_conv2_0.kernel, head.output_conv2_0.bias,
            head.output_conv2_2.kernel, head.output_conv2_2.bias)

    def chain():
        y = resize_bilinear_align_corners(xh, (H, W))
        y = y + (0.1 * pe[None]).to(y.dtype)
        return head.output_conv2_2(F.relu(head.output_conv2_0(y)))

    T.reset_launch_counts()
    before = T.design_launches()
    out = T.fused_tail(x, pos, *args)
    torch.cuda.synchronize()
    launches = T.LAUNCHES["dpt_tail"]
    designs = {d: n - before[d] for d, n in T.design_launches().items()}
    registers, spills = own_ptxas_report("dpt_tail")
    ref = T.fused_tail_ref(x, pos, *args)
    want = chain()
    max_abs = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    rel_chain = _rel_rms(out, want)
    cmid, cout = args[0].shape[-1], args[2].shape[-1]
    flops = 2.0 * S * H * W * (9 * cin * cmid + cmid * cout)
    nbytes = 2 * x.numel() + 2 * pos.numel() + 4 * out.numel()
    t_ops = flops / BF16_PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    res = dict(kernel="dpt_tail", shape_x=list(x.shape),
               rows_out=H, cmid=cmid, cout=cout, launches=launches,
               designs=designs, registers=registers, spill_store_bytes=spills,
               max_abs_err=max_abs, ref_max_abs=scale,
               tol=1e-2 * scale, rel_rms_vs_head_chain=rel_chain,
               tol_vs_head_chain=2e-2,
               ms=cuda_ms(lambda: T.fused_tail(x, pos, *args), iters=10),
               graph_ms=graph_ms(lambda: T.fused_tail(x, pos, *args),
                                 calls=10),
               plain_ms=cuda_ms(lambda: T.fused_tail_ref(x, pos, *args),
                                iters=2),
               library_ms=cuda_ms(chain, iters=5),
               column_upsample_ms=cuda_ms(
                   lambda: T.upsample_columns(
                       xh.permute(0, 2, 3, 1).contiguous(), W), iters=5),
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, gbytes=nbytes / 1e9,
               note="library_ms: the head's own unfused chain (bilinear "
                    "upsample, pos add, cuDNN 3x3 conv with TF32 off, "
                    "ReLU, 1x1 einsum)")
    log("dpt_tail_check", **res)
    # fused vs plain: the same roundings, f32 sums in another order;
    # vs the head's chain: it rounds the 2D upsample, the pos sum and the
    # conv output to bf16 at other places
    if not bool(torch.isfinite(out).all()) or max_abs > 1e-2 * scale \
            or rel_chain > 2e-2:
        raise AssertionError(f"dpt_tail disagrees: max abs {max_abs} of "
                             f"{scale}, rel RMS vs the head {rel_chain}")
    if launches != 1:
        raise AssertionError("dpt_tail was not launched")
    if designs != {"wgmma_sm90": 1}:
        raise AssertionError(f"the fused tail's launch ran {designs} by "
                             f"design, not one dpt_tail_sm90")
    if not registers or spills:
        raise AssertionError(f"dpt_tail_sm90's ptxas report: registers "
                             f"{registers}, spill stores {spills}")
    del x, pos, out, ref, want
    torch.cuda.empty_cache()
    return res


def drive_image_folder_cli(device, per_forward):
    """Phase D: the CLI on 24 panned 480x640 PNGs with --qk_int8; each forward
    adds `per_forward` (phase C's designs)."""
    import tempfile

    from vggt_slam_tpu_torch.data.images import load_image, write_png
    from vggt_slam_tpu_torch.main import parser, run_slam
    from vggt_slam_tpu_torch.utils.profiling import sync

    tmp = tempfile.mkdtemp(prefix="png_folder_")
    try:
        folder = os.path.join(tmp, "rgb")
        os.makedirs(folder)
        frames = synth_frames(24, hw=(480, 640), step_px=70, seed=SEED + 3)
        t0 = time.perf_counter()
        paths = [os.path.join(folder, f"{i:06d}.png")
                 for i in range(len(frames))]
        kinds = np.concatenate([write_png(p, f)
                                for p, f in zip(paths, frames)])
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = [load_image(p) for p in paths]
        decode_s = (time.perf_counter() - t0) / len(paths)
        if not all(np.array_equal(d, f) for d, f in zip(decoded, frames)):
            raise AssertionError("the PNG reader does not give back the "
                                 "frames written")
        del decoded
        log_path = os.path.join(tmp, "poses.txt")
        args = parser.parse_args(
            ["--image_folder", folder, "--qk_int8", "--log_results",
             "--skip_dense_log", "--log_path", log_path, "--seed", str(SEED),
             "--timing"])
        torch.cuda.synchronize()
        A.reset_launch_counts()
        before, t0 = A.forward_design_launches(), time.perf_counter()
        result = run_slam(args, device=device)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(A.LAUNCHES)
        designs = {d: n - before[d]
                   for d, n in A.forward_design_launches().items()}
        solver = result["solver"]
        n_sub = solver.map.get_num_submaps()
        poses = [p for s in solver.map.ordered_submaps_by_key()
                 for p in s.get_all_poses_world()]
        homogs = [solver.graph.get_homography(k)
                  for k in sorted(solver.graph.initialized_nodes)]
        finite = bool(all(np.isfinite(p).all() for p in poses)
                      and all(np.isfinite(h).all() for h in homogs))
        tum = np.loadtxt(log_path) if os.path.exists(log_path) else None
        dets = [float(np.linalg.det(h)) for h in homogs]
        stages = {k: {"total_s": v["total_s"], "count": v["count"]}
                  for k, v in result["timer"].summary().items()}
        log("image_folder_cli", frames=len(frames), frame_hw=[480, 640],
            keyframe_backend=[args.keyframe_backend,
                              solver.flow_tracker.backend],
            png_write_s=write_s, png_decode_s_per_frame=decode_s,
            png_row_filters=np.bincount(kinds, minlength=5).tolist(),
            submaps=n_sub, poses=len(poses),
            tum_rows=None if tum is None else int(tum.shape[0]),
            homography_dets=dets, launches=launches, designs=designs,
            wall_s=wall,
            fps=len(frames) / wall, stages=stages, all_finite=finite)
        if n_sub < 2:
            raise AssertionError(f"only {n_sub} submap(s) formed")
        if solver.flow_tracker.backend != "torch":
            raise AssertionError(f"the CLI's default keyframe backend ran "
                                 f"{solver.flow_tracker.backend} on the card")
        if not finite or any(abs(d - 1.0) > 1e-3 for d in dets):
            raise AssertionError(f"non-finite pose, or a homography off "
                                 f"SL(4): dets {dets}")
        if tum is None or tum.ndim != 2 or tum.shape[1] != 8 or \
                not np.isfinite(tum).all():
            raise AssertionError("the TUM pose log was not written")
        if launches["flash_multi_i8"] == 0:
            raise AssertionError("the int8 kernel was not launched on the "
                                 "--qk_int8 path")
        forwards = launches["flash_multi_i8"] / 24   # VGGT-1B global blocks
        want = {d: forwards * n for d, n in per_forward.items()}
        if designs != want:
            raise AssertionError(f"{designs} over {forwards} forwards, not "
                                 f"{want}: a forward left flash_sm90.cuh")
        del result, solver
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase E: the frame-attention probes (vggt_slam_tpu_torch/scripts/
# bench_attention.py, the counterpart of scripts/bench_attention.py)

PROBE_COMMAND = "python -m vggt_slam_tpu_torch.scripts.bench_attention --check"
# kernel: (representative variant, the TPU kernel it replaces)
PROBE_KERNELS = {
    "matmul_only": ("matmul-only floor",
                    "scripts/bench_attention.py:45 (_matmul_only_kernel, "
                    "through make_flat_call, launched at :171)"),
    "softmax_only": ("softmax-only floor",
                     "scripts/bench_attention.py:57 (_softmax_only_kernel, "
                     "through make_flat_call, launched at :171)"),
    "grouped": ("grouped G=2",
                "scripts/bench_attention.py:70 (_grouped_kernel, through "
                "make_grouped_call, launched at :142)"),
    "pipelined": ("pipelined G=2",
                  "scripts/bench_attention.py:101 (_pipelined_kernel, "
                  "through make_grouped_call, launched at :142)"),
}


def _instance_patterns(variant):
    """Name patterns of a variant's grouped_sm90<G, schedule> instance in
    ptxas's report."""
    from vggt_slam_tpu_torch.scripts import bench_attention as BA

    kind = variant.split(" ")[0]
    if kind == "matmul-only":       # bench_attention.cu's one global_sm90
        return ("global_sm90<", "global_sm90ILi")
    if kind == "softmax-only":
        return ("softmax_only_kernel",)
    if BA.instance(variant):
        schedule, G = BA.instance(variant)
        sched = BA.SCHEDULES.index(schedule)
        return (f"grouped_sm90<{G}, {sched}>(",
                f"grouped_sm90ILi{G}ELi{sched}EE")
    if kind == "production":
        return ("flash_fwd_sm90<64, false, false>(",
                "flash_fwd_sm90ILi64ELb0ELb0EE")
    return ()


def mufu_ex2_counts(lib_path):
    """{kernel: MUFU.EX2 count} from `cuobjdump -sass`, or None without
    cuobjdump."""

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    counts, fn = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and "MUFU.EX2" in ln:
            counts[fn] += 1
    return counts


def run_probe_script(BA, argv):
    """The probe script's main(argv), its printed lines captured."""

    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        result = BA.main(argv)
    torch.cuda.synchronize()
    return result, dict(command=f"python -m {BA.__name__} {' '.join(argv)}",
                        seconds=time.perf_counter() - t0,
                        output=text.getvalue().splitlines())


def check_grouped_tiled(device):
    """The nine grouped, interleaved, pipelined instances at the small and
    frame shapes into NaN-filled outputs, held at their key tile. {variant:
    {shape: (err, share of tol, block_k)}}."""

    from vggt_slam_tpu_torch.scripts import bench_attention as BA

    out = {}
    for shape, (S, H, N) in (("small", (2, 4, 100)),
                             ("frame", (18, 16, 1041))):
        qkv = BA.make_inputs(S, H, N, 64, seed=SEED + 2, device=device)
        for name, p in BA.make_variants(S, H, N, 64).items():
            if not BA.instance(name):
                continue
            args = p.prep(*qkv)
            before = BA.design_launches()["tma_wgmma"]
            got = p.run(*args, out=torch.full_like(args[0], math.nan))
            torch.cuda.synchronize()
            launched = BA.design_launches()["tma_wgmma"] - before
            err = BA.tiled_error(name, args, got)
            out.setdefault(name, {})[shape] = err
            if not (err[1] <= 1 and launched == 1):
                raise AssertionError(f"{name} at the {shape} shape: {err} "
                                     f"(share of tolerance must be <= 1), "
                                     f"{launched} grouped_sm90 launches")
            del args, got
        del qkv
    log("probe_tiled", errors=out)
    torch.cuda.empty_cache()
    return out


def check_probe_kernels(device):
    """Phase E: bench_attention --check at (288, 1152, 64),
    `check_grouped_tiled`, a padded-keys control, ptxas registers,
    softmax-only's exp2 count, then the script at its defaults."""

    from vggt_slam_tpu_torch.ops import cuda_build
    from vggt_slam_tpu_torch.scripts import bench_attention as BA

    S, H, N, D = 18, 16, 1041, 64
    BH, Np = S * H, BA.roundup(N, 128)
    tiled = check_grouped_tiled(device)
    BA.reset_launch_counts()
    before = BA.design_launches()
    frame, run = run_probe_script(BA, ["--frames", str(S), "--check"])
    expect_probe_design(BA, before)
    log("probe_frame_shape", **run)
    # the probes' instances from their own library's report (global_sm90's
    # matmul instance has namesakes in the global probes' libraries)
    report = ptxas_report(cuda_build.build_log)
    probe_report = own_ptxas_report("bench_attention")
    results = {}
    for line in frame["lines"]:
        patterns = _instance_patterns(line["variant"])
        registers, spills = probe_report if line["kernel"] else report
        line["registers"], line["spill_store_bytes"] = next(
            ((r, spills.get(f, 0)) for f, r in registers.items()
             if any(pat in f for pat in patterns)), (None, None))
        if line["kernel"] == "matmul_only":
            line["instance"] = next((f for f in registers
                                     if any(pat in f for pat in patterns)),
                                    None)
            if line["instance"] is None or line["spill_store_bytes"]:
                raise AssertionError(f"matmul-only's global_sm90 instance: "
                                     f"{line}")
        if line["variant"] in tiled:
            line["tiled"] = tiled[line["variant"]]
        results[line["variant"]] = line
        log("probe_check", **line)

    p = BA.make_variants(S, H, N, D)["grouped G=2"]
    args = p.prep(*BA.make_inputs(S, H, N, D, seed=SEED, device=device))
    out = p.run(*args)
    err, tol = BA.probe_error(p.kind, out, p.plain(*args))
    ctrl, _ = BA.probe_error(p.kind, out,
                             BA.exp2_attention_ref(*args, l_keys=N))
    log("probe_control", variant="grouped G=2", max_abs_err=err, tol=tol,
        padded_keys_dropped_err=ctrl)
    if not (err <= tol < ctrl):
        raise AssertionError(f"the check does not tell a kernel that drops "
                             f"padded keys from l ({err}, {tol}, {ctrl})")
    del args, out

    soft = results["softmax-only floor"]
    ex2_floor_ms = BH * Np * Np / frame["ex2_rate_measured"] * 1e3
    sass = mufu_ex2_counts(os.path.join(cuda_build.BUILD_DIR,
                                        "libbench_attention.so"))
    n_ex2 = (None if sass is None else
             [c for f, c in sass.items() if "softmax_only_kernel" in f])
    log("probe_exp2", ex2_rate_derived=frame["ex2_rate_derived"],
        ex2_derivation=frame["ex2_derivation"],
        ex2_rate_measured=frame["ex2_rate_measured"],
        softmax_only_ms=soft["ms"], ex2_floor_ms=ex2_floor_ms,
        sass_check="cuobjdump" if sass is not None else
        "not run: no cuobjdump (the timing check stands alone)",
        softmax_only_mufu_ex2=n_ex2, mufu_ex2_per_kernel=sass)
    # one exp2 per logit cannot run faster than the card's exp2 rate
    if not soft["ms"] >= ex2_floor_ms:
        raise AssertionError(f"softmax-only took {soft['ms']} ms, under "
                             f"{ex2_floor_ms} ms of exp2: it was hoisted")
    # one MUFU.EX2 per logit of a 16 x 64 tile per warp: 32 per thread
    if sass is not None and (not n_ex2 or n_ex2[0] < 32):
        raise AssertionError(f"softmax-only SASS has {n_ex2} MUFU.EX2: "
                             f"the exp2 was hoisted")
    torch.cuda.empty_cache()

    BA.reset_launch_counts()
    before = BA.design_launches()
    _, run = run_probe_script(BA, ["--check"])
    launches = {name: BA.LAUNCHES[name] for name in PROBE_KERNELS}
    designs = expect_probe_design(BA, before)
    log("probe_path", launches=launches, designs=designs, **run)
    if not all(launches.values()):
        raise AssertionError(f"the probe script did not launch every probe "
                             f"kernel: {launches}")
    torch.cuda.empty_cache()
    return results, launches


def expect_probe_design(BA, before):
    """Every grouped and pipelined launch since `before` ran grouped_sm90 and
    every matmul-only launch global_sm90. Returns both counts."""
    now = BA.design_launches()
    n = {d: now[d] - before[d] for d in now}
    calls = BA.LAUNCHES["grouped"] + BA.LAUNCHES["pipelined"]
    if not (n["tma_wgmma"] == calls > 0):
        raise AssertionError(f"{calls} grouped and pipelined launches, "
                             f"{n['tma_wgmma']} of them grouped_sm90")
    if not n["global_sm90"] == BA.LAUNCHES["matmul_only"] > 0:
        raise AssertionError(f"{BA.LAUNCHES['matmul_only']} matmul-only "
                             f"launches, {n['global_sm90']} of them "
                             f"global_sm90")
    return n


def probe_kernel_entries(results, launches):
    """The four probe kernels' entries of the kernels line."""
    library_ms = results["SDPA (library)"]["ms"]
    entries = []
    for name, (rep, replaces) in PROBE_KERNELS.items():
        variants = [r for r in results.values() if r["kernel"] == name]
        r = results[rep]
        grouped = name in ("grouped", "pipelined")
        entry = {
            "name": name, "status": "ported", "route": "cuda",
            "source": "vggt_slam_tpu_torch/csrc/bench_attention.cu" + (
                ", csrc/sm90_common.cuh" if grouped else
                ", csrc/global_sm90.cuh" if name == "matmul_only" else ""),
            "replaces": replaces, "launches": launches[name],
            "launches_path": PROBE_COMMAND + " (its defaults: S = 33)",
            "variant": rep,
            "max_abs_err": max(c["max_abs_err"] for c in variants),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "variants": variants}
        if grouped:
            entry["design"] = "tma_wgmma (grouped_sm90)"
            entry["library_ms"] = library_ms
        else:
            if name == "matmul_only":
                entry["design"] = f"{GLOBAL_SM90_DESIGN}: {r['instance']}"
                entry["registers"] = r["registers"]
            entry["library_ms_reason"] = ("no single PyTorch call computes "
                                          "a probe floor")
        entries.append(entry)
    return entries


# Phase F: the global-shape probes (vggt_slam_tpu_torch/scripts/
# bench_global_attention.py, bench_softmax_variants.py and
# bench_int8_inkernel.py, the counterparts of the scripts of those names)

GLOBAL_PROBE_ITERS = "4"
# script: (its LAUNCHES key, its kernel template, the TPU kernel it replaces,
# the representative variant of the kernels line, the offset of its modes in
# global_sm90's MODE)
GLOBAL_PROBES = {
    "bench_global_attention": (
        "global_attention", "global_sm90",
        "scripts/bench_global_attention.py:48 (_kernel, launched through "
        "run_kernel at :106)", "bf16 bq=64 bk=64", 0),
    "bench_softmax_variants": (
        "softmax_variants", "global_sm90",
        "scripts/bench_softmax_variants.py:41 (_kernel, launched through "
        "run_kernel at :118)", "online bq=64 bk=64", 6),
    "bench_int8_inkernel": (
        "int8_inkernel", "global_sm90",
        "scripts/bench_int8_inkernel.py:43 (_kernel, launched through run "
        "at :118)", "qk8 bq=64 bk=64", 3),
}
GLOBAL_SM90_DESIGN = ("tma_wgmma (global_sm90: TMA ring refilled by release "
                      "counts, wgmma, QK^T of tile t + 1 before PV of t)")


def global_ptxas(report, template, mode, bq, bk):
    """(registers, spill bytes) of <bq, bk, mode> of `template` in a
    `ptxas_report`; (None, None) if absent."""
    registers, spills = report
    patterns = (f"{template}<{bq}, {bk}, {mode}>(",
                f"{template}ILi{bq}ELi{bk}ELi{mode}EE")
    return next(((r, spills.get(f, 0)) for f, r in registers.items()
                 if any(pat in f for pat in patterns)), (None, None))


def check_global_probes():
    """Phase F: each global script --check (modes, tilings, int8 controls,
    one global_sm90 launch a call). {script: (result, launches, designs)}."""
    import importlib

    results = {}
    for script, (counter, template, _, _, offset) in GLOBAL_PROBES.items():
        mod = importlib.import_module(f"vggt_slam_tpu_torch.scripts.{script}")
        report = own_ptxas_report(script)
        mod.reset_launch_counts()
        before = mod.design_launches()["tma_wgmma"]
        out, run = run_probe_script(
            mod, ["--check", "--iters", GLOBAL_PROBE_ITERS])
        launches = mod.LAUNCHES[counter]
        designs = mod.design_launches()["tma_wgmma"] - before
        log("global_probe_path", script=script, launches=launches,
            design_launches=designs, **run)
        if not launches:
            raise AssertionError(f"{script} launched no kernel")
        if designs != launches:
            raise AssertionError(f"{script}: {launches} launches, "
                                 f"{designs} of them global_sm90")
        instances = {}
        for mode in mod.MODES:
            for bq, bk in mod.TILINGS:
                m = mod.MODES.index(mode) + offset
                name = f"{template}<{bq}, {bk}, {m}>"
                instances[name] = global_ptxas(report, template, m, bq, bk)
                if instances[name][0] is None or instances[name][1]:
                    raise AssertionError(f"{name} ({mode}): (registers, "
                                         f"spill-store bytes) "
                                         f"{instances[name]}")
        log("global_probe_instances", script=script, instances=instances)
        for line in out["lines"]:
            mode = mod.MODES.index(line["mode"]) + offset
            line["registers"], line["spill_store_bytes"] = instances[
                f"{template}<{line['block_q']}, {line['block_k']}, {mode}>"]
            log("global_probe_line", script=script, **line)
        checks = out["checks"]
        n_modes, n_tilings = len(mod.MODES), len(mod.TILINGS)
        controls = {k: c for k, c in checks.items()
                    if "mean_dist_own_plain" in c}
        log("global_probe_check", script=script, checks=checks)
        if (len(checks) != n_modes * n_tilings
                or len(controls) != (2 if counter == "int8_inkernel" else 1)):
            raise AssertionError(f"{script}: the check covered {list(checks)}"
                                 f", controls {list(controls)}")
        results[script] = (out, launches, designs)
        torch.cuda.empty_cache()
    return results


def global_probe_entries(results):
    """The three global-shape probe kernels' entries of the kernels line."""
    entries = []
    for script, (_, _, replaces, rep, _) in GLOBAL_PROBES.items():
        out, launches, designs = results[script]
        r = next(line for line in out["lines"] if line["variant"] == rep)
        entry = {
            "name": script, "status": "ported", "route": "cuda",
            "source": f"vggt_slam_tpu_torch/csrc/{script}.cu, "
                      f"csrc/global_sm90.cuh",
            "replaces": replaces, "launches": launches,
            "launches_path": f"python -m vggt_slam_tpu_torch.scripts.{script}"
                             f" --check --iters {GLOBAL_PROBE_ITERS} (its "
                             f"defaults: BH 16, N 34816, D 64)",
            "design": GLOBAL_SM90_DESIGN,
            "design_launches": designs,
            "registers": {line["variant"]: line["registers"]
                          for line in out["lines"]},
            "variant": rep,
            "max_abs_err": max(c["max_abs_err"]
                               for c in out["checks"].values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bound_unit": r["bound_unit"], "library_ms": r["library_ms"],
            "variants": out["lines"]}
        if r.get("library_ms_reason"):
            entry["library_ms_reason"] = r["library_ms_reason"]
        entries.append(entry)
    return entries


# Phase G: the matmul-shape probes (vggt_slam_tpu_torch/scripts/
# bench_matmul_shapes.py, the counterpart of scripts/bench_matmul_shapes.py)

MATMUL_COMMAND = ("python -m vggt_slam_tpu_torch.scripts.bench_matmul_shapes "
                  "--check")
# kernel: (the TPU kernel it replaces, its representative line at the
# reference's B = 528 QK^T shape)
MATMUL_PROBES = {
    "batched_mm": ("scripts/bench_matmul_shapes.py:41 (pallas_batched_mm, "
                   "launched at :49)", "batched 128x128"),
    "grouped_mm": ("scripts/bench_matmul_shapes.py:64 (pallas_grouped_mm, "
                   "launched at :75)", "grouped G=2 128x128"),
}


def check_matmul_probes():
    """Phase G: the script --check (lines, B 528 controls, one mm_sm90 launch a
    C call, registers). Returns (result, launches, designs)."""

    from vggt_slam_tpu_torch.ops import cuda_build
    from vggt_slam_tpu_torch.scripts import bench_matmul_shapes as MM

    MM.reset_launch_counts()
    before = MM.design_launches()["tma_wgmma"]
    out, run = run_probe_script(MM, ["--check"])
    launches = dict(MM.LAUNCHES)
    designs = {"tma_wgmma": MM.design_launches()["tma_wgmma"] - before}
    calls = sum(MM.CALLS.values())
    log("matmul_probe_path", launches=launches, calls=dict(MM.CALLS),
        design_launches=designs, **run)
    if not all(launches.values()):
        raise AssertionError(f"the matmul script did not launch every "
                             f"kernel: {launches}")
    if not designs["tma_wgmma"] == calls > 0:
        raise AssertionError(f"{calls} calls of the matmul entries, "
                             f"{designs['tma_wgmma']} of them mm_sm90")
    report = ptxas_report(cuda_build.build_log)
    for line in out["lines"]:
        bn = line["tiling"][1]     # both kernels run mm_sm90<block_n>
        line["registers"], line["spill_store_bytes"] = mm_ptxas(report, bn)
        log("matmul_probe_line", **line)
        if line["registers"] is None:
            raise AssertionError(f"no ptxas report of mm_sm90<{bn}> for "
                                 f"{line['variant']}")
    log("matmul_probe_check", library=out["library"], checks=out["checks"],
        controls=out["controls"])
    if (len(out["checks"]) != len(out["lines"])
            or len(out["controls"]) != 2):
        raise AssertionError(f"the check covered {len(out['checks'])} of "
                             f"{len(out['lines'])} lines, controls at "
                             f"{list(out['controls'])}")
    torch.cuda.empty_cache()
    return out, launches, designs


def mm_ptxas(report, bn):
    """(registers, spill bytes) of mm_sm90<bn> in a `ptxas_report`; (None,
    None) if absent."""
    registers, spills = report
    patterns = (f"mm_sm90<{bn}>(", f"mm_sm90ILi{bn}EE")
    return next(((r, spills.get(f, 0)) for f, r in registers.items()
                 if any(pat in f for pat in patterns)), (None, None))


def matmul_probe_entries(out, launches, designs):
    """The two matmul-shape kernels' entries of the kernels line."""
    entries = []
    for name, (replaces, rep) in MATMUL_PROBES.items():
        variants = [line for line in out["lines"] if line["kernel"] == name]
        r = next(line for line in variants if line["variant"] == rep
                 and line["B"] == 528 and line["K"] == 64)
        entries.append({
            "name": name, "status": "ported", "route": "cuda",
            "source": "vggt_slam_tpu_torch/csrc/bench_matmul_shapes.cu, "
                      "csrc/sm90_common.cuh",
            "replaces": replaces, "launches": launches[name],
            "launches_path": MATMUL_COMMAND + " (its defaults)",
            "design": "tma_wgmma (mm_sm90: persistent, TMA ring, wgmma, "
                      "TMA-store epilogue)",
            "design_launches_both_kernels": designs,
            "registers": {f"{line['tiling'][0]}x{line['tiling'][1]}":
                          line["registers"] for line in variants},
            "variant": f"B=528 (1056,64,1056) {rep}",
            "max_abs_err": max(line["max_abs_err"] for line in variants),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library": "torch.bmm",
            "variants": variants})
    return entries


# Phases 7-9: training at VGGT-1B width, and the train_tiny CLI

def training_model(device):
    """VGGT-1B with seeded weights on the card, configured for training
    (flash_grad, checkpointing, exact global attention, no point head,
    bf16)."""
    from vggt_slam_tpu_torch.main import build_model
    from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig

    cfg = VGGTConfig.vggt_1b(attn_impl="flash_grad", remat=True,
                             global_kv_stride=1, enable_point_head=False)
    return build_model(cfg, seed=SEED, device=device).train()


def training_batch(n_frames, device):
    from vggt_slam_tpu_torch.tools import synth3d
    batch = synth3d.training_batch(SEED, n_frames=n_frames, image_hw=HW)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


GRAD_LEAVES = {
    "frame_block_qkv": "aggregator.frame_block_12.attn.qkv.kernel",
    "global_block_qkv": "aggregator.global_block_12.attn.qkv.kernel",
    "camera_head_trunk_qkv": "camera_head.trunk_0.attn.qkv.kernel",
    "camera_head_pose_branch": "camera_head.pose_branch.fc2.kernel",
    "depth_head_last_conv": "depth_head.output_conv2_2.kernel",
}


def check_backward(device):
    """A 2-frame VGGT-1B loss's gradient through the kernels against plain:
    relative RMS of named leaves and every attention projection."""

    from vggt_slam_tpu_torch.parallel.train import vggt_loss

    model = training_model(device)
    batch = training_batch(2, device)
    params = dict(model.named_parameters())
    qkv_names = [n for n in params if n.endswith("attn.qkv.kernel")]

    def grads():
        model.zero_grad(set_to_none=True)
        loss = vggt_loss(model, batch)
        loss.backward()
        keep = set(GRAD_LEAVES.values()) | set(qkv_names)
        return float(loss.detach()), {n: params[n].grad.detach().clone()
                             for n in keep}

    A.reset_launch_counts()
    loss_k, g_k = grads()
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)
    with plain_attention():
        loss_p, g_p = grads()
    errs = {k: _rel_rms(g_k[n], g_p[n]) for k, n in GRAD_LEAVES.items()}
    per_block = [[n, _rel_rms(g_k[n], g_p[n])] for n in qkv_names]
    tol = 5e-2
    first_apart = next((n for n, e in per_block if e > tol), None)
    qkv_errs = [e for _, e in per_block]
    log("backward_check", frames=2, loss_kernels=loss_k, loss_plain=loss_p,
        rel_rms_grad_err=errs, tol=tol, launches=launches,
        qkv_leaves=len(qkv_errs), qkv_rel_rms_min=min(qkv_errs),
        qkv_rel_rms_max=max(qkv_errs), first_qkv_leaf_past_tol=first_apart,
        note="relative RMS difference of bf16 gradients through the kernels "
             "and through their plain versions")
    finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    del model, params, g_k, g_p
    torch.cuda.empty_cache()
    if not finite or max(errs.values()) > tol:
        raise AssertionError(f"backward disagrees with the plain path: "
                             f"{errs}; first qkv leaf apart: {first_apart}")


def drive_training(device, n_steps=3, profile=False):
    """`n_steps` of make_train_step at VGGT-1B on a 4-frame batch: the steps'
    launches and the last one's; `profile` adds a profiled step."""

    from vggt_slam_tpu_torch.parallel.train import make_train_step

    torch.cuda.reset_peak_memory_stats()
    model = training_model(device)
    model_cfg = model.cfg
    batch = training_batch(4, device)
    step, _ = make_train_step(model)
    params = list(model.parameters())
    losses, step_ms, per_step = [], [], []
    A.reset_launch_counts()
    designs_before = A.bwd_design_launches()
    fwd_before = A.forward_design_launches()
    for _ in range(n_steps):
        before = dict(A.LAUNCHES)
        t0 = time.perf_counter()
        loss = float(step(batch))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append({k: A.LAUNCHES[k] - before[k] for k in before})
        missing = sum(p.grad is None for p in params)
        finite = all(bool(torch.isfinite(p.grad).all()) for p in params
                     if p.grad is not None)
        if missing or not finite or loss != loss:
            raise AssertionError(f"training step: loss {loss}, {missing} "
                                 f"parameters without a gradient, finite "
                                 f"gradients {finite}")
    launches = dict(A.LAUNCHES)
    designs = {d: n - designs_before[d]
               for d, n in A.bwd_design_launches().items()}
    fwd_designs = {d: n - fwd_before[d]
                   for d, n in A.forward_design_launches().items()}
    peak = torch.cuda.max_memory_allocated()
    if profile:
        log("profile_training_step", frames=4,
            **profiled(lambda: step(batch)))
    log("training", frames=4, image_hw=list(HW), steps=n_steps,
        params=sum(p.numel() for p in params), losses=losses,
        step_ms=step_ms, peak_memory_gib=peak / 2 ** 30,
        launches=launches, launches_per_step=per_step,
        fwd_design_launches=fwd_designs, bwd_design_launches=designs)
    del model, params, step, batch
    torch.cuda.empty_cache()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    for name in ("flash_single", "flash_multi", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "training path")
    want = backward_designs(model_cfg, n_steps)
    if designs != want:
        raise AssertionError(f"the training steps' backward ran {designs} "
                             f"by design, not {want}")
    if fwd_designs != {"tma_wgmma": forward_calls(launches)}:
        raise AssertionError(f"the training steps' forward calls {launches}"
                             f" ran {fwd_designs} by design")
    return launches, per_step[-1]


def backward_designs(cfg, n_steps) -> dict:
    """flash_bwd launches by design in `n_steps` steps of a `cfg` model (each
    camera-trunk block at each iteration), all "tma_wgmma"."""
    return {"tma_wgmma": n_steps * (cfg.enc_depth + 2 * cfg.agg_depth
                                    + cfg.cam_trunk_depth
                                    * cfg.cam_iterations)}


def small_forward_launches(cfg) -> dict:
    """A 4-frame forward's launches of a `cfg` model: flash_single (encoder,
    frame, camera trunk), flash_multi (global)."""

    want = dict.fromkeys(A.LAUNCHES, 0)
    want["flash_single"] = (cfg.enc_depth + cfg.agg_depth
                            + cfg.cam_trunk_depth * cfg.cam_iterations)
    want["flash_multi"] = cfg.agg_depth
    return want


def drive_cli(device):
    """train_tiny on the small model for 6 steps; its checkpoint's forward,
    launches and design checked. The checkpoint (kept for phase R)."""
    import os
    import tempfile

    from vggt_slam_tpu_torch.main import build_model
    from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn
    from vggt_slam_tpu_torch.tools import synth3d

    out = tempfile.mkdtemp(prefix="train_tiny_")
    try:
        cmd = [sys.executable, "-m", "vggt_slam_tpu_torch.tools.train_tiny",
               "--out", out, "--model_size", "small", "--frames", "4",
               "--steps", "6", "--val_every", "3", "--ckpt_every", "3"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, cwd=os.path.dirname(
                                  os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
        tail = proc.stdout.strip().splitlines()[-4:]
        if proc.returncode != 0:
            raise AssertionError(f"train_tiny failed ({proc.returncode}): "
                                 f"{proc.stderr[-2000:]}")
        train_designs = json.loads(tail[-1])["bwd_design_launches"]
        ckpt = os.path.join(out, "checkpoint.npz")
        cfg = VGGTConfig.small(enable_point_head=False)
        model = build_model(cfg, checkpoint=ckpt, device=device)
        fn = make_bucketed_model_fn(model, 4, as_numpy=True, device=device)
        images = synth3d.training_batch(SEED + 1, n_frames=4,
                                        image_hw=HW)["images"]
        pred = {}
        A.reset_launch_counts()
        design = launched_design(lambda: pred.update(fn(images)))
        launches = dict(A.LAUNCHES)
        want = small_forward_launches(cfg)
        finite = all(np.isfinite(pred[k]).all()
                     for k in ("pose_enc", "depth", "depth_conf"))
        with open(os.path.join(out, "train_log.jsonl")) as f:
            n_log = len(f.read().splitlines())
        log("train_tiny_cli", wall_s=wall, files=sorted(os.listdir(out)),
            log_rows=n_log, stdout_tail=tail, forward_finite=finite,
            pose_enc_shape=list(pred["pose_enc"].shape),
            forward_launches=launches, forward_design=design,
            train_bwd_design_launches=train_designs)
        if not finite:
            raise AssertionError("the trained checkpoint's forward is not "
                                 "finite")
        if launches != want:
            raise AssertionError(f"the small model's forward launched "
                                 f"{launches}, not {want}")
        if design != "tma_wgmma":
            raise AssertionError(f"the small model's forward ran {design}, "
                                 f"not tma_wgmma")
        want_bwd = backward_designs(cfg, 6)
        if train_designs != want_bwd:
            raise AssertionError(f"train_tiny's backward ran {train_designs}"
                                 f" by design, not {want_bwd}")
    except BaseException:
        shutil.rmtree(out, ignore_errors=True)
        raise
    return ckpt


# Phases H, S, L: the torch-checkpoint converters, SALAD at full width, and
# loop closure through the CLI

SALAD_TOL = 2e-2      # L2 distance of a descriptor from the plain f32 path
LOOP_SEQ_SEED = 4_000_000     # evals/smoke_loop.py's sequence


def unit_salad_weight(key: str) -> bool:
    """LayerNorm weights and LayerScale gammas drawn as 1 (all N(0, 0.02) let
    no phase S control be rejected)."""
    return key.endswith(".gamma") or (".norm" in key
                                      and key.endswith(".weight"))


def check_converters(tmp):
    """Phase H: both converters over the released manifests; a seeded
    dino_salad checkpoint as the npz of phases S and L (its path)."""

    from vggt_slam_tpu_torch.models import retrieval as R
    from vggt_slam_tpu_torch.models.vggt import convert as C
    from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
    from vggt_slam_tpu_torch.models.vggt.model import VGGT

    def manifest(name):
        with open(os.path.join("tests", "data", f"manifest_{name}.json")) \
                as f:
            return json.load(f)

    out = {}
    for name, convert, template, allowed in (
            ("vggt_1b", C.convert_torch_state_dict,
             C.meta_template(VGGT, VGGTConfig.vggt_1b()),
             C.allowed_unused_vggt),
            ("salad", R.convert_torch_state_dict,
             C.meta_template(R.SALAD, R.SALADConfig()),
             R.allowed_unused_salad)):
        t0 = time.perf_counter()
        sd = {k: torch.zeros(()).expand(s)
              for k, s in manifest(name).items()}
        _, report = convert(sd, template)
        stray = [k for k in report["unused_torch"] if not allowed(k)]
        out[name] = {"torch_keys": len(sd), "params": len(template),
                     "unmatched": report["unmatched_flax"],
                     "unused": report["unused_torch"], "stray": stray,
                     "seconds": time.perf_counter() - t0}
        if report["unmatched_flax"] or stray:
            raise AssertionError(f"{name} converter: {out[name]}")
    g = torch.Generator().manual_seed(SEED)
    sd = {k: torch.ones(s) if unit_salad_weight(k) else
          torch.randn(s, generator=g) * 0.02
          for k, s in manifest("salad").items()}
    ckpt = os.path.join(tmp, "dino_salad.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    npz = os.path.join(tmp, "salad.npz")
    t0 = time.perf_counter()
    report = R.convert_torch_checkpoint(ckpt, npz)
    out["salad_checkpoint"] = {"seconds": time.perf_counter() - t0,
                               "unmatched": report["unmatched_flax"],
                               "unused": report["unused_torch"],
                               "npz_bytes": os.path.getsize(npz)}
    log("converters", **out)
    if report["unmatched_flax"]:
        raise AssertionError("the seeded dino_salad checkpoint left "
                             f"{report['unmatched_flax']} unmatched")
    return npz


@contextlib.contextmanager
def zero_attention():
    """Every attention of the port's modules (`attention`, `flash_single`)
    returns zeros inside the block."""

    from vggt_slam_tpu_torch.models.vggt import modules

    ops = modules.attn_ops
    saved = ops.attention, ops.flash_single
    ops.attention = ops.flash_single = \
        lambda q, k, v, **kw: torch.zeros_like(q)
    try:
        yield
    finally:
        ops.attention, ops.flash_single = saved


def check_salad(device, npz, frames):
    """Phase S: SALAD at full width, phase H's weights, 17 frames: 12
    flash_single a call, within SALAD_TOL (L2) of plain (another frame and
    zeroed attention must exceed it); timed. The row's SALAD entry."""

    from vggt_slam_tpu_torch.data.images import preprocess_frames
    from vggt_slam_tpu_torch.models import retrieval as R

    model = R.build_salad(224, npz, str(device))
    plain = R.SALAD(R.SALADConfig(attn_impl="chunked"))
    plain.load_state_dict(model.state_dict())
    plain = plain.to(device).eval()
    x = torch.from_numpy(preprocess_frames(frames[:17])).to(device)
    with torch.no_grad():
        torch.cuda.synchronize()
        A.reset_launch_counts()
        before = A.forward_design_launches()
        desc = model(x)
        torch.cuda.synchronize()
        launches = dict(A.LAUNCHES)
        designs = {d: n - before[d]
                   for d, n in A.forward_design_launches().items()}
        ref = plain(x)
        with zero_attention():
            broken = plain(x)
        salad_ms = cuda_ms(lambda: model(x), 5)
        plain_salad_ms = cuda_ms(lambda: plain(x), 2)
    dist = torch.linalg.vector_norm(desc - ref, dim=1)
    control = torch.linalg.vector_norm(desc - ref.roll(1, 0), dim=1)
    broken_l2 = torch.linalg.vector_norm(desc - broken, dim=1)
    norms = torch.linalg.vector_norm(desc, dim=1)
    finite = bool(torch.isfinite(desc).all())

    g = torch.Generator(device=device).manual_seed(SEED)
    B, N, H, D = 17, 257, 12, 64
    case = dict(q=None, kw=dict(num_heads=H))
    case["q"], case["k"], case["v"] = (
        torch.randn(B, N, H * D, generator=g, device=device).to(
            torch.bfloat16) for _ in range(3))
    q, k, v = case["q"], case["k"], case["v"]
    with torch.no_grad():
        out_k = A.flash_single(q, k, v, num_heads=H)
        out_p = A.flash_single_ref(q, k, v, num_heads=H)
        err = float((out_k.float() - out_p.float()).abs().max())
        kernel_ms = cuda_ms(lambda: A.flash_single(q, k, v, num_heads=H), 20)
        plain_ms = cuda_ms(lambda: A.flash_single_ref(q, k, v, num_heads=H),
                           5)
        sdpa_ms = cuda_ms(sdpa_call(case), 20)
    bound, bound_by, unit = attention_bound_ms(case)
    res = {"frames": 17, "descriptor_dim": int(desc.shape[1]),
           "launches_per_call": launches, "designs": designs,
           "salad_ms": salad_ms, "plain_salad_ms": plain_salad_ms,
           "max_l2_from_plain": float(dist.max()), "tol": SALAD_TOL,
           "control_min_l2": float(control.min()),
           "zero_attention_min_l2": float(broken_l2.min()),
           "norm_err": float((norms - 1).abs().max()), "finite": finite,
           "flash_single": {"shape_bh_n_d": [B * H, N, D],
                            "max_abs_err": err, "ms": kernel_ms,
                            "plain_ms": plain_ms, "library_ms": sdpa_ms,
                            "bound_ms": bound, "bound_by": bound_by,
                            "bound_unit": unit}}
    log("salad", **res)
    if not finite or tuple(desc.shape) != (17, 8448) or \
            res["norm_err"] > 1e-4:
        raise AssertionError(f"SALAD descriptors {tuple(desc.shape)}, "
                             f"finite {finite}, |norm - 1| "
                             f"{res['norm_err']}")
    if launches != {k: 12 * (k == "flash_single") for k in launches} or \
            designs != {"tma_wgmma": 12}:
        raise AssertionError(f"a SALAD call launched {launches}, "
                             f"{designs} by design: not 12 flash_single "
                             f"on flash_sm90.cuh")
    if res["max_l2_from_plain"] > SALAD_TOL:
        raise AssertionError(f"SALAD on the kernels lies "
                             f"{res['max_l2_from_plain']} from its plain "
                             f"path (tol {SALAD_TOL})")
    for ctrl in ("control_min_l2", "zero_attention_min_l2"):
        if res[ctrl] <= SALAD_TOL:
            raise AssertionError(f"{ctrl} {res[ctrl]} lies within the "
                                 f"tolerance: the check cannot reject it")
    if err > 2e-2:
        raise AssertionError(f"flash_single at SALAD's shape: {err}")
    return {"launches_per_call": 12, "salad_ms": salad_ms,
            **res["flash_single"]}


# Phase L's runs: tiny at smoke_loop's settings; SALAD on phase H's weights
# at the CLI's defaults (B*H = 204) but smoke_loop's keyframe disparity.
LOOP_RUNS = (("tiny", ("--submap_size", "4", "--max_loops", "3",
                       "--min_disparity", "8")),
             ("salad", ("--min_disparity", "8")))


def loop_cli_run(device, seq, backend, extra=()):
    """run_slam on the loop sequence at VGGT-1B (seeded weights): loops
    detected, inserted, rejected; the TUM log and its ATE."""

    from vggt_slam_tpu_torch.evals.ate import ate_from_files
    from vggt_slam_tpu_torch.main import parser, run_slam

    log_path = os.path.join(seq, f"poses_{backend}.txt")
    args = parser.parse_args(
        ["--image_folder", os.path.join(seq, "rgb"), "--retrieval_backend",
         backend, "--log_results", "--skip_dense_log", "--log_path",
         log_path, "--seed", str(SEED), "--timing", *extra])
    result, out, wall, launches, designs = counted(
        lambda: run_slam(args, device=device))
    print(out[-1500:])
    solver = result["solver"]
    stages = {k: {"total_s": v["total_s"], "count": v["count"]}
              for k, v in result["timer"].summary().items()}
    tum = np.loadtxt(log_path) if os.path.exists(log_path) else None
    ate = ate_from_files(os.path.join(seq, "groundtruth.txt"), log_path)
    res = {"backend": backend, "args": list(extra),
           "frames": result["n_frames"],
           "submaps": solver.map.get_num_submaps(),
           "detected": solver.detected_loop_count,
           "inserted": solver.graph.get_num_loops(),
           "rejected": solver.rejected_loop_count,
           "tum_rows": None if tum is None else int(tum.shape[0]),
           "ate_rmse_random_weights": ate.rmse, "ate_pairs": ate.n_pairs,
           "wall_s": wall, "fps": result["n_frames"] / wall,
           "launches": launches, "designs": designs, "stages": stages}
    log("loop_cli", **res)
    if tum is None or tum.ndim != 2 or tum.shape[1] != 8 or \
            not np.isfinite(tum).all():
        raise AssertionError(f"{backend}: the TUM pose log was not written")
    if res["detected"] < 1 or \
            res["detected"] != res["inserted"] + res["rejected"]:
        raise AssertionError(f"{backend}: loops detected {res['detected']},"
                             f" inserted {res['inserted']}, rejected "
                             f"{res['rejected']}")
    if designs != {"tma_wgmma": forward_calls(launches)}:
        raise AssertionError(f"{backend}: forward calls {launches} ran "
                             f"{designs} by design")
    del result, solver
    return res


def run_smoke_loop(*argv):
    """evals/smoke_loop.py as a subprocess; (exit code, stdout)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vggt_slam_tpu_torch.evals.smoke_loop",
         *argv], capture_output=True, text=True, timeout=600)
    log("smoke_loop", argv=list(argv), rc=proc.returncode,
        seconds=time.perf_counter() - t0,
        stdout_tail=proc.stdout.strip().splitlines()[-6:])
    return proc.returncode, proc.stdout + proc.stderr[-1500:]


def drive_loop_closure(device, npz, small_ckpt):
    """Phase L: a 40-frame loop through the 1B CLI, tiny and SALAD backends
    (>= 1 loop, inserted or rejected, or a factor without the gate); V to
    T on it (R with phase 9's `small_ckpt`); smoke_loop without the gate
    (it exits 1 at its defaults in both packages). (SALAD's launches,
    {"clip": P's entry, "siglip": N's, "voxel_eval_launches"})."""

    from vggt_slam_tpu_torch.tools.synth3d import write_tum_sequence

    seq = tempfile.mkdtemp(prefix="loop_seq_")
    try:
        t0 = time.perf_counter()
        write_tum_sequence(seq, n_frames=40, seed=LOOP_SEQ_SEED,
                           image_hw=HW, kind="loop")
        log("loop_sequence", frames=40, seconds=time.perf_counter() - t0)
        runs = {}
        for backend, settings in LOOP_RUNS:
            if backend == "salad":
                settings += ("--retrieval_checkpoint", npz)
            runs[backend] = loop_cli_run(device, seq, backend, settings)
            if runs[backend]["inserted"] == 0:
                r = loop_cli_run(device, seq, backend,
                                 settings + ("--loop_inlier_thresh", "0"))
                if r["inserted"] < 1:
                    raise AssertionError(f"{backend}: no loop factor "
                                         f"without the gate")
            torch.cuda.empty_cache()
        # a VGGT forward a submap (88 calls at 1B), plus 12 SALAD's in SALAD's
        tiny, salad = runs["tiny"], runs["salad"]
        per_forward = forward_calls(tiny["launches"]) / tiny["submaps"]
        want = salad["submaps"] * (per_forward + 12)
        if forward_calls(salad["launches"]) != want:
            raise AssertionError(f"the SALAD run launched "
                                 f"{salad['launches']}, not {want} forward "
                                 f"calls")
        drive_viewer_and_evals(device, seq)
        drive_semantics(device, seq)
        encoders = {"clip": drive_encoders(device, seq,
                                           os.path.join(seq, "clip"))}
        drive_sam2(device, seq, os.path.join(seq, "clip"))
        encoders["siglip"] = drive_encoders(
            device, seq, os.path.join(seq, "siglip"), "siglip")
        encoders["voxel_eval_launches"] = drive_evals(
            device, seq, os.path.join(seq, "sam2.1_hiera_base_plus.pt"),
            os.path.join(seq, "phase_N", "vox"), os.path.join(seq, "siglip"),
            os.path.join(seq, "phase_v"))
        drive_quality_evals(device, small_ckpt, seq)
        drive_tools(device, seq, os.path.join(seq, "phase_v"))
    finally:
        shutil.rmtree(seq, ignore_errors=True)
        shutil.rmtree(os.path.dirname(small_ckpt), ignore_errors=True)
    rc, out = run_smoke_loop("--loop_inlier_thresh", "0")
    if rc != 0:
        raise AssertionError(f"smoke_loop without the gate failed ({rc}): "
                             f"{out[-3000:]}")
    return salad["launches"], encoders


# Phase V: the rest of the CLI (COLMAP alignment, the profiler trace, the
# viewer, GLB export) and the host evals, on phase L's sequence

ALIGN_SIM3 = (1.5, (0.3, -0.2, 0.1), (0.5, -1.0, 2.0))  # s, axis-angle, t


def rotation(w):
    """The rotation by axis-angle w (Rodrigues)."""
    th = np.linalg.norm(w)
    K = np.cross(np.eye(3), np.asarray(w) / th)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def write_colmap_images(seq, path):
    """images.txt with each frame's camera at its groundtruth.txt centre under
    ALIGN_SIM3 (identity orientations)."""

    s, w, t = ALIGN_SIM3
    R = rotation(w)
    lines = []
    with open(os.path.join(seq, "groundtruth.txt")) as f:
        rows = [r.split() for r in f if r.strip() and not r.startswith("#")]
    for i, r in enumerate(rows):
        c = s * R @ np.array(r[1:4], float) + np.array(t)
        lines += [f"{i + 1} 1 0 0 0 {-c[0]:.17g} {-c[1]:.17g} "
                  f"{-c[2]:.17g} 1 {r[0]}.png", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(rows)


def check_glb(path, n_points):
    """The GLB's header, JSON chunk and point accessor."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    magic, version, total = struct.unpack_from("<III", data)
    js_len, js_type = struct.unpack_from("<II", data, 12)
    gltf = json.loads(data[20:20 + js_len])
    count = gltf["accessors"][gltf["meshes"][0]["primitives"][0][
        "attributes"]["POSITION"]]["count"]
    if (magic, version, total, js_type) != (0x46546C67, 2, len(data),
                                            0x4E4F534A) or count != n_points:
        raise AssertionError(f"GLB: {magic:#x} v{version} {total}/"
                             f"{len(data)} bytes, {count} of {n_points} "
                             f"points")
    return len(data)


def check_trace(path):
    """Parse the CLI's Chrome trace; count its CUDA kernel events."""
    t0 = time.perf_counter()
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"bytes": size, "events": len(events), "kernels": len(kernels),
            "flash_kernels": sorted({k for k in kernels if "flash" in k}),
            "parse_s": time.perf_counter() - t0}


def load_viser_stub():
    """tests/viser_stub.py by path (an installed package named `tests`
    may shadow the repository's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "viser_stub", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "viser_stub.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def viewer_cli_run(device, seq, tmp):
    """The CLI at VGGT-1B (tiny backend, submap 16) with the COLMAP alignment,
    the outputs and the viewer stub."""

    from vggt_slam_tpu_torch.main import parser, run_slam
    from vggt_slam_tpu_torch.slam.map import GraphMap
    from vggt_slam_tpu_torch.viz.glb import GLBExporter

    calls = load_viser_stub().install(sys.modules)
    images_txt = os.path.join(tmp, "images.txt")
    n_gt = write_colmap_images(seq, images_txt)
    args = parser.parse_args(
        ["--image_folder", os.path.join(seq, "rgb"), "--retrieval_backend",
         "tiny", "--min_disparity", "8", "--colmap_images_txt", images_txt,
         "--save_path", os.path.join(tmp, "out"), "--log_results",
         "--skip_dense_log", "--log_path", os.path.join(tmp, "poses.txt"),
         "--vis_map",
         "--vis_stride", "4", "--seed", str(SEED), "--timing"])
    seen = {}
    align = GraphMap.align_scale_to_colmap

    def recording(self, *a, **kw):
        seen["before"] = {k: s.get_reference_homography().copy()
                          for k, s in self.submaps.items()}
        seen["T"] = align(self, *a, **kw)
        return seen["T"]

    GraphMap.align_scale_to_colmap = recording
    try:
        result, out, wall, launches, designs = counted(
            lambda: run_slam(args, device=device))
    finally:
        GraphMap.align_scale_to_colmap = align
    print(out[-1500:], flush=True)
    if designs != {"tma_wgmma": forward_calls(launches)}:
        raise AssertionError(f"forward calls {launches} ran {designs}")
    solver = result["solver"]
    subs = list(solver.map.ordered_submaps_by_key())
    rm = re.search(r"RMSE before: (\S+)\s+after: (\S+)", out)
    if not rm or float(rm.group(2)) > float(rm.group(1)):
        raise AssertionError(f"[align]: {rm and rm.groups()}")
    T = seen["T"]
    for s in subs:
        want = T @ seen["before"][s.get_id()]
        got = s.get_reference_homography()
        if np.abs(got - want).max() > 1e-9 * np.abs(want).max():
            raise AssertionError(f"submap {s.get_id()}: H != T H_before")
    # the viewer: a point cloud per submap, a frame and a frustum per pose
    poses = sum(len(s.get_all_poses_world()) for s in subs)
    want = {"scene.add_point_cloud": len(subs), "scene.add_frame": poses,
            "scene.add_camera_frustum": poses}
    named = {k: set() for k in want}
    for name, a, kw in calls:
        if name in want:
            named[name].add(kw.get("name") or a[0])
    got = {k: len(v) for k, v in named.items()}
    if got != want or named["scene.add_point_cloud"] != {
            f"pcd_{s.get_id()}" for s in subs}:
        raise AssertionError(f"viewer calls {got}, want {want}")
    ex = GLBExporter()
    for s in subs:
        ex.add_point_cloud(s.get_points_in_world_frame(stride=4),
                           s.get_points_colors(stride=4))
        for pose in s.get_all_poses_world(ignore_loop_closure_frames=True):
            ex.add_camera_pose(pose)
    n_points = sum(len(p) for p in ex.points)
    glb_bytes = check_glb(ex.export(os.path.join(tmp, "scene.glb")),
                          n_points)
    res = {"frames": result["n_frames"], "submaps": len(subs),
           "gt_frames": n_gt, "align": [float(v) for v in rm.groups()],
           "T": T.tolist(), "wall_s": wall, "fps": result["n_frames"] / wall,
           "viewer_calls": got, "glb_points": n_points,
           "glb_bytes": glb_bytes, "launches": launches,
           "designs": designs,
           "stages": {k: v["total_s"]
                      for k, v in result["timer"].summary().items()}}
    log("viewer_cli", **res)
    return res


def profiled_cli_run(device, seq, tmp):
    """--profile_dir on the loop's first 17 frames (one submap): a trace
    with the flash kernels among its CUDA kernel events."""
    from vggt_slam_tpu_torch.main import parser, run_slam

    frames = os.path.join(tmp, "first17")
    os.makedirs(frames)
    for n in sorted(os.listdir(os.path.join(seq, "rgb")))[:17]:
        os.symlink(os.path.join(seq, "rgb", n), os.path.join(frames, n))
    args = parser.parse_args(
        ["--image_folder", frames, "--retrieval_backend", "tiny",
         "--min_disparity", "8", "--profile_dir", os.path.join(tmp, "prof"),
         "--seed", str(SEED)])
    _, _, wall, launches, designs = counted(
        lambda: run_slam(args, device=device))
    trace = check_trace(os.path.join(tmp, "prof", "trace.json"))
    os.remove(os.path.join(tmp, "prof", "trace.json"))
    log("profiled_cli", wall_s=wall, trace=trace, launches=launches)
    if not trace["flash_kernels"] or \
            designs != {"tma_wgmma": forward_calls(launches)}:
        raise AssertionError(f"the trace: {trace}; {designs}")


def drive_viewer_and_evals(device, seq):
    """Phase V: COLMAP alignment, viewer, GLB, a 17-frame trace; run_eval,
    process_logs, geometry_eval (100k points), pipeline_overlap."""
    from scipy.spatial import cKDTree

    from vggt_slam_tpu_torch.data.pcd import read_pcd
    from vggt_slam_tpu_torch.evals import geometry_eval as GE
    from vggt_slam_tpu_torch.evals import process_logs, run_eval
    from vggt_slam_tpu_torch.native import kdtree

    t_phase = time.perf_counter()
    tmp = os.path.join(seq, "phase_v")
    os.makedirs(tmp)      # kept for phase Q
    viewer_cli_run(device, seq, tmp)
    profiled_cli_run(device, seq, tmp)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    csv_path = os.path.join(tmp, "eval.csv")
    rows = run_eval.main(
        ["--dataset_root", os.path.dirname(seq), "--sequences",
         os.path.basename(seq), "--trials", "1", "--min_disparity", "8",
         "--global_kv_stride", "16", "--retrieval_backend", "tiny",
         "--in_process", "--out", csv_path])
    run_eval._WARM.update(model_fn=None, retrieval=None)
    torch.cuda.empty_cache()
    summary = process_logs.summarize(csv_path)
    row = rows[0]
    log("run_eval", row=row, summary=summary,
        seconds=time.perf_counter() - t0)
    if len(rows) != 1 or not np.isfinite(row["ate_rmse"]) or \
            row["ate_pairs"] < 30:
        raise AssertionError(f"run_eval: {rows}")

    t0 = time.perf_counter()
    pts, _ = read_pcd(os.path.join(tmp, "out", "result.pcd"))
    pts = pts[:: max(1, len(pts) // 100_000)]
    shifted = pts + np.float32([0.01, -0.02, 0.005])
    if not kdtree.available():
        raise AssertionError("the kd-tree did not build")
    d = GE.nn_distances(pts, shifted)
    d_ref, _ = cKDTree(shifted).query(pts, k=1, workers=-1)
    cham = GE.chamfer(pts, shifted)
    err = float(np.abs(d - d_ref).max())
    log("geometry_eval", points=len(pts), max_abs_vs_ckdtree=err,
        chamfer=cham, seconds=time.perf_counter() - t0)
    if err > 1e-6 or d.max() > 0.0230:   # no farther than |shift|
        raise AssertionError(f"geometry_eval: {err}, {cham}")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vggt_slam_tpu_torch.evals."
         "pipeline_overlap", "--seq_dir", seq, "--frames", "40",
         "--warmup_frames", "17", "--submap_size", "16",
         "--min_disparity", "8", "--model_size", "1b", "--out",
         os.path.join(tmp, "pipeline_overlap.txt")],
        capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"pipeline_overlap ({proc.returncode}): "
                             f"{proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    split = json.loads(lines[-1])
    log("pipeline_overlap", **split, seconds=time.perf_counter() - t0,
        report=lines[-30:-2])
    if any(split[k]["frames"] != 40 or not split[k]["fps"] > 0
           for k in ("serial", "pipelined")):
        raise AssertionError(f"pipeline_overlap: {split}")
    log("phase_v", seconds=time.perf_counter() - t_phase)


# Phase W: the semantic voxel map on phase L's sequence

SEMANTIC_TARGET = 128       # the embedder's square size (the Solver resizes)
VOXEL_SIZE = 0.05


def voxelize_errors(got, centers, counts, means, feats):
    """voxelize_device against voxelize_np's first num voxels: (centres equal,
    counts equal, means within mean_tolerance, largest mean error)."""

    from vggt_slam_tpu_torch.ops.voxel import mean_tolerance

    c, m, n, num = (x.cpu().numpy() for x in got)
    k = int(num)
    if k > len(centers):
        return False, False, False, float("inf")
    err = np.abs(m[:k] - means[:k]).max(1)
    return (bool(np.array_equal(c[:k], centers[:k])),
            bool(np.array_equal(n[:k], counts[:k]) and not n[k:].any()),
            bool((err <= mean_tolerance(counts[:k], feats)).all()),
            float(err.max(initial=0.0)))


def check_voxelize(device, pts, feats, V):
    """voxelize_device against voxelize_np at capacity V + 1 and V // 2, a
    half-voxel shift it must reject; timed. (results, voxelize_np's)."""

    from vggt_slam_tpu_torch.ops.voxel import voxelize_device, voxelize_np

    t0 = time.perf_counter()
    centers, means, inverse = voxelize_np(pts, feats, VOXEL_SIZE)
    np_s = time.perf_counter() - t0
    counts = np.bincount(inverse)
    if len(centers) != V:
        raise AssertionError(f"voxelize_np: {len(centers)} voxels, the map "
                             f"{V}")
    p, f = torch.from_numpy(pts).to(device), torch.from_numpy(feats).to(device)
    mask = torch.ones(len(pts), dtype=torch.bool, device=device)
    res = {"np_s": np_s}
    for name, cap in (("full", V + 1), ("half", V // 2)):
        got = voxelize_device(p, f, mask, VOXEL_SIZE, cap)
        ok = voxelize_errors(got, centers, counts, means, feats)
        res[name] = {"capacity": cap, "num": int(got[3]),
                     "centres": ok[0], "counts": ok[1], "means": ok[2],
                     "max_abs_err": ok[3]}
        if not all(ok[:3]) or int(got[3]) != min(V, cap):
            raise AssertionError(f"voxelize_device ({name}): {res[name]}")
    shifted = voxelize_device(p + VOXEL_SIZE / 2, f, mask, VOXEL_SIZE, V + 1)
    ctrl = voxelize_errors(shifted, centers, counts, means, feats)
    res["control_rejected"] = not all(ctrl[:3])
    if not res["control_rejected"]:
        raise AssertionError("voxelize_device: the shifted control passed")
    res["device_ms"] = cuda_ms(
        lambda: voxelize_device(p, f, mask, VOXEL_SIZE, V + 1), 3)
    return res, (centers, means, counts)


def drive_semantics(device, seq):
    """Phase W: the embedder CLI; the 1B CLI with --get_voxel; the saved map
    checked; `check_voxelize`; query_voxelmap --visualize on the stub."""

    from vggt_slam_tpu_torch.data.images import load_image, resize_linear
    from vggt_slam_tpu_torch.main import parser, run_slam
    from vggt_slam_tpu_torch.native import felzenszwalb
    from vggt_slam_tpu_torch.ops.voxel import mean_tolerance
    from vggt_slam_tpu_torch.semantic import embedder
    from vggt_slam_tpu_torch.semantic.voxel_map import SemanticVoxelMap
    from vggt_slam_tpu_torch.tools import query_voxelmap

    t_phase = time.perf_counter()
    rgb = os.path.join(seq, "rgb")
    frames = sorted(os.listdir(rgb))
    with tempfile.TemporaryDirectory(prefix="phase_w_") as tmp:
        emb_dir, vox_dir = os.path.join(tmp, "emb"), os.path.join(tmp, "vox")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            n = embedder.main(["--image_dir", rgb, "--out_dir", emb_dir,
                               "--target_size", str(SEMANTIC_TARGET)])
        embed_s = time.perf_counter() - t0
        first = load_image(os.path.join(rgb, frames[0]))[..., ::-1] / 255.0
        masks = embedder.felzenszwalb_mask_generator(resize_linear(
            first.astype(np.float32), SEMANTIC_TARGET, SEMANTIC_TARGET))
        with np.load(os.path.join(emb_dir, os.path.splitext(frames[0])[0]
                                  + ".npz")) as z:
            d = z["embedding"].shape[-1]
        log("embedder", frames=n, seconds=embed_s, s_per_frame=embed_s / n,
            masks_first_frame=len(masks), d=d, out=out.getvalue().strip())
        if n != len(frames) or not felzenszwalb.available() or \
                "felzenszwalb_mask_generator" not in out.getvalue():
            raise AssertionError(f"embedder: {n} of {len(frames)} frames, "
                                 f"{out.getvalue()!r}")

        args = parser.parse_args(
            ["--image_folder", rgb, "--retrieval_backend", "tiny",
             "--min_disparity", "8", "--semantic_emb_dir", emb_dir,
             "--get_voxel", "--voxel_size", str(VOXEL_SIZE),
             "--voxel_save_dir", vox_dir, "--seed", str(SEED), "--timing"])
        result, _, wall, launches, designs = counted(
            lambda: run_slam(args, device=device))
        if designs != {"tma_wgmma": forward_calls(launches)} or \
                not forward_calls(launches):
            raise AssertionError(f"forward calls {launches} ran {designs}")
        solver = result["solver"]
        stages = result["timer"].summary()
        t0 = time.perf_counter()       # the build's point filters alone
        pts, feats, _, _, _ = solver.map.semantic_points(VOXEL_SIZE,
                                                         device=device)
        points_s = time.perf_counter() - t0
        vm = result["voxel_map"]
        V = len(vm.get_centers_world())
        res = {"frames": result["n_frames"],
               "submaps": solver.map.get_num_submaps(), "wall_s": wall,
               "build_s": stages["semantic_voxel_map"]["total_s"],
               "filters_s": points_s,
               "N": len(pts), "V": V, "d": int(feats.shape[1]),
               "launches": launches, "designs": designs,
               "stages": {k: v["total_s"] for k, v in stages.items()}}
        log("semantic_cli", **res)
        del result, solver
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        loaded = SemanticVoxelMap.load_from_directory(vox_dir)
        load_s = time.perf_counter() - t0
        names = set(frames)
        bad = [c for c in {c for cs in loaded.get_contributors() for c in cs}
               if loaded.resolve_contributor(*c) not in names]
        lf = loaded.get_features()
        if V == 0 or len(loaded.get_centers_world()) != V or \
                not np.isfinite(lf).all() or bad:
            raise AssertionError(f"saved map: V {V}, "
                                 f"{len(loaded.get_centers_world())} loaded, "
                                 f"finite {np.isfinite(lf).all()}, "
                                 f"{len(bad)} unresolved contributors")
        vox, (centers, means, counts) = check_voxelize(device, pts, feats, V)
        map_err = np.abs(lf - means).max(1)
        if not np.array_equal(loaded.get_centers_world(), centers) or \
                (map_err > mean_tolerance(counts, feats)).any():
            raise AssertionError(f"the map's voxels are not voxelize_np's "
                                 f"(features off by {map_err.max()})")
        log("voxelize", **vox, map_max_abs_err=float(map_err.max()),
            load_s=load_s)

        calls = load_viser_stub().install(sys.modules)
        # phase V's viewer module holds phase V's stub: import it afresh
        sys.modules.pop("vggt_slam_tpu_torch.viz.viser_viewer", None)
        out, stdin = io.StringIO(), sys.stdin
        sys.stdin = io.StringIO("")      # show_voxels waits for Enter
        try:
            with contextlib.redirect_stdout(out):
                ranked = query_voxelmap.main(
                    ["--voxel_dir", vox_dir, "--query", "a chair",
                     "--top_k", "5", "--image_dir", rgb, "--out_dir",
                     os.path.join(tmp, "query"), "--visualize"])
        finally:
            sys.stdin = stdin
        clouds = [kw for name, _, kw in calls
                  if name == "scene.add_point_cloud"]
        log("query_voxelmap", ranked=[list(r) for r in ranked],
            copied=len(os.listdir(os.path.join(tmp, "query"))),
            viewer_points=len(clouds[0]["points"]) if clouds else 0)
        if len(ranked) != 5 or any(r[3] not in names for r in ranked) or \
                len(clouds) != 1:
            raise AssertionError(f"query_voxelmap: {ranked}, {len(clouds)} "
                                 f"clouds")
    log("phase_w", seconds=time.perf_counter() - t_phase)


# Phases P and N: CLIP ViT-B/32 and SigLIP base-patch16-224 with their
# tokenizers on the card, then the semantic map on their features

ENCODER_TOL = SALAD_TOL   # L2 distance of a unit feature from the plain path
CLIP_TEXT_TOL = 1e-4      # CLIP's causal text tower (plain) against the CPU
CLIP_MERGES = ("c h", "a i", "ai r</w>", "ch air</w>", "t a", "b l",
               "ta bl", "tabl e</w>", "d o", "o r</w>", "do or</w>", "c a",
               "ca t</w>")
QUERIES = ("a chair", "a table by the door", "IT'S a photo of a cat!",
           "½ cup ٣ café", "")
# family: (phase, frames of phase L's sequence, d, vision tokens, manifest,
# its values, whether the text tower runs flash_single)
ENCODERS = {"clip": ("P", 8, 512, 50, "manifest_clip_vit_b32.json",
                     151_277_313, False),
            "siglip": ("N", 4, 768, 196, "manifest_siglip_b16.json",
                       203_155_970, True)}


def encoder_module(family):
    from vggt_slam_tpu_torch.models import clip, siglip
    M = clip if family == "clip" else siglip
    cfg = M.CLIPConfig.base_patch32() if family == "clip" else \
        M.SigLIPConfig.base_patch16_224()
    return M, cfg


def write_encoder_checkpoint(path, device, family="clip"):
    """A full-width checkpoint directory (config.json, seeded
    pytorch_model.bin as the tests/data manifest, tokenizer files).
    (values, seconds)."""
    import string

    M, cfg = encoder_module(family)
    *_, manifest, want, _ = ENCODERS[family]
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(SEED)
    sd = {k: v.cpu() for k, v in M.init_torch_state_dict(cfg, g).items()}
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", manifest)) as f:
        manifest = {k: tuple(v) for k, v in json.load(f).items()}
    values = sum(v.numel() for v in sd.values())
    if {k: tuple(v.shape) for k, v in sd.items()} != manifest or \
            values != want:
        raise AssertionError(f"the seeded checkpoint ({len(sd)} keys, "
                             f"{values} values) is not the manifest's")
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f)
    if family == "siglip":
        from vggt_slam_tpu_torch.models.siglip_tokenizer import \
            SigLIPTokenizer, write_spiece_model
        words = sorted({w for q in QUERIES
                        for w in SigLIPTokenizer.canonicalize(q).split()})
        pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2),
                  ("▁", -4.0, 1)] + [("▁" + w, -1.0, 1) for w in words] + \
            [(c, -5.0, 1) for c in string.ascii_letters + string.digits]
        with open(os.path.join(path, "spiece.model"), "wb") as f:
            f.write(write_spiece_model(pieces))
        return values, time.perf_counter() - t0
    from vggt_slam_tpu_torch.models.clip_tokenizer import bytes_to_unicode
    vocab = list(bytes_to_unicode().values())
    vocab += [v + "</w>" for v in vocab]
    vocab += ["".join(m.split()) for m in CLIP_MERGES]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(CLIP_MERGES) + "\n")
    return values, time.perf_counter() - t0


@contextlib.contextmanager
def permuted_keys():
    """flash_single sees each row's keys rolled by one token against its
    values: a kernel that pairs keys with the wrong values."""

    flash = A.flash_single
    A.flash_single = lambda q, k, v, **kw: flash(
        q, k.roll(1, dims=1).contiguous(), v, **kw)
    try:
        yield
    finally:
        A.flash_single = flash


def clip_crops(seq, n, size, seed=SEED):
    """n (3, size, size) float [0, 1] windows of phase L's frames."""

    from vggt_slam_tpu_torch.data.images import load_image

    rgb = os.path.join(seq, "rgb")
    names = sorted(os.listdir(rgb))[:10]
    frames = [load_image(os.path.join(rgb, f))[..., ::-1] for f in names]
    rng = np.random.default_rng(seed)
    out = np.empty((n, 3, size[0], size[1]), np.float32)
    for i in range(n):
        f = frames[i % len(frames)]
        y = rng.integers(0, f.shape[0] - size[0] + 1)
        x = rng.integers(0, f.shape[1] - size[1] + 1)
        out[i] = f[y:y + size[0], x:x + size[1]].transpose(2, 0, 1) / 255.0
    return out


def kernel_vs_plain(fn, model):
    """fn() on the kernel, then plain, with zeroed attention and with permuted
    keys: (features, launches, designs, max L2 from plain, the controls'
    min L2)."""

    torch.cuda.synchronize()
    A.reset_launch_counts()
    before = A.forward_design_launches()
    feats = fn()
    launches = dict(A.LAUNCHES)
    designs = {d: n - before[d]
               for d, n in A.forward_design_launches().items()}
    model.set_attn_impl("plain")
    ref = fn()
    model.set_attn_impl("flash")
    with zero_attention():
        zeroed = fn()
    with permuted_keys():
        permuted = fn()

    def l2(a):
        return np.linalg.norm(a - ref, axis=1)

    return feats, launches, designs, float(l2(feats).max()), {
        "zero_attention_min_l2": float(l2(zeroed).min()),
        "permuted_keys_min_l2": float(l2(permuted).min())}


def flash_single_at(device, B, N):
    """flash_single at (B, N, 12, 64) against its plain version, timed
    beside it and SDPA, with its bound."""

    g = torch.Generator(device=device).manual_seed(SEED)
    case = dict(kw=dict(num_heads=12))
    q, k, v = case["q"], case["k"], case["v"] = tuple(
        torch.randn(B, N, 768, generator=g, device=device).to(
            torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        err = float((A.flash_single(q, k, v, num_heads=12).float()
                     - A.flash_single_ref(q, k, v, num_heads=12).float()
                     ).abs().max())
        res = {"shape_b_n_h_d": [B, N, 12, 64], "max_abs_err": err,
               "ms": cuda_ms(lambda: A.flash_single(q, k, v, num_heads=12),
                             20),
               "plain_ms": cuda_ms(lambda: A.flash_single_ref(
                   q, k, v, num_heads=12), 5),
               "library_ms": cuda_ms(sdpa_call(case), 20)}
    res["bound_ms"], res["bound_by"], res["bound_unit"] = \
        attention_bound_ms(case)
    if err > 2e-2:
        raise AssertionError(f"flash_single at ({B}, {N}): {err}")
    return res


def check_encoders(device, ckpt, seq, family):
    """resolve_clip_encoders on 100 crops at 224 px and 6 at 180 x 150: 12
    flash_single a chunk, within ENCODER_TOL (L2) of plain (controls must
    exceed it); the text tower likewise (SigLIP) or within CLIP_TEXT_TOL
    of the CPU; timings."""

    from vggt_slam_tpu_torch.semantic.embedder import resolve_clip_encoders

    M, _ = encoder_module(family)
    _, _, d, tokens, _, _, text_flash = ENCODERS[family]
    t0 = time.perf_counter()
    encode_crops, encode_text = resolve_clip_encoders(ckpt, "auto",
                                                      str(device))
    load_s = time.perf_counter() - t0
    model = encode_crops.model
    crops = clip_crops(seq, 100, (224, 224))
    odd = clip_crops(seq, 6, (180, 150), seed=SEED + 1)
    t0 = time.perf_counter()
    feats, launches, designs, err, ctrl = kernel_vs_plain(
        lambda: np.concatenate([encode_crops(crops), encode_crops(odd)]),
        model)
    encode_s = time.perf_counter() - t0
    per_chunk, chunks = 12, 2 + 1
    res = {"crops": len(feats), "d": int(feats.shape[1]), "load_s": load_s,
           "encode_s": encode_s, "launches": launches, "designs": designs,
           "max_l2_from_plain": err, "tol": ENCODER_TOL, **ctrl,
           "norm_err": float(np.abs(np.linalg.norm(feats, axis=1) - 1).max()),
           "finite": bool(np.isfinite(feats).all())}
    want = {"flash_single": per_chunk * chunks}
    if text_flash:
        text, tl, td, terr, tctrl = kernel_vs_plain(
            lambda: encode_text(list(QUERIES)), model)
        res.update(text_launches=tl, text_designs=td,
                   text_max_l2_from_plain=terr,
                   **{"text_" + k: v for k, v in tctrl.items()})
        ctrl.update({"text_" + k: v for k, v in tctrl.items()})
        if terr > ENCODER_TOL or td != {"tma_wgmma": per_chunk} or \
                tl != {n: per_chunk * (n == "flash_single") for n in tl}:
            raise AssertionError(f"{family}'s text tower on the kernel: "
                                 f"{terr} from plain, {tl}, {td}")
    else:
        text = encode_text(list(QUERIES))
        _, cpu_text = M.make_encoders(ckpt, device="cpu")
        res["text_max_abs_err"] = float(np.abs(
            text - cpu_text(list(QUERIES))).max())
        if res["text_max_abs_err"] > CLIP_TEXT_TOL:
            raise AssertionError(f"CLIP's text tower on the card lies "
                                 f"{res['text_max_abs_err']} from the CPU")
    x = M.preprocess_images(torch.from_numpy(crops[:64]).to(device), 224)
    with torch.no_grad():
        res["vision_ms_batch64"] = cuda_ms(lambda: model.encode_image(x), 10)
        model.set_attn_impl("plain")
        res["plain_vision_ms_batch64"] = cuda_ms(
            lambda: model.encode_image(x), 10)
        model.set_attn_impl("flash")
    res["crops_per_s"] = 64e3 / res["vision_ms_batch64"]
    res["launches_per_chunk"] = per_chunk
    res["flash_single"] = flash_single_at(device, 64, tokens)
    if text_flash:
        res["flash_single_text"] = flash_single_at(device, 64, 64)
    log(family, **res)
    if not res["finite"] or feats.shape != (106, d) or \
            res["norm_err"] > 1e-4 or text.shape != (len(QUERIES), d):
        raise AssertionError(f"{family} features {feats.shape}, finite "
                             f"{res['finite']}, |norm - 1| "
                             f"{res['norm_err']}, text {text.shape}")
    if launches != {n: want.get(n, 0) for n in launches} or \
            designs != {"tma_wgmma": per_chunk * chunks}:
        raise AssertionError(f"{family}'s {chunks} chunks launched "
                             f"{launches}, {designs} by design: not "
                             f"{per_chunk} flash_single a chunk on "
                             f"flash_sm90.cuh")
    if err > ENCODER_TOL:
        raise AssertionError(f"{family} on the kernel lies {err} from its "
                             f"plain path (tol {ENCODER_TOL})")
    for name, v in ctrl.items():
        if v <= ENCODER_TOL:
            raise AssertionError(f"{name} {v} lies within the tolerance: "
                                 f"the check cannot reject it")
    return res


def drive_encoders(device, seq, ckpt, family="clip"):
    """Phase P (CLIP) or N (SigLIP): the checkpoint, `check_encoders`, the
    embedder CLI (12 flash_single a frame), the small CLI with
    --get_voxel, query_voxelmap. flash_single's entry."""

    from vggt_slam_tpu_torch.main import parser, run_slam
    from vggt_slam_tpu_torch.semantic import embedder
    from vggt_slam_tpu_torch.tools import query_voxelmap

    phase, n_frames, d_want = ENCODERS[family][:3]
    t_phase = time.perf_counter()
    os.makedirs(ckpt, exist_ok=True)
    tmp = os.path.join(seq, f"phase_{phase}")
    os.makedirs(tmp)      # N's map is phase Q's
    values, write_s = write_encoder_checkpoint(ckpt, device, family)
    log(f"{family}_checkpoint", values=values, seconds=write_s)
    res = check_encoders(device, ckpt, seq, family)
    torch.cuda.empty_cache()

    rgb = os.path.join(tmp, "rgb")
    os.makedirs(rgb)
    frames = sorted(os.listdir(os.path.join(seq, "rgb")))[:n_frames]
    for f in frames:
        shutil.copy(os.path.join(seq, "rgb", f), rgb)
    emb_dir, vox_dir = os.path.join(tmp, "emb"), os.path.join(tmp, "vox")

    n, out, embed_s, launches, designs = counted(lambda: embedder.main(
        ["--image_dir", rgb, "--out_dir", emb_dir, "--target_size",
         str(SEMANTIC_TARGET), "--clip_model_dir", ckpt,
         "--device", "cuda"]))
    painted, norm_err, finite, d = 0.0, 0.0, True, set()
    for f in frames:
        with np.load(os.path.join(emb_dir, os.path.splitext(f)[0]
                                  + ".npz")) as z:
            e = z["embedding"]
        norms = np.linalg.norm(e, axis=-1)
        d.add(e.shape[-1])
        finite &= bool(np.isfinite(e).all())
        painted += float((norms > 0).mean()) / len(frames)
        norm_err = max(norm_err, float(np.abs(norms[norms > 0] - 1).max()))
    emb = {"frames": n, "seconds": embed_s, "s_per_frame": embed_s / n,
           "launches": launches, "designs": designs, "d": sorted(d),
           "painted_share": painted, "norm_err": norm_err,
           "finite": finite, "out": out}
    log(f"{family}_embedder", **emb)
    per = res["launches_per_chunk"] * n
    if n != len(frames) or d != {d_want} or not finite or \
            norm_err > 1e-4 or "felzenszwalb_mask_generator" not in out \
            or launches["flash_single"] != per or \
            designs != {"tma_wgmma": per}:
        raise AssertionError(f"the embedder with {family}: {emb}")

    args = parser.parse_args(
        ["--image_folder", rgb, "--model_size", "small",
         "--min_disparity", "8", "--semantic_emb_dir", emb_dir,
         "--get_voxel", "--voxel_size", str(VOXEL_SIZE),
         "--voxel_save_dir", vox_dir, "--seed", str(SEED), "--timing"])
    result, _, wall, launches, designs = counted(
        lambda: run_slam(args, device=device))
    vm = result["voxel_map"]
    feats = vm.get_features()
    stages = result["timer"].summary()
    cli = {"frames": result["n_frames"],
           "submaps": result["solver"].map.get_num_submaps(),
           "wall_s": wall,
           "build_s": stages["semantic_voxel_map"]["total_s"],
           "V": len(vm.get_centers_world()), "d": int(feats.shape[1]),
           "launches": launches, "designs": designs,
           "stages": {k: v["total_s"] for k, v in stages.items()}}
    log(f"{family}_semantic_cli", **cli)
    del result, vm
    if designs != {"tma_wgmma": forward_calls(launches)} or \
            not forward_calls(launches) or cli["d"] != d_want or \
            cli["V"] < 5 or not np.isfinite(feats).all():
        raise AssertionError(f"the SLAM CLI on {family} features: {cli}")

    ranked, *_ = counted(lambda: query_voxelmap.main(
        ["--voxel_dir", vox_dir, "--query", "a chair", "--top_k", "5",
         "--clip_model_dir", ckpt, "--device", "cuda"]))
    log(f"{family}_query", ranked=[list(r) for r in ranked])
    if len(ranked) != 5 or not all(np.isfinite(r[2]) for r in ranked) \
            or any(r[3] not in frames for r in ranked):
        raise AssertionError(f"query_voxelmap with {family}: {ranked}")
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"phase_{phase.lower()}", seconds=seconds)
    return {"launches_per_chunk": res["launches_per_chunk"],
            "check_launches": res["launches"]["flash_single"],
            "embedder_launches": emb["launches"]["flash_single"],
            "vision_ms_batch64": res["vision_ms_batch64"],
            "crops_per_s": res["crops_per_s"],
            "max_l2_from_plain": res["max_l2_from_plain"],
            "phase_s": seconds, **res["flash_single"],
            **({"text": res["flash_single_text"],
                "text_launches": res["text_launches"]["flash_single"]}
               if "flash_single_text" in res else {})}


# Phase M: SAM2 (Hiera-B+) and its automatic mask generator on the card

SAM2_TOL = 1e-4     # f32 on the card against float64, of the largest entry


def sam2_errors(model, ref, image, points):
    """embed_image's features and decode_points' masks, iou, obj of `model`
    against float64 `ref`: max abs error over the largest entry, each."""

    with torch.no_grad():
        f, r = model.embed_image(image), ref.embed_image(image.double())
        got = (*f.values(), *model.decode_points(f, points))
        want = (*r.values(), *ref.decode_points(r, points.double()))
    return [float((a.double() - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]


def drive_sam2(device, seq, clip_ckpt):
    """Phase M: a seeded sam2.1_hiera_base_plus .pt (IoU head's last bias +3),
    kept for Q; embed_image and a 192-point decode against float64
    (SAM2_TOL) with a layout control; the AMG; the embedder with --masker
    sam2 --clip_model_dir on 4 frames."""
    import copy

    from vggt_slam_tpu_torch.data.images import load_image, resize_linear
    from vggt_slam_tpu_torch.models import sam2 as S
    from vggt_slam_tpu_torch.semantic import embedder
    from vggt_slam_tpu_torch.semantic import sam2_amg as AMG

    t_phase = time.perf_counter()
    cfg = S.SAM2Config.base_plus()
    rgb = os.path.join(seq, "rgb")
    frames = sorted(os.listdir(rgb))[:4]
    with tempfile.TemporaryDirectory(prefix="phase_m_") as tmp:
        pt = os.path.join(seq, "sam2.1_hiera_base_plus.pt")   # for phase Q
        sd = S.init_state_dict(cfg, SEED, device)
        sd["mask_decoder.iou_head.layers_2.bias"] += 3.0   # IoUs ~0.95
        torch.save({"model": {k: v.cpu() for k, v in
                              S.to_torch_state_dict(sd, cfg).items()}}, pt)
        t0 = time.perf_counter()
        gen = AMG.make_sam2_mask_generator(pt, device="cuda")
        load_s = time.perf_counter() - t0
        model = gen.model
        got = model.state_dict()
        if sorted(got) != sorted(sd) or any(
                not torch.equal(got[k], sd[k]) for k in sd):
            raise AssertionError("load_params did not give back the weights")
        ref = copy.deepcopy(model).double()
        bad = copy.deepcopy(model)
        for m in (bad.mask_decoder.upscale_dc1, bad.mask_decoder.upscale_dc2):
            m.kernel.data = m.kernel.flip(0, 1)
        k = bad.trunk.patch_embed.kernel
        k.data = k.transpose(0, 1).contiguous()
        frame = load_image(os.path.join(rgb, frames[0]))[..., ::-1]
        S_ = cfg.img_size
        image = torch.from_numpy(resize_linear(frame, S_, S_)[None]).to(
            device, torch.float32)
        pts = torch.from_numpy(AMG.build_point_grid(24)[:192] * S_).to(
            device, torch.float32)
        errs = sam2_errors(model, ref, image, pts)
        ctrl = sam2_errors(bad, ref, image, pts)
        del ref, bad
        with torch.no_grad():
            feats = model.embed_image(image)
            embed_ms = cuda_ms(lambda: model.embed_image(image), 3)
            decode_ms = cuda_ms(lambda: AMG.decode_chunk(model, feats, pts),
                                3)
        res = {"values": sum(v.numel() for v in sd.values()),
               "load_s": load_s, "f64_rel_err": dict(zip(
                   ("image_embed", "feat_s0", "feat_s1", "masks", "iou",
                    "obj"), errs)), "tol": SAM2_TOL,
               "control_rel_err": [ctrl[0], ctrl[3]], "embed_ms": embed_ms,
               "decode_chunk_ms_192": decode_ms}
        del feats
        for name, kw in (("defaults", {}), ("zero_thresh", dict(
                pred_iou_thresh=0.0, stability_score_thresh=0.0))):
            amg = AMG.SAM2MaskGenerator(model, **kw)
            t0 = time.perf_counter()
            masks = amg(frame)
            res[name] = {"masks": len(masks), "seconds":
                         time.perf_counter() - t0, "chunks": amg.chunks,
                         **amg.seconds}
        h, w = frame.shape[:2]
        areas = [m["area"] for m in masks]
        inside = all(0 <= m["bbox"][0] <= m["bbox"][0] + m["bbox"][2] <= w
                     and 0 <= m["bbox"][1] <= m["bbox"][1] + m["bbox"][3]
                     <= h for m in masks)
        log("sam2", **res, inside=inside)
        if res["values"] != 73_328_657 or \
                not all(e <= SAM2_TOL for e in errs) or \
                not ctrl[0] > SAM2_TOL < ctrl[3] or not masks or \
                not inside or areas != sorted(areas, reverse=True):
            raise AssertionError(f"SAM2 on the card: {res}")
        del gen, amg, model
        torch.cuda.empty_cache()

        sub = os.path.join(tmp, "rgb")
        os.makedirs(sub)
        for f in frames:
            shutil.copy(os.path.join(rgb, f), sub)
        out = io.StringIO()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            n = embedder.main(
                ["--image_dir", sub, "--out_dir", os.path.join(tmp, "emb"),
                 "--target_size", str(SEMANTIC_TARGET), "--masker", "sam2",
                 "--sam2_checkpoint", pt, "--clip_model_dir", clip_ckpt,
                 "--device", "cuda"])
        seconds = time.perf_counter() - t0
        embs = [np.load(os.path.join(tmp, "emb", os.path.splitext(f)[0]
                                     + ".npz"))["embedding"] for f in frames]
        cli = {"frames": n, "seconds": seconds, "s_per_frame": seconds / 4,
               "d": sorted({e.shape[-1] for e in embs}),
               "painted_share": float(np.mean([(np.abs(e).sum(-1) > 0).mean()
                                               for e in embs])),
               "launches": dict(A.LAUNCHES), "out": out.getvalue().strip()}
        log("sam2_embedder", **cli)
        if n != 4 or not all(np.isfinite(e).all() for e in embs) or \
                "SAM2MaskGenerator" not in cli["out"]:
            raise AssertionError(f"the embedder with SAM2: {cli}")
    torch.cuda.empty_cache()
    log("phase_m", seconds=time.perf_counter() - t_phase)


# Phase Q: the semantic evals on the outputs of phases V, M and N

# The 7-Scenes dump: frames; the chamfer RMSE bound, ~10x the clean RMSEs
# (3.1e-4) and ~6x under the control's: every DENSE_STRIDE-th frame scaled
# about its centroid, against the same frames (a rigid ICP cannot undo it).
DENSE_FRAMES, DENSE_BOUND, DENSE_SCALE, DENSE_STRIDE = 30, 3e-3, 1.1, 5


def seven_scenes_dump(root, n=DENSE_FRAMES):
    """A 7-Scenes sequence by synth3d at 480x640 (16-bit mm depth,
    pose.txt), an exact estimate and the control: (seq, estimate,
    control, TUM)."""
    from concurrent.futures import ThreadPoolExecutor

    from vggt_slam_tpu_torch.data.images import resize_nearest, write_png16
    from vggt_slam_tpu_torch.evals import dense_7scenes as D
    from vggt_slam_tpu_torch.evals.geometry_eval import backproject_depth
    from vggt_slam_tpu_torch.ops.lie import rotmat_to_quat
    from vggt_slam_tpu_torch.tools import synth3d

    K = synth3d.camera_intrinsics(480, 640, math.degrees(
        2 * math.atan(320 / 585)))
    if np.abs(K - D.K_7SCENES).max() > 1e-9:
        raise AssertionError(f"K {K} is not K_7SCENES")
    scene = synth3d.make_scene(seed=SEED)
    centers, rots = synth3d.camera_path(n, seed=SEED, kind="pan")
    seq, est = os.path.join(root, "seq"), os.path.join(root, "est")
    scaled = os.path.join(root, "scaled")
    for d in (seq, est, scaled):
        os.makedirs(d)
    K_eval = D.vggt_resize_K(K)
    c2w = np.zeros((n, 4, 4))
    c2w[:, :3, :3] = rots.transpose(0, 2, 1)
    c2w[:, :3, 3], c2w[:, 3, 3] = centers, 1.0

    def frame(i):               # render, write, backproject: one a thread
        depth = synth3d.render(scene, centers[i], rots[i], K, (480, 640))[1]
        stem = os.path.join(seq, f"frame-{i:06d}")
        write_png16(stem + ".depth.png", np.round(depth * 1000).astype(
            np.uint16))
        np.savetxt(stem + ".pose.txt", c2w[i])
        return backproject_depth(resize_nearest(
            depth, *D.EVAL_HW[::-1]), K_eval, c2w[i], max_depth=4.0,
            stride=4).astype(np.float32)
    with ThreadPoolExecutor(8) as ex:
        clouds = list(ex.map(frame, range(n)))
    centroid = np.concatenate(clouds[::DENSE_STRIDE]).mean(0)
    for i, pts in enumerate(clouds):
        for d, p in ((est, pts), (scaled, centroid + DENSE_SCALE
                                  * (pts - centroid))):
            if d == est or i % DENSE_STRIDE == 0:
                np.savez(os.path.join(d, f"{i:06d}.npz"), point_map_world=p,
                         conf_mask=np.ones(len(p), bool),
                         extrinsic_world=c2w[i])
    q = rotmat_to_quat(torch.from_numpy(c2w[:, :3, :3])).numpy()
    tum = os.path.join(root, "est_poses.txt")
    np.savetxt(tum, np.concatenate([np.arange(n)[:, None], centers,
                                    q[:, 1:], q[:, :1]], 1))
    return seq, est, scaled, tum


def counted(fn):
    """fn() with the launch counts zeroed just before, printing into a
    buffer: (its result, its text, seconds, launches, designs by the C
    count)."""

    from vggt_slam_tpu_torch.utils.profiling import sync

    out = io.StringIO()
    sync()
    A.reset_launch_counts()
    before, t0 = A.forward_design_launches(), time.perf_counter()
    with contextlib.redirect_stdout(out):
        r = fn()
    sync()
    return r, out.getvalue().strip(), time.perf_counter() - t0, \
        dict(A.LAUNCHES), {k: v - before[k] for k, v in
                           A.forward_design_launches().items()}


def drive_evals(device, seq, sam2_pt, vox_dir, encoder_dir, phase_v):
    """Phase Q: mask_eval with M's SAM2; voxel_eval over N's map and SigLIP
    (validity 1.0, 0.0 past the tolerance); dense_7scenes (ATE < 1e-6,
    chamfer RMSEs < DENSE_BOUND, the control above); visualize_results
    over V's outputs and N's map, then --headless. Returns the text
    tower's flash_single launches."""

    from vggt_slam_tpu_torch.evals import dense_7scenes, mask_eval, voxel_eval
    from vggt_slam_tpu_torch.semantic import sam2_amg as AMG

    t_phase = time.perf_counter()
    tmp = os.path.join(seq, "phase_q")
    os.makedirs(tmp)
    make, sam2_s = AMG.make_sam2_mask_generator, []

    def timed(*a, **kw):           # SAM2's seconds a scene
        gen = make(*a, **kw)

        def call(img):
            t0 = time.perf_counter()
            masks = gen(img)
            sam2_s.append(time.perf_counter() - t0)
            return masks
        return call

    AMG.make_sam2_mask_generator = timed
    try:
        rows, _, seconds, *_ = counted(lambda: mask_eval.main(
            ["--scenes", "3", "--sam2_checkpoint", sam2_pt, "--out",
             os.path.join(tmp, "mask_quality.csv")]))
    finally:
        AMG.make_sam2_mask_generator = make
    rows = {r["proposer"]: r for r in rows}
    log("mask_eval", rows=rows, seconds=seconds, sam2_s_per_scene=sum(
        sam2_s) / 3)
    fz, grid = rows["felzenszwalb"], rows["grid8"]
    if set(rows) != {"felzenszwalb", "grid8", "sam2"} or len(sam2_s) != 3 \
            or not fz["mean_best_iou"] > 0.6 > grid["mean_best_iou"] or \
            not fz["recall_at_50"] > 0.8 > grid["recall_at_50"]:
        raise AssertionError(f"mask_eval: {rows}")

    with open(os.path.join(vox_dir, "frame_names.json")) as f:
        stamps = sorted({voxel_eval.SearchValidityEvaluator._timestamp_of(n)
                         for names in json.load(f).values()
                         for n in names.values()})
    # the names' stamps are seconds: the tolerance is in their units
    tol = min(np.diff(stamps), default=1.0) / 4
    moved = [s + stamps[-1] - stamps[0] + 4 * tol for s in stamps]
    job = {"voxel_dir": vox_dir, "evaluator": "search_validity",
           "clip_model_dir": encoder_dir, "tolerance_ns": tol}
    cfg = os.path.join(tmp, "jobs.json")
    with open(cfg, "w") as f:
        json.dump({"jobs": [
            dict(job, queries={"a chair": stamps}, sweep={"top_k": [1, 5]}),
            dict(job, queries={"a chair": moved}),
            {"voxel_dir": vox_dir, "evaluator": "voxel_count"},
            {"voxel_dir": vox_dir, "evaluator": "perf"}]}, f)
    res, _, seconds, launches, designs = counted(lambda: voxel_eval.main(
        ["--config", cfg, "--out", os.path.join(tmp, "voxel_eval.json")]))
    r = [x["result"] for x in res["results"]]
    V = r[3]["num_voxels"]
    vox = {"seconds": seconds, "launches": launches, "designs": designs,
           "tolerance": tol, "validity": [x["validity_rate"] for x in r[:3]],
           "count": r[3], "perf": r[4],
           "hits": [x["per_query"]["a chair"]["hits"] for x in r[:3]]}
    log("voxel_eval", **vox)
    want = 3 * encoder_module("siglip")[1].text_layers   # a query a job
    if vox["validity"] != [1.0, 1.0, 0.0] or len(vox["hits"][1]) != min(
            5, V) or launches["flash_single"] != want or \
            designs != {"tma_wgmma": want}:
        raise AssertionError(f"voxel_eval: {vox}")

    t0 = time.perf_counter()
    d7, est, scaled, tum = seven_scenes_dump(os.path.join(tmp, "7scenes"))
    dense = {"dump_s": time.perf_counter() - t0}
    for name, fo, stride in (("estimate", est, 1),
                             ("scaled_control", scaled, DENSE_STRIDE)):
        t0 = time.perf_counter()
        dense[name] = dense_7scenes.evaluate_sequence(
            d7, tum, frame_output_dir=fo, gt_stride=stride)
        dense[name]["seconds"] = time.perf_counter() - t0
    log("dense_7scenes", frames=DENSE_FRAMES, bound=DENSE_BOUND,
        scale=DENSE_SCALE, stride=DENSE_STRIDE, **dense)
    m, c = dense["estimate"], dense["scaled_control"]
    if not (m["ate_rmse"] < 1e-6 and m["ate_pairs"] == DENSE_FRAMES and
            max(m["rmse_accuracy"], m["rmse_completeness"]) < DENSE_BOUND
            < max(c["rmse_accuracy"], c["rmse_completeness"]) and
            c["ate_pairs"] == len(range(0, DENSE_FRAMES, DENSE_STRIDE))):
        raise AssertionError(f"dense_7scenes: {dense}")

    calls = load_viser_stub().install(sys.modules)
    sys.modules.pop("vggt_slam_tpu_torch.viz.viser_viewer", None)
    from vggt_slam_tpu_torch.tools import visualize_results as VR
    out_v, log_v = (os.path.join(phase_v, f) for f in ("out", "poses.txt"))
    argv = ["--pose_log", log_v, "--poses_path", log_v, "--image_folder",
            os.path.join(seq, "rgb"), "--voxel_dir", vox_dir,
            "--side_by_side"]
    printed, stdin = [], sys.stdin
    try:
        sys.stdin = io.StringIO("")       # main waits for Enter
        # --headless without the cloud and the point maps: their reads are
        # the pass's cost, and the first pass prints their stats
        for a in (["--pcd_path", os.path.join(out_v, "result.pcd"),
                   "--frame_output_dir", os.path.join(out_v, "frame_output")]
                  + argv, argv + ["--headless"]):
            printed.append(counted(lambda: VR.main(a))[1:3])
    finally:
        sys.stdin = stdin
    n_frames = len(os.listdir(os.path.join(out_v, "frame_output")))
    n_poses = len(VR.load_tum_poses(log_v))
    n_images = len(os.listdir(os.path.join(seq, "rgb")))
    counts = {k: sum(c[0] == k for c in calls) for k in (
        "ViserServer", "scene.add_point_cloud", "scene.add_frame",
        "scene.add_camera_frustum")}
    drawn = [kw["points"] for name, _, kw in calls
             if name == "scene.add_point_cloud"][-1]
    with np.load(os.path.join(vox_dir, "semantic_voxels.npz")) as z:
        centers = z["centers_world"]
    x = re.search(r"offsetting voxels by \+X=(\S+)", printed[0][0])
    x = float(x.group(1)) if x else 0.0
    viz = {"seconds": [p[1] for p in printed], "calls": counts,
           "frames": n_frames, "poses": n_poses, "images": n_images,
           "V": V, "x_offset": x, "headless": printed[1][0].splitlines()}
    log("visualize_results", **viz)
    if counts != {"ViserServer": 2, "scene.add_point_cloud": 2,
                  "scene.add_frame": n_frames + n_poses,
                  "scene.add_camera_frustum":
                  n_poses if n_images == n_poses else 0} or not x > 0 or \
            len(drawn) != min(V, 20000) or (V <= 20000 and np.abs(
                drawn - centers - [x, 0, 0]).max() > 1e-3) or \
            not set(printed[1][0].splitlines()) <= set(
                printed[0][0].splitlines()) or \
            f"voxel map: {V} voxels" not in printed[1][0]:
        raise AssertionError(f"visualize_results: {viz}, {printed}")
    log("phase_q", seconds=time.perf_counter() - t_phase)
    return launches["flash_single"]


# Phases R, T: the retrieval and attention A/B evals, the host tools

def drive_quality_evals(device, small_ckpt, root):
    """Phase R: retrieval_quality's CLI a backend at a time on a 40-frame
    loop with the gate (salad_random: unit descriptors); ab_attention's,
    three configs on 24 frames with phase 9's model, run_eval in this
    process so that launches count. Every launch tma_wgmma."""
    import types

    from vggt_slam_tpu_torch.evals import ab_attention as AB
    from vggt_slam_tpu_torch.evals import retrieval_quality as RQ
    from vggt_slam_tpu_torch.evals import run_eval

    t_phase, tmp = time.perf_counter(), os.path.join(root, "phase_r")
    make, descs, runs = RQ.make_backend, {}, {}

    def capturing(name, dev):
        fn = make(name, dev)
        return lambda frames: descs.setdefault(name, fn(frames))

    def in_process(cmd, **kw):
        name = os.path.basename(cmd[cmd.index("--out") + 1])[:-4]
        _, out, wall, launches, designs = counted(
            lambda: run_eval.main(cmd[3:]))
        run_eval._WARM.update(model_fn=None, retrieval=None)
        torch.cuda.empty_cache()
        runs[name] = dict(seconds=wall, launches=launches, designs=designs)
        return subprocess.CompletedProcess(cmd, 0, out, "")

    RQ.make_backend = capturing
    AB.subprocess = types.SimpleNamespace(run=in_process)
    try:
        for b in ("tiny", "salad_random"):
            (rows, _), _, wall, launches, designs = counted(lambda: RQ.main(
                ["--backends", b, "--n_sequences", "1", "--n_frames", "40",
                 "--geometric_gate", "--device", str(device), "--out",
                 os.path.join(tmp, f"{b}.csv")]))
            runs[b] = dict(rows[0], seconds=wall, launches=launches,
                           designs=designs, gate_fracs=None)
        (rows, summary, pairs), _, wall, _, _ = counted(lambda: AB.main(
            ["--checkpoint", small_ckpt, "--seq_root", tmp, "--n_frames",
             "24", "--n_sequences", "1", "--configs", "exact_online",
             "merged8_static", "merged16_flash_full", "--device",
             str(device), "--out", os.path.join(tmp, "ab.csv")]))
    finally:
        RQ.make_backend, AB.subprocess = make, subprocess
    d = descs["salad_random"]
    err = float(np.abs(np.linalg.norm(d, axis=1) - 1).max())
    log("phase_r", runs=runs, ab_rows=rows, ab_summary=summary,
        ab_pairs=pairs, ab_seconds=wall, salad_shape=d.shape,
        salad_norm_err=err, seconds=time.perf_counter() - t_phase)
    calls = {k: forward_calls(r["launches"]) for k, r in runs.items()}
    if any(r["designs"] != {"tma_wgmma": calls[k]} for k, r in runs.items()) \
            or calls["tiny"] or runs["salad_random"]["launches"][
                "flash_single"] != 12 or d.shape != (40, 8448) or \
            not err < 1e-4 or len(rows) != 3 or any(
                not calls.get(r["config"]) or not np.isfinite(
                    float(r["ate_rmse"])) for r in rows):
        raise AssertionError(f"phase R: {runs}, {rows}")


def drive_tools(device, seq, phase_v):
    """Phase T, CLIs: occupancy on V's cloud and L's ground truth (flags and
    grid as the CPU's); undistort, metacam on two 3000x3000 frames, euroc
    on two 752x480 (within one grey level of the CPU on >= 99.9%; ms);
    align_points on a Sim(3)-moved 200k-point crop (1e-4)."""

    from vggt_slam_tpu_torch.data.images import (read_png, resize_linear,
                                                 write_png)
    from vggt_slam_tpu_torch.data.pcd import read_pcd, write_pcd
    from vggt_slam_tpu_torch.tools import align_points as AP
    from vggt_slam_tpu_torch.tools import occupancy as OC
    from vggt_slam_tpu_torch.tools import undistort as UD

    t_phase, res = time.perf_counter(), {}
    tmp = os.path.join(seq, "phase_t")
    os.makedirs(tmp)
    files = [os.path.join(phase_v, "out", "result.pcd"), os.path.join(
        tmp, "images.txt"), os.path.join(tmp, "path")]
    write_colmap_images(seq, files[1])
    with open(files[2], "w") as f:
        f.write("\n".join(sorted(os.listdir(os.path.join(seq, "rgb")))))
    pts = read_pcd(files[0])[0]
    z = OC.apply_T_world(OC.get_T_zup_from_xleft_ydown_zin(), pts)
    lo, hi = np.nanpercentile(z, [5, 95], axis=0)
    grid = [float(max(hi[:2] - lo[:2]) / 100), float(hi[2]),
            float((hi[2] - lo[2]) / 10)]          # voxel, ceiling, height
    nav = []
    for dev in (str(device), "cpu"):
        t0 = time.perf_counter()
        nav.append(OC.main(sum((["--" + k, str(v)] for k, v in zip(
            ("pcd_path", "colmap_images_txt", "path_txt", "voxel_size",
             "ceiling_z", "height_thresh", "device"), files + grid + [dev])),
            [])).details)
        res[f"occupancy_{dev[:4]}_s"] = time.perf_counter() - t0
    occ = [OC.build_occupancy_from_pointcloud(z, *grid, d)
           for d in (device, "cpu")]
    same = [np.array_equal(a, b) for a, b in zip(*occ)]
    res.update(points=len(pts), grid=grid, cells=len(occ[1][0]),
               blocked=int(occ[1][1].sum()), navigable=nav[1],
               build_ms=cuda_ms(lambda: OC.build_occupancy_from_pointcloud(
                   z, *grid, device), 3))
    if nav[0] != nav[1] or not all(same):
        raise AssertionError(f"occupancy: the card differs: {same}, {nav}")

    rng = np.random.default_rng(SEED)
    for mode, (h, w) in (("metacam", (3000, 3000)), ("euroc", (480, 752))):
        d_in, d_out = (os.path.join(tmp, mode + s) for s in ("", "_out"))
        os.makedirs(d_in)
        for i in range(2):
            write_png(os.path.join(d_in, f"{i}.png"), resize_linear(
                rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8), w, h))
        _, _, wall, _, _ = counted(lambda: UD.main(
            [mode, "--input_dir", d_in, "--output_dir", d_out, "--device",
             str(device)]))
        maps = ((lambda d: UD.METACAM_LEFT.undistort_maps(device=d)[:2])
                if mode == "metacam" else lambda d: UD.radtan_maps(
                    UD.EUROC_CAM0_K, UD.EUROC_CAM0_D, (w, h), d))
        img = read_png(os.path.join(d_in, "0.png"))
        diff = np.abs(read_png(os.path.join(d_out, "0.png")).astype(int)
                      - UD.remap_linear(img, *maps("cpu")).numpy())
        m, x = maps(device), torch.as_tensor(img, device=device)
        res[mode] = dict(seconds=wall, within_one=float((diff <= 1).mean()),
                         maps_ms=cuda_ms(lambda: maps(device), 3),
                         remap_ms=cuda_ms(lambda: UD.remap_linear(x, *m), 5))
        if res[mode]["within_one"] < 0.999 or len(os.listdir(d_out)) != 2:
            raise AssertionError(f"undistort {mode}: {res[mode]}")

    ok = pts[np.isfinite(pts).all(1)]
    crop = ok[np.argsort(np.linalg.norm(ok - np.median(ok, 0), axis=1))
              [:200_000]].astype(np.float64)
    s, R, t = 1.3, rotation([0.2, -0.1, 0.3]), np.ptp(crop, 0) * [.5, -.2, .1]
    paths = [os.path.join(tmp, n) for n in ("src.pcd", "dst.pcd")]
    write_pcd(paths[0], crop)
    write_pcd(paths[1], s * crop @ R.T + t)
    (s1, R1, t1, rmse), _, wall, _, _ = counted(lambda: AP.main(
        ["--source", paths[0], "--target", paths[1], "--max_points",
         "200000", "--device", str(device)]))
    err = max(abs(s1 / s - 1), np.abs(R1 - R).max(),
              np.abs(t1 - t).max() / np.ptp(crop))
    res["align"] = dict(points=len(crop), seconds=wall, rmse=rmse, err=err)
    log("phase_t", **res, seconds=time.perf_counter() - t_phase)
    if err > 1e-4:
        raise AssertionError(f"align_points: {res['align']}")


# Device time of one call


def graph_ms(fn, calls=20, reps=3, stream=None):
    """Device ms per fn() from one CUDA graph of `calls` calls on `stream`,
    best of `reps` replays."""

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    del graph
    return best


def sm90_registers(registers, static, int8) -> dict:
    """ptxas registers of the flash_fwd_sm90<D, STATIC, I8> instances with
    these flags."""

    out = {}
    for name, n in registers.items():
        m = (re.search(r"flash_fwd_sm90<\d+, (\w+), (\w+)>", name)
             or re.search(r"flash_fwd_sm90ILi\d+ELb([01])ELb([01])E", name))
        if m and [f in ("true", "1") for f in m.groups()] == [static, int8]:
            out[name] = n
    return out


def own_ptxas_report(name) -> tuple[dict, dict]:
    """`ptxas_report` of this tree's library `name` alone."""
    from vggt_slam_tpu_torch.ops import cuda_build

    return ptxas_report({name: cuda_build.build_log[name]})


def ptxas_report(build_log) -> tuple[dict, dict]:
    """({kernel: registers}, {kernel: spill bytes, where not 0}) from nvcc's
    -Xptxas=-v output, demangled by c++filt where installed."""

    regs, spills, name = {}, {}, None
    for text in build_log.values():
        for ln in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m and name is not None and int(m.group(1)):
                spills[name] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", ln)
            if m and name is not None:
                regs[name] = int(m.group(1))
    if shutil.which("c++filt") and regs:
        out = subprocess.run(["c++filt"], input="\n".join(regs),
                             capture_output=True, text=True).stdout
        names = dict(zip(regs, out.splitlines()))
        regs = {names[k]: v for k, v in regs.items()}
        spills = {names[k]: v for k, v in spills.items()}
    return regs, spills


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vggt_slam_tpu_torch.main import build_model, make_config, parser
    from vggt_slam_tpu_torch.ops import cuda_build
    from vggt_slam_tpu_torch.ops import dpt_tail as T
    from vggt_slam_tpu_torch.scripts import bench_attention as BA
    from vggt_slam_tpu_torch.scripts import bench_global_attention as GA
    from vggt_slam_tpu_torch.scripts import bench_int8_inkernel as IK
    from vggt_slam_tpu_torch.scripts import bench_matmul_shapes as MM
    from vggt_slam_tpu_torch.scripts import bench_softmax_variants as SV

    t_smoke = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log("environment", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])

    t0 = time.perf_counter()
    cuda_build.build_all()
    A.kernel_library()
    A.bwd_kernel_library()
    T.kernel_library()
    BA.kernel_library()
    for probe in (GA, SV, IK, MM):
        probe.kernel_library()
    registers, spills = ptxas_report(cuda_build.build_log)
    log("build", seconds=time.perf_counter() - t0,
        nvcc_seconds=cuda_build.build_seconds, registers=registers,
        spill_store_bytes=spills)

    checks = check_kernels(device)
    int8_checks = check_int8_kernels(device)
    train_checks = check_training_kernels(device)
    probe_checks, probe_launches = check_probe_kernels(device)
    global_probes = check_global_probes()
    matmul_probes = check_matmul_probes()
    if "--kernels-only" in argv:     # a quick build-and-compare run
        return 0
    t0 = time.perf_counter()
    model = build_model(make_config(parser.parse_args([])), seed=SEED,
                        device=device)
    torch.cuda.synchronize()
    log("model", seconds=time.perf_counter() - t0,
        params=sum(p.numel() for p in model.parameters()))
    frames = synth_frames(N_FRAMES)
    check_forward(model, device, frames)
    if "--profile" in argv:
        profile_forward(model, device, frames)
    launches = drive_main_path(model, device, frames)
    captured, int8_launches, per_forward = check_int8_forward(model, device,
                                                              frames)
    tail = check_dpt_tail(model, device, captured)
    del model, captured
    torch.cuda.empty_cache()
    cli_launches = drive_image_folder_cli(device, per_forward)
    check_backward(device)
    train_launches, train_per_step = drive_training(
        device, profile="--profile" in argv)
    small_ckpt = drive_cli(device)
    with tempfile.TemporaryDirectory(prefix="converters_") as tmp:
        salad_npz = check_converters(tmp)
        salad = check_salad(device, salad_npz, frames)
        salad["loop_cli_launches"], encoders = drive_loop_closure(
            device, salad_npz, small_ckpt)

    replaces = {
        "flash_single": "vggt_slam_tpu/ops/attention.py:387 "
                        "(_flash_single_kernel, launched at :826)",
        "flash_multi": "vggt_slam_tpu/ops/attention.py:121 "
                       "(_flash_kernel, launched at :877)",
        "flash_bwd_dq": "vggt_slam_tpu/ops/attention.py:1106 "
                        "(_flash_bwd_dq_kernel, launched at :1215)",
        "flash_bwd_dkv": "vggt_slam_tpu/ops/attention.py:1138 "
                         "(_flash_bwd_dkv_kernel, launched at :1234)",
        "flash_multi_i8": "vggt_slam_tpu/ops/attention.py:121 "
                          "(_flash_kernel with qk_int8=True, static "
                          "softmax, launched at :877)",
        "flash_single_i8": "vggt_slam_tpu/ops/attention.py:121 "
                           "(_flash_kernel with qk_int8=True, online "
                           "softmax, launched at :877)",
        "dpt_tail": "vggt_slam_tpu/ops/dpt_tail.py:84 (_kernel, launched "
                    "at :179)",
    }
    representative = {"flash_single": "frame_block",
                      "flash_multi": "global_block"}
    # the training case most of the kernel's training launches come from
    training_case = {"flash_single": "encoder_frame", "flash_multi": "global"}
    kernels = []
    for name in ("flash_single", "flash_multi"):
        variants = [c for c in checks if c["kernel"] == name]
        rep = next(c for c in variants if c["variant"] == representative[name])
        train = next(c for c in train_checks
                     if c["variant"] == training_case[name])
        static = name == "flash_multi"   # the Hopper instance's template
        kernels.append({
            "name": name, "status": "ported", "route": "cuda",
            "source": "vggt_slam_tpu_torch/csrc/flash_attention.cu, "
                      "csrc/flash_sm90.cuh",
            "replaces": replaces[name], "launches": launches[name],
            "variant": rep["variant"], "design": rep["design"],
            "designs": {c["variant"]: c["design"] for c in variants
                        + [t for t in train_checks if t["kernel"] == name]},
            "registers": sm90_registers(registers, static, False),
            "max_abs_err": max(c["max_abs_err"] for c in variants),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "library_prepared_ms": rep["library_prepared_ms"],
            "training_launches": train_launches[name],
            "training_launches_per_step": train_per_step[name],
            "training_variant": train["variant"],
            "training_ms": train["fwd_ms"],
            "training_library_ms": train["sdpa_fwd_ms"],
            **({"salad": salad, **encoders,
                "launches_path": "phase 6, the SLAM main path; a SALAD "
                                 "call 12 (phases S, L); CLIP's vision "
                                 "tower 12 a chunk of <= 64 crops "
                                 "(phase P); SigLIP's towers 12 a chunk "
                                 "of <= 64 crops or texts (phase N), a "
                                 "query in voxel_eval (phase Q)"}
               if name == "flash_single" else {}),
            "variants": variants})
    # One flash_bwd call computes both TPU kernels' functions (dq; dk, dv):
    # both rows carry its time, the fused bound and SDPA's backward alone.
    rep = next(c for c in train_checks if c["variant"] == "global")
    for name, grads in (("flash_bwd_dq", ("dq",)),
                        ("flash_bwd_dkv", ("dk", "dv"))):
        kernels.append({
            "name": name, "status": "ported", "route": "cuda",
            "source": "vggt_slam_tpu_torch/csrc/flash_attention_bwd.cu, "
                      "csrc/flash_bwd_sm90.cuh",
            "replaces": replaces[name], "launches": train_launches[name],
            "launches_per_step": train_per_step[name],
            "variant": rep["variant"], "design": rep["bwd_design"],
            "designs": {c["variant"]: c["bwd_design"] for c in train_checks},
            "registers": {k: v for k, v in registers.items()
                          if "flash_bwd_sm90" in k},
            "max_abs_err": max(c["errors"][n] for c in train_checks
                               for n in grads),
            "ms": rep["bwd_ms"], "plain_ms": rep["bwd_plain_ms"],
            "bound_ms": rep["bound_ms"]["bwd"],
            "bound_by": rep["bound_by"]["bwd"],
            "library_ms": rep["sdpa_bwd_ms"],
            "sdpa_fwd_bwd_ms": rep["sdpa_fwd_bwd_ms"],
            "variants": [{k_: c[k_] for k_ in (
                "variant", "B", "N", "H", "D", "valid_len", "errors",
                "bwd_design", "bwd_ms", "bwd_plain_ms", "sdpa_bwd_ms",
                "sdpa_fwd_bwd_ms", "bound_ms", "bound_by")}
                for c in train_checks]})
    # The int8 kernels: launches on their own paths (the --qk_int8 CLI run
    # for the static kernel, the online-softmax int8 forward for the other;
    # counts reset just before each).
    int8_path = {"flash_multi_i8": (cli_launches, "image_folder_cli"),
                 "flash_single_i8": (int8_launches["online"],
                                     "int8_forward_online")}
    for name in ("flash_multi_i8", "flash_single_i8"):
        variants = [c for c in int8_checks if c["kernel"] == name]
        rep_ = next(c for c in variants if c["variant"] == "slam_global")
        kernels.append({
            "name": name, "status": "ported", "route": "cuda",
            "source": "vggt_slam_tpu_torch/csrc/flash_attention.cu, "
                      "csrc/flash_sm90.cuh",
            "replaces": replaces[name],
            "launches": int8_path[name][0][name],
            "launches_path": int8_path[name][1],
            "variant": rep_["variant"], "design": rep_["design"],
            "designs": {c["variant"]: c["design"] for c in variants},
            "registers": sm90_registers(registers, name == "flash_multi_i8",
                                        True),
            "scales_ms": rep_["scales_ms"],
            "scales_plain_ms": rep_["scales_plain_ms"],
            "max_abs_err": max(c["max_abs_err"] for c in variants),
            "ms": rep_["ms"], "plain_ms": rep_["plain_ms"],
            "bound_ms": rep_["bound_ms"], "bound_by": rep_["bound_by"],
            "library_ms": rep_["library_ms"],
            "bf16_kernel_ms": rep_["bf16_kernel_ms"],
            "variants": variants})
    kernels.append({
        "name": "dpt_tail", "status": "ported", "route": "cuda",
        "source": "vggt_slam_tpu_torch/csrc/dpt_tail.cu",
        "replaces": replaces["dpt_tail"], "launches": tail["launches"],
        "launches_path": "phase B, the depth head's activations (the "
                         "reference wires no path to this kernel)",
        "design": "wgmma_sm90", "designs": tail["designs"],
        "registers": tail["registers"],
        "max_abs_err": tail["max_abs_err"], "ms": tail["ms"],
        "graph_ms": tail["graph_ms"],
        "plain_ms": tail["plain_ms"], "bound_ms": tail["bound_ms"],
        "bound_by": tail["bound_by"], "library_ms": tail["library_ms"],
        "rel_rms_vs_head_chain": tail["rel_rms_vs_head_chain"]})
    kernels += probe_kernel_entries(probe_checks, probe_launches)
    kernels += global_probe_entries(global_probes)
    kernels += matmul_probe_entries(*matmul_probes)
    log("smoke", seconds=time.perf_counter() - t_smoke)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
