"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # build, check every kernel, drive SLAM
                                     # and training
    python3 chip_smoke.py --kernels-only   # build and check the kernels only
    python3 chip_smoke.py --profile        # also profile one forward and
                                           # one training step
    python3 chip_smoke.py --ab DIR...   # build, then time the forwards,
                                        # the backward and the probes of
                                        # each DIR's sources and this
                                        # tree's in turns, and stop

Phases, one line of output each (and the contract lines at the end):
  1. environment: device, `nvidia-smi` name and power limit, versions;
  2. build the CUDA kernels from vggt_slam_tpu_torch/csrc with nvcc, one
     process per source, all at once;
  3. hold each forward kernel against its plain PyTorch version at the SLAM
     path's shapes, VGGT-1B's and the small model's (head dim 32) (max abs /
     rel error, kernel / plain / SDPA times, bound with the unit that sets
     it; the design each shape ran, from the C launcher's counts of the
     kernels it launched, which must be flash_sm90.cuh's at every head
     dim; SDPA on the prepared q and k where the kernel applies LN and
     rope itself);
  4. hold the training kernels (the forward kernels' stats variant and the
     backward, flash_bwd, which computes dq, dk and dv in one call) against
     their plain versions at the training shapes, with the kernel and plain
     times, SDPA's forward, forward+backward and backward-alone times, the
     bounds, the backward's design (flash_bwd_sm90.cuh at every head dim)
     and dq's run-to-run spread;
  5. a full-width VGGT-1B forward through the kernels against the same
     forward through the kernels' plain versions, on a 2-frame input;
  6. the SLAM main path at VGGT-1B width (seeded random weights drawn on the
     card) over a synthetic panned sequence, through `run_slam` with the
     CLI's default keyframe backend (auto, which must resolve to the torch
     tracker on the card): launches of each kernel, per-stage seconds,
     submaps, poses; all poses and SL(4) homographies must be finite, and
     every forward launch must run flash_sm90.cuh (launches by design);
  7. the gradient of a 2-frame VGGT-1B training loss through the kernels
     against the same gradient through their plain versions, on named
     leaves;
  8. the training path at VGGT-1B width and depth: 3 steps of
     parallel.train.make_train_step on one 4-frame synth3d batch, with the
     loss, step time, peak memory and launches per step; the loss and every
     gradient must be finite and the loss must fall, and the forward and
     backward must run flash_sm90.cuh and flash_bwd_sm90.cuh at every
     head dim (launches by design);
  9. the train_tiny CLI on the small model for 6 steps, whose backward
     must run flash_bwd_sm90.cuh (the launches by design it prints), and
     whose checkpoint must load into the port's VGGT and give a finite
     forward on the card, with the launches of that forward (counts set to
     0 just before it: 18 flash_single, 6 flash_multi) and its design
     (flash_sm90.cuh).
And, for the --qk_int8 path and the fused DPT tail:
  A. the int8 kernels (flash_multi_i8, flash_single_i8) against their plain
     versions at the SLAM global shape (18-frame bucket, merged K/V, rope,
     kv_bias, valid_len) at VGGT-1B's and the small model's widths, the
     camera trunk's shape (head dim 128) and the training global shape,
     beside the bf16 kernels' times at the same shapes; the design each
     ran (flash_sm90.cuh), and the call's scales pass against int8_scales
     (bit-equal; timed);
  B. the fused DPT tail on the depth head's own output_conv1 activations of
     a full-width 18-frame forward, against its plain version and against
     the head's unfused chain (heads.py:228-231, cuDNN, TF32 off), its one
     launch counted by the wrapper and by the C launcher's design count
     (dpt_tail_sm90), its ptxas registers;
  C. the full-width 18-frame forward with global_qk_int8 through the
     kernels against their plain versions, in both softmax modes (24 int8
     launches each, on the bf16 forward's designs), and against the bf16
     forward (reported, with the three forwards' times);
  D. the CLI's own path on a folder of 24 PNG frames at 480x640 with
     --qk_int8 and the default keyframe backend (auto: the torch tracker
     on the card): decoding and resizing without OpenCV, its own VGGT-1B,
     at least 2 submaps, finite poses and homographies, the TUM log, the
     int8 launches on flash_sm90.cuh (the designs by count).
And, for the frame-attention probes of scripts/bench_attention.py:
  E. the four probe kernels (matmul-only, softmax-only, grouped and
     pipelined at G = 2, 4, 8) against their plain versions at the SLAM
     frame shape through the probe script's main, with a padded-keys
     control, their times beside flash_single and SDPA, and one exp2 per
     softmax-only logit (SASS count, time against the card's exp2 rate);
     the grouped and pipelined kernels (grouped_sm90: TMA, wgmma) also
     at a small shape and the frame shape against the plain version at
     their own key tile, every launch of them one of grouped_sm90 and
     every matmul-only launch one of global_sm90 by the C launcher's
     counts; then `python -m vggt_slam_tpu_torch.scripts.bench_attention
     --check` at its defaults.
And, for the global-shape probes of scripts/bench_global_attention.py,
bench_softmax_variants.py and bench_int8_inkernel.py:
  F. each script's main with --check at its defaults (BH 16, N 34816,
     D 64): every mode and tiling against its plain version, the int8
     controls, the launches (each one of global_sm90 by the C launcher's
     count), ptxas registers of every instance (no spill), the times
     beside their bounds and SDPA.
And, for the matmul-shape probes of scripts/bench_matmul_shapes.py:
  G. its main with --check at its defaults: both kernels, tilings and
     shapes against their plain version with three controls, launches,
     ptxas registers per instance, times beside bounds and torch.bmm.
And, for loop closure (after phase 9; `check_converters`, `check_salad`,
`drive_loop_closure`):
  H. both torch-checkpoint converters over the released manifests, and a
     seeded dino_salad checkpoint into an npz;
  S. SALAD at full width on that npz: 12 flash_single launches a call,
     descriptors against the plain f32 path and two controls, its times;
  L. the CLI at VGGT-1B width on a synthetic loop with the tiny and the
     SALAD backends, then evals/smoke_loop.py at its defaults.
Phases E, F and G run under --kernels-only too. With --ab DIR... the
script builds the kernels, then times the bf16 forward at every shape of
phases 3 and 4 (head dims 32, 64 and 128) in turns (each DIR's
flash_attention.cu, built with the headers beside it and named after its
folder, then this tree's), each held against its plain version first,
beside SDPA and the bound, with the host cost per call at two shapes; then
the int8 forward at phase A's shapes, both kernels (each build's against
its own plain version, eager and as a CUDA graph, beside this tree's bf16
call); then the backward at the six training shapes in turns (each DIR's
flash_attention_bwd.cu through its own entries, then this tree's
flash_bwd; a DIR may hold only the backward's sources), beside SDPA's
backward alone (eager and as a CUDA graph) and the bound; then the
matmul-only floor and the nine grouped, interleaved and pipelined probes
of each DIR's bench_attention.cu beside this tree's at the frame shape
(each held to its plain version, then in turns as CUDA graphs, beside
SDPA and the bound); then every mode and tiling of
each DIR's bench_global_attention.cu, bench_softmax_variants.cu and
bench_int8_inkernel.cu beside this tree's at the global shape; then
each DIR's dpt_tail.cu (behind the dpt_tail.py beside it, if any) beside
this tree's at phase B's shape, cout 2 and 4, as CUDA graphs, with the
bound and its share; each leg runs where some DIR holds its source; and
stops without the result lines.
The last lines are the kernels JSON object and {"ok": true, "device": ...}.
Any failure raises, and the script exits non-zero with no result line. It
needs a CUDA device and imports nothing of JAX, OpenCV or the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
N_FRAMES = 40
HW = (392, 518)
BF16_PEAK_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
INT8_PEAK_OPS = 1979e12       # H100 SXM dense int8 tensor-core peak
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events)."""
    import torch
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


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def main_path_attention_cases(device):
    """The attention calls of one bucketed VGGT-1B forward (S = 16 + 1 + 1
    frames, 392x518 -> 28x37 patches + 5 special tokens = 1041 tokens per
    frame, global K/V sim-merged at stride 16, the last frame padding), and
    those of VGGTConfig.small at the same tokens (4 heads of 32; the
    encoder, frame and global blocks, 4, 6 and 6 a forward)."""
    import torch

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
    """The card's exp2 rate: MUFU.EX2 at 16 per SM per clock at its SM
    count and maximum SM clock (bench_attention.sfu_rate)."""
    import torch

    from vggt_slam_tpu_torch.scripts.bench_attention import sfu_rate
    return sfu_rate(torch.device("cuda", 0))[0]


def least_ms(t_tensor, n_exp2, nbytes) -> tuple[float, str, str]:
    """The bound of a call from its tensor-core time (ms), its exp2 count and
    its bytes: (ms, "operations" or "bytes", which unit: "tensor cores",
    "exp units" or "bytes")."""
    terms = {"tensor cores": t_tensor, "exp units": n_exp2 / ex2_per_s() * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    unit = max(terms, key=terms.get)
    return terms[unit], "bytes" if unit == "bytes" else "operations", unit


def attention_bound_ms(case, int8=False) -> tuple[float, str, str]:
    """Least H100 time for the call (`least_ms`): bytes read once and
    written once over the HBM rate, against the tensor-core flops over the
    bf16 peak (with `int8`, QK^T's half of them over the int8 peak) and one
    exp2 per valid logit over the card's exp2 rate."""
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
    """One scaled_dot_product_attention call computing the same function on
    the same inputs, where SDPA can express it (no in-kernel LN or rope)."""
    import torch
    import torch.nn.functional as F

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
    """SDPA on q and k prepared by the plain version's `_prep` (LN and rope
    applied before the call, so its time excludes that work, which the
    kernel does in-kernel), kv_bias and the valid_len mask as one additive
    float mask: the same function as the kernel. None where `sdpa_call`
    applies."""
    import torch
    import torch.nn.functional as F

    from vggt_slam_tpu_torch.ops import attention as A

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
    """The design that fn(), one forward call, ran: the forward launches by
    design that the C launcher counted during it, "tma_wgmma" for
    flash_fwd_sm90 (csrc/flash_sm90.cuh); with `counts` =
    bwd_design_launches, one flash_bwd call's (csrc/flash_bwd_sm90.cuh).
    Raises where the call launched none. (torch.profiler on the card has
    lost every kernel record of such a short profile, so the kernels' names
    are not read here.)"""
    import torch

    from vggt_slam_tpu_torch.ops import attention as A

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
    """The forward, bf16 or int8, runs flash_sm90.cuh and the backward
    flash_bwd_sm90.cuh at every head dim, 32, 64 and 128
    (flash_attention.cu launch_dim, flash_attention_bwd.cu flash_bwd)."""
    want = "tma_wgmma"
    if design != want:
        raise AssertionError(f"{name} (head dim {D}) ran {design}, not "
                             f"{want}")


def _rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt()
                 / (b ** 2).mean().sqrt().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# Phase 4: training kernels against their plain versions
# ---------------------------------------------------------------------------

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
    """Whether a TRAINING_CASES entry's forward runs flash_multi: a static
    softmax over more keys than flash_attention's one-block rule allows."""
    from vggt_slam_tpu_torch.ops import attention as A

    return softmax == "static" and not A.fits_one_block(N)


def training_bounds(B, N, H, D, vl):
    """Least H100 time of the forward with stats and of the backward
    (`least_ms`): flops (4 and 10 N_q N_k H D per batch: the backward's
    five products, QK^T recomputed) over the bf16 peak, one exp2 per valid
    logit in each (the backward recomputes p once) over the card's exp2
    rate, against the bytes (each input read once, each output written
    once) over the HBM rate."""
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
    """Forward with stats and the backward (flash_bwd: dq, dk, dv) against
    their plain versions at the training shapes of VGGT-1B (and two of
    VGGTConfig.small, head dim 32), on bf16 q, k, v that arrive with
    qk-norm and rope applied. The backward runs twice: dq's f32 sums are
    atomic adds in a varying order, so its bits may differ by a bf16
    rounding (held to 2^-7 of its largest entry)."""
    import torch
    import torch.nn.functional as F

    from vggt_slam_tpu_torch.ops import attention as A

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
            # SDPA on the same pre-applied bf16 q, k, v: forward + backward,
            # the forward alone (keeping its logsumexp, as the kernel its
            # row stats, since q, k, v need grad), and the backward alone
            # on one saved forward
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
    import torch

    from vggt_slam_tpu_torch.ops import attention as A

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


# ---------------------------------------------------------------------------
# Phase 4: full-width forward, kernels against the plain attention path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_attention(model=None):
    """Run the model's attention, forward and backward, through the kernels'
    plain versions (on the card), then restore the kernels."""
    from vggt_slam_tpu_torch.ops import attention as A
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
    """2-frame VGGT-1B forward through the kernels against the same forward
    through the kernels' plain versions (the check), and against the
    chunked reference path (reported)."""
    import numpy as np
    import torch

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
    # Relative RMS, not max: random bf16 weights through 48 blocks amplify
    # single-ulp attention differences into a few percent at the worst
    # pixel. The RMS measured 0.9e-2 to 1.9e-2 on an H100; the bound
    # leaves room for the card-to-card spread of bf16 summation order.
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
    """Run fn() once under torch.profiler (after the caller's warm-up):
    wall ms, device kernel ms by family, the device's busy share, and the
    largest kernels."""
    import torch
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
    """`--profile`: one bucketed forward (17 frames in an 18-frame bucket,
    as on the main path) under torch.profiler."""
    from vggt_slam_tpu_torch.data.images import preprocess_frames
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn

    fn = make_bucketed_model_fn(model, 18, as_numpy=False,
                                with_unprojection=True, device=device)
    images = preprocess_frames(frames[:17])
    fn(images)
    log("profile", frames=17, bucket=18, **profiled(lambda: fn(images)))


# ---------------------------------------------------------------------------
# Phase 5: the SLAM main path
# ---------------------------------------------------------------------------

def synth_frames(n_frames: int, hw=HW, step_px: int = 60, seed: int = SEED):
    """A camera panning over a textured plane: a low-frequency colour field,
    sparse large shapes and light noise (the scene of the JAX package's
    tools/synth_sequence.py, drawn with numpy and torch). Returns (H, W, 3)
    uint8 BGR frames."""
    import numpy as np
    import torch
    import torch.nn.functional as F

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
    import numpy as np
    import torch

    from vggt_slam_tpu_torch.main import parser, run_slam
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn
    from vggt_slam_tpu_torch.ops import attention as A
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


# ---------------------------------------------------------------------------
# Phases A-D: the --qk_int8 path and the fused DPT tail
# ---------------------------------------------------------------------------

def int8_cases(device):
    """The int8 kernels' shapes: the global block of the 18-frame SLAM
    bucket at VGGT-1B's and the small model's widths (head dims 64 and 32;
    the qk-norm already applied outside, as with --qk_int8), the camera
    trunk's call of that bucket (head dim 128, valid_len 17) and the
    training global block (pre-applied q, k)."""
    import torch

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
    from vggt_slam_tpu_torch.ops import attention as A

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
    """The int8 kernel's (out, m, l) against its plain version `ref` and
    against the bf16 plain path `ctrl` on the same inputs. Both int8 sides
    quantize with the same scales and their s32 logits are exact, so the
    f32 row stats m and l agree to f32 summation order (relative error
    INT8_STATS_TOL at most) and the outputs to the bf16 output rounding
    (one bf16 ulp is at most 2^-7 = 0.0078 of the largest |out|, held to
    1e-2 of it). The bf16 path's l differs from the int8 one by the int8
    grid's logit error (relative 6e-3 to 1.7 at these shapes in the plain
    versions), so the control proves that the check tells int8 QK^T from
    bf16: it must exceed ten times INT8_STATS_TOL."""
    import torch

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
    """Phase A: flash_multi and flash_single with qk_int8 against their
    plain versions (the same scales, exact s32 products) and against the
    bf16 plain path as a control (`int8_errors`), with the design each ran
    and the bf16 kernel's time at the same shape; the call's scales pass
    (`int8_scales_cuda`) against `int8_scales`, bit for bit, both timed as
    CUDA graphs."""
    import torch

    from vggt_slam_tpu_torch.ops import attention as A

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
    """The model's global blocks with int8 QK^T (the qk-norm then runs
    outside the kernel) under `softmax`, as --qk_int8 [--global_softmax]
    configure them; restored afterwards."""
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
    """Phases B and C on one 18-frame bucket (17 frames + 1 padding) at
    392x518: the bf16 forward captures the depth head's output_conv1
    activations for phase B; then the int8 forward through the kernels
    against the same forward through their plain versions, in both softmax
    modes, on the bf16 forward's designs (the C launcher's counts: the int8
    launches take the bf16 global blocks' flash_sm90.cuh). Host ms of each
    forward (ending in the outputs on the host). Returns (the captured
    activations, launches per mode, the bf16 forward's designs)."""
    import numpy as np
    import torch

    from vggt_slam_tpu_torch.data.images import preprocess_frames
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn
    from vggt_slam_tpu_torch.ops import attention as A

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
    """Phase B: the depth head's tail on its own activations. x is
    output_conv1's output after the column upsample, pos the head's 0.1 UV
    embedding; the kernel against fused_tail_ref and against the head's
    unfused chain (align-corners upsample, pos add, output_conv2_0, ReLU,
    output_conv2_2)."""
    import torch
    import torch.nn.functional as F

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
    """Phase D: the CLI's own path on a PNG folder with --qk_int8: 24
    panned 480x640 frames written here, read back by the in-repo decoder,
    resized without OpenCV to 392x518, and run by `run_slam` with the
    model it builds itself (VGGT-1B, seeded random weights). `per_forward`:
    one 18-frame forward's designs (phase C), all flash_sm90.cuh's
    ("tma_wgmma"), what each of the run's forwards must add."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vggt_slam_tpu_torch.data.images import load_image, write_png
    from vggt_slam_tpu_torch.main import parser, run_slam
    from vggt_slam_tpu_torch.ops import attention as A
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


# ---------------------------------------------------------------------------
# Phase E: the frame-attention probes (vggt_slam_tpu_torch/scripts/
# bench_attention.py, the counterpart of scripts/bench_attention.py)
# ---------------------------------------------------------------------------

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
    """Demangled and mangled name patterns of a variant's kernel instance in
    ptxas's report (grouped_sm90<G, schedule>: 0 straight, 1 interleaved,
    2 pipelined)."""
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
    """{kernel function: MUFU.EX2 instructions in its SASS}, from
    `cuobjdump -sass`, or None where the toolkit has no cuobjdump."""
    import re
    import shutil

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
    import io

    import torch

    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        result = BA.main(argv)
    torch.cuda.synchronize()
    return result, dict(command=f"python -m {BA.__name__} {' '.join(argv)}",
                        seconds=time.perf_counter() - t0,
                        output=text.getvalue().splitlines())


def check_grouped_tiled(device):
    """The nine grouped, interleaved and pipelined instances at the small
    (S 2, H 4, N 100 -> 128) and frame (S 18, H 16, N 1041 -> 1152) shapes,
    each written into a NaN-filled output and held to the plain version at
    its own key tile (`BA.tiled_error`: 2e-3, or one bf16 step of the plain
    value where larger), each launch one of grouped_sm90 by the C
    launcher's count. Returns {variant: {shape: (max abs err, share of the
    tolerance, block_k)}} (also logged)."""
    import torch

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
    """Phase E. The probe script's main at the SLAM bucket's frame attention
    (S = 18 frames x 16 heads, N = 1041 padded to 1152, D = 64) with
    --check: every probe kernel, at every G and schedule, against its plain
    version on all problems (softmax-only bit-exact, the others 1e-2 of
    max|ref|; the grouped kernels also at their key tile), timed beside
    flash_single and SDPA. Here beside it: the grouped kernels at the small
    and frame shapes at their key tile (`check_grouped_tiled`); a control
    that drops the padded keys from l, which the check must reject; ptxas
    registers and spills per instance; that the softmax-only kernel runs
    one exp2 per logit (its SASS's MUFU.EX2 count where cuobjdump is found,
    and always its time against the card's measured exp2 rate). Then the
    script at its defaults with --check, counts reset just before. Every
    grouped and pipelined launch must be one of grouped_sm90 (the C
    launcher's count)."""
    import torch

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
    """Every grouped and pipelined launch since the counts were reset was
    one of grouped_sm90, and every matmul-only launch one of global_sm90,
    by the C launcher's counts (`before` its counts then). Returns
    {"tma_wgmma": grouped_sm90 launches, "global_sm90": launches}."""
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


# ---------------------------------------------------------------------------
# Phase F: the global-shape probes (vggt_slam_tpu_torch/scripts/
# bench_global_attention.py, bench_softmax_variants.py and
# bench_int8_inkernel.py, the counterparts of the scripts of those names)
# ---------------------------------------------------------------------------

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
    """(registers, spill-store bytes) of instance <bq, bk, mode> of
    `template` in `ptxas_report`'s result; (None, None) if absent."""
    registers, spills = report
    patterns = (f"{template}<{bq}, {bk}, {mode}>(",
                f"{template}ILi{bq}ELi{bk}ELi{mode}EE")
    return next(((r, spills.get(f, 0)) for f, r in registers.items()
                 if any(pat in f for pat in patterns)), (None, None))


def check_global_probes():
    """Phase F. Each global-shape probe script's main at its defaults (BH
    16, N 34353 padded to 34816, D 64) with --check and --iters cut to
    GLOBAL_PROBE_ITERS, counts reset just before: every mode at the default
    tiling on all q rows and every other tiling on a 2048-row slab against
    its plain version (1e-2 of max|ref|), the int8 controls (int8,
    staticint8, qk8, qk8av8 further from the bf16 mode's plain version than
    from their own), each kernel launched, and every launch one
    global_sm90 launch by the C launcher's count; ptxas registers per
    instance, every mode and tiling of each script (an instance with no
    report or with spills an error). Returns {script: (main's result,
    launches, global_sm90 launches)}."""
    import importlib

    import torch

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


# ---------------------------------------------------------------------------
# Phase G: the matmul-shape probes (vggt_slam_tpu_torch/scripts/
# bench_matmul_shapes.py, the counterpart of scripts/bench_matmul_shapes.py)
# ---------------------------------------------------------------------------

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
    """Phase G: the script's main with --check at its defaults, counts
    reset just before; every line checked, the controls run at both B = 528
    shapes, each kernel launched, and every call of the C entries one
    launch of mm_sm90 by the C launcher's count; ptxas registers and spills
    per instance, a line with no report an error. Returns (main's result,
    launches, launches by design)."""
    import torch

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
    """(registers, spill-store bytes) of mm_sm90<bn> in `ptxas_report`'s
    result, by demangled or mangled name; (None, None) if absent."""
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


# ---------------------------------------------------------------------------
# Phases 7-9: training at VGGT-1B width, and the train_tiny CLI
# ---------------------------------------------------------------------------

def training_model(device):
    """VGGT-1B width and depth with seeded random weights drawn on the
    card, in the training configuration: flash_grad attention, activation
    checkpointing, exact global attention, no point head, bf16 compute."""
    from vggt_slam_tpu_torch.main import build_model
    from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig

    cfg = VGGTConfig.vggt_1b(attn_impl="flash_grad", remat=True,
                             global_kv_stride=1, enable_point_head=False)
    return build_model(cfg, seed=SEED, device=device).train()


def training_batch(n_frames, device):
    import torch

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
    """Gradient of a 2-frame VGGT-1B training loss through the kernels
    against the same gradient through their plain versions: the relative
    RMS difference of named leaves, and of every attention projection in
    forward order (to find where the two parted, should a leaf fail)."""
    import torch

    from vggt_slam_tpu_torch.ops import attention as A
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
    """The training path at VGGT-1B width and depth: `n_steps` of
    make_train_step (AdamW, lr 1e-4, weight decay 0.05) on one 4-frame
    synth3d batch at 392x518. Returns the launches of those steps and of
    the last one. `profile`: one more step under torch.profiler."""
    import torch

    from vggt_slam_tpu_torch.ops import attention as A
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
    """flash_bwd launches by design in `n_steps` training steps of a
    VGGTConfig-`cfg` model: each encoder, frame and global block once a
    step, each camera-trunk block at each iteration (activation
    checkpointing recomputes forwards, not backwards), all on
    flash_bwd_sm90.cuh ("tma_wgmma")."""
    return {"tma_wgmma": n_steps * (cfg.enc_depth + 2 * cfg.agg_depth
                                    + cfg.cam_trunk_depth
                                    * cfg.cam_iterations)}


def small_forward_launches(cfg) -> dict:
    """Kernel launches of one forward of a VGGTConfig-`cfg` model on 4
    frames of HW: each encoder and frame block and each camera-trunk block
    at each iteration runs flash_single, each global block (4 frames of
    1041 tokens, static softmax) flash_multi."""
    from vggt_slam_tpu_torch.ops import attention as A

    want = dict.fromkeys(A.LAUNCHES, 0)
    want["flash_single"] = (cfg.enc_depth + cfg.agg_depth
                            + cfg.cam_trunk_depth * cfg.cam_iterations)
    want["flash_multi"] = cfg.agg_depth
    return want


def drive_cli(device):
    """`python -m vggt_slam_tpu_torch.tools.train_tiny` on the small model
    for 6 steps into a temporary directory; its checkpoint must load into
    the port's VGGT(small) and give a finite forward on the card, the small
    model's own path: its launches (counts set to 0 just before it) and the
    design its kernels ran (flash_sm90.cuh) are checked."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from vggt_slam_tpu_torch.main import build_model
    from vggt_slam_tpu_torch.ops import attention as A
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
    finally:
        shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phases H, S, L: the torch-checkpoint converters, SALAD at full width, and
# loop closure through the CLI
# ---------------------------------------------------------------------------

SALAD_TOL = 2e-2      # L2 distance of a descriptor from the plain f32 path
LOOP_SEQ_SEED = 4_000_000     # evals/smoke_loop.py's sequence


def unit_salad_weight(key: str) -> bool:
    """The seeded SALAD checkpoint's LayerNorm weights and LayerScale
    gammas, drawn as 1 (the rest N(0, 0.02)). With every tensor N(0, 0.02)
    the attention hardly reaches the descriptor and panned frames'
    descriptors nearly coincide, so phase S's controls (another frame's
    descriptor, the attention zeroed) could not be rejected."""
    return key.endswith(".gamma") or (".norm" in key
                                      and key.endswith(".weight"))


def check_converters(tmp):
    """Phase H: both converters over full-size zero weights broadcast from
    the released checkpoints' manifests (tests/data/manifest_*.json; no
    memory): every parameter filled, every unused key allowlisted. Then a
    seeded dino_salad-layout checkpoint in the manifest's shapes
    (`unit_salad_weight`) through the SALAD converter's CLI helper into an
    npz, which phases S and L load. Returns the npz path."""
    import torch

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
    """Inside the block every attention of the port's modules returns
    zeros: the descriptor of a kernel that wrote nothing."""
    import torch

    from vggt_slam_tpu_torch.models.vggt import modules

    saved = modules.attn_ops.attention
    modules.attn_ops.attention = lambda q, k, v, **kw: torch.zeros_like(q)
    try:
        yield
    finally:
        modules.attn_ops.attention = saved


def check_salad(device, npz, frames):
    """Phase S: SALAD at full width (DINOv2-B/14 at 224 px, 8448-D) with
    phase H's weights on 17 frames of the SLAM sequence: 12 flash_single
    launches a call, all on flash_sm90.cuh by the C launcher's count;
    finite unit-norm descriptors within SALAD_TOL (L2) of the plain f32
    path on the card (chunked attention), which two controls must exceed:
    another frame's descriptor and the descriptor with the attention
    zeroed; SALAD's ms a call, and flash_single at
    SALAD's (B*H, N, D) = (204, 257, 64) against its plain version, SDPA
    and the bound. Returns the flash_single row's SALAD entry."""
    import torch

    from vggt_slam_tpu_torch.data.images import preprocess_frames
    from vggt_slam_tpu_torch.models import retrieval as R
    from vggt_slam_tpu_torch.ops import attention as A

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


# Phase L's CLI runs: the tiny backend at evals/smoke_loop.py's settings;
# SALAD on phase H's weights at the CLI's defaults (submap 16: SALAD's
# batch is the 17-frame bucket, B*H = 204) but smoke_loop's keyframe
# disparity, without which this sequence gives one submap.
LOOP_RUNS = (("tiny", ("--submap_size", "4", "--max_loops", "3",
                       "--min_disparity", "8")),
             ("salad", ("--min_disparity", "8")))


def loop_cli_run(device, seq, backend, extra=()):
    """The CLI's run_slam on the loop sequence at VGGT-1B width (seeded
    random weights): loops detected, inserted and rejected by the gate,
    the TUM log, the ATE against groundtruth.txt (random weights)."""
    import numpy as np

    from vggt_slam_tpu_torch.evals.ate import ate_from_files
    from vggt_slam_tpu_torch.main import parser, run_slam
    from vggt_slam_tpu_torch.ops import attention as A
    from vggt_slam_tpu_torch.utils.profiling import sync

    log_path = os.path.join(seq, f"poses_{backend}.txt")
    args = parser.parse_args(
        ["--image_folder", os.path.join(seq, "rgb"), "--retrieval_backend",
         backend, "--log_results", "--skip_dense_log", "--log_path",
         log_path, "--seed", str(SEED), "--timing", *extra])
    sync()
    A.reset_launch_counts()
    before, t0 = A.forward_design_launches(), time.perf_counter()
    result = run_slam(args, device=device)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    designs = {d: n - before[d]
               for d, n in A.forward_design_launches().items()}
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


def drive_loop_closure(device, npz):
    """Phase L: a 40-frame kind="loop" sequence written by the port's
    write_tum_sequence; the CLI at VGGT-1B width with the tiny backend and
    with SALAD on phase H's weights (LOOP_RUNS; the SALAD run's forward
    calls must be the tiny run's per submap plus 12 flash_single a SALAD
    call, one call a submap), each with >= 1 loop detected and every
    detection inserted or rejected by the gate, and a run at
    --loop_inlier_thresh 0 (no gate) with >= 1 loop factor where the gate
    rejected them all; then evals/smoke_loop.py at its defaults as a
    subprocess, which must exit 0; where it fails because the gate
    rejected every loop it detected (random weights), it runs again with
    the gate off and must exit 0 then, and the first exit code is logged.
    Returns the SALAD run's launches."""
    import re
    import shutil

    import torch

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
        # a VGGT forward a submap (88 forward calls at 1B, the global
        # blocks on flash_single or flash_multi by the bucket), and in the
        # SALAD run one 12-call SALAD forward a submap
        tiny, salad = runs["tiny"], runs["salad"]
        per_forward = forward_calls(tiny["launches"]) / tiny["submaps"]
        want = salad["submaps"] * (per_forward + 12)
        if forward_calls(salad["launches"]) != want:
            raise AssertionError(f"the SALAD run launched "
                                 f"{salad['launches']}, not {want} forward "
                                 f"calls")
    finally:
        shutil.rmtree(seq, ignore_errors=True)
    rc, out = run_smoke_loop()
    if rc != 0:
        m = re.search(r"Loop closures detected (\d+), rejected by the "
                      r"geometric gate (\d+)", out)
        if not (m and int(m.group(1)) >= 1 and m.group(1) == m.group(2)):
            raise AssertionError(f"smoke_loop failed ({rc}): {out[-3000:]}")
        rc, out = run_smoke_loop("--loop_inlier_thresh", "0")
        if rc != 0:
            raise AssertionError(f"smoke_loop without the gate failed "
                                 f"({rc}): {out[-3000:]}")
    return salad["launches"]


# ---------------------------------------------------------------------------
# --ab DIR: the bf16 forward at head dim 64 against an earlier build, in turns
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def using_library(lib, mod=None, loader="kernel_library"):
    """Route the forward wrappers of `mod` (default this tree's
    ops/attention.py) to `lib`, one ctypes build of some
    flash_attention.cu, inside the block; with loader="bwd_kernel_library"
    its backward wrappers to a build of some flash_attention_bwd.cu."""
    from vggt_slam_tpu_torch.ops import attention as A
    mod = mod or A
    saved = getattr(mod, loader)
    setattr(mod, loader, lambda: lib)
    try:
        yield mod
    finally:
        setattr(mod, loader, saved)


def _ab_wrapper(d, module="attention"):
    """The wrapper module of A/B folder `d`: its `module`.py (the same
    tree's ops/`module`.py, e.g. entries that take their arguments in
    another layout) where it holds one, else this tree's."""
    import importlib
    import importlib.util

    wrapper = os.path.join(d, f"{module}.py")
    if not os.path.exists(wrapper):
        return importlib.import_module(f"vggt_slam_tpu_torch.ops.{module}")
    name = os.path.basename(os.path.normpath(d))
    spec = importlib.util.spec_from_file_location(f"ab_{module}_{name}",
                                                  wrapper)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ab_builds(dirs):
    """{build: (wrapper module, library)}: each of `dirs` that holds a
    flash_attention.cu with the headers it includes, named after its
    folder, then this tree's, "this_tree"; each behind its `_ab_wrapper`."""
    from vggt_slam_tpu_torch.ops import attention as A
    from vggt_slam_tpu_torch.ops import cuda_build

    builds = {}
    for d in dirs:
        if not os.path.exists(os.path.join(d, "flash_attention.cu")):
            continue
        name = os.path.basename(os.path.normpath(d))
        mod = _ab_wrapper(d)
        builds[name] = (mod, cuda_build.load(
            f"flash_attention_ab_{name}", mod._SIGNATURES,
            os.path.join(d, "flash_attention.cu")))
    builds["this_tree"] = (A, A.kernel_library())
    return builds


def ab_bwd_calls(builds, dirs):
    """{build: call(q, k, v, dout, out, m, l, H, vl) -> (dq, dk, dv)}: the
    backward of each of `dirs` that holds a flash_attention_bwd.cu, behind
    the wrapper module of its forward build (`ab_builds`; its
    `_ab_wrapper` where the DIR has no forward): through its own
    flash_bwd, or, for a build from before flash_bwd, delta in torch and
    its flash_bwd_dq and flash_bwd_dkv entries, as that tree's
    FlashAttentionGrad ran them; then this tree's flash_bwd."""
    from concurrent.futures import ThreadPoolExecutor

    from vggt_slam_tpu_torch.ops import attention as A
    from vggt_slam_tpu_torch.ops import cuda_build

    def through(mod, lib):
        def call(q, k, v, dout, out, m, l, H, vl):
            with using_library(lib, mod, "bwd_kernel_library"):
                if hasattr(mod, "flash_bwd"):
                    return mod.flash_bwd(q, k, v, dout, out, m, l,
                                         num_heads=H, valid_len=vl)
                delta = A.bwd_delta(dout, out, H)
                dq = mod.flash_bwd_dq(q, k, v, dout, m, l, delta,
                                      num_heads=H, valid_len=vl)
                return (dq, *mod.flash_bwd_dkv(q, k, v, dout, m, l, delta,
                                               num_heads=H, valid_len=vl))
        return call

    folders = {os.path.basename(os.path.normpath(d)): d for d in dirs}
    srcs = {n: os.path.join(d, "flash_attention_bwd.cu")
            for n, d in folders.items()}
    srcs = {n: src for n, src in srcs.items() if os.path.exists(src)}
    with ThreadPoolExecutor(max(len(srcs), 1)) as pool:   # nvcc at once
        list(pool.map(lambda n: cuda_build.build(
            f"flash_attention_bwd_ab_{n}", srcs[n]), srcs))
    calls = {}
    for name, src in srcs.items():
        mod = (builds[name][0] if name in builds
               else _ab_wrapper(folders[name]))
        calls[name] = through(mod, cuda_build.load(
            f"flash_attention_bwd_ab_{name}", mod._BWD_SIGNATURES, src))
    calls["this_tree"] = through(A, A.bwd_kernel_library())
    return calls


def ab_backward(device, builds, dirs):
    """The backward of each build (`ab_bwd_calls`) against its plain
    version, then timed in turns (first to last, then back) at the six
    training shapes of phase 4, on this tree's forward's out and stats:
    CUDA events around 20 eager calls (`ms`) and one CUDA graph of 20 calls
    (`graph_ms`), beside SDPA's backward alone timed both ways and the
    fused bound. Returns the rows (also logged)."""
    import torch
    import torch.nn.functional as F

    from vggt_slam_tpu_torch.ops import attention as A

    calls = ab_bwd_calls(builds, dirs)
    names = list(calls)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    rows = []
    for name, B, N, H, D, vl, softmax, _ in TRAINING_CASES:
        q, k, v, dout = (torch.randn((B, N, H * D), generator=g,
                                     device=device).to(torch.bfloat16)
                         for _ in range(4))
        smax = A.static_bound(q, k, H) if takes_static(softmax, N) else None
        kw = dict(num_heads=H, valid_len=vl, return_stats=True)
        out, m, l = (A.flash_single(q, k, v, **kw) if smax is None
                     else A.flash_multi(q, k, v, smax, **kw))
        refs = A.flash_bwd_ref(q, k, v, dout, m, l, A.bwd_delta(dout, out, H),
                               num_heads=H, valid_len=vl)
        args = (q, k, v, dout, out, m, l, H, vl)
        errs, runs, graph_runs = {}, {n: [] for n in names}, {
            n: [] for n in names}
        for n in names + names[::-1]:
            fn = functools.partial(calls[n], *args)
            if n not in errs:
                got = fn()
                torch.cuda.synchronize()
                errs[n] = {gn: float((a.float() - b.float()).abs().max()
                                     / max(float(b.float().abs().max()),
                                           1e-30))
                           for gn, a, b in zip(("dq", "dk", "dv"), got, refs)}
                bad = max(errs[n].values()) > 2e-2 or not all(
                    bool(torch.isfinite(t).all()) for t in got)
                if bad:
                    raise AssertionError(f"{n}'s backward disagrees with "
                                         f"its plain version at {name}: "
                                         f"{errs[n]}")
                del got
            runs[n].append(cuda_ms(fn, iters=20))
            graph_runs[n].append(graph_ms(fn))
        sdpa_ms = sdpa_graph_ms = None
        if vl is None:
            # each on one saved forward of its own leaves: eager on this
            # stream's, the graph on one run on the stream it captures
            # (autograd runs each backward op on its forward's stream)
            do_h = dout.view(B, N, H, D).transpose(1, 2)

            def leaves():
                return tuple(t.view(B, N, H, D).transpose(1, 2).detach()
                             .requires_grad_() for t in (q, k, v))

            xs = leaves()
            o = F.scaled_dot_product_attention(*xs)
            sdpa_ms = cuda_ms(lambda: torch.autograd.grad(
                o, xs, do_h, retain_graph=True), iters=20)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                xs_side = leaves()
                o_side = F.scaled_dot_product_attention(*xs_side)
            torch.cuda.current_stream().wait_stream(side)
            sdpa_graph_ms = graph_ms(lambda: torch.autograd.grad(
                o_side, xs_side, do_h, retain_graph=True), stream=side)
            del o, o_side
        bound = training_bounds(B, N, H, D, vl)["bwd"]
        dev_ms = {n: sum(r) / len(r) for n, r in graph_runs.items()}
        row = dict(variant=f"training_{name}", D=D, bound_ms=bound[0],
                   bound_unit=bound[2],
                   ms={n: sum(r) / len(r) for n, r in runs.items()},
                   graph_ms=dev_ms, runs=runs, graph_runs=graph_runs,
                   errors=errs, sdpa_bwd_ms=sdpa_ms,
                   sdpa_bwd_graph_ms=sdpa_graph_ms,
                   share_of_bound={n: bound[0] / t for n, t in dev_ms.items()},
                   speedup={n: t / dev_ms["this_tree"]
                            for n, t in dev_ms.items() if n != "this_tree"})
        log("ab_backward", **row)
        rows.append(row)
        del q, k, v, dout, out, m, l, refs
    return rows


def _forward_calls(q, k, v, kw, smax):
    """(kernel call of a wrapper module, plain call): flash_multi with
    `smax`, or flash_single where it is None."""
    from vggt_slam_tpu_torch.ops import attention as A

    if smax is None:
        return (lambda mod: lambda: mod.flash_single(q, k, v, **kw),
                lambda: A.flash_single_ref(q, k, v, **kw))
    return (lambda mod: lambda: mod.flash_multi(q, k, v, smax, **kw),
            lambda: A.flash_multi_ref(q, k, v, smax, **kw))


def ab_cases(device):
    """The bf16 forward's shapes of phases 3 and 4 (head dims 32, 64 and
    128): dicts of name, kernel, D, bound (ms and unit), kern(module) (the
    call through a wrapper module), plain(), stats (with row stats) and
    sdpa (one SDPA call computing the same function, or None)."""
    import torch
    import torch.nn.functional as F

    from vggt_slam_tpu_torch.ops import attention as A

    cases = []
    for case in main_path_attention_cases(device):
        q, k, v, kw = case["q"], case["k"], case["v"], case["kw"]
        smax = (A.static_bound(q, k, kw["num_heads"], qk_ln=kw["qk_ln"],
                               kv_bias=kw["kv_bias"])
                if case["kernel"] == "flash_multi" else None)
        kern, plain = _forward_calls(q, k, v, kw, smax)
        bound = attention_bound_ms(case)
        cases.append(dict(name=case["name"], kernel=case["kernel"],
                          D=q.shape[2] // kw["num_heads"], bound=bound[0],
                          unit=bound[2], kern=kern, plain=plain, stats=False,
                          sdpa=sdpa_call(case) or sdpa_prepared_call(case)))
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    for name, B, N, H, D, vl, softmax, _ in TRAINING_CASES:
        q, k, v = (torch.randn((B, N, H * D), generator=g, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        kw = dict(num_heads=H, valid_len=vl, return_stats=True)
        static = takes_static(softmax, N)
        smax = A.static_bound(q, k, H) if static else None
        kern, plain = _forward_calls(q, k, v, kw, smax)
        sdpa = None
        if vl is None:   # as phase 4: q, k, v need grad, SDPA keeps its lse
            qs, ks, vs = (t.view(B, N, H, D).transpose(1, 2).detach()
                          .requires_grad_() for t in (q, k, v))
            sdpa = functools.partial(F.scaled_dot_product_attention, qs, ks,
                                     vs)
        bound = training_bounds(B, N, H, D, vl)["fwd"]
        cases.append(dict(name=f"training_{name}",
                          kernel="flash_multi" if static else "flash_single",
                          D=D, bound=bound[0], unit=bound[2], kern=kern,
                          plain=plain, stats=True, sdpa=sdpa))
    return cases


def ab_errors(got, ref, stats):
    """Max abs error of the output (tolerance 2e-2) and, with row stats,
    their max relative errors (1e-3), as phases 3 and 4 hold them."""
    import torch

    out, want = (got[0], ref[0]) if stats else (got, ref)
    errs = {"out": float((out.float() - want.float()).abs().max())}
    if stats:
        errs["m_rel"] = float(((got[1] - ref[1]).abs()
                               / ref[1].abs().clamp_min(1.0)).max())
        errs["l_rel"] = float(((got[2] - ref[2]).abs() / ref[2]).max())
    ok = errs["out"] <= 2e-2 and all(errs[n] <= 1e-3 for n in errs
                                     if n != "out")
    return errs, ok and bool(torch.isfinite(out).all())


def ab_host_us(builds, device, calls=100, rounds=12):
    """Host microseconds per forward call, where the card keeps up, at a
    small shape (B 1, N 256, H 16, D 64; LN, rope, kv_bias, valid_len;
    flash_multi) and at the camera-trunk training shape (B 1, N 4, H 16,
    D 128, row stats; flash_single): each build behind its wrapper (the
    Python side, tensor-map encodes, attributes, launches), `calls` calls at
    a time in turns, first to last and back, `rounds` times; the median of
    the 2 * `rounds` runs of each (the host's clock varies from run to run
    by more than the differences)."""
    import torch

    from vggt_slam_tpu_torch.ops import attention as A

    g = torch.Generator(device=device).manual_seed(SEED + 2)
    q, k, v = (torch.randn((1, 256, 1024), generator=g, device=device)
               .to(torch.bfloat16) for _ in range(3))
    cs = torch.rand((256, 32), generator=g, device=device)
    ln = tuple(torch.ones(64, device=device) for _ in range(4))
    kw = dict(num_heads=16, rope_q=(cs, cs), rope_k=(cs, cs), qk_ln=ln,
              kv_bias=torch.zeros(256, device=device), valid_len=250)
    smax = A.static_bound(q, k, 16, qk_ln=ln, kv_bias=kw["kv_bias"])
    qc, kc, vc = (torch.randn((1, 4, 2048), generator=g, device=device)
                  .to(torch.bfloat16) for _ in range(3))
    shapes = {
        "n256_d64_ln_rope": lambda mod: mod.flash_multi(q, k, v, smax, **kw),
        "camera_trunk_stats": lambda mod: mod.flash_single(
            qc, kc, vc, num_heads=16, return_stats=True)}
    names = list(builds)
    runs = {s_: {n: [] for n in names} for s_ in shapes}
    for name in (names + names[::-1]) * rounds:
        mod, lib = builds[name]
        with using_library(lib, mod):
            for shape, fn in shapes.items():
                runs[shape][name].append(_host_us(lambda: fn(mod), calls))
    return {s_: {n: dict(runs=r, median=sorted(r)[len(r) // 2], min=min(r))
                 for n, r in rn.items()} for s_, rn in runs.items()}


def graph_ms(fn, calls=20, reps=3, stream=None):
    """Device ms per fn() from one CUDA graph of `calls` calls, captured on
    `stream` (a side stream of its own where None), best of `reps` replays
    after a warm-up call and replay: no host cost in it."""
    import torch

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


def _host_us(fn, calls):
    """Host microseconds per fn() over `calls` calls after one warm-up call,
    ending in a synchronize (at these shapes the card keeps up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def ab_forward(device, dirs):
    """Each build (`dirs`, then this tree; `ab_builds`) against its plain
    version, then timed in turns (first to last, then back) at every bf16
    forward shape of phases 3 and 4: CUDA events around 20 eager calls
    (`ms`: the host's time where it is the longer) and one CUDA graph of 20
    calls (`graph_ms`: the device's), beside SDPA timed both ways and the
    bound; then the
    host cost per call (`ab_host_us`). Returns the builds and the rows
    (also logged)."""
    import torch

    from vggt_slam_tpu_torch.ops import cuda_build

    from vggt_slam_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    builds = ab_builds(dirs)
    log("ab_build", seconds=time.perf_counter() - t0,
        nvcc_seconds={n: cuda_build.build_seconds.get(
            f"flash_attention_ab_{n}") for n in builds if n != "this_tree"})
    names = list(builds)
    rows = []
    for c in ab_cases(device):
        name, stats = c["name"], c["stats"]
        ref = c["plain"]()
        errs, runs, graph_runs = {}, {n: [] for n in names}, {
            n: [] for n in names}
        for n in names + names[::-1]:
            mod, lib = builds[n]
            with using_library(lib, mod):
                kern = c["kern"](mod)
                if n not in errs:
                    got = kern()
                    torch.cuda.synchronize()
                    errs[n], ok = ab_errors(got, ref, stats)
                    if not ok:
                        raise AssertionError(f"{n} disagrees with the plain "
                                             f"version at {name}: {errs[n]}")
                    del got
                runs[n].append(cuda_ms(kern, iters=20))
                graph_runs[n].append(graph_ms(kern))
        ms = {n: sum(r) / len(r) for n, r in runs.items()}
        dev_ms = {n: sum(r) / len(r) for n, r in graph_runs.items()}
        sdpa_ms = cuda_ms(c["sdpa"], iters=20) if c["sdpa"] else None
        sdpa_graph = graph_ms(c["sdpa"]) if c["sdpa"] else None
        row = dict(variant=name, kernel=c["kernel"], D=c["D"], stats=stats,
                   design=launched_design(c["kern"](A)), bound_ms=c["bound"],
                   bound_unit=c["unit"], ms=ms, graph_ms=dev_ms, runs=runs,
                   graph_runs=graph_runs, errors=errs, sdpa_ms=sdpa_ms,
                   sdpa_graph_ms=sdpa_graph,
                   share_of_bound={n: c["bound"] / t
                                   for n, t in dev_ms.items()})
        row["faster_than"] = {n: dev_ms["this_tree"] < t
                              for n, t in dev_ms.items() if n != "this_tree"}
        if sdpa_ms is not None:
            row["no_slower_than_sdpa"] = ms["this_tree"] <= sdpa_ms
        log("ab_forward", **row)
        rows.append(row)
        del ref
    log("ab_host", us_per_call=ab_host_us(builds, device))
    return builds, rows


def ab_probe_libs(dirs):
    """{build: library}: each of `dirs` that holds a bench_attention.cu
    (with the headers it includes beside it), named after its folder,
    without the entries an older build lacks, then this tree's,
    "this_tree". Builds on first use (`cuda_build.load`, which raises
    where there is no nvcc)."""
    from vggt_slam_tpu_torch.ops import cuda_build
    from vggt_slam_tpu_torch.scripts import bench_attention as BA

    ported = {n: sig for n, sig in BA._SIGNATURES.items()
              if n not in ("bench_grouped_block_k",
                           "bench_attention_design_launches")}
    libs = {}
    for d in dirs:
        src = os.path.join(d, "bench_attention.cu")
        if os.path.exists(src):
            name = os.path.basename(os.path.normpath(d))
            libs[name] = cuda_build.load(f"bench_attention_ab_{name}",
                                         ported, src)
    libs["this_tree"] = BA.kernel_library()
    return libs


def ab_matmul_only_tilings(args, ref):
    """global_sm90's matmul mode at scale 1, the matmul-only floor's
    function, at every tiling of bench_global_attention on the floor's
    arguments `args`: each held to the plain version `ref` first, then
    timed in turns as CUDA graphs (`graph_ms`), so that the floor's tiling
    is the fastest. Returns {"BQxBK": device ms}."""
    from vggt_slam_tpu_torch.scripts import bench_attention as BA
    from vggt_slam_tpu_torch.scripts import bench_global_attention as GA

    calls = {f"{bq}x{bk}": functools.partial(GA.run_kernel, *args, bq, bk,
                                             "matmul", 1.0)
             for bq, bk in GA.TILINGS}
    for name, call in calls.items():
        err, tol = BA.probe_error("matmul", call(), ref)
        if not err <= tol:
            raise AssertionError(f"global_sm90 matmul {name}: {err} > {tol}")
    runs = {n: [] for n in calls}
    for n in list(calls) + list(calls)[::-1]:
        runs[n].append(graph_ms(calls[n]))
    return {n: sum(r) / len(r) for n, r in runs.items()}


def ab_probes(device, dirs):
    """The matmul-only floor and the grouped, interleaved and pipelined
    probes of each of `dirs` that holds a bench_attention.cu
    (`ab_probe_libs`), then this tree's, at the SLAM frame shape (S 18,
    H 16, N 1041 -> 1152): each build held to its plain version first
    (1e-2 of max|ref|; this tree's grouped kernels also at their key tile),
    then timed in turns (first to last, then back) as one CUDA graph of 20
    calls (`graph_ms`: device ms), beside the bound and, for the attention
    probes, SDPA's graph; the floor's row also holds this tree's
    global_sm90 matmul mode at every tiling (`ab_matmul_only_tilings`).
    Returns the rows (also logged)."""
    import torch

    from vggt_slam_tpu_torch.scripts import bench_attention as BA

    libs = ab_probe_libs(dirs)
    names = list(libs)
    S, H, N, D = 18, 16, 1041, 64
    Np = BA.roundup(N, 128)
    qkv = BA.make_inputs(S, H, N, D, seed=SEED, device=device)
    variants = BA.make_variants(S, H, N, D)
    rate = BA.sfu_rate(device)[0]
    sdpa = variants["SDPA (library)"]
    sdpa_args = sdpa.prep(*qkv)
    sdpa_ms = graph_ms(lambda: sdpa.run(*sdpa_args))
    del sdpa_args
    rows = []
    for variant, p in variants.items():
        if not (BA.instance(variant) or p.counter == "matmul_only"):
            continue
        bound = BA.bound_ms(p.kind, S * H, Np, D, rate)
        args = p.prep(*qkv)
        ref = p.plain(*args)
        errs, runs = {}, {n: [] for n in names}
        for n in names + names[::-1]:
            with using_library(libs[n], BA):
                def call():
                    return p.run(*args)
                if n not in errs:
                    got = call()
                    torch.cuda.synchronize()
                    errs[n] = BA.probe_error(p.kind, got, ref)
                    if n == "this_tree" and BA.instance(variant):
                        errs["this_tree_tiled"] = BA.tiled_error(variant,
                                                                 args, got)
                    if not (errs[n][0] <= errs[n][1]
                            and errs.get(f"{n}_tiled", (0, 0))[1] <= 1):
                        raise AssertionError(f"{n} disagrees with the plain "
                                             f"version at {variant}: {errs}")
                    del got
                runs[n].append(graph_ms(call))
        dev_ms = {n: sum(r) / len(r) for n, r in runs.items()}
        row = dict(variant=variant, graph_ms=dev_ms, runs=runs, errors=errs,
                   bound_ms=bound[0], bound_by=bound[1],
                   share_of_bound={n: bound[0] / t for n, t in dev_ms.items()})
        if p.kind == "attention":
            row.update(sdpa_graph_ms=sdpa_ms,
                       over_sdpa={n: t / sdpa_ms for n, t in dev_ms.items()})
        else:
            row["global_sm90_tilings_ms"] = ab_matmul_only_tilings(args, ref)
        row["faster_than"] = {n: dev_ms["this_tree"] < t
                              for n, t in dev_ms.items() if n != "this_tree"}
        log("ab_probe", **row)
        rows.append(row)
        del args, ref
        torch.cuda.empty_cache()
    return rows


AB_MM_GROUPS = (2, 16)


def ab_mm_tilings(d):
    """The tilings of A/B folder `d`'s matmul build: TILINGS of the
    bench_matmul_shapes.py beside its .cu (that tree's port script), read
    without importing it, else this tree's."""
    import ast

    from vggt_slam_tpu_torch.scripts import bench_matmul_shapes as MM

    script = os.path.join(d, "bench_matmul_shapes.py")
    if not os.path.exists(script):
        return MM.TILINGS
    with open(script) as f:
        tree = ast.parse(f.read())
    return next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "TILINGS"
                        for t in node.targets))


def ab_mm_call(lib, tilings):
    """run_variant's launch on one ctypes build `lib` of some
    bench_matmul_shapes.cu, whose tilings are `tilings`: the operands
    checked, its C entry called into `out`, nothing counted."""
    from vggt_slam_tpu_torch.scripts import bench_attention as BA
    from vggt_slam_tpu_torch.scripts import bench_matmul_shapes as MM

    def call(kernel, a, b, G, tile, out):
        MM.check_operands(a, b, G, tile, out, tilings)
        BA._launch(f"bench_{kernel}", a.device, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), *a.shape, b.shape[2],
                   *((G,) if kernel == "grouped_mm" else ()), *tile, lib=lib)
        return out
    return call


def ab_matmul(device, dirs, iters=20):
    """The matmul-shape probes of each of `dirs` that holds a
    bench_matmul_shapes.cu (with the headers it includes beside it; the
    build named after its folder), then this tree's, at every tiling of
    each build (`ab_mm_tilings`): batched_mm at the reference's nine B = 1
    shapes, batched_mm and grouped_mm at G in AB_MM_GROUPS at the QK^T and
    PV shapes at B 528. Each line held within one bf16 ulp of max|ref| of
    `batched_mm_ref` first (a NaN-filled output), then timed in turns
    (first to last, then back) as CUDA graphs over copies spanning 2 x L2
    (`graph_bench`: device ms), beside the library call (torch.bmm,
    torch.matmul at B = 1) and the bound. Returns the rows (also logged)."""
    import torch

    from vggt_slam_tpu_torch.ops import cuda_build
    from vggt_slam_tpu_torch.scripts import bench_attention as BA
    from vggt_slam_tpu_torch.scripts import bench_matmul_shapes as MM

    sigs = {n: sig for n, sig in MM._SIGNATURES.items()
            if n != "bench_matmul_design_launches"}
    libs, tilings = {}, {}
    for d in dirs:
        src = os.path.join(d, "bench_matmul_shapes.cu")
        if os.path.exists(src):
            name = os.path.basename(os.path.normpath(d))
            libs[name] = cuda_build.load(f"bench_matmul_shapes_ab_{name}",
                                         sigs, src)
            tilings[name] = ab_mm_tilings(d)
    libs["this_tree"], tilings["this_tree"] = MM.kernel_library(), MM.TILINGS
    calls = {n: ab_mm_call(lib, tilings[n]) for n, lib in libs.items()}
    log("ab_matmul_builds", tilings=tilings)
    runners = [(n, t) for n in libs for t in tilings[n]]
    gen = torch.Generator(device).manual_seed(SEED)
    rows = []
    for _, B, (M, K, N) in MM.sections():
        a, b = (torch.randn(s_, generator=gen, device=device).to(
            torch.bfloat16) for s_ in ((B, M, K), (B, K, N)))
        ref = MM.batched_mm_ref(a, b)
        bound, by = MM.bound_ms(B, M, K, N)
        sets = [(x, y, torch.empty(B, M, N, dtype=torch.bfloat16,
                                   device=device)) for x, y in
                [(a, b)] + [(a.clone(), b.clone())
                            for _ in range(MM.copies(B, M, K, N) - 1)]]
        lib_ms = BA.graph_bench(MM.library_mm, sets, iters)
        kernels = [("batched_mm", 1)] + ([("grouped_mm", G)
                                          for G in AB_MM_GROUPS] if B > 1
                                         else [])
        for kernel, G in kernels:
            errs, runs = {}, {r: [] for r in runners}
            for n, t in runners + runners[::-1]:
                if (n, t) not in errs:
                    out = calls[n](kernel, a, b, G, t,
                                   torch.full_like(ref, math.nan))
                    torch.cuda.synchronize()
                    errs[n, t] = MM.mm_error(out, ref)
                    del out
                    if not errs[n, t][0] <= errs[n, t][1]:
                        raise AssertionError(
                            f"{n} {kernel} G={G} {t} at B={B} "
                            f"({M},{K},{N}): {errs[n, t]}")
                runs[n, t].append(BA.graph_bench(
                    calls[n], [(kernel, x, y, G, t, o) for x, y, o in sets],
                    iters))
            name = {r: f"{r[0]} {MM.tile_name(r[1])}" for r in runners}
            ms = {name[r]: sum(v) / len(v) for r, v in runs.items()}
            best = {n: min(ms[name[n, t]] for t in tilings[n]) for n in libs}
            row = dict(kernel=kernel, G=G, B=B, M=M, K=K, N=N, graph_ms=ms,
                       runs={name[r]: v for r, v in runs.items()},
                       errors={name[r]: e for r, e in errs.items()},
                       best_ms=best, bound_ms=bound, bound_by=by,
                       library="torch.bmm" if B > 1 else "torch.matmul",
                       library_ms=lib_ms, copies=len(sets),
                       share_of_bound={n: bound / t for n, t in best.items()},
                       over_library={n: t / lib_ms for n, t in best.items()})
            row["faster_than"] = {n: best["this_tree"] < t
                                  for n, t in best.items() if n != "this_tree"}
            log("ab_matmul", **row)
            rows.append(row)
        del a, b, ref, sets
        torch.cuda.empty_cache()
    return rows


def ab_dpt_tail(device, dirs, calls=10):
    """The DPT tail of each of `dirs` holding a dpt_tail.cu (with its
    headers; behind its `_ab_wrapper`), then this tree's, at phase B's
    shape (seeded inputs on the card, x and pos bf16), cout 2 (depth head)
    and 4 (point head): each build's `_launch` held to fused_tail_ref (1e-2
    of max|ref|), then in turns as CUDA graphs of `calls` calls (device ms,
    with the wrapper's few small weight kernels), beside the bound. Returns
    the rows (also logged)."""
    import torch

    from vggt_slam_tpu_torch.ops import cuda_build
    from vggt_slam_tpu_torch.ops import dpt_tail as T

    builds = {}
    for d in dirs:
        src = os.path.join(d, "dpt_tail.cu")
        if os.path.exists(src):
            name = os.path.basename(os.path.normpath(d))
            mod = _ab_wrapper(d, "dpt_tail")
            sigs = {n: sig for n, sig in mod._SIGNATURES.items()
                    if not n.endswith("_design_launches")}
            builds[name] = (mod, cuda_build.load(f"dpt_tail_ab_{name}", sigs,
                                                 src))
    builds["this_tree"] = (T, T.kernel_library())
    names = list(builds)
    gen = torch.Generator(device).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    S, rows_in, (H, W), cin, cmid = 18, 224, HW, 128, 32
    x = rnd(S, rows_in, W, cin).bfloat16()
    pos = (0.1 * rnd(H, W, cin)).bfloat16()
    w0 = (rnd(3, 3, cin, cmid) / (3 * cin ** 0.5)).bfloat16()
    b0 = 0.1 * rnd(cmid)
    rows = []
    for cout in (2, 4):
        w1, b1 = rnd(1, 1, cmid, cout) / 6.0, rnd(cout)
        args = (x, pos, w0, b0, w1, b1)
        ref = T.fused_tail_ref(*args)
        tol = 1e-2 * float(ref.abs().max())
        flops = 2.0 * S * H * W * (9 * cin * cmid + cmid * cout)
        nbytes = 2 * x.numel() + 2 * pos.numel() + 4 * ref.numel()
        t_ops = flops / BF16_PEAK_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        errs, runs = {}, {n: [] for n in names}
        for n in names + names[::-1]:
            mod, lib = builds[n]
            with using_library(lib, mod):
                def call():
                    return mod._launch(*args)
                if n not in errs:
                    got = call()
                    torch.cuda.synchronize()
                    errs[n] = float((got - ref).abs().nan_to_num(math.inf)
                                    .max())
                    del got
                    if not errs[n] <= tol:
                        raise AssertionError(f"{n}'s dpt_tail disagrees with "
                                             f"the plain version at cout "
                                             f"{cout}: {errs[n]} > {tol}")
                runs[n].append(graph_ms(call, calls=calls))
        dev_ms = {n: sum(r) / len(r) for n, r in runs.items()}
        row = dict(kernel="dpt_tail", cout=cout, shape_x=list(x.shape),
                   rows_out=H, graph_ms=dev_ms, runs=runs, errors=errs,
                   tol=tol, bound_ms=bound,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   share_of_bound={n: bound / t for n, t in dev_ms.items()},
                   faster_than={n: dev_ms["this_tree"] < t
                                for n, t in dev_ms.items()
                                if n != "this_tree"})
        log("ab_dpt_tail", **row)
        rows.append(row)
        del ref
    del x, pos
    torch.cuda.empty_cache()
    return rows


AB_GLOBAL_SCRIPTS = ("bench_global_attention", "bench_softmax_variants",
                     "bench_int8_inkernel")


def ab_global_libs(dirs):
    """{script: {build: library}} for the three global-shape probes: each
    of `dirs` that holds the script's .cu (with the headers it includes
    beside it), named after its folder, then this tree's, "this_tree"; a
    script no DIR holds is left out. Builds on first use
    (`cuda_build.load`, which raises where there is no nvcc)."""
    import importlib

    from vggt_slam_tpu_torch.ops import cuda_build

    libs = {}
    for script in AB_GLOBAL_SCRIPTS:
        mod = importlib.import_module(f"vggt_slam_tpu_torch.scripts.{script}")
        sigs = {n: sig for n, sig in mod._SIGNATURES.items()
                if not n.endswith("_design_launches")}
        found = {}
        for d in dirs:
            src = os.path.join(d, f"{script}.cu")
            if os.path.exists(src):
                name = os.path.basename(os.path.normpath(d))
                found[name] = cuda_build.load(f"{script}_ab_{name}", sigs,
                                              src)
        if found:
            found["this_tree"] = mod.kernel_library()
            libs[script] = found
    return libs


def ab_global_modes(script, device, rate, iters):
    """One global-shape probe at the global shape (BH 16, N 34816, D 64):
    (module, wrapper, plain version, SDPA ms on the script's inputs and
    scale, {mode: (args(bq, bk, n_rows): the wrapper's arguments on the
    first n_rows q rows (None: all), bound)})."""
    from vggt_slam_tpu_torch.scripts import bench_attention as BA
    from vggt_slam_tpu_torch.scripts import bench_global_attention as GA
    from vggt_slam_tpu_torch.scripts import bench_int8_inkernel as IK
    from vggt_slam_tpu_torch.scripts import bench_softmax_variants as SV

    BH, D = 16, GA.HEAD_DIM
    N = BA.roundup(34353, 2048)
    sv = script == "bench_softmax_variants"
    q, k, v = GA.make_inputs(BH, N, D, device=device,
                             scale=0.3 if sv else 1.0)
    scale = math.log(2.0) if sv else 1.0 / math.sqrt(D)
    sdpa_ms = BA.bench(GA.sdpa, (q, k, v, scale), iters)
    modes = {}
    if script == "bench_int8_inkernel":
        for mode in IK.MODES:
            sc = IK.scales(q, k, v, mode)
            modes[mode] = (
                lambda bq, bk, n, mode=mode, sc=sc: (
                    sc, q[:, :n].contiguous(), k, v, bq, bk, mode),
                GA.bound_ms(BH, N, N, D, rate, qk8=mode != "bf16",
                            pv8=mode == "qk8av8"))
        return IK, IK.attention, IK.attention_ref, sdpa_ms, modes
    mod = SV if sv else GA
    int8_mode = "staticint8" if sv else "int8"
    q8, k8, s8 = (SV.int8_operands(q, k) if sv
                  else GA.int8_operands(q, k, scale))
    for mode in mod.MODES:
        qq, kk, sc = ((q8, k8, s8) if mode == int8_mode
                      else (q, k, SV.SMAX if sv else scale))
        modes[mode] = (
            lambda bq, bk, n, mode=mode, qq=qq, kk=kk, sc=sc: (
                qq[:, :n].contiguous(), kk, v, bq, bk, mode, sc, N),
            GA.bound_ms(BH, N, N, D, rate, qk8=mode == int8_mode,
                        exp=mode != "matmul",
                        qk_bytes=1 if mode == int8_mode else 2))
    return mod, mod.run_kernel, mod.run_kernel_ref, sdpa_ms, modes


def ab_global(device, dirs, iters=4):
    """The three global-shape probes on global_sm90 against each of `dirs`
    that holds their .cu (`ab_global_libs`), at the global shape (BH 16, N
    34816, D 64; `ab_global_modes`): every mode and tiling of each build
    held to its plain version on a 2048-row slab over all keys first
    (`check_line`), then timed in turns (first to last, then back; CUDA
    events, best of 2 over `iters` calls), beside SDPA (scale 1/sqrt(D), or
    ln 2 for the softmax variants' raw logits), the bound and this tree's
    ptxas registers. Returns the rows (also logged)."""
    import torch

    from vggt_slam_tpu_torch.scripts import bench_attention as BA
    from vggt_slam_tpu_torch.scripts import bench_global_attention as GA

    libs = ab_global_libs(dirs)
    rate = BA.ex2_rate(device)
    rows = []
    for script, builds in libs.items():
        _, template, _, _, offset = GLOBAL_PROBES[script]
        report = own_ptxas_report(script)
        mod, run, plain, sdpa_ms, modes = ab_global_modes(script, device,
                                                          rate, iters)
        for mode, (call, bound) in modes.items():
            for bq, bk in mod.TILINGS:
                slab = call(bq, bk, GA.SLAB_ROWS)
                ref = plain(*slab)
                errs, runs = {}, {n: [] for n in builds}
                for n in list(builds) + list(builds)[::-1]:
                    with using_library(builds[n], mod):
                        if n not in errs:
                            errs[n] = GA.check_line(
                                f"{n} {GA.variant_name(mode, bq, bk)}",
                                run(*slab), ref, GA.SLAB_ROWS)
                        runs[n].append(BA.bench(run, call(bq, bk, None),
                                                iters, reps=2))
                ms = {n: sum(r) / len(r) for n, r in runs.items()}
                regs, spill = global_ptxas(
                    report, template, mod.MODES.index(mode) + offset, bq, bk)
                row = dict(script=script, variant=GA.variant_name(mode, bq,
                                                                  bk),
                           mode=mode, block_q=bq, block_k=bk, ms=ms,
                           runs=runs, errors=errs, bound_ms=bound[0],
                           bound_by=bound[1], bound_unit=bound[2],
                           sdpa_ms=sdpa_ms, registers=regs,
                           spill_store_bytes=spill,
                           share_of_bound={n: bound[0] / t
                                           for n, t in ms.items()},
                           over_sdpa={n: t / sdpa_ms for n, t in ms.items()})
                row["faster_than"] = {n: ms["this_tree"] < t
                                      for n, t in ms.items()
                                      if n != "this_tree"}
                log("ab_global", **row)
                rows.append(row)
                del ref
        del modes
        torch.cuda.empty_cache()
    return rows


def ab_int8(device, builds):
    """The int8 forward of each build (`ab_builds`) at phase A's shapes,
    both kernels: held to its own wrapper's plain version and bf16 control
    (`int8_errors`, `int8_failure`), then timed in turns with this tree's
    bf16 call at the same shape and softmax mode (first to last, then
    back): CUDA events around 20 eager calls (`ms`) and one CUDA graph of
    20 calls (`graph_ms`). Returns the rows (also logged)."""
    names = list(builds) + ["bf16"]
    rows = []
    for case in int8_cases(device):
        D = case["q"].shape[2] // case["kw"]["num_heads"]
        bound = attention_bound_ms(case, int8=True)
        bf16_bound = attention_bound_ms(case)[0]
        for kernel in ("flash_multi_i8", "flash_single_i8"):
            calls = {n: int8_calls(case, builds[n][0])[kernel]
                     for n in builds}
            errs, runs, graph_runs = {}, {n: [] for n in names}, {
                n: [] for n in names}
            for n in names + names[::-1]:
                mod, lib = builds["this_tree" if n == "bf16" else n]
                with using_library(lib, mod):
                    kern = calls["this_tree" if n == "bf16" else n][0]
                    fn = functools.partial(kern, n != "bf16")
                    if n not in errs and n != "bf16":
                        plain = calls[n][1]
                        errs[n] = int8_errors(kern(True, True),
                                              plain(True, True),
                                              plain(False, True))
                        why = int8_failure(errs[n])
                        if why is not None:
                            raise AssertionError(f"{n}'s {kernel} at "
                                                 f"{case['name']}: {why}")
                    runs[n].append(cuda_ms(fn, iters=20))
                    graph_runs[n].append(graph_ms(fn))
            ms = {n: sum(r) / len(r) for n, r in runs.items()}
            dev_ms = {n: sum(r) / len(r) for n, r in graph_runs.items()}
            row = dict(variant=case["name"], kernel=kernel, D=D,
                       design=launched_design(functools.partial(
                           calls["this_tree"][0], True)),
                       bound_ms=bound[0], bound_unit=bound[2], ms=ms,
                       graph_ms=dev_ms, runs=runs, graph_runs=graph_runs,
                       errors=errs,
                       share_of_bound={
                           n: (bf16_bound if n == "bf16" else bound[0]) / t
                           for n, t in dev_ms.items()},
                       speedup={n: t / dev_ms["this_tree"]
                                for n, t in dev_ms.items()
                                if n not in ("this_tree", "bf16")},
                       vs_bf16=dev_ms["this_tree"] / dev_ms["bf16"])
            log("ab_int8", **row)
            expect_design(f"{kernel} at {case['name']}", D, row["design"])
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------

def sm90_registers(registers, static, int8) -> dict:
    """ptxas registers of the flash_fwd_sm90<D, STATIC, I8> instances with
    these flags, by (demangled or mangled) name."""
    import re

    out = {}
    for name, n in registers.items():
        m = (re.search(r"flash_fwd_sm90<\d+, (\w+), (\w+)>", name)
             or re.search(r"flash_fwd_sm90ILi\d+ELb([01])ELb([01])E", name))
        if m and [f in ("true", "1") for f in m.groups()] == [static, int8]:
            out[name] = n
    return out


def own_ptxas_report(name) -> tuple[dict, dict]:
    """`ptxas_report` of this tree's library `name` alone: an A/B build or
    another library may hold instances of the same name."""
    from vggt_slam_tpu_torch.ops import cuda_build

    return ptxas_report({name: cuda_build.build_log[name]})


def ptxas_report(build_log) -> tuple[dict, dict]:
    """({kernel: registers}, {kernel: spill-store bytes, where not 0}) from
    nvcc's -Xptxas=-v output, the names demangled by c++filt where it is
    installed."""
    import re
    import shutil

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
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vggt_slam_tpu_torch.main import build_model, make_config, parser
    from vggt_slam_tpu_torch.ops import attention as A
    from vggt_slam_tpu_torch.ops import cuda_build
    from vggt_slam_tpu_torch.ops import dpt_tail as T
    from vggt_slam_tpu_torch.scripts import bench_attention as BA
    from vggt_slam_tpu_torch.scripts import bench_global_attention as GA
    from vggt_slam_tpu_torch.scripts import bench_int8_inkernel as IK
    from vggt_slam_tpu_torch.scripts import bench_matmul_shapes as MM
    from vggt_slam_tpu_torch.scripts import bench_softmax_variants as SV

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

    if "--ab" in argv:     # the builds in turns, then stop
        rest = argv[argv.index("--ab") + 1:]
        dirs = [d for d in rest if not d.startswith("-")]

        def holding(src):
            return any(os.path.exists(os.path.join(d, src)) for d in dirs)

        builds = {}
        if holding("flash_attention.cu"):
            builds, _ = ab_forward(device, dirs)
            ab_int8(device, builds)
        if holding("flash_attention_bwd.cu"):
            ab_backward(device, builds, dirs)
        if holding("bench_attention.cu"):
            ab_probes(device, dirs)
        if holding("bench_matmul_shapes.cu"):
            ab_matmul(device, dirs)
        if any(holding(f"{s}.cu") for s in AB_GLOBAL_SCRIPTS):
            ab_global(device, dirs)
        if holding("dpt_tail.cu"):
            ab_dpt_tail(device, dirs)
        return 0
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
    drive_cli(device)
    with tempfile.TemporaryDirectory(prefix="converters_") as tmp:
        salad_npz = check_converters(tmp)
        salad = check_salad(device, salad_npz, frames)
        salad["loop_cli_launches"] = drive_loop_closure(device, salad_npz)

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
            **({"salad": salad} if name == "flash_single" else {}),
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
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
