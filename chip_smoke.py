"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # build, check every kernel, drive SLAM
    python3 chip_smoke.py --kernels-only   # build and check the kernels only
    python3 chip_smoke.py --profile        # also profile one forward

Phases, one line of output each (and the contract lines at the end):
  1. environment: device, `nvidia-smi` name and power limit, versions;
  2. build the CUDA kernels from vggt_slam_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes (max abs / rel error, kernel / plain / SDPA times, bound);
  4. a full-width VGGT-1B forward through the kernels against the same
     forward through the kernels' plain versions, on a 2-frame input;
  5. the SLAM main path at VGGT-1B width (seeded random weights drawn on the
     card) over a synthetic panned sequence, through `run_slam` with the
     torch keyframe backend: launches of each kernel, per-stage seconds,
     submaps, poses; all poses and SL(4) homographies must be finite.
The last lines are the kernels JSON object and {"ok": true, "device": ...}.
Any failure raises, and the script exits non-zero with no result line. It
needs a CUDA device and imports nothing of JAX, OpenCV or the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

SEED = 0
N_FRAMES = 40
HW = (392, 518)
BF16_PEAK_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
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
    frame, global K/V sim-merged at stride 16, the last frame padding)."""
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
    cos_p, sin_p = rope_2d_angles(
        torch.stack([yy.reshape(-1), xx.reshape(-1)], -1), 64, 100.0)
    cos = torch.cat([torch.ones(ns, 32, device=device), cos_p])
    sin = torch.cat([torch.zeros(ns, 32, device=device), sin_p])

    def ln_params():
        return (1.0 + 0.1 * torch.randn(64, generator=g, device=device),
                0.05 * torch.randn(64, generator=g, device=device),
                1.0 + 0.1 * torch.randn(64, generator=g, device=device),
                0.05 * torch.randn(64, generator=g, device=device))

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
    ]


def attention_bound_ms(case) -> tuple[float, str]:
    """Least H100 time for the call: bytes read once and written once over
    the HBM rate, against the tensor-core flops over the bf16 peak."""
    q, k, v, kw = case["q"], case["k"], case["v"], case["kw"]
    B, Nq, HD = q.shape
    Nk = k.shape[1]
    nk_used = min(kw.get("valid_len") or Nk, Nk)
    flops = 4.0 * B * Nq * nk_used * HD               # QK^T and PV, all heads
    nbytes = 2 * (q.numel() + 2 * B * nk_used * HD) + 2 * q.numel()
    for t in (kw.get("rope_q") or ()) + (kw.get("rope_k") or ()):
        nbytes += 4 * t.numel()
    if kw.get("kv_bias") is not None:
        nbytes += 4 * nk_used
    t_ops = flops / BF16_PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


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
        bound_ms, bound_by = attention_bound_ms(case)
        res = dict(variant=case["name"], kernel=case["kernel"],
                   shape_q=list(q.shape), shape_kv=list(k.shape),
                   max_abs_err=max_abs, max_rel_err=max_rel, tol=tol,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   launches_per_forward=case["launches_per_forward"])
        log("kernel_check", **res)
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
def plain_attention(model):
    """Run the model's attention through the kernels' plain versions (on
    the card), then restore the kernels."""
    from vggt_slam_tpu_torch.ops import attention as A
    saved = A.flash_single, A.flash_multi
    A.flash_single, A.flash_multi = A.flash_single_ref, A.flash_multi_ref
    try:
        yield
    finally:
        A.flash_single, A.flash_multi = saved


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


def profile_forward(model, device, frames):
    """`--profile`: one bucketed forward (17 frames in an 18-frame bucket,
    as on the main path) under torch.profiler: device time by kernel
    family, and the device's busy share of the forward's wall time."""
    import time as _time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vggt_slam_tpu_torch.data.images import preprocess_frames
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn

    fn = make_bucketed_model_fn(model, 18, as_numpy=False,
                                with_unprojection=True, device=device)
    images = preprocess_frames(frames[:17])
    fn(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = _time.perf_counter()
        fn(images)
        torch.cuda.synchronize()
        wall_ms = (_time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: operator events carry their kernels' time as well
    rows = sorted(((e.key, dev_us(e) / 1e3) for e in prof.key_averages()
                   if "CUDA" in str(e.device_type) and dev_us(e) > 0),
                  key=lambda r: -r[1])
    families = {}
    for name, ms in rows:
        low = name.lower()
        fam = ("attention" if "flash_fwd" in low or "prep_rows" in low
               else "matmul" if any(s in low for s in (
                   "gemm", "xmma", "cutlass", "nvjet", "matmul"))
               else "conv" if "conv" in low or "cudnn" in low
               else "other")
        families[fam] = families.get(fam, 0.0) + ms
    device_ms = sum(ms for _, ms in rows)
    log("profile", frames=17, bucket=18, wall_ms=wall_ms,
        device_ms=device_ms, busy_share=device_ms / wall_ms,
        families_ms=families, top=[[n[:80], ms] for n, ms in rows[:12]])


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

    args = parser.parse_args(["--keyframe_backend", "torch", "--timing",
                              "--seed", str(SEED)])
    bucket = args.submap_size + args.overlapping_window_size + args.max_loops
    model_fn = make_bucketed_model_fn(model, bucket, as_numpy=False,
                                      with_unprojection=True, device=device)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_slam(args, frames=frames, model_fn=model_fn, device=device)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
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
        launches=launches, wall_s=wall, fps=len(frames) / wall,
        stages=stages, all_finite=finite)
    if n_sub < 2:
        raise AssertionError(f"only {n_sub} submap(s) formed")
    if not finite:
        raise AssertionError("non-finite pose or homography")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    return launches


# ---------------------------------------------------------------------------

def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vggt_slam_tpu_torch.main import build_model, make_config, parser
    from vggt_slam_tpu_torch.ops import attention as A
    from vggt_slam_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log("environment", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])

    t0 = time.perf_counter()
    A.kernel_library()
    log("build", seconds=time.perf_counter() - t0,
        nvcc_seconds=cuda_build.build_seconds,
        ptxas=[ln for text in cuda_build.build_log.values()
               for ln in text.splitlines() if "registers" in ln
               or "spill" in ln])

    checks = check_kernels(device)
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

    replaces = {
        "flash_single": "vggt_slam_tpu/ops/attention.py:387 "
                        "(_flash_single_kernel, launched at :826)",
        "flash_multi": "vggt_slam_tpu/ops/attention.py:121 "
                       "(_flash_kernel, launched at :877)",
    }
    representative = {"flash_single": "frame_block",
                      "flash_multi": "global_block"}
    kernels = []
    for name in ("flash_single", "flash_multi"):
        variants = [c for c in checks if c["kernel"] == name]
        rep = next(c for c in variants if c["variant"] == representative[name])
        kernels.append({
            "name": name, "status": "ported", "route": "cuda",
            "source": "vggt_slam_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces[name], "launches": launches[name],
            "variant": rep["variant"],
            "max_abs_err": max(c["max_abs_err"] for c in variants),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "variants": variants})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
