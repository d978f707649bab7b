"""Global-attention probe on the card: the port of
scripts/bench_global_attention.py.

At an S = 33 submap's exact global shape (BH 16, N = 34353 padded to
34816, D 64, nothing masked) one kernel (csrc/bench_global_attention.cu on
csrc/global_sm90.cuh) computes the reference's modes at five tilings:
`bf16` (s = f32(q kᵀ)/√D, online softmax with the natural exp), `int8` (q,
k quantized per tensor outside the kernel, PV in bf16) and `matmul` (o =
Σ bf16(s/√D) v, the tensor-core floor). As in the reference, `run_kernel`
attends to the first q.shape[1] keys, so the "2048x4096 slab" attends to
2048 keys. SDPA is the library line.

    python -m vggt_slam_tpu_torch.scripts.bench_global_attention
        [--iters 8] [--n 34353] [--heads 16] [--check]

Each line: ms (CUDA events, best of 3), TF/s (4·BH·N²·D), the bound and
its share, the plain version's ms. `--check` first holds every mode
against its plain version (the default tiling on all rows, the others on a
2048-row slab) with the int8 control. Needs the card. The module also
holds what the other global-shape probes share (the plain online softmax,
the operand checks, the bound, the line); `LAUNCHES` and `design_launches`
count launches.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from vggt_slam_tpu_torch.scripts import bench_attention as BA

INT8_PEAK_OPS = 1979e12       # H100 SXM dense int8 tensor-core peak
HEAD_DIM = BA.HEAD_DIM
NEG_INF = -1e30
SLAB_ROWS = 2048              # q rows of the check's slab and accuracy lines
MODES = ("bf16", "int8", "matmul")
# The card's CTA tilings (block_q, block_k): the reference's VMEM blocks
TILINGS = {(64, 64): (1024, 2048), (128, 64): (2048, 2048),
           (64, 128): (1024, 4096), (128, 128): (2048, 4096),
           (128, 32): (512, 2048)}
DEFAULT_TILING = (64, 64)

# Launches of the CUDA kernel in this process (plain-version calls are not
# counted). Read by chip_smoke.py to show the script ran the kernel.
LAUNCHES = {"global_attention": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (shared by the global-shape probes)
# ---------------------------------------------------------------------------

def qk_f32(q, k):
    """q kᵀ with f32 products and sums (exact for int8 values)."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def pv_bf16(p, v):
    """bf16(p) v with f32 products and sums."""
    return torch.matmul(p.to(torch.bfloat16).float(), v.float())


def online_softmax(q, k, v, block_k, logits, ex, pv=pv_bf16):
    """The reference kernels' online softmax over key blocks of block_k in
    their order (m_new = max(m, row max), alpha = ex(m - m_new), p = ex(s -
    m_new), l = alpha l + Σp, acc = alpha acc + pv(p, v)), so p rounds against
    the kernels' max. Returns (acc, l), f32."""
    shape = q.shape[:-1]
    acc = torch.zeros(*shape, v.shape[-1], device=q.device)
    m = torch.full(shape, NEG_INF, device=q.device)
    l = torch.zeros(shape, device=q.device)
    for j in range(0, k.shape[-2], block_k):
        s = logits(q, k[..., j:j + block_k, :])
        m_new = torch.maximum(m, s.amax(-1))
        alpha = ex(m - m_new)
        p = ex(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + pv(p, v[..., j:j + block_k, :])
        m = m_new
    return acc, l


def blockwise_sum(q, k, v, block_k, fn):
    """Σ over key blocks of fn(q, k_blk, v_blk) (f32), bounding the logits
    to (BH, Nq, block_k)."""
    return sum(fn(q, k[:, j:j + block_k], v[:, j:j + block_k])
               for j in range(0, k.shape[1], block_k))


def run_kernel_ref(q, k, v, block_q, block_k, mode, scale, n_keys=None):
    """Plain `run_kernel`: the first n_keys keys (default Nq) in blocks of
    block_k, in the kernel's order."""
    n = q.shape[1] if n_keys is None else n_keys
    k, v = k[:, :n], v[:, :n]

    def logits(q, k):
        return qk_f32(q, k) * scale

    if mode == "matmul":
        acc = blockwise_sum(q, k, v, block_k,
                            lambda q, k, v: pv_bf16(logits(q, k), v))
        return acc.to(torch.bfloat16)
    acc, l = online_softmax(q, k, v, block_k, logits, torch.exp)
    return (acc / l[..., None]).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bench_global_attention": ([_P] * 4 + [_I] * 8 + [ctypes.c_float, _P],
                               ctypes.c_int),
    "bench_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "bench_global_attention_design_launches": (
        [ctypes.POINTER(ctypes.c_longlong)], None),
}


def kernel_library():
    """Build (if stale) and load csrc/bench_global_attention.cu."""
    from vggt_slam_tpu_torch.ops import cuda_build
    return cuda_build.load("bench_global_attention", _SIGNATURES)


def design_launches(lib=None, entry="bench_global_attention") -> dict:
    """Launches by design from the C launcher: "tma_wgmma" for `global_sm90`;
    `lib` and `entry` name another probe's library."""
    out = (ctypes.c_longlong * 1)()
    getattr(lib or kernel_library(), f"{entry}_design_launches")(out)
    return {"tma_wgmma": out[0]}


def output(q, out):
    """`out` (default a new tensor) checked as a bf16 tensor of q's shape,
    contiguous, on q's device."""
    if out is None:
        return torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    if (out.shape != q.shape or out.dtype != torch.bfloat16
            or out.device != q.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous bf16 {tuple(q.shape)} "
                         f"tensor on {q.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    return out


def check_operands(q, k, v, qk_dtype, block_q, block_k, n_keys, tilings):
    """Raise on what the kernels do not take: (BH, rows, 64) contiguous tensors
    on q's device, q and k of qk_dtype, v bf16, k and v of one row count >=
    n_keys, a tiling in `tilings` whose tiles divide the rows."""
    if q.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {q.device}")
    for name, t, dtype in (("q", q, qk_dtype), ("k", k, qk_dtype),
                           ("v", v, torch.bfloat16)):
        if t.dim() != 3 or t.shape[0] != q.shape[0] or t.shape[2] != q.shape[2]:
            raise ValueError(f"(BH, rows, D) operands of one BH and D "
                             f"expected, got {name} {tuple(t.shape)} and q "
                             f"{tuple(q.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"the kernel takes {dtype} {name} here, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.shape[2] != HEAD_DIM:
        raise ValueError(f"the probe kernels take head dim {HEAD_DIM}, got "
                         f"{q.shape[2]}")
    if k.shape[1] != v.shape[1] or not 0 < n_keys <= k.shape[1]:
        raise ValueError(f"k and v of one row count >= {n_keys} expected, "
                         f"got {k.shape[1]} and {v.shape[1]}")
    if (block_q, block_k) not in tilings:
        raise ValueError(f"tiling ({block_q}, {block_k}) not built; the "
                         f"kernel takes {sorted(tilings)}")
    if q.shape[1] % block_q or n_keys % block_k:
        raise ValueError(f"the tile ({block_q}, {block_k}) does not divide "
                         f"{q.shape[1]} q rows and {n_keys} keys")


def run_kernel(q, k, v, block_q, block_k, mode, scale, n_keys=None,
               out=None):
    """The probe on (BH, Nq, D) q and (BH, Nk, D) k, v (int8 q, k in mode
    "int8"), attending to the first n_keys keys (default Nq), into `out` where
    given; CPU tensors take `run_kernel_ref`."""
    if q.device.type == "cpu":
        return run_kernel_ref(q, k, v, block_q, block_k, mode, scale, n_keys)
    n = q.shape[1] if n_keys is None else n_keys
    check_operands(q, k, v, torch.int8 if mode == "int8" else torch.bfloat16,
                   block_q, block_k, n, TILINGS)
    out = output(q, out)
    BA._launch("bench_global_attention", q.device, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0],
               q.shape[1], n, k.shape[1], q.shape[2], block_q, block_k,
               MODES.index(mode), scale, lib=kernel_library())
    LAUNCHES["global_attention"] += 1
    return out


def sdpa(q, k, v, scale):
    """The library yardstick: SDPA (the flash backend on the card) on
    (BH, N, D) as (1, BH, N, D). The port never calls it."""
    ctx = contextlib.nullcontext()
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        ctx = sdpa_kernel(SDPBackend.FLASH_ATTENTION)
    with ctx:
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              scale=scale)[0]


# ---------------------------------------------------------------------------
# Inputs, quantization, bounds, lines (shared by the global-shape probes)
# ---------------------------------------------------------------------------

def make_inputs(BH, N, D, seed=0, device="cpu", scale=1.0):
    """q, k, v (BH, N, D) bf16 from a seeded numpy normal, in the
    reference's order; q and k times `scale` (v never)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        x = rng.normal(size=(BH, N, D)) * (scale if i < 2 else 1.0)
        out.append(torch.from_numpy(x.astype(np.float32)).to(device)
                   .to(torch.bfloat16))
    return tuple(out)


def quantize(x):
    """The reference's per-tensor quantization: amax = max|x|, clip(rint(x /
    amax · 127), ±127) as int8. Returns (int8, amax as a 0-d f32 tensor)."""
    xf = x.float()
    amax = xf.abs().amax()
    return (torch.round(xf / amax * 127).clamp(-127, 127).to(torch.int8),
            amax)


def int8_operands(q, k, scale):
    """(q8, k8, int8_scale): int8_scale = qa·ka/127²·scale in f32, as the
    reference's numpy scalars compute it, as a Python float."""
    q8, qa = quantize(q)
    k8, ka = quantize(k)
    return q8, k8, float(qa * ka / (127 * 127) * scale)


def bound_ms(BH, Nq, Nk, D, ex2_rate, *, qk8=False, pv8=False, exp=True,
             qk_bytes=2):
    """Least card time of one call: the largest of the tensor-core time (QKᵀ
    and PV, 2·BH·Nq·Nk·D each, at the int8 or bf16 peak), the exp time
    (BH·Nq·Nk at `ex2_rate`) and the bytes (q, k at qk_bytes, v and o in bf16,
    once each) at 3.35 TB/s. Returns (ms, "operations" or "bytes", what sets
    it)."""
    mm = 2.0 * BH * Nq * Nk * D
    tensor = (mm / (INT8_PEAK_OPS if qk8 else BA.BF16_PEAK_FLOPS)
              + mm / (INT8_PEAK_OPS if pv8 else BA.BF16_PEAK_FLOPS)) * 1e3
    sfu = BH * Nq * Nk / ex2_rate * 1e3 if exp else 0.0
    nbytes = BH * D * ((Nq + Nk) * qk_bytes + (Nk + Nq) * 2)
    t_bytes = nbytes / BA.HBM_BYTES_PER_S * 1e3
    ms, unit = max((tensor, "tensor cores"), (sfu, "exp units"),
                   (t_bytes, "HBM"))
    return ms, ("bytes" if unit == "HBM" else "operations"), unit


def mean_distance(a, b):
    return float((a.float() - b.float()).abs().mean())


def check_line(name, out, ref, rows):
    """Hold one output to its plain version (1e-2 of max|ref|: the same
    roundings, another f32 order); print and return the entry, raising on a
    mismatch."""
    err, tol = BA.probe_error("attention", out, ref)
    print(f"  check {name} ({rows} q rows): max|err|={err:.3g} against "
          f"plain (tol {tol:.3g})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: max|err| {err} over {tol}")
    return dict(max_abs_err=err, tol=tol, rows=rows)


def int8_control(name, out, own_ref, bf16_ref):
    """An int8 kernel must lie further (mean |diff|) from the bf16 plain
    version than from its own. Prints and returns both."""
    own, other = mean_distance(out, own_ref), mean_distance(out, bf16_ref)
    print(f"  control {name}: mean|diff| {own:.3g} from its plain version, "
          f"{other:.3g} from the bf16 mode's", flush=True)
    if not other > own:
        raise AssertionError(f"{name}: the check cannot tell int8 from bf16 "
                             f"({own} >= {other})")
    return dict(mean_dist_own_plain=own, mean_dist_bf16_plain=other)


def time_line(name, kernel, run, plain, args, iters, flops, bound,
              library_ms=None, library_reason=None, extra=None):
    """Time `run(*args)` (CUDA events, best of 3 over `iters`) and `plain`
    (once, after a warm-up), print the line and return its dict."""
    ms = BA.bench(run, args, iters)
    plain_ms = BA.bench(plain, args, 1, reps=1)
    b_ms, by, unit = bound
    print(f"{name:32s} {ms:8.3f} ms {flops / ms / 1e9:6.1f} TF/s   bound "
          f"{b_ms:.3f} ms ({unit}), {100 * b_ms / ms:5.1f}% of it; plain "
          f"{plain_ms:.1f} ms", flush=True)
    line = dict(variant=name, kernel=kernel, ms=ms, plain_ms=plain_ms,
                tflops=flops / ms / 1e9, bound_ms=b_ms, bound_by=by,
                bound_unit=unit, pct_of_bound=100 * b_ms / ms,
                library_ms=library_ms)
    if library_reason:
        line["library_ms_reason"] = library_reason
    line.update(extra or {})
    return line


def require_card():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes run on the card")
    return torch.device("cuda", torch.cuda.current_device())


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

parser = argparse.ArgumentParser(
    description="Global-attention probe on the card: bf16 (natural exp), "
                "int8 QK^T and matmul-only modes at five CTA tilings "
                f"(block_q, block_k) in {sorted(TILINGS)}, beside SDPA.")
parser.add_argument("--iters", type=int, default=8)
parser.add_argument("--n", type=int, default=34353)
parser.add_argument("--heads", type=int, default=16)
parser.add_argument("--check", action="store_true",
                    help="hold every mode and tiling against its plain "
                         "version first")


def variant_name(mode, bq, bk):
    return f"{mode} bq={bq} bk={bk}"


def check_sweep(modes, tilings, default, N, call):
    """--check's sweep: every mode at the `default` tiling on all rows and at
    the others on the first 2048, by `check_line`. Returns ({variant: entry},
    {mode: (output, plain) at the default tiling})."""
    errors, at_default = {}, {}
    for mode in modes:
        for bq, bk in tilings:
            rows = N if (bq, bk) == default else SLAB_ROWS
            name = variant_name(mode, bq, bk)
            out, ref = call(mode, bq, bk, rows)
            errors[name] = check_line(name, out, ref, rows)
            if (bq, bk) == default:
                at_default[mode] = (out, ref)
    return errors, at_default


def check(operands, N):
    """--check on {mode: (q, k, v, scale)}: the sweep, then the int8
    control at the default tiling. Raises on a mismatch."""
    def call(mode, bq, bk, rows):
        q, k, v, sc = operands[mode]
        args = (q[:, :rows].contiguous(), k, v, bq, bk, mode, sc, N)
        return run_kernel(*args), run_kernel_ref(*args)

    errors, at = check_sweep(MODES, TILINGS, DEFAULT_TILING, N, call)
    errors[variant_name("int8", *DEFAULT_TILING)].update(
        int8_control("int8", *at["int8"], at["bf16"][1]))
    return errors


def main(argv=None):
    """Run the benchmark on the card. Returns the exp2 rate, the SDPA time, the
    slab's accuracy and the lines."""
    args = parser.parse_args(argv)
    device = require_card()
    D, BH = HEAD_DIM, args.heads
    N = BA.roundup(args.n, 2048)
    print(f"shape: BH={BH} N={N} D={D} (padded from {args.n})", flush=True)
    flops = 4.0 * BH * N * N * D
    q, k, v = make_inputs(BH, N, D, device=device)
    scale = 1.0 / math.sqrt(D)
    q8, k8, int8_scale = int8_operands(q, k, scale)
    operands = {"bf16": (q, k, v, scale), "matmul": (q, k, v, scale),
                "int8": (q8, k8, v, int8_scale)}

    # The reference's accuracy slab: q[:, :2048] against k, v[:, :4096] with
    # its grid's key count, q's 2048.
    slab = {mode: run_kernel(qq[:, :2048].contiguous(),
                             kk[:, :4096].contiguous(),
                             v[:, :4096].contiguous(), *DEFAULT_TILING, mode,
                             sc)
            for mode, (qq, kk, _, sc) in operands.items() if mode != "matmul"}
    err = (slab["int8"].float() - slab["bf16"].float()).abs()
    slab_err = dict(max=float(err.max()), mean=float(err.mean()),
                    keys_attended=2048)
    print(f"int8 vs bf16 (2048x4096 slab; the first 2048 keys attended, as "
          f"the reference's grid takes the key count from q): max "
          f"{slab_err['max']:.4f} mean {slab_err['mean']:.5f}", flush=True)

    errors = check(operands, N) if args.check else {}
    rate = BA.ex2_rate(device)
    print(f"exp2 rate: {rate / 1e12:.3f} T/s measured (ex2.approx chains)",
          flush=True)
    library_ms = BA.bench(sdpa, (q, k, v, scale), args.iters)
    print(f"{'SDPA (library, scale 1/sqrt(D))':32s} {library_ms:8.3f} ms "
          f"{flops / library_ms / 1e9:6.1f} TF/s", flush=True)
    lines = []
    for mode in ("matmul", "bf16", "int8"):
        qq, kk, vv, sc = operands[mode]
        bound = bound_ms(BH, N, N, D, rate, qk8=mode == "int8",
                         exp=mode != "matmul",
                         qk_bytes=1 if mode == "int8" else 2)
        for bq, bk in TILINGS:
            name = variant_name(mode, bq, bk)
            lines.append(time_line(
                name, "global_attention", run_kernel, run_kernel_ref,
                (qq, kk, vv, bq, bk, mode, sc), args.iters, flops, bound,
                library_ms=library_ms if mode == "bf16" else None,
                library_reason=None if mode == "bf16" else (
                    "no single PyTorch call computes a probe floor"
                    if mode == "matmul" else
                    "no PyTorch call quantizes QK^T"),
                extra=dict(mode=mode, block_q=bq, block_k=bk,
                           reference_blocks=TILINGS[(bq, bk)],
                           **errors.get(name, {}))))
    return dict(ex2_rate_measured=rate, library_ms=library_ms, slab=slab_err,
                int8_scale=int8_scale, lines=lines, checks=errors)


if __name__ == "__main__":
    main()
