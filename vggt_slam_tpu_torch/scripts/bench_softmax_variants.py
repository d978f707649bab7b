"""Flash-softmax variants at the global shape on the card: the port of
scripts/bench_softmax_variants.py.

BH 16, N 34353 padded to 34816, D 64, q and k × 0.3, raw logits s = q kᵀ.
One kernel (csrc/bench_softmax_variants.cu on csrc/global_sm90.cuh)
computes `matmul` (o = Σ bf16(s) v), `online` (exp2, running max),
`static` (p = exp2(s - 12)), `staticfused` (v widened by 64 columns of
ones, so l is the tensor cores' sum of bf16(p)) and `staticint8` (q, k
quantized per tensor outside, p = exp2(f32(s32)·dequant - 12)). SDPA at
scale ln 2 is the library line of online and static.

    python -m vggt_slam_tpu_torch.scripts.bench_softmax_variants
        [--iters 8] [--n 34353] [--heads 16] [--block_q 64] [--block_k 64]
        [--check]

`--block_q`/`--block_k` take the card's tilings (TILINGS). Lines as in
bench_global_attention, then the reference's `max |static-online|` and
`|staticfused-online|`. `--check` holds every mode (the chosen tiling on
all rows, the others on a 2048-row slab) against its plain version, with
the int8 control. Needs the card; `LAUNCHES` and `design_launches` count
launches.
"""
from __future__ import annotations

import argparse
import ctypes
import math

import torch

from vggt_slam_tpu_torch.scripts import bench_attention as BA
from vggt_slam_tpu_torch.scripts import bench_global_attention as G

MODES = ("matmul", "online", "static", "staticfused", "staticint8")
TILINGS = {(64, 64): (1024, 2048), (128, 64): (2048, 2048),
           (64, 128): (1024, 4096)}
SMAX = 12.0

LAUNCHES = {"softmax_variants": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def run_kernel_ref(q, k, v, block_q, block_k, mode, smax=SMAX,
                   n_keys=None):
    """Plain `run_kernel` (int8 q, k in `staticint8`, whose smax is (12.0,
    dequant)): the first n_keys keys (default Nq) in blocks of block_k, in the
    kernel's order."""
    n = q.shape[1] if n_keys is None else n_keys
    k, v = k[:, :n], v[:, :n]
    if mode == "matmul":
        acc = G.blockwise_sum(q, k, v, block_k,
                              lambda q, k, v: G.pv_bf16(G.qk_f32(q, k), v))
        return acc.to(torch.bfloat16)
    if mode == "online":
        acc, l = G.online_softmax(q, k, v, block_k, G.qk_f32, torch.exp2)
        return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)

    def p_of(q, k):
        if mode == "staticint8":
            return torch.exp2(G.qk_f32(q, k) * smax[1] - smax[0])
        return torch.exp2(G.qk_f32(q, k) - smax)

    def acc_and_l(q, k, v):
        p = p_of(q, k)
        if mode == "staticfused":      # l from the bf16 p, as column D
            p = p.to(torch.bfloat16).float()
        return torch.cat([G.pv_bf16(p, v), p.sum(-1, keepdim=True)], -1)

    acc = G.blockwise_sum(q, k, v, block_k, acc_and_l)
    o, l = acc[..., :-1], acc[..., -1:]
    return (o / l.clamp_min(1e-30)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bench_softmax_variant": ([_P] * 4 + [_I] * 8 + [ctypes.c_float] * 2
                              + [_P], ctypes.c_int),
    "bench_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "bench_softmax_variants_design_launches": (
        [ctypes.POINTER(ctypes.c_longlong)], None),
}


def kernel_library():
    """Build (if stale) and load csrc/bench_softmax_variants.cu."""
    from vggt_slam_tpu_torch.ops import cuda_build
    return cuda_build.load("bench_softmax_variants", _SIGNATURES)


def design_launches() -> dict:
    """The kernel's launches in this process by design, counted by the C
    launcher: "tma_wgmma" for `global_sm90` (csrc/global_sm90.cuh)."""
    return G.design_launches(kernel_library(), "bench_softmax_variants")


def run_kernel(q, k, v, block_q, block_k, mode, smax=SMAX, n_keys=None,
               out=None):
    """The probe on (BH, Nq, D) q and (BH, Nk, D) k, v (int8 q, k in
    `staticint8`), attending to the first n_keys keys (default Nq), into `out`
    where given; CPU tensors take `run_kernel_ref`."""
    if q.device.type == "cpu":
        return run_kernel_ref(q, k, v, block_q, block_k, mode, smax, n_keys)
    int8 = mode == "staticint8"
    n = q.shape[1] if n_keys is None else n_keys
    G.check_operands(q, k, v, torch.int8 if int8 else torch.bfloat16,
                     block_q, block_k, n, TILINGS)
    shift, dequant = smax if int8 else (smax, 1.0)
    out = G.output(q, out)
    BA._launch("bench_softmax_variant", q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1], n,
               k.shape[1], q.shape[2], block_q, block_k, MODES.index(mode),
               shift, dequant, lib=kernel_library())
    LAUNCHES["softmax_variants"] += 1
    return out


def int8_operands(q, k):
    """The reference's staticint8 operands (:193-198): q8 = clip(round(q ·
    (127/max|q|)), ±127), 127/max|q| in double applied in f32, the same for k,
    dequant = (qs/127)(ks/127) in double. Returns (q8, k8, (12.0, dequant))."""
    qs, ks = (float(t.float().abs().amax()) for t in (q, k))
    q8, k8 = (torch.round(t.float() * (127.0 / a)).clamp(-127, 127)
              .to(torch.int8) for t, a in ((q, qs), (k, ks)))
    return q8, k8, (SMAX, (qs / 127.0) * (ks / 127.0))


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

parser = argparse.ArgumentParser(
    description="Flash-softmax variants (matmul, online, static, "
                "staticfused, staticint8) at the global-attention shape on "
                "the card, beside SDPA.")
parser.add_argument("--iters", type=int, default=8)
parser.add_argument("--n", type=int, default=34353)
parser.add_argument("--heads", type=int, default=16)
parser.add_argument("--block_q", type=int, default=64,
                    help=f"CTA q rows; (block_q, block_k) in "
                         f"{sorted(TILINGS)}")
parser.add_argument("--block_k", type=int, default=64,
                    help="keys per K/V tile")
parser.add_argument("--check", action="store_true",
                    help="hold every mode and tiling against its plain "
                         "version first")


def check(operands, tiling, N):
    """--check on {mode: (q, k, v, smax)}: the sweep around `tiling`, then
    the int8 control (staticint8 against static's plain version). Returns
    the check entries and the outputs at `tiling`; raises on a mismatch."""
    def call(mode, bq, bk, rows):
        q, k, v, smax = operands[mode]
        args = (q[:, :rows].contiguous(), k, v, bq, bk, mode, smax, N)
        return run_kernel(*args), run_kernel_ref(*args)

    errors, at = G.check_sweep(MODES, TILINGS, tiling, N, call)
    errors[G.variant_name("staticint8", *tiling)].update(
        G.int8_control("staticint8", *at["staticint8"], at["static"][1]))
    return errors, {mode: pair[0] for mode, pair in at.items()}


def main(argv=None):
    """Run the benchmark on the card. Returns the measured exp2 rate, the
    SDPA time, one dict per line (with the check's error, tolerance and
    control under --check) and the static/online differences."""
    args = parser.parse_args(argv)
    device = G.require_card()
    tiling = (args.block_q, args.block_k)
    if tiling not in TILINGS:
        raise ValueError(f"(--block_q, --block_k) must be one of "
                         f"{sorted(TILINGS)}, got {tiling}")
    BH, D = args.heads, G.HEAD_DIM
    N = BA.roundup(args.n, 2048)
    q, k, v = G.make_inputs(BH, N, D, device=device, scale=0.3)
    flops = 4.0 * BH * N * N * D
    print(f"shape: BH={BH} N={N} D={D}  bq={args.block_q} bk={args.block_k}"
          f"  {flops / 1e12:.2f} TFLOP/call", flush=True)
    q8, k8, smax8 = int8_operands(q, k)
    operands = {mode: (q, k, v, SMAX) for mode in MODES}
    operands["staticint8"] = (q8, k8, v, smax8)
    errors, outs = check(operands, tiling, N) if args.check else ({}, {})

    rate = BA.ex2_rate(device)
    print(f"exp2 rate: {rate / 1e12:.3f} T/s measured (ex2.approx chains)",
          flush=True)
    library_ms = BA.bench(G.sdpa, (q, k, v, math.log(2.0)), args.iters)
    print(f"{'SDPA (library, scale ln 2)':32s} {library_ms:8.3f} ms "
          f"{flops / library_ms / 1e9:6.1f} TF/s", flush=True)
    lines = []
    for mode in MODES:
        qq, kk, vv, smax = operands[mode]
        int8 = mode == "staticint8"
        bound = G.bound_ms(BH, N, N, D, rate, qk8=int8,
                           exp=mode != "matmul", qk_bytes=1 if int8 else 2)
        name = G.variant_name(mode, *tiling)
        lines.append(G.time_line(
            name, "softmax_variants", run_kernel, run_kernel_ref,
            (qq, kk, vv, *tiling, mode, smax), args.iters, flops, bound,
            library_ms=library_ms if mode in ("online", "static") else None,
            library_reason=None if mode in ("online", "static") else (
                "no PyTorch call quantizes QK^T" if int8 else
                "no single PyTorch call computes a probe floor"
                if mode == "matmul" else
                "no PyTorch call sums bf16-rounded weights into the row sum"),
            extra=dict(mode=mode, block_q=args.block_q, block_k=args.block_k,
                       reference_blocks=TILINGS[tiling],
                       **errors.get(name, {}))))
    base = lines[0]["ms"]
    for line in lines[1:]:
        line["pct_of_matmul_floor"] = 100 * base / line["ms"]
        print(f"  {line['mode']:12s}: {line['pct_of_matmul_floor']:.0f}% of "
              f"the bf16 matmul floor", flush=True)

    # numeric sanity: static vs online on the same inputs
    if not outs:
        outs = {mode: run_kernel(q, k, v, *tiling, mode)
                for mode in ("online", "static", "staticfused")}
    d1 = float((outs["static"].float() - outs["online"].float()).abs().max())
    d2 = float((outs["staticfused"].float() - outs["online"].float())
               .abs().max())
    print(f"max |static-online| = {d1:.2e}   |staticfused-online| = "
          f"{d2:.2e}", flush=True)
    return dict(ex2_rate_measured=rate, library_ms=library_ms, lines=lines,
                checks=errors, static_vs_online=d1,
                staticfused_vs_online=d2)


if __name__ == "__main__":
    main()
