"""In-kernel int8 quantization at the global shape on the card (counterpart
of scripts/bench_int8_inkernel.py): BH 16, N 34353 padded to 34816, D 64;
csrc/bench_int8_inkernel.cu (on global_sm90.cuh) computes exp2-domain
online-softmax attention with per-(b, h) scales from `scales`: `bf16`,
`qk8` (q, k quantized in the kernel) and `qk8av8` (p and v too), each K, V
tile quantized as it lands (the same int8 values as the reference's
scratch). SDPA (scale 1/√D) is bf16's library line.

    python -m vggt_slam_tpu_torch.scripts.bench_int8_inkernel
        [--iters 6] [--n 34353] [--check]

The reference's accuracy lines (each mode against f32 on 2048 rows), then
a line per mode and tiling. `--check` holds every mode to its plain
version with the int8 controls. Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import math

import torch

from vggt_slam_tpu_torch.scripts import bench_attention as BA
from vggt_slam_tpu_torch.scripts import bench_global_attention as G

MODES = ("bf16", "qk8", "qk8av8")
TILINGS = {(64, 64): (1024, 2048), (128, 64): (2048, 2048)}
DEFAULT_TILING = (64, 64)

LAUNCHES = {"int8_inkernel": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def scales(q, k, v, mode):
    """The reference's (5, BH) f32 scales (:105-114), in its f32 order:
    127/qa, 127/ka, 127/va, dq (c = log2(e)/√D in bf16 mode, qa·ka/127²·c
    otherwise) and va/127², with xa = max|x| over each (b, h)."""
    c = math.log2(math.e) / math.sqrt(q.shape[-1])
    qa, ka, va = (t.float().abs().amax(dim=(1, 2)) for t in (q, k, v))
    dq = torch.full_like(qa, c) if mode == "bf16" else \
        qa * ka / (127.0 * 127.0) * c
    n127 = qa.new_tensor(127.0)     # 127 / x, not 127 · (1 / x)
    return torch.stack([n127 / qa, n127 / ka, n127 / va, dq,
                        va / (127.0 * 127.0)])


# Plain version

def quant(x, inv):
    """clip(round(x · inv), ±127) per (b, h) (round half to even), as f32
    values."""
    return torch.round(x.float() * inv[:, None, None]).clamp(-127, 127)


def attention_ref(sc, q, k, v, block_q, block_k, mode):
    """Plain `attention` with scales `sc`: the online exp2 softmax over key
    blocks of block_k in the kernel's order; int8 products as exact f32 sums of
    integers."""
    dq = sc[3][:, None, None]
    if mode != "bf16":
        q, k = quant(q, sc[0]), quant(k, sc[1])

    def pv(p, vb):
        if mode != "qk8av8":
            return G.pv_bf16(p, vb)
        p8 = torch.round(p * 127.0).clamp(0, 127)
        return torch.matmul(p8, vb) * sc[4][:, None, None]

    if mode == "qk8av8":
        v = quant(v, sc[2])
    acc, l = G.online_softmax(q, k, v, block_k,
                              lambda q, k: G.qk_f32(q, k) * dq, torch.exp2,
                              pv)
    return (acc / l[..., None]).to(torch.bfloat16)


def run_ref(q, k, v, block_q, block_k, mode):
    """Plain version of `run`."""
    return attention_ref(scales(q, k, v, mode), q, k, v, block_q, block_k,
                         mode)


def f32_attention(q, k, v, heads_per_chunk=4):
    """Softmax attention in f32 at scale 1/√D, the reference's accuracy
    yardstick, chunked over heads (the logits of 2048 q rows of all 16
    heads at the global shape are 4.6 GB)."""
    c = 1.0 / math.sqrt(q.shape[-1])
    out = []
    for h in range(0, q.shape[0], heads_per_chunk):
        qs, ks, vs = (t[h:h + heads_per_chunk].float() for t in (q, k, v))
        w = torch.softmax(torch.matmul(qs, ks.transpose(-1, -2)) * c, -1)
        out.append(torch.matmul(w, vs))
    return torch.cat(out)


# CUDA kernel wrapper

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bench_int8_inkernel": ([_P] * 5 + [_I] * 7 + [_P], ctypes.c_int),
    "bench_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "bench_int8_inkernel_design_launches": (
        [ctypes.POINTER(ctypes.c_longlong)], None),
}


def kernel_library():
    """Build (if stale) and load csrc/bench_int8_inkernel.cu."""
    from vggt_slam_tpu_torch.ops import cuda_build
    return cuda_build.load("bench_int8_inkernel", _SIGNATURES)


def design_launches() -> dict:
    """The kernel's launches in this process by design, counted by the C
    launcher: "tma_wgmma" for `global_sm90` (csrc/global_sm90.cuh)."""
    return G.design_launches(kernel_library(), "bench_int8_inkernel")


def attention(sc, q, k, v, block_q, block_k, mode, out=None):
    """The probe on bf16 (BH, Nq, D) q and (BH, Nk, D) k, v with (5, BH)
    f32 scales `sc`, into `out` where given. CPU tensors take
    `attention_ref`, CUDA tensors the CUDA kernel."""
    if q.device.type == "cpu":
        return attention_ref(sc, q, k, v, block_q, block_k, mode)
    G.check_operands(q, k, v, torch.bfloat16, block_q, block_k, k.shape[1],
                     TILINGS)
    if (sc.shape != (5, q.shape[0]) or sc.dtype != torch.float32
            or sc.device != q.device or not sc.is_contiguous()):
        raise ValueError(f"contiguous (5, {q.shape[0]}) f32 scales on "
                         f"{q.device} expected, got {tuple(sc.shape)} "
                         f"{sc.dtype} on {sc.device}")
    out = G.output(q, out)
    BA._launch("bench_int8_inkernel", q.device, sc.data_ptr(), q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0],
               q.shape[1], k.shape[1], q.shape[2], block_q, block_k,
               MODES.index(mode), lib=kernel_library())
    LAUNCHES["int8_inkernel"] += 1
    return out


def run(q, k, v, block_q, block_k, mode):
    """The reference's `run`: the scales, then the probe."""
    return attention(scales(q, k, v, mode), q, k, v, block_q, block_k, mode)


# Entry point

parser = argparse.ArgumentParser(
    description="In-kernel int8 quantization (bf16, qk8, qk8av8) of "
                "exp2-domain flash attention at the global shape on the "
                "card, beside SDPA.")
parser.add_argument("--iters", type=int, default=6)
parser.add_argument("--n", type=int, default=34353)
parser.add_argument("--check", action="store_true",
                    help="hold every mode and tiling against its plain "
                         "version first")


def check(q, k, v, N):
    """--check: the sweep, then the int8 controls of qk8 and qk8av8 at the
    default tiling. Raises on a mismatch."""
    def call(mode, bq, bk, rows):
        args = (scales(q, k, v, mode), q[:, :rows].contiguous(), k, v, bq,
                bk, mode)
        return attention(*args), attention_ref(*args)

    errors, at = G.check_sweep(MODES, TILINGS, DEFAULT_TILING, N, call)
    for mode in ("qk8", "qk8av8"):
        errors[G.variant_name(mode, *DEFAULT_TILING)].update(
            G.int8_control(mode, *at[mode], at["bf16"][1]))
    return errors


def main(argv=None):
    """Run the benchmark on the card. Returns the measured exp2 rate, the
    SDPA time, the accuracy lines and one dict per line (with the check's
    error, tolerance and control under --check)."""
    args = parser.parse_args(argv)
    device = G.require_card()
    BH, D = 16, G.HEAD_DIM
    N = BA.roundup(args.n, 2048)
    print(f"shape: BH={BH} N={N} D={D}", flush=True)
    flops = 4.0 * BH * N * N * D
    q, k, v = G.make_inputs(BH, N, D, device=device)

    # accuracy on a 2048-q slab against f32 attention over all keys
    qs = q[:, :G.SLAB_ROWS].contiguous()
    ref = f32_attention(qs, k, v)
    accuracy = {}
    for mode in MODES:
        err = (run(qs, k, v, *DEFAULT_TILING, mode).float() - ref).abs()
        accuracy[mode] = dict(max=float(err.max()), mean=float(err.mean()))
        print(f"{mode:7s} vs f32: max {accuracy[mode]['max']:.4f} "
              f"mean {accuracy[mode]['mean']:.5f}", flush=True)
    del ref

    errors = check(q, k, v, N) if args.check else {}
    rate = BA.ex2_rate(device)
    print(f"exp2 rate: {rate / 1e12:.3f} T/s measured (ex2.approx chains)",
          flush=True)
    library_ms = BA.bench(G.sdpa, (q, k, v, 1.0 / math.sqrt(D)), args.iters)
    print(f"{'SDPA (library, scale 1/sqrt(D))':32s} {library_ms:8.3f} ms "
          f"{flops / library_ms / 1e9:6.1f} TF/s", flush=True)
    lines = []
    for mode in MODES:
        sc = scales(q, k, v, mode)
        bound = G.bound_ms(BH, N, N, D, rate, qk8=mode != "bf16",
                           pv8=mode == "qk8av8")
        for bq, bk in TILINGS:
            name = G.variant_name(mode, bq, bk)
            lines.append(G.time_line(
                name, "int8_inkernel", attention, attention_ref,
                (sc, q, k, v, bq, bk, mode), args.iters, flops, bound,
                library_ms=library_ms if mode == "bf16" else None,
                library_reason=None if mode == "bf16" else
                "no PyTorch call quantizes QK^T",
                extra=dict(mode=mode, block_q=bq, block_k=bk,
                           reference_blocks=TILINGS[(bq, bk)],
                           **errors.get(name, {}))))
    return dict(ex2_rate_measured=rate, library_ms=library_ms,
                accuracy=accuracy, lines=lines, checks=errors)


if __name__ == "__main__":
    main()
