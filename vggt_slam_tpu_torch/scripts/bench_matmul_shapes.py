"""Matmul rates at attention-like shapes on the card: the port of
scripts/bench_matmul_shapes.py.

Do the tensor cores keep up at K = 64, and does a grid of one problem a
tile keep up with the library's batched product?
csrc/bench_matmul_shapes.cu computes o[p] = bf16(a[p] @ b[p]) on bf16 a
(B, M, K), b (B, K, N) on `mm_sm90` (persistent grid, TMA ring, `wgmma`,
TMA-store epilogue): `batched_mm` (a work item is one output tile;
`pallas_batched_mm`) and `grouped_mm` (that tile of G problems in order;
`pallas_grouped_mm`), at TILINGS, beside `torch.bmm`, in the reference's
sections: nine products at B = 1, B = 528 at the QKᵀ shape with G in (2,
4, 8, 16), the PV shape.

    python -m vggt_slam_tpu_torch.scripts.bench_matmul_shapes
        [--iters 20] [--check]

Each line: the kernel alone from a CUDA graph of at least --iters launches
(`bench_attention.graph_bench`), best of 3, cycling through operand copies
spanning twice the 50 MB L2; TF/s; the bound and its share; the plain and
library times. Seeded normals drawn on the card. `--check` runs every line
into a NaN-filled output, holds it within one bf16 ulp of max|ref|, and at
B = 528 runs three controls it must reject. `LAUNCHES` counts runs (a
graph's at each replay), `CALLS` the C entries' calls, `design_launches()`
the C launcher's count (captures included).
"""
from __future__ import annotations

import argparse
import ctypes
import math

import torch

from vggt_slam_tpu_torch.scripts import bench_attention as BA
from vggt_slam_tpu_torch.scripts import bench_global_attention as GA

TILINGS = ((128, 128), (128, 256))    # output tiles (block_m, block_n)
DEFAULT_TILING = (128, 128)
L2_BYTES = 50e6                       # H100 L2
SINGLE_SHAPES = [(1056, 64, 1056), (1024, 64, 1024), (1056, 128, 1056),
                 (1056, 256, 1056), (1056, 512, 1056), (1024, 1024, 1024),
                 (2048, 64, 2048), (4096, 64, 4096), (2048, 2048, 2048)]
BATCH = 528
QK_SHAPE = (1056, 64, 1056)
PV_SHAPE = (1056, 1056, 64)
GROUPS = (2, 4, 8, 16)
K_DROPPED = 16                        # the lost-K control's dropped depth

# Kernel runs on the card in this process, and calls of the C entries
# (captures into a graph included), read by chip_smoke.py.
LAUNCHES = {"batched_mm": 0, "grouped_mm": 0}
CALLS = {"batched_mm": 0, "grouped_mm": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = CALLS[name] = 0


# ---------------------------------------------------------------------------
# Plain version and the library line
# ---------------------------------------------------------------------------

def batched_mm_ref(a, b, chunk=64):
    """Plain version of both kernels: exact f32 products of the bf16 inputs,
    f32 sums, rounded once; `chunk` problems at a time."""
    return torch.cat([torch.matmul(a[i:i + chunk].float(),
                                   b[i:i + chunk].float()).to(torch.bfloat16)
                      for i in range(0, a.shape[0], chunk)])


def library_mm(a, b, out=None):
    """The library line (the reference's `xla_batched_mm`): `torch.bmm`,
    `torch.matmul` at B = 1. Timed beside the kernels only."""
    if a.shape[0] > 1:
        return torch.bmm(a, b, out=out)
    return torch.matmul(a[0], b[0], out=None if out is None else out[0])[None]


def max_abs_diff(x, y, chunk=64):
    """max |x - y| over (B, ...) tensors, `chunk` problems at a time; NaN
    where either holds a NaN."""
    return float(torch.stack([(x[i:i + chunk].float() - y[i:i + chunk].float())
                              .abs().max()
                              for i in range(0, x.shape[0], chunk)]).max())


def mm_error(out, ref):
    """(max |out - ref|, one bf16 ulp of max |ref|): both sides round one
    f32 sum of exact products once; another summation order can flip a
    rounding, by one ulp of that element."""
    top = float(ref.float().abs().max())
    tol = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return max_abs_diff(out, ref), tol


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bench_batched_mm": ([_P] * 3 + [_I] * 6 + [_P], ctypes.c_int),
    "bench_grouped_mm": ([_P] * 3 + [_I] * 7 + [_P], ctypes.c_int),
    "bench_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "bench_matmul_design_launches": (
        [ctypes.POINTER(ctypes.c_longlong)], None),
}


def kernel_library():
    """Build (if stale) and load csrc/bench_matmul_shapes.cu."""
    from vggt_slam_tpu_torch.ops import cuda_build
    return cuda_build.load("bench_matmul_shapes", _SIGNATURES)


def design_launches() -> dict:
    """Both kernels' launches by design from the C launcher (launches and
    captures): "tma_wgmma" for `mm_sm90`."""
    out = (ctypes.c_longlong * 1)()
    kernel_library().bench_matmul_design_launches(out)
    return {"tma_wgmma": out[0]}


def check_operands(a, b, G, tile, out=None, tilings=None):
    """Raise unless a (B, M, K), b (B, K, N) and out (B, M, N) are bf16,
    contiguous, 16-byte aligned, on one device, K and N multiples of 8, G
    divides B and the tiling is in `tilings`."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"(B, M, K) and (B, K, N) operands expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, M, K = a.shape
    if out is not None and out.shape != (B, M, b.shape[2]):
        raise ValueError(f"out must be {(B, M, b.shape[2])}, got "
                         f"{tuple(out.shape)}")
    named = [("a", a), ("b", b)] + ([("out", out)] if out is not None else [])
    for name, t in named:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernels take bfloat16 {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    for name, t in named:
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
    if K % 8 or b.shape[2] % 8:
        raise ValueError(f"K and N must be multiples of 8 (16-byte rows), "
                         f"got K {K}, N {b.shape[2]}")
    if G < 1 or B % G:
        raise ValueError(f"G = {G} does not divide B = {B}")
    tilings = TILINGS if tilings is None else tilings
    if tuple(tile) not in tilings:
        raise ValueError(f"tiling {tuple(tile)} not built; the kernels take "
                         f"{list(tilings)}")


def count(kernel, n=1):
    """Add n runs of `kernel` on the card to LAUNCHES."""
    LAUNCHES[kernel] += n


def run_variant(kernel, a, b, G, tile, out=None):
    """The wrappers' body: C entry bench_<kernel> on CUDA tensors into
    `out` (a new tensor by default), `batched_mm_ref` on CPU tensors."""
    check_operands(a, b, G, tile, out)
    if a.device.type == "cpu":
        ref = batched_mm_ref(a, b)
        return ref if out is None else out.copy_(ref)
    if a.device.type != "cuda":
        raise ValueError(f"no matmul kernel for device {a.device}")
    B, M, K = a.shape
    N = b.shape[2]
    if out is None:
        out = torch.empty(B, M, N, dtype=torch.bfloat16, device=a.device)
    BA._launch(f"bench_{kernel}", a.device, a.data_ptr(), b.data_ptr(),
               out.data_ptr(), B, M, K, N,
               *((G,) if kernel == "grouped_mm" else ()), *tile,
               lib=kernel_library())
    CALLS[kernel] += 1
    if not torch.cuda.is_current_stream_capturing():   # graph_bench counts
        count(kernel)                                   # the replays
    return out


def batched_mm(a, b, tile=DEFAULT_TILING):
    """o[p] = bf16(a[p] @ b[p]), a work item one output tile of one
    problem."""
    return run_variant("batched_mm", a, b, 1, tile)


def grouped_mm(a, b, G, tile=DEFAULT_TILING):
    """The same product, a work item the same tile of G consecutive
    problems, in order."""
    return run_variant("grouped_mm", a, b, G, tile)


# ---------------------------------------------------------------------------
# Bounds, lines, check
# ---------------------------------------------------------------------------

def problem_bytes(B, M, K, N):
    """bf16 a and b read once, o written once."""
    return 2.0 * B * (M * K + K * N + M * N)


def bound_ms(B, M, K, N):
    """(ms, "operations" or "bytes"): the larger of 2·B·M·K·N at 989
    TFLOP/s and `problem_bytes` at 3.35 TB/s."""
    t_ops = 2.0 * B * M * K * N / BA.BF16_PEAK_FLOPS * 1e3
    t_bytes = problem_bytes(B, M, K, N) / BA.HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def copies(B, M, K, N):
    """How many copies of a shape's operands and output span 2 * L2."""
    return math.ceil(2 * L2_BYTES / problem_bytes(B, M, K, N))


def tile_name(tile):
    return f"{tile[0]}x{tile[1]}"


def variants(B):
    """(name, kernel, G, tiling) of a shape's lines: batched at every
    tiling and, at B = 528, grouped at every G and tiling."""
    out = [(f"batched {tile_name(t)}", "batched_mm", 1, t) for t in TILINGS]
    if B == BATCH:
        out += [(f"grouped G={G} {tile_name(t)}", "grouped_mm", G, t)
                for G in GROUPS for t in TILINGS]
    return out


def controls(a, b, out, ref, tile=DEFAULT_TILING):
    """Controls `mm_error` must reject on a batched output: `batch` (problem p
    against the plain output of p + 1), `edge` (the last partial row tile left
    NaN), `k_tile` (the plain product without the last K_DROPPED of K). Returns
    the errors and "tol"; raises if the check passes any."""
    M, K = a.shape[1:]
    _, tol = mm_error(out, ref)
    edge = out.clone()
    edge[:, (M - 1) // tile[0] * tile[0]:] = math.nan
    kk = K - K_DROPPED
    errs = {"batch": max_abs_diff(out, ref.roll(-1, 0)),
            "edge": max_abs_diff(edge, ref),
            "k_tile": max_abs_diff(out, batched_mm_ref(a[..., :kk],
                                                       b[:, :kk]))}
    print(f"  controls ({tile_name(tile)}): " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + f" (tol {tol:.3g})",
        flush=True)
    if any(e <= tol for e in errs.values()):
        raise AssertionError(f"the check passes a control: {errs}, tol {tol}")
    return dict(errs, tol=tol)


def check(a, b, ref, names, with_controls):
    """--check on one shape: every line of `names` into a NaN-filled output
    against `ref`, raising on a mismatch; the controls on the default tiling's
    output. Returns ({name: entry}, the controls or None)."""
    errors, ctrl = {}, None
    for name, kernel, G, tile in names:
        out = run_variant(kernel, a, b, G, tile,
                          torch.full_like(ref, math.nan))
        err, tol = mm_error(out, ref)
        print(f"  check {name}: max|err|={err:.3g} against plain (tol "
              f"{tol:.3g})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name}: max|err| {err} over {tol}")
        errors[name] = dict(max_abs_err=err, tol=tol)
        if with_controls and kernel == "batched_mm" and tile == DEFAULT_TILING:
            ctrl = controls(a, b, out, ref)
        del out
    return errors, ctrl


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

parser = argparse.ArgumentParser(
    description="Batched bf16 matmul rates at attention-like shapes on the "
                "card: one hand-written Hopper kernel (persistent grid, TMA "
                "ring, wgmma, TMA-store epilogue; a work item one output "
                "tile of one problem, or of G; tilings "
                f"{[tile_name(t) for t in TILINGS]}) beside torch.bmm.")
parser.add_argument("--iters", type=int, default=20)
parser.add_argument("--check", action="store_true",
                    help="hold every line against the plain version, with "
                         "the controls, first")


def sections():
    """The reference's sections: (title, B, (M, K, N)) per shape."""
    return ([("single big matmuls (B=1)", 1, s) for s in SINGLE_SHAPES]
            + [("batched B=528 attention-shape matmuls", BATCH, QK_SHAPE),
               ("PV-shape: (M,N)@(N,64)", BATCH, PV_SHAPE)])


def main(argv=None):
    """Run on the card; return the lines (with their checks), the library
    lines, the checks and the controls."""
    args = parser.parse_args(argv)
    device = GA.require_card()
    gen = torch.Generator(device).manual_seed(0)

    def mk(shape):
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)

    flags = torch.backends.cuda.matmul
    print(f"library: torch.bmm, allow_bf16_reduced_precision_reduction="
          f"{flags.allow_bf16_reduced_precision_reduction}; plain version "
          f"f32 (TF32 {'on' if flags.allow_tf32 else 'off'})", flush=True)
    lines, library, checks, ctrls, title = [], [], {}, {}, None
    for sec, B, (M, K, N) in sections():
        if sec != title:
            title = sec
            print(f"== {sec} ==", flush=True)
        a, b = mk((B, M, K)), mk((B, K, N))
        shape = f"B={B} ({M},{K},{N})"
        names = variants(B)
        flops = 2.0 * B * M * K * N
        bound, by = bound_ms(B, M, K, N)
        n_copies = copies(B, M, K, N)
        unit, mult = ("us", 1e3) if B == 1 else ("ms", 1.0)
        ref = batched_mm_ref(a, b)
        lib_err, _ = mm_error(library_mm(a, b), ref)
        if args.check:
            errs, ctrl = check(a, b, ref, names, B > 1)
            checks.update({f"{shape} {n}": e for n, e in errs.items()})
            if ctrl:
                ctrls[shape] = ctrl
        del ref
        plain_ms = BA.bench(batched_mm_ref, (a, b), 1, reps=1)
        sets = [(x, y, torch.empty(B, M, N, dtype=torch.bfloat16,
                                   device=device)) for x, y in
                [(a, b)] + [(a.clone(), b.clone())
                            for _ in range(n_copies - 1)]]
        lib_ms = BA.graph_bench(library_mm, sets, args.iters)
        print(f"  {shape} {'library (torch.bmm)':22s} {lib_ms * mult:9.2f} "
              f"{unit} {flops / lib_ms / 1e9:6.1f} TF/s   max|err| "
              f"{lib_err:.3g} against plain; plain {plain_ms:.3f} ms; bound "
              f"{bound * mult:.2f} {unit} ({by})"
              + (f"; over {n_copies} copies" if n_copies > 1 else ""),
              flush=True)
        library.append(dict(B=B, M=M, K=K, N=N, ms=lib_ms,
                            max_abs_err_vs_plain=lib_err))
        for name, kernel, G, tile in names:
            ms = BA.graph_bench(
                run_variant, [(kernel, x, y, G, tile, o) for x, y, o in sets],
                args.iters, replayed=lambda n: count(kernel, n))
            print(f"  {shape} {name:22s} {ms * mult:9.2f} {unit} "
                  f"{flops / ms / 1e9:6.1f} TF/s   bound {bound * mult:.2f} "
                  f"{unit} ({by}), {100 * bound / ms:5.1f}% of it", flush=True)
            lines.append(dict(
                section=sec, variant=name, kernel=kernel, B=B, M=M, K=K, N=N,
                G=G, tiling=list(tile), ms=ms, tflops=flops / ms / 1e9,
                bound_ms=bound, bound_by=by, pct_of_bound=100 * bound / ms,
                plain_ms=plain_ms, library_ms=lib_ms, copies=n_copies,
                **checks.get(f"{shape} {name}", {})))
        del a, b, sets
    return dict(lines=lines, library=library, checks=checks, controls=ctrls)


if __name__ == "__main__":
    main()
