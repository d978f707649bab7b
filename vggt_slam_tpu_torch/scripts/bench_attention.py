"""Microbenchmark of the frame-attention kernel on the card: the port's
counterpart of scripts/bench_attention.py.

Frame attention is BH = S·H independent problems of ~1041 tokens at D =
64. The script times `ops.attention.flash_single` beside four CUDA probes
(csrc/bench_attention.cu) that split it: `matmul_only` (o = bf16(q kᵀ) v,
the tensor-core floor), `softmax_only` (the exp2 softmax of a broadcast
logit row, the softmax floor), `grouped_attention` (straight or
interleaved) and `pipelined_attention` (G problems a work item on
`grouped_sm90`, to see whether one problem's products hide another's
softmax), and SDPA at scale ln 2. Inputs are padded to Np = roundup(N,
128) with unmasked zero keys, as in the reference; G in 2, 4, 8.

    python -m vggt_slam_tpu_torch.scripts.bench_attention [--iters 20]
        [--frames 33] [--heads 16] [--tokens 1041] [--dim 64] [--check]

Each line: ms (CUDA events, best of 3), TF/s (4·BH·Np²·D), the bound and
its share, the plain version's ms. `--check` first holds every call
against its plain version (softmax-only bit-exact, else 1e-2 of max|ref|;
grouped and pipelined also at their key tile, `tiled_tolerance`; the
attention calls against naive attention on two heads) and raises on a
mismatch. Needs the card. Wrappers take their plain versions for CPU
tensors only; `LAUNCHES` counts launches, `design_launches()` the C
launcher's counts.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import math
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from vggt_slam_tpu_torch.ops.attention import (LOG2E, flash_single,
                                               flash_single_ref,
                                               naive_attention)

BF16_PEAK_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
EX2_PER_SM_CLOCK = 16         # MUFU.EX2 results per SM per clock
HEAD_DIM = 64                 # the head dim the probe kernels are built for
# The grouped kernels' schedules, in the order of their C ids.
SCHEDULES = ("straight", "interleaved", "pipelined")
TILED_TOL = 2e-3              # against the plain version at the key tile

# Launches of each CUDA kernel in this process (plain-version calls are not
# counted). Read by chip_smoke.py to show the script ran the kernels.
LAUNCHES = {"matmul_only": 0, "softmax_only": 0, "grouped": 0,
            "pipelined": 0, "ex2_rate": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def roundup(x, m):
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _by_problem(fn, q, k, v, chunk=64):
    """fn over chunks of at most `chunk` problems of (..., Np, D) inputs,
    which bounds the (chunk, Np, Np) f32 intermediates."""
    qf, kf, vf = (t.reshape(-1, *t.shape[-2:]) for t in (q, k, v))
    out = torch.cat([fn(qf[i:i + chunk], kf[i:i + chunk], vf[i:i + chunk])
                     for i in range(0, qf.shape[0], chunk)])
    return out.reshape(q.shape)


def matmul_only_ref(q, k, v):
    """Plain version of `matmul_only`: o = bf16(q kᵀ) v with f32 products,
    cast to q's dtype."""
    def fn(q, k, v):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)).to(v.dtype)
        return torch.matmul(s.float(), v.float()).to(q.dtype)
    return _by_problem(fn, q, k, v)


def softmax_only_ref(q, k, v):
    """Plain version of `softmax_only`: the logits of row r are
    q[r, 0]·0.01 in f32 in each of the Np = k.shape[-2] columns; m = max,
    p = exp2(s - m), l = Σp, o = p[:, :D] / max(l, 1e-30) in q's dtype."""
    def fn(q, k, v):
        s = (q[..., :1].float() * 0.01).expand(-1, -1, k.shape[-2])
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        return (p[..., :q.shape[-1]] / l.clamp_min(1e-30)).to(q.dtype)
    return _by_problem(fn, q, k, v)


def exp2_attention_ref(q, k, v, l_keys=None, block_k=None):
    """Plain version of the grouped and pipelined probes: s = q kᵀ in f32 on
    pre-scaled q, m the row max over all keys (padded ones too), p = exp2(s -
    m), l the f32 sum of p, o = (bf16(p) v) / max(l, 1e-30). With `block_k`, m
    is the running max over key tiles as the kernels take it, so p rounds
    against the same max. `l_keys` sums l over the first l_keys keys only: a
    control the checks must reject."""
    def logits(q, k):
        return torch.matmul(q.float(), k.float().transpose(-1, -2))

    def fn(q, k, v):
        if block_k is None:
            s = logits(q, k)
            p = torch.exp2(s - s.amax(-1, keepdim=True))
            l = (p if l_keys is None else p[..., :l_keys]).sum(-1,
                                                               keepdim=True)
            o = torch.matmul(p.to(v.dtype).float(), v.float())
            return (o / l.clamp_min(1e-30)).to(q.dtype)
        shape = q.shape[:-1] + (1,)
        m = torch.full(shape, -1e30, device=q.device)
        l = torch.zeros(shape, device=q.device)
        acc = torch.zeros(q.shape, device=q.device)
        for j in range(0, k.shape[-2], block_k):
            s = logits(q, k[..., j:j + block_k, :])
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            a = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            n = block_k if l_keys is None else min(max(l_keys - j, 0),
                                                   block_k)
            l = a * l + p[..., :n].sum(-1, keepdim=True)
            acc = a * acc + torch.matmul(p.to(v.dtype).float(),
                                         v[..., j:j + block_k, :].float())
            m = m_new
        return (acc / l.clamp_min(1e-30)).to(q.dtype)
    return _by_problem(fn, q, k, v)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bench_matmul_only": ([_P] * 4 + [_I] * 3 + [_P], ctypes.c_int),
    "bench_softmax_only": ([_P, _P, _I, _I, _I, ctypes.c_float, _P],
                           ctypes.c_int),
    "bench_grouped": ([_P] * 4 + [_I] * 5 + [_P], ctypes.c_int),
    "bench_pipelined": ([_P] * 4 + [_I] * 4 + [_P], ctypes.c_int),
    "bench_ex2_rate": ([_P, _I, _I, _P], ctypes.c_int),
    "bench_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "bench_grouped_block_k": ([_I, _I], ctypes.c_int),
    "bench_attention_design_launches": (
        [ctypes.POINTER(ctypes.c_longlong)], None),
}


def kernel_library():
    """Build (if stale) and load csrc/bench_attention.cu."""
    from vggt_slam_tpu_torch.ops import cuda_build
    return cuda_build.load("bench_attention", _SIGNATURES)


def design_launches() -> dict:
    """The probes' launches by design from the C launcher: "tma_wgmma"
    (`grouped_sm90`) and "global_sm90" (the matmul-only floor)."""
    out = (ctypes.c_longlong * 2)()
    kernel_library().bench_attention_design_launches(out)
    return {"tma_wgmma": out[0], "global_sm90": out[1]}


def instance(variant):
    """(schedule, G) of a grouped, interleaved or pipelined variant's name
    ("grouped G=2" is the straight schedule), else None."""
    kind, _, G = variant.partition(" G=")
    if not G or kind not in ("grouped", "interleaved", "pipelined"):
        return None
    return ("straight" if kind == "grouped" else kind), int(G)


def block_k(schedule, G):
    """The key tile of the `grouped_sm90` instance of `schedule` and G, as
    its library reports it (on the card): the `block_k` of its plain
    version."""
    n = kernel_library().bench_grouped_block_k(G, SCHEDULES.index(schedule))
    if n <= 0:
        raise ValueError(f"no grouped kernel for {schedule} at G={G}")
    return n


def tiled_tolerance(ref):
    """TILED_TOL, or one bf16 step of |ref| where larger: both sides round o to
    bf16, so two right f32 values near a boundary end one step apart."""
    m, e = torch.frexp(ref.float())
    step = torch.where(m == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))
    return step.clamp_min(TILED_TOL)


def tiled_error(variant, args, out):
    """(max |out - ref|, that over `tiled_tolerance`, block_k) of a grouped or
    pipelined kernel against `exp2_attention_ref` at its own key tile; holds
    where the second is at most 1."""
    bk = block_k(*instance(variant))
    ref = exp2_attention_ref(*args, block_k=bk)
    diff = (out.float() - ref.float()).abs()
    return (float(diff.max()), float((diff / tiled_tolerance(ref)).max()),
            bk)


def _check_cuda(q, k, v, ndim, rows=64):
    if q.dim() != ndim or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v of one {ndim}-d shape expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the probe kernels take bf16 {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Np, D = q.shape[-2:]
    if D != HEAD_DIM or Np % rows:
        raise ValueError(f"the probe kernels take head dim {HEAD_DIM} and a "
                         f"multiple of {rows} rows, got {Np} x {D}")


def _launch(entry, device, *args, lib=None):
    """Launch the C entry point `entry` of `lib` (default: this script's
    library) on the device's current stream; raise on a nonzero code."""
    lib = lib or kernel_library()
    with torch.cuda.device(device):
        code = getattr(lib, entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.bench_error_string(code).decode()}")


def _require_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {q.device}")


def matmul_only(q, k, v, *, out=None):
    """Matmul-only probe on (BH, Np, D) bf16, Np a multiple of 128: CPU
    tensors take `matmul_only_ref`, CUDA tensors the CUDA kernel, written
    into `out` where given."""
    if q.device.type == "cpu":
        return matmul_only_ref(q, k, v)
    _require_cuda(q)
    _check_cuda(q, k, v, 3, rows=128)
    out = _output(q, out)
    _launch("bench_matmul_only", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), *q.shape)
    LAUNCHES["matmul_only"] += 1
    return out


def softmax_only(q, k, v):
    """Softmax-only probe on (BH, Np, D) bf16 (k and v give the shape
    only): CPU tensors take `softmax_only_ref`, CUDA tensors the CUDA
    kernel, whose z = 0 keeps each logit opaque to the compiler."""
    if q.device.type == "cpu":
        return softmax_only_ref(q, k, v)
    _require_cuda(q)
    _check_cuda(q, k, v, 3)
    out = torch.empty_like(q)
    _launch("bench_softmax_only", q.device, q.data_ptr(), out.data_ptr(),
            *q.shape, 0.0)
    LAUNCHES["softmax_only"] += 1
    return out


def _output(q, out):
    """A call's output: `out` where given, checked to be a contiguous
    tensor like q, else a new one."""
    if out is None:
        return torch.empty_like(q)
    if (out.shape != q.shape or out.dtype != q.dtype
            or out.device != q.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like q")
    return out


def _grouped_out(q, k, v, out):
    """Check a grouped call's arguments; its output (`out` where given)."""
    _require_cuda(q)
    _check_cuda(q, k, v, 4, rows=128)
    return _output(q, out)


def grouped_attention(q, k, v, *, interleave=False, out=None):
    """Grouped probe on (BH/G, G, Np, D) bf16: a work item takes a group's G
    problems one by one or, with `interleave`, all QKᵀ of a key tile first. CPU
    tensors take `exp2_attention_ref`, CUDA tensors the kernel, into `out`
    where given."""
    if q.device.type == "cpu":
        return exp2_attention_ref(q, k, v)
    out = _grouped_out(q, k, v, out)
    _launch("bench_grouped", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), q.shape[0] * q.shape[1],
            q.shape[2], q.shape[3], q.shape[1], int(bool(interleave)),
            lib=kernel_library())
    LAUNCHES["grouped"] += 1
    return out


def pipelined_attention(q, k, v, *, out=None):
    """Pipelined probe on (BH/G, G, Np, D) bf16: per key tile the QKᵀ of
    problem g + 1 is issued before the softmax and PV of problem g. CPU
    tensors take `exp2_attention_ref`, CUDA tensors the CUDA kernel,
    written into `out` where given."""
    if q.device.type == "cpu":
        return exp2_attention_ref(q, k, v)
    out = _grouped_out(q, k, v, out)
    _launch("bench_pipelined", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), q.shape[0] * q.shape[1],
            q.shape[2], q.shape[3], q.shape[1], lib=kernel_library())
    LAUNCHES["pipelined"] += 1
    return out


def sdpa(q, k, v):
    """The library yardstick: SDPA at scale ln 2, whose exp(ln 2·s) is
    exp2(s), on pre-scaled q computes `exp2_attention_ref`'s function. The
    port never calls it."""
    return F.scaled_dot_product_attention(q, k, v, scale=math.log(2.0))


# call: (kind, its LAUNCHES counter, its plain version)
_ROLE = {matmul_only: ("matmul", "matmul_only", matmul_only_ref),
         softmax_only: ("softmax", "softmax_only", softmax_only_ref),
         grouped_attention: ("attention", "grouped", exp2_attention_ref),
         pipelined_attention: ("attention", "pipelined", exp2_attention_ref),
         sdpa: ("library", None, exp2_attention_ref)}


# ---------------------------------------------------------------------------
# The reference's calls: padding, reshapes, pre-scale
# ---------------------------------------------------------------------------

class Probe:
    """One line: `prep` makes the call's arguments once (untimed), `run` is the
    timed call, `plain` its plain version, `unprep` slices back to (S, H, N,
    D), `kind` picks bound and tolerance, `counter` names its LAUNCHES
    entry."""

    def __init__(self, kind, counter, prep, run, plain, unprep):
        self.kind, self.counter, self.prep, self.run = kind, counter, prep, run
        self.plain, self.unprep = plain, unprep

    def __call__(self, q, k, v):
        return self.unprep(self.run(*self.prep(q, k, v)), q.shape)


def _pad_rows(t, BH, N, D, Np):
    t = t.reshape(BH, N, D)
    return F.pad(t, (0, 0, 0, Np - N)) if Np > N else t.contiguous()


def make_flat_call(kernel, N, D, BH, extra=()):
    """One problem per (BH, Np, D) row block, the production layout: the
    inputs padded to Np = roundup(N, 128) rows with zeros, the output
    sliced back to N."""
    Np = roundup(N, 128)

    def prep(q, k, v):
        return tuple(_pad_rows(t, BH, N, D, Np) for t in (q, k, v))

    def unprep(out, shape):
        return out[:, :N].reshape(shape)

    kind, counter, plain = _ROLE[kernel]
    return Probe(kind, counter, prep,
                 functools.partial(kernel, **dict(extra)), plain, unprep)


def make_grouped_call(kernel, G, N, D, BH, extra=()):
    """As `make_flat_call`, with the padded problems grouped G at a time
    into (BH/G, G, Np, D)."""
    Np = roundup(N, 128)

    def prep(q, k, v):
        return tuple(_pad_rows(t, BH, N, D, Np).reshape(BH // G, G, Np, D)
                     for t in (q, k, v))

    def unprep(out, shape):
        return out.reshape(BH, Np, D)[:, :N].reshape(shape)

    kind, counter, plain = _ROLE[kernel]
    return Probe(kind, counter, prep,
                 functools.partial(kernel, **dict(extra)), plain, unprep)


def scaled(probe, D):
    """q pre-scaled by log2(e)/sqrt(D) in f32 and rounded back to its
    dtype before the call, as the reference's `scaled`."""
    c_scale = LOG2E / math.sqrt(D)

    def prep(q, k, v):
        return probe.prep((q.float() * c_scale).to(q.dtype), k, v)

    return Probe(probe.kind, probe.counter, prep, probe.run, probe.plain,
                 probe.unprep)


def production(H):
    """The port's `flash_single` on the inputs packed once into its
    (S, N, H·D) layout, unpadded (it takes ragged N itself)."""
    def prep(q, k, v):
        return tuple(t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)
                     .contiguous() for t in (q, k, v))

    def unprep(out, shape):
        S, H_, N, D = shape
        return out.view(S, N, H_, D).transpose(1, 2)

    return Probe("production", None, prep,
                 functools.partial(flash_single, num_heads=H),
                 functools.partial(flash_single_ref, num_heads=H), unprep)


def make_variants(S, H, N, D):
    """The reference's variants by name, plus SDPA."""
    BH = S * H
    variants = {
        "production flash_attention": production(H),
        "matmul-only floor": make_flat_call(matmul_only, N, D, BH),
        "softmax-only floor": make_flat_call(softmax_only, N, D, BH),
    }
    for G in (2, 4, 8):
        if BH % G:
            continue
        variants[f"grouped G={G}"] = scaled(make_grouped_call(
            grouped_attention, G, N, D, BH, extra=(("interleave", False),)),
            D)
        variants[f"interleaved G={G}"] = scaled(make_grouped_call(
            grouped_attention, G, N, D, BH, extra=(("interleave", True),)), D)
        variants[f"pipelined G={G}"] = scaled(make_grouped_call(
            pipelined_attention, G, N, D, BH), D)
    variants["SDPA (library)"] = scaled(make_grouped_call(sdpa, H, N, D, BH),
                                        D)
    return variants


def make_inputs(S, H, N, D, seed=0, device="cpu"):
    """q, k, v (S, H, N, D) bf16 from a seeded numpy normal, in the
    reference's order."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(S, H, N, D))
                                  .astype(np.float32)).to(device)
                 .to(torch.bfloat16) for _ in range(3))


def probe_error(kind, out, ref):
    """(max |out - ref|, tolerance): softmax-only bit-exact, else 1e-2 of
    max|ref| (another f32 order can flip a bf16 rounding of s or p)."""
    diff = float((out.float() - ref.float()).abs().max())
    tol = 0.0 if kind == "softmax" else 1e-2 * float(ref.float().abs().max())
    return diff, tol


# ---------------------------------------------------------------------------
# Bounds and timing
# ---------------------------------------------------------------------------

def bound_ms(kind, BH, n, D, ex2_rate):
    """Least card time of one call on BH problems of n keys: (ms, "operations"
    or "bytes"): 4·BH·n²·D flops at the bf16 peak, BH·n² exp2 at `ex2_rate`, or
    both (attention), against each input read and the output written once
    (softmax-only reads only q)."""
    tensor = 4.0 * BH * n * n * D / BF16_PEAK_FLOPS * 1e3
    sfu = BH * n * n / ex2_rate * 1e3
    ops = {"matmul": tensor, "softmax": sfu}.get(kind, max(tensor, sfu))
    nbytes = (2 if kind == "softmax" else 4) * 2.0 * BH * n * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= t_bytes else (t_bytes, "bytes")


def sfu_rate(device):
    """The card's MUFU.EX2 rate derived from its SM count and its maximum SM
    clock (nvidia-smi clocks.max.sm) at 16 per SM per clock:
    (exp2 per second, derivation)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi gave no SM clock: {out.stderr}")
    mhz = float(out.stdout.split()[0])
    return (sms * EX2_PER_SM_CLOCK * mhz * 1e6,
            f"{sms} SMs x {EX2_PER_SM_CLOCK} x {mhz:.0f} MHz")


def bench(fn, args, iters, reps=3):
    """Best of `reps` mean device times (ms) of fn(*args) over `iters`
    launches, CUDA events, after one warm-up call."""
    fn(*args)
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def graph_bench(fn, arg_sets, iters, reps=3, replayed=None):
    """Best of `reps` mean device ms of fn(*args) over one CUDA graph of at
    least `iters` calls cycling through `arg_sets`; `replayed(n)` hears of each
    replay's n calls."""
    n = len(arg_sets) * -(-iters // len(arg_sets))
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    best = math.inf
    for rep in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        if replayed:
            replayed(n)
        if rep:
            best = min(best, start.elapsed_time(end) / n)
    return best


def ex2_rate(device, iters=4096):
    """The card's measured MUFU.EX2 rate (exp2/s): 8 CTAs of 256 threads per
    SM, 8 chains x <- 2^-x a thread (a calibration kernel), CUDA events; every
    output must be 8 times the fixed point."""
    if device.type != "cuda":
        raise ValueError(f"ex2_rate measures a card, not {device}")
    blocks = 8 * torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.empty(blocks * 256, device=device)

    def launch():
        _launch("bench_ex2_rate", device, out.data_ptr(), blocks, iters)
        LAUNCHES["ex2_rate"] += 1

    ms = bench(launch, (), 2)
    x = 0.5
    for _ in range(100):
        x = 2.0 ** -x
    err = float((out - 8 * x).abs().max())
    if not err < 1e-4:
        raise AssertionError(f"ex2 chains end {err} away from 8 x {x}")
    return blocks * 256 * 8 * iters / (ms * 1e-3)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

parser = argparse.ArgumentParser(
    description="Frame-attention probes on the card (matmul-only and "
                "softmax-only floors, grouped and pipelined schedules) "
                "beside flash_single and SDPA.")
parser.add_argument("--iters", type=int, default=20)
parser.add_argument("--frames", type=int, default=33)
parser.add_argument("--heads", type=int, default=16)
parser.add_argument("--tokens", type=int, default=1041)
parser.add_argument("--dim", type=int, default=64)
parser.add_argument("--check", action="store_true",
                    help="hold every call against its plain version and the "
                         "attention calls against naive attention first")


def check(variants, q, k, v):
    """--check: every call against its plain version, the grouped and pipelined
    kernels also at their key tile (`tiled_error`), the attention calls against
    naive attention on two heads. Returns {name: (max err, tolerance)}; raises
    on a mismatch."""
    ref = naive_attention(*(t[:1, :2].float() for t in (q, k, v)))
    errors = {}
    for name, p in variants.items():
        args = p.prep(q, k, v)
        out = p.run(*args)
        err, tol = probe_error(p.kind, out, p.plain(*args))
        line = (f"  check {name}: max|err|={err:.3g} against plain "
                f"(tol {tol:.3g})")
        ok = err <= tol
        if instance(name) and out.device.type == "cuda":
            terr, share, bk = tiled_error(name, args, out)
            line += (f", {terr:.3g} at block_k {bk} ({share:.3g} of "
                     f"tiled_tolerance)")
            ok = ok and share <= 1
        if p.kind not in ("matmul", "softmax"):
            e2 = float((p.unprep(out, q.shape)[:1, :2].float() - ref)
                       .abs().max())
            line += f", {e2:.4f} against naive attention (tol 0.05)"
            ok = ok and e2 < 0.05
        print(line, flush=True)
        if not ok:
            raise AssertionError(f"{name}: {line.strip()}")
        errors[name] = (err, tol)
    return errors


def main(argv=None):
    """Run the benchmark on the card. Returns the exp2 rates and one dict
    per line (with the check's error and tolerance under --check)."""
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes run on the card")
    device = torch.device("cuda", torch.cuda.current_device())
    S, H, N, D = args.frames, args.heads, args.tokens, args.dim
    BH, Np = S * H, roundup(N, 128)
    q, k, v = make_inputs(S, H, N, D, device=device)
    flops = 4 * BH * Np ** 2 * D
    variants = make_variants(S, H, N, D)
    errors = check(variants, q, k, v) if args.check else {}
    print(f"shape: BH={BH} N={N} (Np={Np}) D={D}; {flops / 1e9:.1f} "
          f"GFLOP/call", flush=True)
    rate, how = sfu_rate(device)
    measured = ex2_rate(device)
    print(f"exp2 rate: {rate / 1e12:.3f} T/s derived ({how}), "
          f"{measured / 1e12:.3f} T/s measured (ex2.approx chains)",
          flush=True)
    lines = []
    for name, p in variants.items():
        call_args = p.prep(q, k, v)
        ms = bench(p.run, call_args, args.iters)
        plain_ms = bench(p.plain, call_args, 1)
        bound, by = bound_ms(p.kind, BH, N if p.kind == "production" else Np,
                             D, rate)
        print(f"{name:32s} {ms:7.3f} ms {flops / ms / 1e9:7.1f} TF/s   "
              f"bound {bound:.4f} ms ({by}), {100 * bound / ms:5.1f}% of it; "
              f"plain {plain_ms:.3f} ms", flush=True)
        line = dict(variant=name, kind=p.kind, kernel=p.counter, ms=ms,
                    plain_ms=plain_ms, tflops=flops / ms / 1e9,
                    bound_ms=bound, bound_by=by, pct_of_bound=100 * bound / ms)
        if name in errors:
            line["max_abs_err"], line["tol"] = errors[name]
        lines.append(line)
        del call_args
    return dict(ex2_rate_derived=rate, ex2_derivation=how,
                ex2_rate_measured=measured, lines=lines)


if __name__ == "__main__":
    main()
