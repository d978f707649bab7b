"""The CUDA kernels against their plain versions, on the card.

Marked `gpu`; without a CUDA device each test skips (decided inside the
fixture, never at import). On the card:
    python -m pytest --noconftest tests/test_torch_gpu.py
bf16 outputs 2e-2: the output's rounding (2^-9 relative) and the bf16
softmax weights before PV. f32 row stats 1e-3 relative (the same bf16
products summed in another order); 1e-2 where the kernel applies
qk-LayerNorm itself (its approximate rsqrt can flip one bf16 rounding of a
prepared element, 2^-8, and move l by ~1e-3). Gradients 2e-2 of the
largest reference entry (dL rounded to bf16 before its products; a
slightly different p flips roundings), plus 1e-5 absolute in the edge
cases (with one key the exact dq, dk are 0); dq's f32 atomic adds vary in
order, so two runs are held to 2^-7 of its largest entry. int8: both sides
share the scales and exact s32 logits, so stats 1e-4 relative and outputs
1e-2 of their largest entry (one bf16 ulp is at most 2^-7 of it); the bf16
path's row sums must lie ten times 1e-4 away, which tells int8 QK^T from
bf16. The DPT tail 1e-2 of its largest output (u, h rounded to bf16 on
both sides, the 3x3 sums in another order), written into NaN-filled
tensors; the output with frames 0 and 1 swapped must fail. CLIP's vision
tower and SigLIP's towers (flash_single on bf16 q, k, v in an f32 module)
2e-2 (L2) of their plain routes on unit features, SALAD's bound. SAM2 in
f32 within chip_smoke.SAM2_TOL of float64. voxelize_device sums by atomic
adds: means within ops/voxel.mean_tolerance, centres and counts exact.
"""
import functools
import math

import numpy as np
import pytest
import torch

from vggt_slam_tpu_torch.ops import attention as A
from vggt_slam_tpu_torch.ops import dpt_tail as T
from vggt_slam_tpu_torch.scripts import bench_attention as BA
from vggt_slam_tpu_torch.scripts import bench_global_attention as GA
from vggt_slam_tpu_torch.scripts import bench_int8_inkernel as IK
from vggt_slam_tpu_torch.scripts import bench_matmul_shapes as MM
from vggt_slam_tpu_torch.scripts import bench_softmax_variants as SV

pytestmark = pytest.mark.gpu
TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(device, B, H, Nq, Nk, D, rope, ln, bias, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*s):
        return torch.randn(s, generator=g, device=device)

    q, k, v = (rnd(B, n, H * D).bfloat16() for n in (Nq, Nk, Nk))
    kw = dict(num_heads=H)
    if rope:
        kw["rope_q"] = (rnd(Nq, D // 2).cos(), rnd(Nq, D // 2).sin())
        kw["rope_k"] = (rnd(Nk, D // 2).cos(), rnd(Nk, D // 2).sin())
    if ln:
        kw["qk_ln"] = tuple(1.0 + 0.1 * rnd(D) if i % 2 == 0 else 0.05 * rnd(D)
                            for i in range(4))
    if bias:
        kw["kv_bias"] = torch.log(torch.randint(1, 20, (Nk,), generator=g,
                                                device=device).float())
    return q, k, v, kw


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("variant", ["plain", "rope_ln", "bias_valid_len"])
def test_flash_single_matches_plain(cuda, variant, D):
    q, k, v, kw = _case(cuda, 2, 4, 300, 300, D, rope=variant == "rope_ln",
                        ln=variant == "rope_ln",
                        bias=variant == "bias_valid_len")
    if variant == "bias_valid_len":
        kw["valid_len"] = 211
    before = A.LAUNCHES["flash_single"]
    out = A.flash_single(q, k, v, **kw)
    torch.cuda.synchronize()
    assert A.LAUNCHES["flash_single"] == before + 1
    ref = A.flash_single_ref(q, k, v, **kw)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_multi_matches_plain(cuda, D):
    q, k, v, kw = _case(cuda, 1, 4, 700, 500, D, rope=True, ln=True,
                        bias=True)
    kw["valid_len"] = 437
    smax = A.static_bound(q, k, 4, qk_ln=kw["qk_ln"], kv_bias=kw["kv_bias"])
    before = A.LAUNCHES["flash_multi"]
    out = A.flash_multi(q, k, v, smax, **kw)
    torch.cuda.synchronize()
    assert A.LAUNCHES["flash_multi"] == before + 1
    ref = A.flash_multi_ref(q, k, v, smax, **kw)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=TOL, rtol=0)


def _close(out, ref, tol):
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=tol, rtol=0)


def _stats_close(out, ref, rtol=1e-3):
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("variant", ["single", "single_valid_len",
                                     "multi_static"])
def test_forward_stats_match_plain(cuda, variant, D):
    Nk = 2500 if variant == "multi_static" else 300
    q, k, v, kw = _case(cuda, 1, 4, 260, Nk, D, rope=False, ln=False,
                        bias=False, seed=3)
    if variant == "single_valid_len":
        kw["valid_len"] = 201
    if variant == "multi_static":
        smax = A.static_bound(q, k, 4)
        out, m, l = A.flash_multi(q, k, v, smax, return_stats=True, **kw)
        ref = A.flash_multi_ref(q, k, v, smax, return_stats=True, **kw)
    else:
        out, m, l = A.flash_single(q, k, v, return_stats=True, **kw)
        ref = A.flash_single_ref(q, k, v, return_stats=True, **kw)
    torch.cuda.synchronize()
    assert m.shape == l.shape == (1, 4, 260)
    _close(out, ref[0], TOL)
    _stats_close(m, ref[1])
    _stats_close(l, ref[2])


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("variant", ["single", "valid_len", "multi_static"])
def test_backward_kernels_match_plain(cuda, variant, D):
    N = 2500 if variant == "multi_static" else 300
    q, k, v, kw = _case(cuda, 2, 2, N, N, D, rope=False, ln=False,
                        bias=False, seed=4)
    softmax = "static" if variant == "multi_static" else "online"
    vl = 211 if variant == "valid_len" else None
    out, m, l = A.flash_attention(q, k, v, num_heads=2, valid_len=vl,
                                  softmax=softmax, return_stats=True)
    g = torch.Generator(device=cuda).manual_seed(5)
    dout = torch.randn(q.shape, generator=g, device=cuda).bfloat16()
    before = dict(A.LAUNCHES)
    dq, dk, dv = A.flash_bwd(q, k, v, dout, out, m, l, num_heads=2,
                             valid_len=vl)
    torch.cuda.synchronize()
    assert A.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert A.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    refs = A.flash_bwd_ref(q, k, v, dout, m, l, A.bwd_delta(dout, out, 2),
                           num_heads=2, valid_len=vl)
    for got, ref in zip((dq, dk, dv), refs):
        assert torch.isfinite(got).all()
        _close(got, ref, 2e-2 * float(ref.float().abs().max()))
    if vl is not None:
        assert float(dk[:, vl:].float().abs().max()) == 0.0
        assert float(dv[:, vl:].float().abs().max()) == 0.0


def test_flash_attention_grad_launches_the_kernels(cuda):
    q, k, v, kw = _case(cuda, 1, 2, 200, 200, 64, rope=False, ln=False,
                        bias=False, seed=6)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(A.LAUNCHES)
    out = A.attention(q, k, v, impl="flash_grad", num_heads=2)
    out.float().sin().sum().backward()
    torch.cuda.synchronize()
    for name in ("flash_single", "flash_bwd_dq", "flash_bwd_dkv"):
        assert A.LAUNCHES[name] == before[name] + 1   # one flash_bwd call
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


# The backward runs csrc/flash_bwd_sm90.cuh at every head dim (128-key
# tiles a CTA, 64-row q tiles by TMA from 4-D maps, two 64-column panels a
# row at D = 128, K and V maps that end at valid_len, dq summed by bulk f32
# reduce-adds): sequence, valid_len, batch and head edges, each case
# written twice into NaN-filled dq, dk, dv (a missed store fails), against
# the plain version at the tolerances above.
def _bwd_case(device, B, H, Nq, Nk, D, vl, seed):
    q, k, v, _ = _case(device, B, H, Nq, Nk, D, rope=False, ln=False,
                       bias=False, seed=seed)
    out, m, l = A.flash_single(q, k, v, num_heads=H, valid_len=vl,
                               return_stats=True)
    g = torch.Generator(device=device).manual_seed(seed + 100)
    dout = torch.randn(q.shape, generator=g, device=device).bfloat16()
    return q, k, v, dout, out, m, l


def _bwd_check(args, H, vl):
    q, k, v, dout, out, m, l = args
    refs = A.flash_bwd_ref(q, k, v, dout, m, l, A.bwd_delta(dout, out, H),
                           num_heads=H, valid_len=vl)
    dqs = []
    for _ in range(2):
        outs = tuple(torch.full_like(t, math.nan) for t in (q, k, v))
        A._launch_bwd(q, k, v, dout, out, m, l, H, vl, outs)
        torch.cuda.synchronize()
        for name, got, ref in zip(("dq", "dk", "dv"), outs, refs):
            assert bool(torch.isfinite(got).all()), name
            _close(got, ref, max(2e-2 * float(ref.float().abs().max()),
                                 1e-5))
        if vl is not None:
            assert not outs[1][:, vl:].any() and not outs[2][:, vl:].any()
        dqs.append(outs[0].float())
    spread = float((dqs[0] - dqs[1]).abs().max())
    assert spread <= 2 ** -7 * float(dqs[0].abs().max()), spread


@pytest.mark.parametrize("D", [32, 64, 128])
def test_bwd_design_launches_count_each_call(cuda, D):
    """One flash_bwd call adds one to the C launcher's count of its design
    (flash_bwd_sm90.cuh at every head dim)."""
    args = _bwd_case(cuda, 1, 2, 200, 200, D, None, seed=20)
    want = "tma_wgmma"
    before = A.bwd_design_launches()
    A.flash_bwd(*args, num_heads=2)
    torch.cuda.synchronize()
    after = A.bwd_design_launches()
    assert {d: after[d] - before[d] for d in after} == {
        d: int(d == want) for d in after}


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 63, 65, 127, 129, 300, 1041, 2500])
def test_bwd_sequence_edges(cuda, n, D):
    _bwd_check(_bwd_case(cuda, 1, 2, n, n, D, None, seed=21), 2, None)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("vl", [0, 1, 127, 128, 129, 300])
def test_bwd_valid_len_edges(cuda, vl, D):
    _bwd_check(_bwd_case(cuda, 1, 2, 300, 300, D, vl, seed=22), 2, vl)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("H", [2, 16])
def test_bwd_batch_and_head_edges(cuda, H, D):
    _bwd_check(_bwd_case(cuda, 2, H, 300, 300, D, 211, seed=23), H, 211)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("nq,nk,vl", [(200, 500, 437), (700, 130, None)])
def test_bwd_nq_not_nk(cuda, nq, nk, vl, D):
    _bwd_check(_bwd_case(cuda, 2, 2, nq, nk, D, vl, seed=24), 2, vl)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_bwd_repeated_runs_agree(cuda, D):
    """Sixty calls at the small global shape (one wave): dk, dv bit-equal call
    to call, dq within the atomics' spread, each within tolerance of the plain
    version; a fault in the order of the CTA's shared buffers across q tiles
    shows as a call that disagrees."""
    H, vl = 4, None
    args = _bwd_case(cuda, 1, H, 4164, 4164, D, vl, seed=25)
    q, k, v, dout, out, m, l = args
    refs = A.flash_bwd_ref(q, k, v, dout, m, l, A.bwd_delta(dout, out, H),
                           num_heads=H, valid_len=vl)
    first = None
    for _ in range(60):
        got = A.flash_bwd(*args, num_heads=H, valid_len=vl)
        torch.cuda.synchronize()
        for name, g_, ref in zip(("dq", "dk", "dv"), got, refs):
            _close(g_, ref, 2e-2 * float(ref.float().abs().max()))
        if first is None:
            first = got
            continue
        assert torch.equal(got[1], first[1]) and torch.equal(got[2], first[2])
        spread = float((got[0].float() - first[0].float()).abs().max())
        assert spread <= 2 ** -7 * float(first[0].float().abs().max())


def test_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 16, 96, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        A.flash_single(q, q, q, num_heads=2)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        A.flash_single(qb, qb, qb, num_heads=4)      # head dim 24


# The Hopper design of the bf16 forward at every head dim
# (csrc/flash_sm90.cuh: 128-row q tiles, 128-key K/V tiles by TMA from 4-D
# maps that end at valid_len; 64-byte rows and swizzle at D = 32, 128-byte
# at D = 64, two 128-byte panels a row at D = 128): its tile edges, batch
# edges and masked rows, each written into a NaN-filled output so that a
# missed store fails, against the plain version at the tolerances above.
SM90_DIMS = [32, 64, 128]


def test_bf16_forward_route_by_head_dim(cuda):
    """bf16 at every head dim launches flash_fwd_sm90<D, ...>
    (flash_attention.cu launch_dim): the three calls under one profiler,
    each launched once before it."""
    from torch.profiler import ProfilerActivity, profile

    cases = [(D, _case(cuda, 1, 2, 200, 200, D, rope=False, ln=False,
                       bias=False, seed=10)) for D in (32, 64, 128)]
    for _, (q, k, v, kw) in cases:
        A.flash_single(q, k, v, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _, (q, k, v, kw) in cases:
            A.flash_single(q, k, v, **kw)
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    for D, _ in cases:
        assert f"flash_fwd_sm90<{D}," in names, (D, names[:800])


@pytest.mark.parametrize("D", [32, 64, 128])
def test_forward_design_launches_count_each_launch(cuda, D):
    """One bf16 forward adds one to the C launcher's count of its design
    (flash_sm90.cuh at every head dim)."""
    q, k, v, kw = _case(cuda, 1, 2, 200, 200, D, rope=False, ln=False,
                        bias=False, seed=11)
    want = "tma_wgmma"
    before = A.forward_design_launches()
    A.flash_single(q, k, v, **kw)
    torch.cuda.synchronize()
    after = A.forward_design_launches()
    assert {d: after[d] - before[d] for d in after} == {
        d: int(d == want) for d in after}


def _sm90_check(q, k, v, kw, softmax, stats=True):
    """Launch the flash_sm90.cuh route into a NaN-filled output and hold out
    (and the row stats) against the plain version; return the output."""
    H, static = kw["num_heads"], softmax == "static"
    smax = A.static_bound(q, k, H, qk_ln=kw.get("qk_ln"),
                          kv_bias=kw.get("kv_bias")) if static else None
    args = (q, k, v, H, kw.get("valid_len"), kw.get("rope_q"),
            kw.get("rope_k"), kw.get("kv_bias"), kw.get("qk_ln"), 1e-5, smax,
            stats)
    out = torch.full_like(q, math.nan)
    got = A._launch("flash_multi_fwd" if static else "flash_single_fwd",
                    *args, False, out=out)
    torch.cuda.synchronize()
    ref = A._plain(*args)
    got_out = got[0] if stats else got
    assert got_out is out and bool(torch.isfinite(out).all())
    _close(out, ref[0] if stats else ref, TOL)
    if stats:
        assert bool(torch.isfinite(got[1]).all() & torch.isfinite(got[2]).all())
        rtol = 1e-3 if kw.get("qk_ln") is None else 1e-2
        _stats_close(got[1], ref[1], rtol)
        _stats_close(got[2], ref[2], rtol)
    return out


@pytest.mark.parametrize("D", SM90_DIMS)
@pytest.mark.parametrize("softmax", ["online", "static"])
@pytest.mark.parametrize("nq", [1, 127, 128, 129, 1041])
def test_sm90_q_tile_edges(cuda, nq, softmax, D):
    q, k, v, kw = _case(cuda, 2, 2, nq, 300, D, rope=True, ln=True,
                        bias=True, seed=11)
    _sm90_check(q, k, v, kw, softmax)


@pytest.mark.parametrize("D", SM90_DIMS)
@pytest.mark.parametrize("softmax", ["online", "static"])
@pytest.mark.parametrize("vl", [0, 1, 127, 128, 129, 2161])
def test_sm90_valid_len_edges(cuda, vl, softmax, D):
    nk = 2231 if vl == 2161 else 300
    q, k, v, kw = _case(cuda, 1, 2, 200, nk, D, rope=True, ln=True,
                        bias=True, seed=12)
    kw["valid_len"] = vl
    _sm90_check(q, k, v, kw, softmax)


@pytest.mark.parametrize("D", SM90_DIMS)
@pytest.mark.parametrize("softmax", ["online", "static"])
@pytest.mark.parametrize("variant", ["plain", "rope_ln", "bias_valid_len",
                                     "rope_ln_bias_valid_len"])
def test_sm90_variants_with_and_without_stats(cuda, variant, softmax, D):
    q, k, v, kw = _case(cuda, 2, 4, 300, 500, D, rope="rope" in variant,
                        ln="ln" in variant, bias="bias" in variant, seed=13)
    if "valid_len" in variant:
        kw["valid_len"] = 437
    for stats in (True, False):
        _sm90_check(q, k, v, kw, softmax, stats)


@pytest.mark.parametrize("D", SM90_DIMS)
@pytest.mark.parametrize("fill", [1e4, math.inf])
def test_sm90_batches_do_not_mix(cuda, fill, D):
    """B = 4 at N = 1041: batch 1's k and v filled with `fill` leave the other
    batches' outputs bit-equal (a map over B * N rows would read batch 1 into
    batch 0's last key tile)."""
    q, k, v, kw = _case(cuda, 4, 16, 1041, 1041, D, rope=True, ln=True,
                        bias=False, seed=14)
    clean = _sm90_check(q, k, v, kw, "online", stats=False)
    k2, v2 = k.clone(), v.clone()
    k2[1] = fill
    v2[1] = fill
    out = A.flash_single(q, k2, v2, **kw)
    torch.cuda.synchronize()
    for b in (0, 2, 3):
        assert torch.equal(out[b], clean[b])


@pytest.mark.parametrize("D", SM90_DIMS)
@pytest.mark.parametrize("softmax", ["online", "static"])
def test_sm90_inf_past_valid_len_gives_finite_output(cuda, softmax, D):
    q, k, v, kw = _case(cuda, 1, 4, 300, 400, D, rope=False, ln=False,
                        bias=True, seed=15)
    kw["valid_len"] = 257
    v[:, 257:] = math.inf
    _sm90_check(q, k, v, kw, softmax)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("variant", ["single", "multi", "multi_no_rope"])
def test_int8_kernels_match_plain(cuda, variant, D):
    q, k, v, kw = _case(cuda, 1, 4, 700, 500, D, rope=variant != "multi_no_rope",
                        ln=False, bias=True, seed=7)
    kw.update(valid_len=437, return_stats=True)
    name = "flash_single_i8" if variant == "single" else "flash_multi_i8"
    if variant == "single":
        kern, plain = A.flash_single, A.flash_single_ref
    else:
        smax = A.static_bound(q, k, 4, kv_bias=kw["kv_bias"])
        kern, plain = (functools.partial(f, smax=smax)
                       for f in (A.flash_multi, A.flash_multi_ref))
    before = dict(A.LAUNCHES)
    out, m, l = kern(q, k, v, qk_int8=True, **kw)
    torch.cuda.synchronize()
    assert A.LAUNCHES[name] == before[name] + 1
    assert all(A.LAUNCHES[n] == before[n] for n in before if n != name)
    ref = plain(q, k, v, qk_int8=True, **kw)
    _close(out, ref[0], 1e-2 * float(ref[0].float().abs().max()))
    np.testing.assert_allclose(m.cpu().numpy(), ref[1].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(l.cpu().numpy(), ref[2].cpu().numpy(),
                               rtol=1e-4, atol=0)
    bf16_l = plain(q, k, v, qk_int8=False, **kw)[2]
    assert float(((l - bf16_l).abs() / bf16_l).max()) > 1e-3


# The int8 route at every head dim (flash_fwd_sm90 with int8 Q and K
# tiles, s8 wgmma; q and k quantized by the call's pre-pass, whose scales
# must equal int8_scales bit for bit): its tile, mask and batch edges,
# each written into a NaN-filled output and held to the plain version at
# the int8 tolerances above.
def _i8_check(q, k, v, kw, softmax, stats=True):
    H, static = kw["num_heads"], softmax == "static"
    smax = A.static_bound(q, k, H, kv_bias=kw.get("kv_bias")) \
        if static else None
    args = (q, k, v, H, kw.get("valid_len"), kw.get("rope_q"),
            kw.get("rope_k"), kw.get("kv_bias"), None, 1e-5, smax, stats)
    out = torch.full_like(q, math.nan)
    got = A._launch("flash_multi_i8_fwd" if static else "flash_single_i8_fwd",
                    *args, True, out=out)
    torch.cuda.synchronize()
    ref = A._plain(*args, qk_int8=True)
    ref_out = ref[0] if stats else ref
    assert bool(torch.isfinite(out).all())
    _close(out, ref_out, 1e-2 * float(ref_out.float().abs().max()))
    if stats:
        np.testing.assert_allclose(got[1].cpu().numpy(), ref[1].cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[2].cpu().numpy(), ref[2].cpu().numpy(),
                                   rtol=1e-4, atol=0)
    return got


@pytest.mark.parametrize("D", SM90_DIMS)
@pytest.mark.parametrize("softmax", ["online", "static"])
@pytest.mark.parametrize("nq", [1, 127, 128, 129, 700])
def test_int8_q_tile_edges(cuda, nq, softmax, D):
    q, k, v, kw = _case(cuda, 2, 2, nq, 300, D, rope=True, ln=False,
                        bias=True, seed=21)
    _i8_check(q, k, v, kw, softmax)


@pytest.mark.parametrize("D", SM90_DIMS)
@pytest.mark.parametrize("softmax", ["online", "static"])
@pytest.mark.parametrize("vl", [0, 1, 127, 128, 129, "Nk"])
def test_int8_valid_len_edges(cuda, vl, softmax, D):
    nk = 2231 if vl == "Nk" else 300
    q, k, v, kw = _case(cuda, 1, 2, 200, nk, D, rope=True, ln=False,
                        bias=True, seed=22)
    kw["valid_len"] = nk if vl == "Nk" else vl
    _i8_check(q, k, v, kw, softmax)


@pytest.mark.parametrize("D", SM90_DIMS)
@pytest.mark.parametrize("fill", [1e4, math.inf])
def test_int8_batches_do_not_mix(cuda, fill, D):
    """B = 4 at N = 1041: batch 1's k and v filled with `fill` leave the
    other batches' outputs bit-equal (its scales, maps and tiles are its
    own)."""
    q, k, v, kw = _case(cuda, 4, 16, 1041, 1041, D, rope=True, ln=False,
                        bias=False, seed=23)
    clean = _i8_check(q, k, v, kw, "online", stats=False)
    k2, v2 = k.clone(), v.clone()
    k2[1] = fill
    v2[1] = fill
    out = A.flash_single(q, k2, v2, qk_int8=True, **kw)
    torch.cuda.synchronize()
    for b in (0, 2, 3):
        assert torch.equal(out[b], clean[b])


@pytest.mark.parametrize("D", SM90_DIMS)
@pytest.mark.parametrize("softmax", ["online", "static"])
def test_int8_inf_past_valid_len_gives_finite_output(cuda, softmax, D):
    q, k, v, kw = _case(cuda, 1, 4, 300, 400, D, rope=False, ln=False,
                        bias=True, seed=24)
    kw["valid_len"] = 257
    v[:, 257:] = math.inf
    _i8_check(q, k, v, kw, softmax)


@pytest.mark.parametrize("D", SM90_DIMS)
@pytest.mark.parametrize("softmax", ["online", "static"])
def test_int8_repeated_runs_are_bit_equal(cuda, softmax, D):
    """Each output row has one CTA and no atomics: two runs agree bit for
    bit (out, m and l)."""
    q, k, v, kw = _case(cuda, 2, 4, 700, 1300, D, rope=True, ln=False,
                        bias=True, seed=25)
    kw["valid_len"] = 1111
    first, second = (_i8_check(q, k, v, kw, softmax) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("D", [32, 64, 128])
def test_int8_design_launches_count_each_launch(cuda, D):
    """One int8 forward adds one to the C launcher's count of its design
    (flash_sm90.cuh at every head dim)."""
    q, k, v, kw = _case(cuda, 1, 2, 200, 300, D, rope=True, ln=False,
                        bias=False, seed=26)
    want = "tma_wgmma"
    before = A.forward_design_launches()
    A.flash_single(q, k, v, qk_int8=True, **kw)
    torch.cuda.synchronize()
    after = A.forward_design_launches()
    assert {d: after[d] - before[d] for d in after} == {
        d: int(d == want) for d in after}


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("rope", [True, False])
def test_int8_scales_kernel_equals_plain(cuda, rope, D):
    """The pre-pass's scales torch.equal int8_scales: two batches 10x
    apart, 5000 and 700 rows (several row blocks), one head of q and one of
    k all zeros (the 1e-6 clamp)."""
    q, k, _, _ = _case(cuda, 2, 4, 5000, 700, D, rope=False, ln=False,
                       bias=False, seed=27)
    q[1] *= 10
    q.view(2, 5000, 4, D)[:, :, 1] = 0
    k.view(2, 700, 4, D)[:, :, 3] = 0
    got = A.int8_scales_cuda(q, k, 4, rope)
    want = A.int8_scales(q, k, 4, rope)
    assert float((127.0 / want[0].view(2, 4)[:, 1]).max()) == \
        pytest.approx(1e-6)
    assert torch.equal(got, want), (got - want).abs().max()


# The camera trunk's calls (head dim 128, 16 heads, a few tokens, one key
# tile): bf16 and int8, both softmax modes, with and without row stats,
# batch 2, and the backward, at the SLAM shape (18 tokens, valid_len 13
# and none) and the training shape (4 tokens).
@pytest.mark.parametrize("n,vl", [(4, None), (18, None), (18, 13), (18, 0),
                                  (18, 1)])
def test_camera_trunk_shapes(cuda, n, vl):
    q, k, v, kw = _case(cuda, 2, 16, n, n, 128, rope=False, ln=False,
                        bias=False, seed=30)
    kw["valid_len"] = vl
    for softmax in ("online", "static"):
        for stats in (True, False):
            _sm90_check(q, k, v, kw, softmax, stats)
            _i8_check(q, k, v, kw, softmax, stats)
    _bwd_check(_bwd_case(cuda, 2, 16, n, n, 128, vl, seed=31), 16, vl)


# The fused DPT tail at rows 224 -> 392: (S, W, cin, cout). W 100 leaves a
# masked edge strip, W 37 is less than one 64-column strip, W 518 is the
# production tail (nine strips, the last of 6 columns); S 1 and S 3 leave a
# frame pair with one frame; cin 32 to 128 (the kernel's four instances).
_TAIL_CASES = {
    "w100_cout2": (2, 100, 64, 2),
    "w100_cout4": (2, 100, 64, 4),
    "w518_s18_cout2": (18, 518, 128, 2),
    "w518_s1_cin32_cout3": (1, 518, 32, 3),
    "w37_s1_cin32_cout1": (1, 37, 32, 1),
    "w37_s18_cin128_cout3": (18, 37, 128, 3),
    "w100_s3_cin96_cout1": (3, 100, 96, 1),
}


@pytest.mark.parametrize("case", list(_TAIL_CASES))
def test_fused_tail_matches_plain(cuda, case):
    S, W, cin, cout = _TAIL_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(8)

    def rnd(*s):
        return torch.randn(s, generator=g, device=cuda)

    x = rnd(S, 224, W, cin).bfloat16()
    args = (0.1 * rnd(392, W, cin), rnd(3, 3, cin, 32) / (3 * cin ** 0.5),
            0.1 * rnd(32), rnd(1, 1, 32, cout) / 6.0, rnd(cout))
    before, designs = T.LAUNCHES["dpt_tail"], T.design_launches()
    counted = T.fused_tail(x, *args)
    out = T._launch(x, *args, out=torch.full_like(counted, math.nan))
    torch.cuda.synchronize()
    assert T.LAUNCHES["dpt_tail"] == before + 1
    assert T.design_launches()["wgmma_sm90"] == designs["wgmma_sm90"] + 2
    ref = T.fused_tail_ref(x, *args)
    assert out.shape == (cout, S, 392, W) and out.dtype == torch.float32
    tol = 1e-2 * float(ref.abs().max())
    for got in (out, counted):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   atol=tol, rtol=0)
    if S > 1:   # control: frames 0 and 1 swapped must fail the check
        swapped = out.clone()
        swapped[:, [0, 1]] = out[:, [1, 0]]
        assert float((swapped - ref).abs().max()) > tol


def test_keyframe_auto_is_the_torch_tracker_on_the_card(cuda):
    from vggt_slam_tpu_torch.main import parser
    from vggt_slam_tpu_torch.slam.solver import Solver

    args = parser.parse_args([])
    assert args.keyframe_backend == "auto"
    solver = Solver(keyframe_backend=args.keyframe_backend, device=cuda)
    assert solver.flow_tracker.backend == "torch"


# The frame-attention probes (scripts/bench_attention.py's port): at a small
# shape (BH 8, N 100 -> 128) and the SLAM frame shape (BH 288, N 1041 ->
# 1152). Softmax-only is bit-exact; the others are held to 1e-2 of max|ref|
# (matmul-only: another f32 summation order can flip a bf16 rounding of s;
# attention: the kernels round p to bf16 against the running max, the plain
# version against the row max). The grouped and pipelined kernels are also
# held to the plain version at their own key tile (the running max per
# tile, as theirs): `BA.tiled_tolerance`, 2e-3 or one bf16 step of the
# plain value where that is larger (both sides round o to bf16). Their
# outputs are written into NaN-filled tensors, so a missed store fails, and
# each launch adds one to the C launcher's count of the design. The
# attention probes must also be further than the tolerance from a control
# that drops the padded keys from l.
_PROBE_SHAPES = {"small": (2, 4, 100), "frame": (18, 16, 1041)}
_GROUPED = [f"{s} G={G}" for G in (2, 4, 8)
            for s in ("grouped", "interleaved", "pipelined")]
_PROBES = ["matmul-only floor", "softmax-only floor"] + _GROUPED


def _grouped_run(p, args):
    """A grouped or pipelined probe's call into a NaN-filled output."""
    return p.run(*args, out=torch.full_like(args[0], math.nan))


@pytest.mark.parametrize("shape", ["small", "frame"])
@pytest.mark.parametrize("variant", _PROBES)
def test_probe_kernels_match_plain(cuda, variant, shape):
    S, H, N = _PROBE_SHAPES[shape]
    p = BA.make_variants(S, H, N, 64)[variant]
    args = p.prep(*BA.make_inputs(S, H, N, 64, seed=3, device=cuda))
    before = BA.LAUNCHES[p.counter]
    grouped = BA.instance(variant) is not None
    designs = BA.design_launches() if grouped else None
    out = _grouped_run(p, args) if grouped else p.run(*args)
    torch.cuda.synchronize()
    assert BA.LAUNCHES[p.counter] == before + 1
    err, tol = BA.probe_error(p.kind, out, p.plain(*args))
    assert err <= tol
    if p.kind == "attention":
        ctrl, _ = BA.probe_error(p.kind, out,
                                 BA.exp2_attention_ref(*args, l_keys=N))
        assert ctrl > tol
    if grouped:
        assert BA.design_launches()["tma_wgmma"] == designs["tma_wgmma"] + 1
        _, share, bk = BA.tiled_error(variant, args, out)
        assert share <= 1, (share, bk)
        dropped = BA.exp2_attention_ref(*args, l_keys=N, block_k=bk)
        ctrl = ((out.float() - dropped.float()).abs()
                / BA.tiled_tolerance(dropped)).max()
        assert ctrl > 1


@pytest.mark.parametrize("Np", [128, 1152])
@pytest.mark.parametrize("variant", _GROUPED)
def test_grouped_probe_one_group(cuda, variant, Np):
    """BH = G: one group, so fewer work items than SMs (one item at Np 128,
    9 or 18 at 1152), all key tiles of one sweep in a CTA."""
    _, G = BA.instance(variant)
    p = BA.make_variants(1, G, Np, 64)[variant]
    args = p.prep(*BA.make_inputs(1, G, Np, 64, seed=5, device=cuda))
    out = _grouped_run(p, args)
    torch.cuda.synchronize()
    _, share, bk = BA.tiled_error(variant, args, out)
    assert share <= 1, (share, bk)


def test_grouped_probe_runs_are_bit_equal(cuda):
    """No atomics: each instance gives the same bits twice at the frame shape,
    and schedules that share a key tile at one G are bit-equal."""
    S, H, N = _PROBE_SHAPES["frame"]
    variants = BA.make_variants(S, H, N, 64)
    qkv = BA.make_inputs(S, H, N, 64, seed=7, device=cuda)
    outs, shared = {}, 0
    for name in _GROUPED:
        args = variants[name].prep(*qkv)
        a, b = (_grouped_run(variants[name], args) for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(a, b), name
        key = (BA.instance(name)[1], BA.block_k(*BA.instance(name)))
        if key in outs:
            assert torch.equal(a, outs[key]), (name, key)
            shared += 1
        outs.setdefault(key, a)
    assert shared >= 1    # interleaved and pipelined at G = 2 (BK 64)


def test_grouped_probe_design_counts_each_launch(cuda):
    """Every grouped, interleaved and pipelined launch is one launch of
    grouped_sm90 by the C launcher's count; a refused launch counts none."""
    p = BA.make_variants(1, 8, 128, 64)
    qkv = BA.make_inputs(1, 8, 128, 64, device=cuda)
    before = BA.design_launches()["tma_wgmma"]
    for name in _GROUPED:
        p[name].run(*p[name].prep(*qkv))
    torch.cuda.synchronize()
    assert BA.design_launches()["tma_wgmma"] == before + len(_GROUPED)
    g3 = torch.zeros(1, 3, 128, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        BA.pipelined_attention(g3, g3, g3)
    assert BA.design_launches()["tma_wgmma"] == before + len(_GROUPED)


# The matmul-only floor on global_sm90 (its matmul mode at scale 1): at
# the frame shape (BH 288, N 1041 padded to 1152) and at BH 3, Np 1152
# (fewer CTAs than SMs), into a NaN-filled output; each launch one of
# global_sm90 by the C launcher's count, none of grouped_sm90; two runs
# bit-equal (no atomics).
@pytest.mark.parametrize("S,H,N", [(18, 16, 1041), (1, 3, 1152)],
                         ids=["frame", "bh3"])
def test_matmul_only_on_global_sm90(cuda, S, H, N):
    p = BA.make_variants(S, H, N, 64)["matmul-only floor"]
    args = p.prep(*BA.make_inputs(S, H, N, 64, seed=8, device=cuda))
    before = BA.design_launches()
    out = torch.full_like(args[0], math.nan)
    assert p.run(*args, out=out) is out
    torch.cuda.synchronize()
    assert BA.design_launches() == {
        "tma_wgmma": before["tma_wgmma"],
        "global_sm90": before["global_sm90"] + 1}
    assert not torch.isnan(out).any()
    err, tol = BA.probe_error(p.kind, out, p.plain(*args))
    assert err <= tol
    assert torch.equal(p.run(*args), out)


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    d32 = torch.zeros(4, 128, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        BA.matmul_only(d32, d32, d32)
    f32 = torch.zeros(4, 128, 64, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        BA.softmax_only(f32, f32, f32)
    g3 = torch.zeros(1, 3, 128, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        BA.grouped_attention(g3, g3, g3)
    np64 = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 128 rows"):
        BA.grouped_attention(np64, np64, np64)
    with pytest.raises(ValueError, match="multiple of 128 rows"):
        BA.matmul_only(np64[0], np64[0], np64[0])
    rate = BA.ex2_rate(cuda, iters=256)
    assert 1e12 < rate < 1e13


# The global-shape probes (bench_global_attention, bench_softmax_variants,
# bench_int8_inkernel): every mode and tiling at a small shape (BH 2, N 512)
# against its plain version, which takes the kernels' running max per key
# block: 1e-2 of max|ref| (f32 sums in another order can flip a bf16 or p8
# rounding). The int8 modes must be further from the bf16 mode's plain
# version than from their own.
_GLOBAL_PROBES = (
    [("global", m, t) for m in GA.MODES for t in GA.TILINGS]
    + [("softmax", m, t) for m in SV.MODES for t in SV.TILINGS]
    + [("inkernel", m, t) for m in IK.MODES for t in IK.TILINGS])


def _global_probe(script, mode, tiling, device, BH=2, N=512):
    """(kernel call, plain call, args, bf16 counterpart's args, LAUNCHES
    dict and key) of one global-shape probe case."""
    if script == "global":
        q, k, v = GA.make_inputs(BH, N, 64, seed=3, device=device)
        bf16_args = (q, k, v, *tiling, "bf16", 0.125)
        args = (q, k, v, *tiling, mode, 0.125)
        if mode == "int8":
            q8, k8, s8 = GA.int8_operands(q, k, 0.125)
            args = (q8, k8, v, *tiling, mode, s8)
        return (GA.run_kernel, GA.run_kernel_ref, args, bf16_args,
                GA.LAUNCHES, "global_attention")
    if script == "softmax":
        q, k, v = GA.make_inputs(BH, N, 64, seed=3, device=device, scale=0.3)
        bf16_args = (q, k, v, *tiling, "static")
        args = (q, k, v, *tiling, mode)
        if mode == "staticint8":
            q8, k8, smax = SV.int8_operands(q, k)
            args = (q8, k8, v, *tiling, mode, smax)
        return (SV.run_kernel, SV.run_kernel_ref, args, bf16_args,
                SV.LAUNCHES, "softmax_variants")
    q, k, v = GA.make_inputs(BH, N, 64, seed=3, device=device)
    return (IK.run, IK.run_ref, (q, k, v, *tiling, mode),
            (q, k, v, *tiling, "bf16"), IK.LAUNCHES, "int8_inkernel")


@pytest.mark.parametrize("script,mode,tiling", _GLOBAL_PROBES,
                         ids=[f"{s}-{m}-{t[0]}x{t[1]}"
                              for s, m, t in _GLOBAL_PROBES])
def test_global_probe_kernels_match_plain(cuda, script, mode, tiling):
    run, plain, args, bf16_args, launches, key = _global_probe(
        script, mode, tiling, cuda)
    before = launches[key]
    out = run(*args)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    ref = plain(*args)
    err, tol = BA.probe_error("attention", out, ref)
    assert err <= tol
    if mode in ("int8", "staticint8", "qk8", "qk8av8"):
        assert (GA.mean_distance(out, plain(*bf16_args))
                > GA.mean_distance(out, ref))


# The three probes on global_sm90 (bench_global_attention,
# bench_int8_inkernel, bench_softmax_variants) at their edges: 27 or 54
# CTAs at BH 3, N 1152 (not a multiple of the 132 SMs); a NaN-filled
# output, so a row the kernel does not write fails; for the global probe
# and the softmax variants k and v of 1408 rows, NaN (int8 k: 127) past the
# 1152 keys attended, which a load reaching past Nk would bring in; every
# call one global_sm90 launch by the C launcher's count.
_SM90_PROBES = ([("global", m, t) for m in GA.MODES for t in GA.TILINGS]
                + [("inkernel", m, t) for m in IK.MODES for t in IK.TILINGS]
                + [("softmax", m, t) for m in SV.MODES for t in SV.TILINGS])
_SM90_MODULE = {"global": GA, "softmax": SV, "inkernel": IK}


def _sm90_design(script):
    return _SM90_MODULE[script].design_launches()["tma_wgmma"]


@pytest.mark.parametrize("script,mode,tiling", _SM90_PROBES,
                         ids=[f"{s}-{m}-{t[0]}x{t[1]}"
                              for s, m, t in _SM90_PROBES])
def test_global_sm90_edges(cuda, script, mode, tiling):
    run, plain, args, _, _, _ = _global_probe(script, mode, tiling, cuda,
                                              BH=3, N=1152)
    designs = _sm90_design(script)
    out = torch.full(args[0].shape, math.nan, dtype=torch.bfloat16,
                     device=cuda)
    mod = _SM90_MODULE[script]
    if script == "inkernel":
        q, k, v = args[:3]
        got = IK.attention(IK.scales(q, k, v, mode), *args, out=out)
    else:
        got = mod.run_kernel(*args, out=out)
    torch.cuda.synchronize()
    assert got is out and not torch.isnan(out).any()
    err, tol = BA.probe_error("attention", out, plain(*args))
    assert err <= tol
    calls = 1
    if script != "inkernel":
        q, k, v = args[:3]
        # int8 k holds no NaN: 127 there, which would move every logit
        pad = torch.full((3, 256, 64), math.nan, device=cuda)
        k_pad = pad.bfloat16() if k.dtype == torch.bfloat16 else \
            torch.full_like(pad, 127).to(k.dtype)
        k_long = torch.cat([k, k_pad], 1).contiguous()
        v_long = torch.cat([v, pad.bfloat16()], 1).contiguous()
        slab = q[:, :256].contiguous()
        got = mod.run_kernel(slab, k_long, v_long, *args[3:], n_keys=1152)
        calls += 1
        torch.cuda.synchronize()
        want = mod.run_kernel_ref(slab, k, v, *args[3:], n_keys=1152)
        err, tol = BA.probe_error("attention", got, want)
        assert err <= tol
    assert _sm90_design(script) == designs + calls


def test_staticfused_sums_the_rounded_weights(cuda):
    """staticfused's l sums bf16(p) on the tensor cores, static's p in f32.
    Every p is 1.0035 (bf16 1), v ones: staticfused gives exactly 1, static 1 /
    1.0035; a kernel that summed p or dropped the ones product fails."""
    BH, N = 2, 1152
    q = torch.zeros(BH, N, 64, dtype=torch.bfloat16, device=cuda)
    k, v = torch.zeros_like(q), torch.ones_like(q)
    q[..., 0], k[..., 0] = 12.0, 1.0
    smax = 12.0 - math.log2(1.0035)
    for tiling in SV.TILINGS:
        fused = SV.run_kernel(q, k, v, *tiling, "staticfused", smax)
        static = SV.run_kernel(q, k, v, *tiling, "static", smax)
        torch.cuda.synchronize()
        assert torch.equal(fused, SV.run_kernel_ref(q, k, v, *tiling,
                                                    "staticfused", smax))
        assert bool((fused == 1).all())
        want = SV.run_kernel_ref(q, k, v, *tiling, "static", smax)
        assert torch.equal(static, want) and bool((want < 1).all())


@pytest.mark.parametrize("mode", SV.MODES)
def test_softmax_variant_runs_are_bit_equal(cuda, mode):
    """No atomics: every global_sm90 instance of the softmax variants gives
    the same bits twice, at BH 3, N 1152."""
    for tiling in SV.TILINGS:
        _, _, args, _, _, _ = _global_probe("softmax", mode, tiling, cuda,
                                            BH=3, N=1152)
        first = SV.run_kernel(*args)
        assert torch.equal(SV.run_kernel(*args), first), tiling


def _key_pos(key):
    """global_sm90.cuh's key_pos: the byte of key `key` in a row of the
    transposed V8 tile."""
    w = key & 7
    return ((key & ~31) + ((key >> 4) & 1) * 16 + (w >> 1) * 4
            + ((key >> 3) & 1) * 2 + (w & 1))


def test_qk8av8_needs_key_pos(cuda):
    """qk8av8's layout control: V8 stored without key_pos gives a function
    further from the plain version than the tolerance; the kernel is within
    it."""
    q, k, v = GA.make_inputs(2, 512, 64, seed=6, device=cuda)
    perm = torch.tensor([_key_pos(i) for i in range(512)], device=cuda)
    assert sorted(perm.tolist()) == list(range(512))
    sc = IK.scales(q, k, v, "qk8av8")
    for tiling in IK.TILINGS:
        out = IK.attention(sc, q, k, v, *tiling, "qk8av8")
        ref = IK.attention_ref(sc, q, k, v, *tiling, "qk8av8")
        dropped = IK.attention_ref(sc, q, k, v[:, perm].contiguous(),
                                   *tiling, "qk8av8")
        err, tol = BA.probe_error("attention", out, ref)
        assert err <= tol
        assert BA.probe_error("attention", dropped, ref)[0] > 4 * tol
        assert GA.mean_distance(out, dropped) > 4 * GA.mean_distance(out, ref)


def test_global_probe_key_count_follows_the_reference(cuda):
    """run_kernel attends to the first q.shape[1] keys, as the reference's
    grid; n_keys widens a q slab to all keys."""
    q, k, v = GA.make_inputs(2, 512, 64, seed=4, device=cuda)
    slab = q[:, :128].contiguous()
    got = GA.run_kernel(slab, k, v, 64, 64, "bf16", 0.125)
    want = GA.run_kernel(slab, k[:, :128].contiguous(),
                         v[:, :128].contiguous(), 64, 64, "bf16", 0.125)
    assert torch.equal(got, want)
    wide = GA.run_kernel(slab, k, v, 64, 64, "bf16", 0.125, n_keys=512)
    err, tol = BA.probe_error("attention", 
        wide, GA.run_kernel_ref(slab, k, v, 64, 64, "bf16", 0.125, 512))
    assert err <= tol


def test_global_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 512, 64, dtype=torch.bfloat16, device=cuda)
    d32 = torch.zeros(2, 512, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        GA.run_kernel(d32, d32, d32, 64, 64, "bf16", 1.0)
    with pytest.raises(TypeError, match="int8"):
        GA.run_kernel(x, x, x, 64, 64, "int8", 1.0)
    with pytest.raises(TypeError, match="bfloat16"):
        SV.run_kernel(x.float(), x, x, 64, 64, "online")
    with pytest.raises(ValueError, match="does not divide"):
        SV.run_kernel(x[:, :480].contiguous(), x, x, 64, 64, "static")
    with pytest.raises(ValueError, match="not built"):
        IK.run(x, x, x, 64, 128, "qk8")
    with pytest.raises(ValueError, match="contiguous"):
        GA.run_kernel(x.transpose(1, 2).contiguous().transpose(1, 2), x, x,
                      64, 64, "bf16", 1.0)


# The matmul-shape probes: both kernels and tilings within one bf16 ulp of
# max|ref| of the plain version (the script's check), at its B = 528 and
# square shapes and odd ones (edges in M, N, K; B = 1); the controls. The
# edges of the 128 x 128 and 128 x 256 tiles: M 1056 leaves 32 rows past
# 1024, N 1056 32 columns past 1024, K 1056 a 32-deep last step (K 40 a
# half k16 step); M < 64 (one warpgroup's rows), N < BN at B = 1; N = K =
# 8; and more work items than 132 SMs x 4 ring slots (864 and 768 at 128
# x 128), so the ring and the staging buffers wrap many times; more
# problems than 65535 and more than 65535 64-row tiles (the persistent grid
# has no per-dimension limit).
_MM_SHAPES = {"qk": (528, 1056, 64, 1056), "pv": (528, 1056, 1056, 64),
              "square": (1, 2048, 2048, 2048), "odd": (6, 100, 72, 40),
              "odd_b1": (1, 130, 200, 136),
              "m_ragged": (4, 1056, 64, 256), "n_ragged": (4, 128, 64, 1056),
              "k_ragged": (4, 256, 1056, 256), "k_half_step": (4, 192, 40, 136),
              "small_b1": (1, 40, 64, 24), "n8_k8": (4, 72, 8, 8),
              "wraps": (96, 384, 136, 264), "wraps_g": (128, 256, 64, 264),
              "b_65544": (65544, 16, 8, 8), "m_4194368": (1, 4194368, 8, 8)}


def _mm_inputs(device, B, M, K, N, seed=5):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device=device).bfloat16()
                 for s in ((B, M, K), (B, K, N)))


@pytest.mark.parametrize("shape", list(_MM_SHAPES))
@pytest.mark.parametrize("tile", MM.TILINGS, ids=MM.tile_name)
@pytest.mark.parametrize("kernel", ["batched_mm", "grouped_mm"])
def test_matmul_probe_kernels_match_plain(cuda, kernel, tile, shape):
    B, M, K, N = _MM_SHAPES[shape]
    G = next(g for g in (16, 4, 3, 2, 1) if B % g == 0)
    a, b = _mm_inputs(cuda, B, M, K, N)
    before = MM.LAUNCHES[kernel]
    designs = MM.design_launches()["tma_wgmma"]
    out = _nan_out(a, b)
    assert MM.run_variant(kernel, a, b, G, tile, out) is out
    torch.cuda.synchronize()
    assert MM.LAUNCHES[kernel] == before + 1
    assert MM.design_launches()["tma_wgmma"] == designs + 1
    err, tol = MM.mm_error(out, MM.batched_mm_ref(a, b))
    assert err <= tol


def _nan_out(a, b):
    """A NaN-filled output: an element the kernel does not write fails."""
    return torch.full((*a.shape[:2], b.shape[2]), math.nan,
                      dtype=torch.bfloat16, device=a.device)


@pytest.mark.parametrize("shape", ["qk", "pv"])
def test_matmul_probe_controls_are_rejected(cuda, shape):
    a, b = _mm_inputs(cuda, *_MM_SHAPES[shape])
    out = MM.run_variant("batched_mm", a, b, 1, MM.DEFAULT_TILING,
                         _nan_out(a, b))
    ctrl = MM.controls(a, b, out, MM.batched_mm_ref(a, b))
    assert ctrl["batch"] > ctrl["tol"] and ctrl["k_tile"] > ctrl["tol"]
    assert math.isnan(ctrl["edge"])


def test_matmul_probe_launches_count_graph_replays(cuda):
    """graph_bench's warm-up call counts once, each replay its n calls;
    the calls captured into the graph launch nothing and count nothing."""
    sets = [(*_mm_inputs(cuda, 2, 64, 64, 64, seed), 1, MM.DEFAULT_TILING)
            for seed in (1, 2, 3)]
    before = MM.LAUNCHES["batched_mm"]
    BA.graph_bench(functools.partial(MM.run_variant, "batched_mm"), sets, 4,
                   reps=2, replayed=lambda n: MM.count("batched_mm", n))
    assert MM.LAUNCHES["batched_mm"] == before + 1 + 3 * 6


def test_matmul_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    a, b = _mm_inputs(cuda, 4, 64, 64, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        MM.batched_mm(a.float(), b)
    with pytest.raises(ValueError, match="contiguous"):
        MM.batched_mm(a.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(ValueError, match="aligned"):
        MM.batched_mm(a.reshape(-1)[4:4 + a.numel() - 64 * 64]
                      .view(3, 64, 64), b[:3].contiguous())
    with pytest.raises(ValueError, match="does not divide"):
        MM.grouped_mm(a, b, 3)
    with pytest.raises(ValueError, match="multiples of 8"):
        MM.batched_mm(*_mm_inputs(cuda, 2, 64, 60, 64))
    with pytest.raises(ValueError, match="not built"):
        MM.batched_mm(a, b, (128, 64))
    with pytest.raises(ValueError, match="not built"):
        MM.batched_mm(a, b, (64, 64))
    with pytest.raises(ValueError, match="is on cpu"):
        MM.run_variant("batched_mm", a, b, 1, MM.DEFAULT_TILING,
                       _nan_out(a, b).cpu())


@pytest.mark.parametrize("tile", MM.TILINGS, ids=MM.tile_name)
def test_matmul_probe_runs_are_bit_equal(cuda, tile):
    """No atomics: a repeated run gives the same bits, and grouped_mm at
    every G gives batched_mm's bits (the same sums, items in another
    order)."""
    a, b = _mm_inputs(cuda, 16, 264, 1056, 200, seed=7)
    first = MM.batched_mm(a, b, tile)
    assert torch.equal(MM.batched_mm(a, b, tile), first)
    for G in (2, 4, 16):
        assert torch.equal(MM.grouped_mm(a, b, G, tile), first)


@pytest.mark.parametrize("tile", MM.TILINGS, ids=MM.tile_name)
@pytest.mark.parametrize("kernel", ["batched_mm", "grouped_mm"])
def test_matmul_probe_writes_nothing_outside_its_output(cuda, kernel, tile):
    """o between two NaN guard bands of one allocation: a store that
    reached past an edge (a map cut wrong, a batch folded into rows) would
    write a guard; every element of o is written and right."""
    B, M, K, N = 6, 200, 72, 264
    a, b = _mm_inputs(cuda, B, M, K, N, seed=8)
    guard = 64 * N   # 64 rows before and after, 16-byte aligned
    buf = torch.full((2 * guard + B * M * N,), math.nan, dtype=torch.bfloat16,
                     device=cuda)
    out = buf[guard:guard + B * M * N].view(B, M, N)
    MM.run_variant(kernel, a, b, 2 if kernel == "grouped_mm" else 1, tile,
                   out)
    torch.cuda.synchronize()
    assert torch.isnan(buf[:guard]).all() and torch.isnan(buf[-guard:]).all()
    err, tol = MM.mm_error(out, MM.batched_mm_ref(a, b))
    assert err <= tol


def test_matmul_design_launches_count_each_launch(cuda):
    """The C launcher counts one mm_sm90 launch a call, of each kernel at
    each tiling; CALLS agrees."""
    a, b = _mm_inputs(cuda, 4, 64, 64, 64)
    before, calls = MM.design_launches()["tma_wgmma"], dict(MM.CALLS)
    for tile in MM.TILINGS:
        MM.batched_mm(a, b, tile)
        MM.grouped_mm(a, b, 2, tile)
    torch.cuda.synchronize()
    n = 2 * len(MM.TILINGS)
    assert MM.design_launches()["tma_wgmma"] == before + n
    assert sum(MM.CALLS.values()) == sum(calls.values()) + n


def test_f32_block_attention_runs_the_bf16_kernel(cuda):
    """An f32 module (SALAD's DINOv2 blocks) on the flash route: one
    flash_single launch on bf16 q, k, v, its output cast back to f32,
    within TOL of the same block on the plain f32 route."""
    from vggt_slam_tpu_torch.models.vggt.modules import Block

    torch.manual_seed(0)
    blocks = [Block(768, 12, layerscale=1.0, attn_impl=impl).to(cuda)
              for impl in ("flash", "chunked")]
    for b in blocks:
        for p in b.parameters():
            torch.nn.init.normal_(p, std=0.02)
            if p.dim() == 1 and p.shape[0] == 768:
                p.data.add_(1.0)
    blocks[1].load_state_dict(blocks[0].state_dict())
    x = torch.randn(3, 257, 768, device=cuda)
    A.reset_launch_counts()
    with torch.no_grad():
        got = blocks[0](x)
        want = blocks[1](x)
    assert got.dtype == torch.float32
    assert A.LAUNCHES["flash_single"] == 1
    assert (got - want).abs().max().item() < TOL * want.abs().max().item()


def test_voxelize_device_matches_voxelize_np(cuda):
    """voxelize_device against voxelize_np with room for every voxel and for
    half (then against its first half); points shifted by half a voxel fail the
    centres check."""
    from vggt_slam_tpu_torch.ops import voxel as VX

    rng = np.random.default_rng(0)
    pts = rng.normal(scale=1.5, size=(300_000, 3)).astype(np.float32)
    feats = rng.normal(size=(300_000, 64)).astype(np.float32)
    mask = rng.random(300_000) > 0.2
    centers, means, inverse = VX.voxelize_np(pts[mask], feats[mask], 0.05)
    counts = np.bincount(inverse)
    V = len(centers)
    for cap in (V + 3, V // 2):
        c, m, n, num = (x.cpu().numpy() for x in VX.voxelize_device(
            *(torch.from_numpy(a).to(cuda) for a in (pts, feats, mask)),
            0.05, cap))
        k = min(V, cap)
        assert int(num) == k and not n[k:].any()
        np.testing.assert_array_equal(c[:k], centers[:k])
        np.testing.assert_array_equal(n[:k], counts[:k])
        err = np.abs(m[:k] - means[:k]).max(1)
        assert (err <= VX.mean_tolerance(counts[:k], feats)).all()
    c, _, _, num = VX.voxelize_device(
        *(torch.from_numpy(a).to(cuda) for a in (pts + 0.025, feats, mask)),
        0.05, V + 3)
    k = min(V, int(num))
    assert not np.array_equal(c[:k].cpu().numpy(), centers[:k])


def test_clip_vision_attention_runs_flash_single_at_50_tokens(cuda):
    """CLIP ViT-B/32's vision tower cut to 2 layers (q, k drawn so logits
    spread by ~3): the kernel at (16, 50, 768) within TOL into a NaN-filled
    output, the unit features within 2e-2 (L2) of the plain route, 2 launches;
    permuted keys must fail."""
    from vggt_slam_tpu_torch.models import clip as M

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(16, 50, 768, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    out = torch.full_like(q, float("nan"))
    A._launch("flash_single_fwd", q, k, v, 12, None, None, None, None, None,
              1e-5, None, False, False, out=out)
    want = A.flash_single_ref(q, k, v, num_heads=12)
    assert (out.float() - want.float()).abs().max().item() < TOL

    cfg = M.CLIPConfig.base_patch32(vision_layers=2, text_layers=1)
    with torch.device("meta"):
        model = M.CLIP(cfg)
    sd = M.convert_torch_state_dict(M.init_torch_state_dict(cfg, g), cfg)
    model.load_state_dict(sd, assign=True)
    x = M.preprocess_images(torch.rand(16, 3, 224, 224, generator=g,
                                       device=cuda), 224)
    flash = A.flash_single

    def permuted(q, k, v, **kw):
        return flash(q, k.roll(1, dims=1).contiguous(), v, **kw)

    with torch.no_grad():
        A.reset_launch_counts()
        got = model.encode_image(x)
        launches = A.LAUNCHES["flash_single"]
        model.set_attn_impl("plain")
        plain = model.encode_image(x)
        model.set_attn_impl("flash")
        A.flash_single = permuted
        try:
            bad = model.encode_image(x)
        finally:
            A.flash_single = flash
    assert launches == 2
    assert torch.linalg.vector_norm(got - plain, dim=1).max().item() < 2e-2
    assert torch.linalg.vector_norm(bad - plain, dim=1).min().item() > 2e-2


def test_siglip_towers_run_flash_single_at_196_and_64_tokens(cuda):
    """SigLIP base_patch16_224 cut to 2 layers a tower: 16 crops and 16
    full-context texts within 2e-2 (L2) of the plain route, 2 launches a tower;
    permuted keys must fail."""
    from vggt_slam_tpu_torch.models import siglip as M

    g = torch.Generator(device=cuda).manual_seed(0)
    cfg = M.SigLIPConfig.base_patch16_224(vision_layers=2, text_layers=2)
    with torch.device("meta"):
        model = M.SigLIP(cfg)
    sd = M.convert_torch_state_dict(M.init_torch_state_dict(cfg, g), cfg)
    model.load_state_dict(sd, assign=True)
    x = M.preprocess_images(torch.rand(16, 3, 224, 224, generator=g,
                                       device=cuda), 224)
    ids = torch.randint(0, cfg.vocab_size, (16, 64), generator=g,
                        device=cuda)
    flash = A.flash_single

    def permuted(q, k, v, **kw):
        return flash(q, k.roll(1, dims=1).contiguous(), v, **kw)

    def both():
        return model.encode_image(x), model.encode_text(ids)

    with torch.no_grad():
        A.reset_launch_counts()
        got = both()
        launches = A.LAUNCHES["flash_single"]
        model.set_attn_impl("plain")
        plain = both()
        model.set_attn_impl("flash")
        A.flash_single = permuted
        try:
            bad = both()
        finally:
            A.flash_single = flash
    assert launches == 4
    for a, p, b in zip(got, plain, bad):
        assert torch.linalg.vector_norm(a - p, dim=1).max().item() < 2e-2
        assert torch.linalg.vector_norm(b - p, dim=1).min().item() > 2e-2


def test_sam2_base_plus_matches_float64(cuda):
    """SAM2 at sam2.1_hiera_base_plus width on a 1024 x 1024 image and 192
    points: embed_image and decode_points in f32 (TF32 off) against the
    same module in float64."""
    import copy

    from chip_smoke import SAM2_TOL, sam2_errors
    from vggt_slam_tpu_torch.models import sam2 as S

    cfg = S.SAM2Config.base_plus()
    model = S.build_model(cfg, S.init_state_dict(cfg, 0, cuda), cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    image = torch.rand(1, 1024, 1024, 3, generator=g, device=cuda) * 255
    pts = torch.rand(192, 2, generator=g, device=cuda) * 1024
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    tf32 = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        errs = sam2_errors(model, copy.deepcopy(model).double(), image, pts)
    finally:
        for f, t in zip(flags, tf32):
            f.allow_tf32 = t
    assert max(errs) < SAM2_TOL, errs
