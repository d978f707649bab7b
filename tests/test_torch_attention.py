"""The port's attention (ops/attention.py) against the JAX reference on the
CPU: the plain versions of both CUDA kernels against the reference's
Pallas kernels in interpret mode, packed, with every variant the main path
uses (in-kernel qk-LN + rope, kv_bias, valid_len cutting a key block,
static-max softmax, head dims 32, 64, 128). f32 inputs 5e-5 (the in-kernel
LN and rope round in another order); bf16 inputs 2e-2 (bf16 tiles).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.ops import attention as jattn
from vggt_slam_tpu_torch.ops import attention as tattn

F32_TOL = 5e-5
BF16_TOL = 2e-2


def _inputs(seed, B, H, Nq, Nk, D, rope=False, ln=False, bias=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Nq, H * D)).astype(np.float32)
    k = rng.normal(size=(B, Nk, H * D)).astype(np.float32)
    v = rng.normal(size=(B, Nk, H * D)).astype(np.float32)
    extra = {}
    if rope:
        pos_q = rng.uniform(0, 30, size=(Nq, 2)).astype(np.float32)
        pos_k = pos_q[:Nk] if Nk <= Nq else rng.uniform(
            0, 30, size=(Nk, 2)).astype(np.float32)
        ang_q = pos_q[:, :1] * np.linspace(0.1, 1, D // 2)[None]
        ang_k = pos_k[:, :1] * np.linspace(0.1, 1, D // 2)[None]
        extra["rope_q"] = (np.cos(ang_q).astype(np.float32),
                           np.sin(ang_q).astype(np.float32))
        extra["rope_k"] = (np.cos(ang_k).astype(np.float32),
                           np.sin(ang_k).astype(np.float32))
    if ln:
        extra["qk_ln"] = tuple(
            (rng.uniform(0.5, 1.5, D) if i % 2 == 0
             else rng.uniform(-0.1, 0.1, D)).astype(np.float32)
            for i in range(4))
    if bias:
        extra["kv_bias"] = np.log(rng.integers(1, 20, size=Nk)).astype(
            np.float32)
    return q, k, v, extra


def _jax(x, dtype):
    if isinstance(x, tuple):
        return tuple(_jax(t, dtype) for t in x)
    return jnp.asarray(x, dtype)


def _torch(x, dtype):
    if isinstance(x, tuple):
        return tuple(_torch(t, dtype) for t in x)
    return torch.from_numpy(np.array(x)).to(dtype)


def _run(seed, B, H, Nq, Nk, D, *, multi, dtype="f32", valid_len=None,
         rope=False, ln=False, bias=False):
    q, k, v, extra = _inputs(seed, B, H, Nq, Nk, D, rope, ln, bias)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    tables = {key: _jax(val, jnp.float32) for key, val in extra.items()}
    jkw = dict(layout="packed", num_heads=H, interpret=True,
               valid_len=valid_len, **tables)
    if multi:
        # Small blocks force the reference's multi-block static kernel.
        jkw.update(block_q=128, block_k=128, softmax="static")
    out_j = jattn.flash_attention(_jax(q, jd), _jax(k, jd), _jax(v, jd),
                                  **jkw)
    tkw = {key: _torch(val, torch.float32) for key, val in extra.items()}
    tq, tk, tv = _torch(q, td), _torch(k, td), _torch(v, td)
    if multi:
        smax = tattn.static_bound(tq, tk, H, qk_ln=tkw.get("qk_ln"),
                                  kv_bias=tkw.get("kv_bias"))
        out_t = tattn.flash_multi(tq, tk, tv, smax, num_heads=H,
                                  valid_len=valid_len, **tkw)
    else:
        out_t = tattn.flash_single(tq, tk, tv, num_heads=H,
                                   valid_len=valid_len, **tkw)
    assert out_t.dtype == td and out_t.shape == q.shape
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               atol=tol, rtol=0)


SINGLE_CASES = {
    # name: (B, H, Nq, Nk, D, kwargs)
    "encoder_d64": (2, 2, 150, 150, 64, {}),
    "frame_rope_ln_d64": (2, 2, 150, 150, 64, dict(rope=True, ln=True)),
    "camera_valid_len_d128": (1, 2, 18, 18, 128, dict(valid_len=13)),
    "bias_valid_len_d64": (1, 2, 90, 200, 64, dict(bias=True,
                                                   valid_len=137)),
    "rope_ln_valid_len_d128": (1, 2, 70, 70, 128, dict(rope=True, ln=True,
                                                       valid_len=61)),
    "encoder_d32": (2, 4, 150, 150, 32, {}),
    "frame_rope_ln_d32": (2, 4, 150, 150, 32, dict(rope=True, ln=True)),
    "bias_valid_len_d32": (1, 4, 90, 200, 32, dict(bias=True,
                                                   valid_len=137)),
}

MULTI_CASES = {
    "global_d64": (1, 2, 300, 300, 64, dict(rope=True, ln=True, bias=True,
                                            valid_len=201)),
    "global_d128": (1, 2, 200, 300, 128, dict(rope=True, ln=True,
                                              bias=True, valid_len=290)),
    "no_ln_row_norm_bound_d64": (2, 2, 150, 260, 64, dict(valid_len=250)),
    "global_d32": (1, 4, 300, 300, 32, dict(rope=True, ln=True, bias=True,
                                            valid_len=201)),
}


@pytest.mark.parametrize("name", sorted(SINGLE_CASES))
def test_flash_single_plain_matches_reference_kernel(name):
    B, H, Nq, Nk, D, kw = SINGLE_CASES[name]
    _run(1, B, H, Nq, Nk, D, multi=False, **kw)


@pytest.mark.parametrize("name", sorted(MULTI_CASES))
def test_flash_multi_plain_matches_reference_kernel(name):
    B, H, Nq, Nk, D, kw = MULTI_CASES[name]
    _run(2, B, H, Nq, Nk, D, multi=True, **kw)


# The tile edges of the CUDA kernel at head dims 32, 64 and 128 (128-row q
# tiles and 128-key tiles, tests/test_torch_gpu.py): Nq and Nk at 127, 129
# and 257, valid_len at 0, 128 and 129; in-kernel LN, rope and kv_bias
# throughout. The head-dim-32 and -128 cases' ids begin with "d32-" and
# "d128-".
EDGE_CASES = [
    # (Nq, Nk, valid_len, multi)
    (127, 127, None, False), (129, 129, None, False),
    (257, 257, 128, False), (129, 257, 129, False),
    (127, 257, 128, True), (257, 129, None, True),
    (129, 257, 129, True), (257, 257, None, True),
    (129, 257, 0, False), (129, 257, 0, True),
]
EDGE_PARAMS = [pytest.param(*case, D, id=("" if D == 64 else f"d{D}-")
                            + "-".join(map(str, case)))
               for D in (64, 32, 128) for case in EDGE_CASES]


@pytest.mark.parametrize("nq,nk,valid_len,multi,D", EDGE_PARAMS)
def test_plain_matches_reference_kernel_at_tile_edges(nq, nk, valid_len,
                                                      multi, D):
    _run(7, 1, 2, nq, nk, D, multi=multi, valid_len=valid_len, rope=True,
         ln=True, bias=True)


@pytest.mark.parametrize("softmax", ["online", "static"])
def test_plain_stats_with_no_valid_key(softmax):
    """valid_len 0 keeps no key: out is 0, l sums nothing (0, as the CUDA
    kernels, which load no key tile, write it) and m is the shift the
    kernels start from, -1e30 online or the static bound."""
    q, k, v, extra = _inputs(8, 1, 2, 129, 257, 64, rope=True, ln=True,
                             bias=True)
    tq, tk, tv = (_torch(x, torch.float32) for x in (q, k, v))
    tkw = {key: _torch(val, torch.float32) for key, val in extra.items()}
    smax = (tattn.static_bound(tq, tk, 2, qk_ln=tkw["qk_ln"],
                               kv_bias=tkw["kv_bias"])
            if softmax == "static" else None)
    out, m, l = tattn._plain(tq, tk, tv, 2, 0, tkw["rope_q"], tkw["rope_k"],
                             tkw["kv_bias"], tkw["qk_ln"], 1e-5, smax, True)
    assert not out.any() and not l.any()
    want = (torch.full_like(m, -1e30) if smax is None
            else smax.float().view(1, 2, 1).expand_as(m))
    assert torch.equal(m, want)


@pytest.mark.parametrize("multi", [False, True])
def test_bf16_plain_matches_reference_kernel(multi):
    _run(3, 1, 2, 140, 200, 64, multi=multi, dtype="bf16", rope=True,
         ln=True, bias=True, valid_len=170)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_plain_references_match_jax_naive(impl):
    q, k, v, extra = _inputs(4, 2, 2, 120, 90, 32, bias=True)

    def bhnd(x):
        return jnp.swapaxes(jnp.asarray(x).reshape(2, -1, 2, 32), 1, 2)

    ref = jattn.naive_attention(bhnd(q), bhnd(k), bhnd(v), valid_len=71,
                                kv_bias=jnp.asarray(extra["kv_bias"]))
    ref = np.asarray(jnp.swapaxes(ref, 1, 2).reshape(2, 120, 64))
    out = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), impl=impl, valid_len=71,
                          kv_bias=torch.from_numpy(extra["kv_bias"]),
                          num_heads=2)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=0)


def test_selection_rule_and_dispatch_match_reference():
    """`flash_attention` picks kernel 1 for a key set that fits one block
    and kernel 2 (static) beyond 2304 keys, as the reference's rule."""
    H, D = 2, 64
    q, k, v, extra = _inputs(5, 1, H, 64, 2400, D, rope=True, ln=True,
                             bias=True)
    tkw = {key: _torch(val, torch.float32) for key, val in extra.items()}
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    calls = []
    orig_single, orig_multi = tattn.flash_single, tattn.flash_multi
    try:
        tattn.flash_single = lambda *a, **kw: calls.append("single") \
            or orig_single(*a, **kw)
        tattn.flash_multi = lambda *a, **kw: calls.append("multi") \
            or orig_multi(*a, **kw)
        out = tattn.flash_attention(tq, tk, tv, num_heads=H, valid_len=2301,
                                    softmax="static", **tkw)
        tattn.flash_attention(tq, tk[:, :1000], tv[:, :1000], num_heads=H,
                              softmax="static")
    finally:
        tattn.flash_single, tattn.flash_multi = orig_single, orig_multi
    assert calls == ["multi", "single"]
    ref = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layout="packed",
        num_heads=H, interpret=True, valid_len=2301, softmax="static",
        **{key: _jax(val, jnp.float32) for key, val in extra.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL,
                               rtol=0)


def test_static_bound_matches_reference_formula():
    rng = np.random.default_rng(6)
    g = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    b = rng.uniform(-0.2, 0.2, 64).astype(np.float32)
    bias = np.log(rng.integers(1, 9, 50)).astype(np.float32)
    q = torch.zeros(2, 10, 128)
    smax = tattn.static_bound(q, q[:, :5], 2, qk_ln=tuple(
        torch.from_numpy(t) for t in (g, b, g, b)),
        kv_bias=torch.from_numpy(bias))
    pb = math.sqrt(64) * np.abs(g).max() + np.sqrt((b * b).sum())
    want = math.log2(math.e) / 8.0 * pb * pb + bias.max() * math.log2(math.e)
    assert smax.shape == (4,)
    np.testing.assert_allclose(smax.numpy(), want, rtol=1e-6)


def test_f32_hands_back_a_ready_tensor_and_converts_the_rest():
    """`_f32` returns a contiguous f32 tensor of the right shape on the
    device as it is (no copy on the wrapper's path), converts or copies any
    other, aligns to 16 bytes only when asked (kv_bias, read by a TMA map),
    and refuses a wrong shape."""
    cpu = torch.device("cpu")
    t = torch.arange(16, dtype=torch.float32)
    assert tattn._f32(t, (16,), "t", cpu) is t
    view = t[1:9]                                # 4 bytes past alignment
    assert tattn._f32(view, (8,), "t", cpu).data_ptr() == view.data_ptr()
    aligned = tattn._f32(view, (8,), "t", cpu, align=True)
    assert aligned.data_ptr() % 16 == 0 and torch.equal(aligned, view)
    half = tattn._f32(t.bfloat16(), (16,), "t", cpu)
    assert half.dtype == torch.float32 and torch.equal(half, t)
    strided = tattn._f32(t.view(4, 4).t(), (4, 4), "t", cpu)
    assert strided.is_contiguous() and torch.equal(strided,
                                                   t.view(4, 4).t())
    with pytest.raises(ValueError, match="expected shape"):
        tattn._f32(t, (8,), "t", cpu)


def test_cpu_wrappers_use_plain_version_and_count_no_launch():
    q = torch.randn(1, 40, 128)
    before = dict(tattn.LAUNCHES)
    out = tattn.flash_single(q, q, q, num_heads=2)
    ref = tattn.flash_single_ref(q, q, q, num_heads=2)
    assert torch.equal(out, ref)
    assert tattn.LAUNCHES == before


def test_other_devices_raise():
    q = torch.empty(1, 8, 128, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        tattn.flash_single(q, q, q, num_heads=2)
    with pytest.raises(ValueError, match="no attention kernel"):
        tattn.flash_multi(q, q, q, torch.zeros(2), num_heads=2)
