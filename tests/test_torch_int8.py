"""The port's int8 QK^T path against the JAX reference on the CPU.

* The plain int8 kernels (`flash_attention(..., qk_int8=True)`) against
  the reference's in interpret mode, packed, with and without rope,
  valid_len, kv_bias and static softmax, at head dims 32, 64 and 128.
  1e-4 max abs in f32: the same int8 grid and scales, exact s32 products;
  only f32 summation order is left.
* The edges of the card's int8 route (Nq 1 and 129, valid_len 0 and 1,
  two batches whose amax differ 10x) at the same tolerance; the q and k
  int8 grids against the reference's, bit for bit.
* At head dim 128 the reference's interpret-mode kernel contracts rope's
  x*C + swap(x)*S into an fma: at seed 7 and (256, 384) one q value
  crosses an int8 rounding boundary and its output row lands 7.7e-4 off.
  The port rounds apart, as its kernel does: its grids are held bit for
  bit to numpy's f32 arithmetic and its output to float64 (1e-5).
* The tiny model with `global_qk_int8=True` against the reference's at 2
  frames of 392x518 with exact global attention (2082 keys), and the
  LN-outside plumbing at block level: 5e-4 absolute on O(1) outputs. The
  standalone qk-LN sums in torch's f32 order on one side and XLA's on the
  other; one ulp there can flip an int8 rounding, a logit by about 1e-2,
  an output by a few 1e-4 (measured: 4 of 134400 past 1e-4, at most
  1.4e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.models.vggt import modules as jmod
from vggt_slam_tpu.models.vggt.config import VGGTConfig as JConfig
from vggt_slam_tpu.models.vggt.convert import _flatten
from vggt_slam_tpu.models.vggt.model import VGGT as JVGGT
from vggt_slam_tpu.models.vggt.model import \
    make_bucketed_model_fn as jax_model_fn
from vggt_slam_tpu.ops import attention as jattn
from vggt_slam_tpu_torch.main import make_config, parser
from vggt_slam_tpu_torch.models.vggt import modules as tmod
from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
from vggt_slam_tpu_torch.models.vggt.convert import load_flax_params
from vggt_slam_tpu_torch.models.vggt.model import VGGT, \
    make_bucketed_model_fn
from vggt_slam_tpu_torch.ops import attention as tattn

TOL = 1e-4
MODEL_TOL = 5e-4

CASES = {
    # name: (B, H, N, Nk, D, kwargs)
    "multiblock_d64": (1, 3, 512, 512, 64, {}),
    "multiblock_d32": (2, 2, 300, 400, 32, {}),
    "rope_valid_len_bias_d64": (1, 2, 384, 384, 64,
                                dict(rope=True, bias=True, valid_len=300)),
    "rope_valid_len_bias_d32": (1, 2, 200, 384, 32,
                                dict(rope=True, bias=True, valid_len=290)),
    "static_d64": (1, 2, 512, 512, 64, dict(softmax="static")),
    "static_rope_bias_d32": (1, 2, 256, 384, 32,
                             dict(softmax="static", rope=True, bias=True,
                                  valid_len=333)),
    "multiblock_d128": (1, 2, 384, 512, 128, {}),
    "static_rope_bias_d128": (1, 2, 200, 384, 128,
                              dict(softmax="static", rope=True, bias=True,
                                   valid_len=290)),
}


def _inputs(seed, B, H, Nq, Nk, D, rope=False, bias=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, n, H * D)).astype(np.float32)
               for n in (Nq, Nk, Nk))
    extra = {}
    if rope:
        pos = jnp.asarray(rng.uniform(0, 20, size=(max(Nq, Nk), 2)),
                          jnp.float32)
        cos, sin = (np.asarray(t) for t in jmod.rope_2d_angles(pos, D, 100.0))
        extra["rope_q"] = (cos[:Nq], sin[:Nq])
        extra["rope_k"] = (cos[:Nk], sin[:Nk])
    if bias:
        extra["kv_bias"] = rng.uniform(0, 1.5, size=(Nk,)).astype(np.float32)
    return q, k, v, extra


def _conv(x, fn):
    return tuple(_conv(t, fn) for t in x) if isinstance(x, tuple) else fn(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_attention_matches_reference_kernel(name):
    B, H, Nq, Nk, D, kw = CASES[name]
    kw = dict(kw)
    softmax = kw.pop("softmax", "online")
    valid_len = kw.pop("valid_len", None)
    q, k, v, extra = _inputs(7, B, H, Nq, Nk, D, **kw)
    want = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layout="packed",
        num_heads=H, block_q=128, block_k=128, interpret=True, qk_int8=True,
        softmax=softmax,
        valid_len=None if valid_len is None else jnp.int32(valid_len),
        **{key: _conv(val, jnp.asarray) for key, val in extra.items()})
    tkw = {key: _conv(val, torch.from_numpy) for key, val in extra.items()}
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    calls = []
    orig = tattn.flash_single, tattn.flash_multi
    try:
        tattn.flash_single = lambda *a, **k_: calls.append(
            ("single", k_["qk_int8"])) or orig[0](*a, **k_)
        tattn.flash_multi = lambda *a, **k_: calls.append(
            ("multi", k_["qk_int8"])) or orig[1](*a, **k_)
        got = tattn.flash_attention(tq, tk, tv, num_heads=H, block_k=128,
                                    qk_int8=True, softmax=softmax,
                                    valid_len=valid_len, **tkw)
    finally:
        tattn.flash_single, tattn.flash_multi = orig
    assert calls == [("multi" if softmax == "static" else "single", True)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    # int8 differs from the bf16-grade f32 path by quantization only
    exact = tattn.flash_attention(tq, tk, tv, num_heads=H, block_k=128,
                                  softmax=softmax, valid_len=valid_len, **tkw)
    err = (got - exact).abs()
    assert 0 < float(err.mean()) < 1.5e-3


EDGE_CASES = {
    # name: (B, H, Nq, Nk, D, softmax, valid_len, rope, batch-1 scale)
    "nq1_d64": (1, 2, 1, 300, 64, "online", 257, True, 1.0),
    "nq129_d32": (1, 2, 129, 300, 32, "static", None, True, 1.0),
    "valid_len0_d64": (1, 2, 200, 300, 64, "static", 0, True, 1.0),
    "valid_len0_d32": (1, 2, 200, 300, 32, "online", 0, False, 1.0),
    "valid_len1_d64": (1, 2, 200, 300, 64, "online", 1, True, 1.0),
    "valid_len1_d32": (1, 2, 200, 300, 32, "static", 1, True, 1.0),
    "b2_amax_10x_d64": (2, 2, 150, 260, 64, "static", 201, True, 10.0),
    "b2_amax_10x_d32": (2, 2, 150, 260, 32, "online", None, False, 10.0),
    "nq1_d128": (1, 2, 1, 300, 128, "static", 257, True, 1.0),
    "nq129_d128": (1, 2, 129, 300, 128, "online", None, False, 1.0),
    "valid_len0_d128": (1, 2, 200, 300, 128, "online", 0, True, 1.0),
    "valid_len1_d128": (1, 2, 200, 300, 128, "static", 1, False, 1.0),
    "b2_amax_10x_d128": (2, 2, 150, 260, 128, "static", 201, True, 10.0),
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_int8_edges_match_reference_kernel(name):
    """The int8 route's tile and mask edges: each output against the
    reference kernel at TOL; with a 10x batch the scales differ by 10x."""
    B, H, Nq, Nk, D, softmax, valid_len, rope, big = EDGE_CASES[name]
    q, k, v, extra = _inputs(11, B, H, Nq, Nk, D, rope=rope, bias=True)
    if B > 1:
        q[1] *= big
        k[1] *= big
    want = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layout="packed",
        num_heads=H, block_q=128, block_k=128, interpret=True, qk_int8=True,
        softmax=softmax,
        valid_len=None if valid_len is None else jnp.int32(valid_len),
        **{key: _conv(val, jnp.asarray) for key, val in extra.items()})
    tkw = {key: _conv(val, torch.from_numpy) for key, val in extra.items()}
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    if B > 1:   # amax (127 / scale) about 10x apart, per head and side
        inv = tattn.int8_scales(tq, tk, H, rope).view(3, B, H)[:2]
        ratio = (inv[:, 0] / inv[:, 1]).numpy()
        assert ((ratio > 5) & (ratio < 20)).all(), ratio
    got = tattn.flash_attention(tq, tk, tv, num_heads=H, block_k=128,
                                qk_int8=True, softmax=softmax,
                                valid_len=valid_len, **tkw)
    assert got.shape == (B, Nq, H * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    if valid_len == 0:
        assert not got.any()


def test_int8_d128_rope_rounds_apart():
    """The case where the reference's contracted rope flips an int8 value: the
    port's grids equal numpy's separately rounded rope and quantization bit for
    bit, and its output float64's to 1e-5."""
    B, H, Nq, Nk, D, vl = 1, 2, 256, 384, 128, 333
    q, k, v, extra = _inputs(7, B, H, Nq, Nk, D, rope=True, bias=True)
    tkw = {key: _conv(val, torch.from_numpy) for key, val in extra.items()}
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    inv_q, inv_k, sc2 = (t.numpy() for t in tattn.int8_scales(tq, tk, H,
                                                               True))
    grids = []
    for x, inv, table in ((q, inv_q, "rope_q"), (k, inv_k, "rope_k")):
        cos, sin = (np.asarray(t, np.float32) for t in extra[table])
        C = np.concatenate([cos, cos], -1)[:, None]          # (N, 1, D)
        S = np.concatenate([-sin, sin], -1)[:, None]
        xh = x.reshape(x.shape[1], H, D)
        sw = np.concatenate([xh[..., D // 2:], xh[..., :D // 2]], -1)
        y = (xh * C).astype(np.float32) + (sw * S).astype(np.float32)
        want = np.clip(np.rint(y * inv[None, :, None]), -127, 127)
        got = tattn._quant_i8(tattn._prep(torch.from_numpy(x), H, None, 1e-5,
                                          tkw[table], 1.0),
                              torch.from_numpy(inv))
        np.testing.assert_array_equal(got[0].numpy(),
                                      want.transpose(1, 0, 2))
        grids.append(want.astype(np.float64))
    s = np.einsum("qhd,khd->hqk", *grids) * sc2[:, None, None]
    s = s + extra["kv_bias"].astype(np.float64) * np.log2(np.e)
    s[:, :, vl:] = -np.inf
    p = np.exp2(s - s.max(-1, keepdims=True))
    vh = v.reshape(Nk, H, D).astype(np.float64)
    exact = np.einsum("hqk,khd->qhd", p / p.sum(-1, keepdims=True), vh)
    got = tattn.flash_attention(tq, tk, torch.from_numpy(v), num_heads=H,
                                block_k=128, qk_int8=True, softmax="static",
                                valid_len=vl, **tkw)
    np.testing.assert_allclose(got.numpy().reshape(Nq, H, D), exact,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("rope", [True, False])
def test_int8_grids_match_reference_bit_for_bit(rope):
    """The int8 values QK^T multiplies: the port's (`_prep` at scale 1,
    then `_quant_i8`) and the reference kernel's (`_rope_in_kernel`, then
    `_quant_i8`) on the same bf16 rows and the same scales, exactly."""
    B, H, N, D = 2, 3, 97, 64
    q, k, _, extra = _inputs(12, B, H, N, N, D, rope=rope)
    q[1] *= 10.0
    tq, tk = (torch.from_numpy(x).bfloat16() for x in (q, k))
    inv_q, inv_k, _ = tattn.int8_scales(tq, tk, H, rope)
    for x, inv, table in ((tq, inv_q, "rope_q"), (tk, inv_k, "rope_k")):
        tables = (tuple(torch.from_numpy(t) for t in extra[table])
                  if rope else None)
        got = tattn._quant_i8(tattn._prep(x, H, None, 1e-5, tables, 1.0),
                              inv)
        rows = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        if rope:
            C, S = jattn._rope_tables(*(jnp.asarray(t)
                                        for t in extra[table]), 1.0, 0)
        for b in range(B):
            for h in range(H):
                t = rows[b, :, h * D:(h + 1) * D]
                if rope:
                    t = jattn._rope_in_kernel(t, C, S)
                want = jattn._quant_i8(t.astype(jnp.float32),
                                       jnp.float32(inv[b * H + h].item()))
                np.testing.assert_array_equal(got[b, h].numpy(),
                                              np.asarray(want, np.float32))


def test_int8_single_block_stays_exact():
    """A key set that fits one block stays bf16 with qk_int8 (reference
    attention.py:549), as the reference's own test checks."""
    q, k, v, _ = _inputs(8, 1, 2, 300, 300, 64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tattn.flash_attention(tq, tk, tv, num_heads=2, qk_int8=True)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), layout="packed",
                                 num_heads=2, interpret=True, qk_int8=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=0)
    np.testing.assert_array_equal(
        got.numpy(), tattn.flash_attention(tq, tk, tv, num_heads=2).numpy())


def test_int8_scales_and_refusals():
    q, k, _, _ = _inputs(9, 2, 2, 40, 30, 32)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    sc = tattn.int8_scales(tq, tk, 2, rope=True)
    qh = q.reshape(2, 40, 2, 32)
    pair = np.sqrt(qh[..., :16] ** 2 + qh[..., 16:] ** 2).max(axis=(1, 3))
    np.testing.assert_allclose(sc[0].numpy(), 127.0 / pair.reshape(-1),
                               rtol=1e-6)
    sc_plain = tattn.int8_scales(tq, tk, 2, rope=False)
    np.testing.assert_allclose(
        sc_plain[0].numpy(), 127.0 / np.abs(qh).max(axis=(1, 3)).reshape(-1),
        rtol=1e-6)
    ln = tuple(torch.ones(32) for _ in range(4))
    rope = (torch.ones(40, 16), torch.zeros(40, 16))
    with pytest.raises(ValueError, match="qk_int8"):
        tattn.flash_single(tq, tq, tq, num_heads=2, rope_q=rope, rope_k=rope,
                           qk_ln=ln, qk_int8=True)
    with pytest.raises(ValueError, match="qk_int8"):
        tattn.flash_attention(tq, tq, tq, num_heads=2, rope_q=rope,
                              rope_k=rope, qk_ln=ln, qk_int8=True)


def test_global_block_with_int8_runs_ln_outside():
    """The global block with qk_int8 at block level: the qk-LN leaves the
    kernel (the reference's fuse_ln = ... and not qk_int8) and rope stays
    in it; 2 x 2100 tokens take the multi-block int8 path."""
    rng = np.random.default_rng(0)
    B, N, C, H = 1, 2100, 64, 2
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    pos = jnp.asarray(rng.uniform(0, 10, size=(N, 2)), jnp.float32)
    cos, sin = jmod.rope_2d_angles(pos, C // H, 100.0)
    jb = jmod.Block(C, H, 4, layerscale=0.5, attn_impl="flash",
                    qk_norm=True, softmax_mode="static", qk_int8=True)
    params = jb.init(jax.random.PRNGKey(1), jnp.asarray(x), cos, sin)
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(2),
                                              p.shape), params)
    want = jb.apply(params, jnp.asarray(x), cos, sin)
    tb = tmod.Block(C, H, 4, layerscale=0.5, qk_norm=True,
                    softmax_mode="static", qk_int8=True)
    tb.load_state_dict(load_flax_params(_flatten(params)), strict=True)
    seen = {}
    orig = tattn.flash_multi

    def spy(*a, **kw):
        seen.update(kw)
        return orig(*a, **kw)

    tattn.flash_multi = spy
    try:
        got = tb(torch.from_numpy(x), torch.from_numpy(np.array(cos)),
                 torch.from_numpy(np.array(sin)))
    finally:
        tattn.flash_multi = orig
    assert seen["qk_int8"] and seen["qk_ln"] is None
    assert seen["rope_q"] is not None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=MODEL_TOL, rtol=0)


def test_cli_flag_reaches_the_global_blocks():
    args = parser.parse_args(["--qk_int8", "--model_size", "tiny"])
    cfg = make_config(args)
    assert cfg.global_qk_int8
    with torch.device("meta"):
        model = VGGT(cfg)
    agg = model.aggregator
    assert all(getattr(agg, f"global_block_{d}").attn.qk_int8
               and not getattr(agg, f"frame_block_{d}").attn.qk_int8
               for d in range(cfg.agg_depth))
    assert not make_config(parser.parse_args([])).global_qk_int8


def test_tiny_model_with_int8_matches_reference():
    """2 frames of 392x518 at tiny width, exact global attention: the
    global blocks see 2082 keys, more than one block, so both sides run
    int8 QK^T there (flash impl; the reference in interpret mode)."""
    kw = dict(global_kv_stride=1, global_qk_int8=True, attn_impl="flash",
              enable_point_head=False)
    jm = JVGGT(JConfig.tiny(**kw))
    hw = (392, 518)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((2, 3) + hw))
    tm = VGGT(VGGTConfig.tiny(**kw))
    tm.load_state_dict(load_flax_params(_flatten(params)), strict=True)
    images = np.random.default_rng(4).uniform(
        size=(2, 3) + hw).astype(np.float32)
    want = jax_model_fn(jm, params, 2, as_numpy=True,
                        with_unprojection=True)(images)
    before = dict(tattn.LAUNCHES)
    got = make_bucketed_model_fn(tm, 2, as_numpy=True,
                                 with_unprojection=True,
                                 device="cpu")(images)
    assert tattn.LAUNCHES == before       # plain versions on the CPU
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        scale = max(1.0, float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key],
                                   atol=MODEL_TOL * scale,
                                   rtol=0, err_msg=key)
