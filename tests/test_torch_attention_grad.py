"""The port's training attention against the JAX reference on the CPU (its
Pallas kernels in interpret mode): the forward's stats (out, m, l) at one
and several blocks, valid_len, D 32 and 128 (5e-5 of the largest |m|,
|l|); `FlashAttentionGrad` against `flash_attention_grad` on
TestFlashGrad's cases plus two (3e-5, the reference's bound; masked keys'
dk, dv below 1e-6) and autograd of `naive_attention` (3e-5); `flash_bwd`'s
plain path against `_flash_bwd` at D 32, 64, 128 (3e-5 of each gradient's
largest entry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.ops import attention as jattn
from vggt_slam_tpu_torch.ops import attention as tattn

F32_TOL = 5e-5
GRAD_TOL = 3e-5


def _qkv(seed, B, H, N, D, Nk=None):
    rng = np.random.default_rng(seed)
    Nk = N if Nk is None else Nk
    return (rng.normal(size=(B, N, H * D)).astype(np.float32),
            rng.normal(size=(B, Nk, H * D)).astype(np.float32),
            rng.normal(size=(B, Nk, H * D)).astype(np.float32))


@pytest.mark.parametrize("B,H,Nq,Nk,D,vl,softmax", [
    (2, 2, 300, 300, 64, None, "online"),      # one block
    (1, 2, 200, 1500, 64, 1234, "online"),     # one block, valid_len
    (1, 2, 300, 2200, 64, None, "static"),     # multi-block, static max
    (1, 2, 400, 2300, 32, 2100, "static"),     # head dim 32, valid_len
    (1, 4, 257, 257, 32, None, "online"),      # head dim 32, packed heads
    (1, 16, 4, 4, 128, None, "online"),        # camera trunk, training
    (1, 16, 18, 18, 128, 13, "online"),        # camera trunk, valid_len
])
def test_forward_stats_match_reference(B, H, Nq, Nk, D, vl, softmax):
    q, k, v = _qkv(0, B, H, Nq, D, Nk)
    want = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid_len=vl,
        interpret=True, layout="packed", num_heads=H, softmax=softmax,
        return_stats=True)
    got = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        num_heads=H, valid_len=vl, softmax=softmax, return_stats=True)
    assert got[1].shape == got[2].shape == (B, H, Nq)
    for name, g, w in zip(("out", "m", "l"), got, want):
        w = np.asarray(w)
        scale = 1.0 if name == "out" else max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=F32_TOL * scale,
                                   rtol=0, err_msg=name)


def _port_grads(q, k, v, H, vl, softmax, dout_fn):
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = tattn.flash_attention_grad(qt, kt, vt, num_heads=H, valid_len=vl,
                                     softmax=softmax)
    dout_fn(out).sum().backward()
    return out, [t.grad.numpy() for t in (qt, kt, vt)]


def _packed_to_bhnd(x, H):
    B, N, HD = x.shape
    return jnp.swapaxes(jnp.asarray(x).reshape(B, N, H, HD // H), 1, 2)


def _bhnd_to_packed(x):
    B, H, N, D = x.shape
    return np.asarray(jnp.swapaxes(x, 1, 2).reshape(B, N, H * D))


@pytest.mark.parametrize("B,H,N,D,vl,softmax", [
    (1, 2, 300, 64, None, "online"),           # TestFlashGrad cases
    (1, 2, 256, 64, 200, "static"),
    (1, 1, 2200, 32, 2050, "static"),          # multi-block, head dim 32
])
def test_backward_matches_reference_flash_grad(B, H, N, D, vl, softmax):
    q, k, v = _qkv(1, B, H, N, D)

    def loss_ref(q, k, v):
        o = jattn.flash_attention_grad(q, k, v, valid_len=vl,
                                       softmax=softmax, block_q=128,
                                       block_k=128, interpret=True)
        return jnp.sum(jnp.sin(o))

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(
        *(_packed_to_bhnd(t, H) for t in (q, k, v)))
    _, got = _port_grads(q, k, v, H, vl, softmax, torch.sin)
    for name, g, w in zip("qkv", got, want):
        w = _bhnd_to_packed(w)
        if vl is not None and name in "kv":
            assert np.abs(g[:, vl:]).max() < 1e-6, name
            g, w = g[:, :vl], w[:, :vl]
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("H,N,D,vl", [(2, 192, 64, None), (3, 150, 32, 97),
                                      (1, 70, 128, 70)])
def test_backward_matches_autograd_of_naive(H, N, D, vl):
    q, k, v = _qkv(2, 1, H, N, D)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    _, got = _port_grads(q, k, v, H, vl, "online", lambda o: torch.cos(o) * w)
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = tattn.attention(qt, kt, vt, impl="naive", num_heads=H,
                          valid_len=vl)
    (torch.cos(out) * w).sum().backward()
    for name, g, t in zip("qkv", got, (qt, kt, vt)):
        np.testing.assert_allclose(g, t.grad.numpy(), atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("B,H,Nq,Nk,D,vl", [
    (1, 2, 150, 150, 64, None),
    (1, 2, 130, 200, 64, 170),     # Nq != Nk, valid_len
    (2, 2, 150, 150, 32, None),
    (1, 2, 200, 140, 32, 97),      # Nq > Nk, valid_len
    (1, 1, 90, 90, 128, None),
    (1, 1, 70, 130, 128, 111),
])
def test_flash_bwd_plain_matches_reference_bwd(B, H, Nq, Nk, D, vl):
    q, k, v = _qkv(4, B, H, Nq, D, Nk)
    do = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    out, m, l = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid_len=vl,
        interpret=True, layout="packed", num_heads=H, return_stats=True)
    want = jattn._flash_bwd(
        *(_packed_to_bhnd(t, H) for t in (q, k, v, np.asarray(out))), m, l,
        _packed_to_bhnd(do, H), vl, 128, 128, True)
    got = tattn.flash_bwd(
        *(torch.from_numpy(np.array(t)) for t in (q, k, v, do, out, m, l)),
        num_heads=H, valid_len=vl)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = _bhnd_to_packed(w)
        assert g.shape == w.shape, name
        tol = GRAD_TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0,
                                   err_msg=name)
        if vl is not None and name != "dq":
            assert not g[:, vl:].any(), name


def test_flash_grad_refuses_kv_bias_and_in_kernel_rope():
    q = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="kv_bias"):
        tattn.attention(q, q, q, impl="flash_grad", num_heads=2,
                        kv_bias=torch.zeros(8))
    with pytest.raises(ValueError, match="pre-applied"):
        tattn.attention(q, q, q, impl="flash_grad", num_heads=2,
                        rope_q=(torch.ones(8, 16), torch.zeros(8, 16)),
                        rope_k=(torch.ones(8, 16), torch.zeros(8, 16)))
