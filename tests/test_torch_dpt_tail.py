"""The port's fused DPT tail (vggt_slam_tpu_torch/ops/dpt_tail.py) against
the JAX reference on the CPU.

`fused_tail_ref`, the plain version of the CUDA kernel, is held against the
reference's Pallas `fused_tail` in interpret mode at the shapes of
tests/test_dpt_tail.py:44-56 (rows 224 -> 392, width 112, cin 8, cmid 16),
cout 2 and 4, atol 2e-4 in f32 (the reference's own tolerance for the
fused kernel against XLA's chain), and at the edge cases W 37 (no
multiple of 8), S 1 and cout 1 and 3. In bf16 both sides round u, the conv
weights and h at the same places, so what differs is f32 summation order,
which can flip a bf16 rounding of h: tolerance 1e-2 of the largest output.
`kernel_weights` is read back by the CUDA kernel's own addressing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.models.vggt.heads import _interp_matrix
from vggt_slam_tpu.ops import dpt_tail as jtail
from vggt_slam_tpu_torch.ops import dpt_tail as ttail


def _inputs(cout, seed=0, S=2, w8=64, W=112):
    rng = np.random.default_rng(seed)
    h8, cin, cmid = 224, 8, 16
    H = 392
    return dict(
        x=rng.normal(size=(S, h8, w8, cin)).astype(np.float32),
        pos=(rng.normal(size=(H, W, cin)) * 0.1).astype(np.float32),
        w0=(rng.normal(size=(3, 3, cin, cmid)) * 0.1).astype(np.float32),
        b0=rng.normal(size=(cmid,)).astype(np.float32),
        w1=(rng.normal(size=(1, 1, cmid, cout)) * 0.3).astype(np.float32),
        b1=rng.normal(size=(cout,)).astype(np.float32))


def test_supported_matches_reference():
    for rows in ((224, 392), (208, 364), (296, 518), (112, 196), (56, 98)):
        assert ttail.supported(*rows) == jtail.supported(*rows)


def test_upsample_columns_matches_reference_einsum():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64, 3)).astype(np.float32)
    want = jnp.einsum("shwc,Ww->shWc", jnp.asarray(x),
                      jnp.asarray(_interp_matrix(64, 112)))
    np.testing.assert_allclose(
        ttail.interp_matrix(64, 112).numpy(), _interp_matrix(64, 112))
    np.testing.assert_allclose(
        ttail.upsample_columns(torch.from_numpy(x), 112).numpy(),
        np.asarray(want), atol=1e-6, rtol=0)


# (cout, dtype, S, w8 -> W): rows 224 -> 392, the geometry `supported`
# takes; the edge cases a narrow W that is no multiple of 8, one frame,
# cout 1 and 3.
_CASES = [pytest.param(c, d, 2, 64, 112, id=f"{c}-{d}")
          for d in ("f32", "bf16") for c in (2, 4)] + [
    pytest.param(c, d, S, 21, 37, id=f"{c}-{d}-S{S}-W37")
    for c, d, S in ((1, "f32", 1), (3, "bf16", 1), (3, "f32", 2),
                    (1, "bf16", 2))]


@pytest.mark.parametrize("cout,dtype,S,w8,W", _CASES)
def test_fused_tail_ref_matches_reference_kernel(cout, dtype, S, w8, W):
    a = _inputs(cout, S=S, w8=w8, W=W)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    Aw = jnp.asarray(_interp_matrix(w8, W), jnp.float32)
    x_cols = jnp.einsum("shwc,Ww->shWc", jnp.asarray(a["x"]), Aw).astype(jd)
    want = np.asarray(jtail.fused_tail(
        x_cols, jnp.asarray(a["pos"]), jnp.asarray(a["w0"]),
        jnp.asarray(a["b0"]), jnp.asarray(a["w1"]), jnp.asarray(a["b1"]),
        interpret=True))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tx = ttail.upsample_columns(t["x"], W).to(td)
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(x_cols.astype(jnp.float32)))
    got = ttail.fused_tail_ref(tx, t["pos"], t["w0"], t["b0"], t["w1"],
                               t["b1"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 2e-4 if dtype == "f32" else 1e-2 * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    # the wrapper takes the plain version on the CPU and counts no launch
    before = dict(ttail.LAUNCHES)
    out = ttail.fused_tail(tx, t["pos"], t["w0"], t["b0"], t["w1"], t["b1"])
    assert ttail.LAUNCHES == before
    np.testing.assert_array_equal(out.numpy(), got.numpy())


@pytest.mark.parametrize("cin", [32, 128])
def test_kernel_weights_are_the_kernels_b_operand(cin):
    """`kernel_weights` read back as the kernel reads it: B (N 96 = (dr, m),
    K = (dc, ci)) in the no-swizzle K-major layout, element (n, k) at byte
    (k / 8) 1536 + 16 n + 2 (k % 8), equals w0[dr, dc, ci, m] in bf16."""
    rng = np.random.default_rng(cin)
    w0 = torch.from_numpy(rng.normal(size=(3, 3, cin, 32)).astype(np.float32))
    got = ttail.kernel_weights(w0)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == (3 * cin // 8, 96, 8)
    dr, dc, ci, m = np.meshgrid(np.arange(3), np.arange(3), np.arange(cin),
                                np.arange(32), indexing="ij")
    n, k = 32 * dr + m, dc * cin + ci
    off = ((k // 8) * 1536 + 16 * n + 2 * (k % 8)) // 2
    np.testing.assert_array_equal(
        got.reshape(-1)[torch.from_numpy(off)].float().numpy(),
        w0.bfloat16()[dr, dc, ci, m].float().numpy())


def test_fused_tail_refuses_unsupported_rows():
    x = torch.zeros(1, 208, 16, 8)
    with pytest.raises(ValueError, match="unsupported"):
        ttail.fused_tail(x, torch.zeros(364, 16, 8), torch.zeros(3, 3, 8, 32),
                         torch.zeros(32), torch.zeros(1, 1, 32, 2),
                         torch.zeros(2))
