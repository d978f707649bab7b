"""The port's fused DPT tail (vggt_slam_tpu_torch/ops/dpt_tail.py) against
the JAX reference on the CPU.

`fused_tail_ref`, the plain version of the CUDA kernel, is held against the
reference's Pallas `fused_tail` in interpret mode at the shapes of
tests/test_dpt_tail.py:44-56 (rows 224 -> 392, width 112, cin 8, cmid 16),
cout 2 and 4, atol 2e-4 in f32 (the reference's own tolerance for the
fused kernel against XLA's chain). In bf16 both sides round u, the conv
weights and h at the same places, so what differs is f32 summation order,
which can flip a bf16 rounding of h: tolerance 1e-2 of the largest output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.models.vggt.heads import _interp_matrix
from vggt_slam_tpu.ops import dpt_tail as jtail
from vggt_slam_tpu_torch.ops import dpt_tail as ttail


def _inputs(cout, seed=0):
    rng = np.random.default_rng(seed)
    S, h8, w8, cin, cmid = 2, 224, 64, 8, 16
    H, W = 392, 112
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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cout", [2, 4])
def test_fused_tail_ref_matches_reference_kernel(cout, dtype):
    a = _inputs(cout)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    Aw = jnp.asarray(_interp_matrix(64, 112), jnp.float32)
    x_cols = jnp.einsum("shwc,Ww->shWc", jnp.asarray(a["x"]), Aw).astype(jd)
    want = np.asarray(jtail.fused_tail(
        x_cols, jnp.asarray(a["pos"]), jnp.asarray(a["w0"]),
        jnp.asarray(a["b0"]), jnp.asarray(a["w1"]), jnp.asarray(a["b1"]),
        interpret=True))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tx = ttail.upsample_columns(t["x"], 112).to(td)
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


def test_fused_tail_refuses_unsupported_rows():
    x = torch.zeros(1, 208, 16, 8)
    with pytest.raises(ValueError, match="unsupported"):
        ttail.fused_tail(x, torch.zeros(364, 16, 8), torch.zeros(3, 3, 8, 32),
                         torch.zeros(32), torch.zeros(1, 1, 32, 2),
                         torch.zeros(2))
