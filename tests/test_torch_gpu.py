"""The CUDA kernels against their plain versions, on the card.

Marked `gpu`; without a CUDA device each test skips with that reason (the
decision is taken inside the fixture, never at import). On the card:
    python -m pytest tests/test_torch_gpu.py
Tolerance 2e-2 on bf16 outputs: the bf16 output rounding (2^-9 relative)
and the bf16 rounding of the softmax weights before PV.
"""
import numpy as np
import pytest
import torch

from vggt_slam_tpu_torch.ops import attention as A

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


@pytest.mark.parametrize("D", [64, 128])
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


@pytest.mark.parametrize("D", [64, 128])
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


def test_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 16, 96, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        A.flash_single(q, q, q, num_heads=2)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        A.flash_single(qb, qb, qb, num_heads=3)
