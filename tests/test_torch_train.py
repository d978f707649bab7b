"""The port's training slice against the JAX reference on the CPU: the tiny
VGGT with the reference's initial weights, loss 1e-5 relative and each
gradient leaf 1e-4 of its largest entry against
`jax.value_and_grad(vggt_loss)`; remat against none (1e-6); the port's
checkpoint in the reference's loader (5e-5); make_train_step.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.models.vggt.config import VGGTConfig as JConfig
from vggt_slam_tpu.models.vggt.convert import _flatten
from vggt_slam_tpu.models.vggt.convert import load_checkpoint as jload
from vggt_slam_tpu.models.vggt.model import VGGT as JVGGT
from vggt_slam_tpu.parallel.train import vggt_loss as jloss
from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
from vggt_slam_tpu_torch.models.vggt.convert import (flax_key_to_torch,
                                                     init_params,
                                                     load_flax_params,
                                                     save_checkpoint)
from vggt_slam_tpu_torch.models.vggt.model import VGGT
from vggt_slam_tpu_torch.parallel.train import (make_dryrun_batch,
                                                make_train_step, vggt_loss)

S, H, W = 2, 56, 70
TRAIN = dict(global_kv_stride=1, enable_point_head=False)


@pytest.fixture(scope="module")
def jax_params():
    """Reference initial weights of the tiny model (its structure does not
    depend on the attention implementation)."""
    return jax.jit(JVGGT(JConfig.tiny(**TRAIN)).init)(
        jax.random.PRNGKey(0), jnp.zeros((S, 3, H, W)))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.uniform(0, 1, (S, 3, H, W)).astype(np.float32),
            "pose_enc_gt": rng.normal(size=(S, 9)).astype(np.float32),
            "depth_gt": rng.uniform(1, 3, (S, H, W)).astype(np.float32)}


def _port_model(jax_params, **overrides):
    kw = dict(attn_impl="flash_grad", remat=True, **TRAIN)
    cfg = VGGTConfig.tiny(**{**kw, **overrides})
    model = VGGT(cfg)
    model.load_state_dict(load_flax_params(_flatten(jax_params)),
                          strict=True)
    return model


def _port_loss_and_grads(model, batch):
    loss = vggt_loss(model, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def test_tiny_training_loss_and_grads_match_reference(jax_params):
    cfg = JConfig.tiny(attn_impl="flash_grad", remat=True, **TRAIN)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(cfg, p, jbatch)))(jax_params)
    loss, grads = _port_loss_and_grads(_port_model(jax_params), batch)
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = {flax_key_to_torch(k): v
            for k, v in _flatten(want_grads).items()}
    assert set(want) == set(grads)
    for name, g in grads.items():
        w = np.asarray(want[name])
        np.testing.assert_allclose(
            g, w, rtol=0, atol=1e-4 * max(float(np.abs(w).max()), 1e-30),
            err_msg=name)


def test_remat_matches_no_remat(jax_params):
    batch = _batch(1)
    loss_r, grads_r = _port_loss_and_grads(_port_model(jax_params), batch)
    loss_n, grads_n = _port_loss_and_grads(
        _port_model(jax_params, remat=False), batch)
    assert loss_r == pytest.approx(loss_n, rel=1e-6)
    for name in grads_r:
        np.testing.assert_allclose(grads_r[name], grads_n[name], rtol=0,
                                   atol=1e-6 * max(
                                       float(np.abs(grads_n[name]).max()),
                                       1e-30), err_msg=name)


def test_save_checkpoint_loads_in_reference(jax_params, tmp_path):
    cfg = VGGTConfig.tiny(**TRAIN)
    sd = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    model = VGGT(cfg)
    model.load_state_dict(sd, strict=True)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(model.state_dict(), path)
    restored = jload(path, jax_params)
    images = _batch(2)["images"]
    want = jax.jit(JVGGT(JConfig.tiny(**TRAIN)).apply)(restored,
                                                       jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    for k in ("pose_enc", "depth", "depth_conf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-5, rtol=0, err_msg=k)


def test_make_train_step_lowers_the_loss_on_a_fixed_batch(jax_params):
    model = _port_model(jax_params)
    step, opt = make_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-3))
    batch = make_dryrun_batch(model.cfg, S, (H, W))
    batch.pop("points_gt")
    losses = [float(step(batch)) for _ in range(3)]
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    assert isinstance(make_train_step(model)[1], torch.optim.AdamW)
