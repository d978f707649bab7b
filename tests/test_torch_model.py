"""The port's VGGT against the JAX reference on the CPU with the reference's
flax parameters (convert.load_flax_params), in f32 at tiny widths: 5e-5 on
O(1) outputs, 2e-4 relative on the O(100) intrinsics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.models.vggt import aggregator as jagg
from vggt_slam_tpu.models.vggt import modules as jmod
from vggt_slam_tpu.models.vggt.config import VGGTConfig as JConfig
from vggt_slam_tpu.models.vggt.convert import _flatten
from vggt_slam_tpu.models.vggt.model import VGGT as JVGGT
from vggt_slam_tpu.models.vggt.model import \
    make_bucketed_model_fn as jax_model_fn
from vggt_slam_tpu_torch.models.vggt import modules as tmod
from vggt_slam_tpu_torch.models.vggt.aggregator import merge_indices, \
    sim_merge
from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
from vggt_slam_tpu_torch.models.vggt.convert import load_checkpoint, \
    load_flax_params
from vggt_slam_tpu_torch.models.vggt.model import VGGT, \
    make_bucketed_model_fn
from vggt_slam_tpu_torch.models.vggt.vit import resize_pos_embed

TOL = 5e-5


def _load(module, flax_params):
    sd = load_flax_params(_flatten(flax_params))
    module.load_state_dict(sd, strict=True)
    return module


@pytest.mark.parametrize("rope,qk_norm,softmax", [
    (False, False, "online"),    # encoder block
    (True, True, "online"),      # frame block
    (True, True, "static"),      # global block, static softmax
])
def test_block_matches_reference(rope, qk_norm, softmax):
    rng = np.random.default_rng(0)
    B, N, C, H = 2, 37, 64, 2
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    kw = {}
    if rope:
        pos = jnp.asarray(rng.uniform(0, 10, size=(N, 2)), jnp.float32)
        kw = dict(zip(("rope_cos", "rope_sin"),
                      jmod.rope_2d_angles(pos, C // H, 100.0)))
    jb = jmod.Block(C, H, 4, layerscale=0.5, attn_impl="flash",
                    qk_norm=qk_norm, softmax_mode=softmax)
    params = jb.init(jax.random.PRNGKey(1), jnp.asarray(x), **kw)
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(2),
                                              p.shape), params)
    want = jb.apply(params, jnp.asarray(x), **kw)
    tb = _load(tmod.Block(C, H, 4, layerscale=0.5, qk_norm=qk_norm,
                          softmax_mode=softmax), params)
    tkw = {k: torch.from_numpy(np.array(v)) for k, v in kw.items()}
    got = tb(torch.from_numpy(x), **tkw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)


def test_rope_angles_and_apply_match_reference():
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 30, size=(50, 2)).astype(np.float32)
    x = rng.normal(size=(2, 50, 64)).astype(np.float32)
    jc, js = jmod.rope_2d_angles(jnp.asarray(pos), 64, 100.0)
    tc, ts = tmod.rope_2d_angles(torch.from_numpy(pos), 64, 100.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(
        tmod.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jmod.apply_rope(jnp.asarray(x), jc, js)), atol=1e-6)


@pytest.mark.parametrize("hw", [(28, 37), (37, 37), (20, 30), (40, 50)])
def test_pos_embed_resize_matches_jax_image_resize(hw):
    """392x518 input -> 28x37 grid: the learned 37x37 grid is shrunk along
    rows, which jax.image.resize antialiases. Tolerance 2e-5: with
    jax_enable_x64 on (other test modules turn it on process-wide) the
    reference computes its resize weights in f64, the port in f32."""
    pos = np.random.default_rng(2).normal(size=(1, 37, 37, 16)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(pos), (1,) + hw + (16,), "bilinear")
    got = resize_pos_embed(torch.from_numpy(pos), *hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_sim_merge_matrix_matches_reference(monkeypatch):
    """The FastVGGT merge matrix and log-count bias, captured from the
    reference aggregator and recomputed by the port from the same tokens
    entering global block 0 (assignment in f32)."""
    cfg = JConfig.tiny(global_kv_stride=4, global_merge="sim")
    S, H, W = 3, 56, 70
    images = np.random.default_rng(3).uniform(size=(S, 3, H, W)).astype(
        np.float32)
    agg = jagg.Aggregator(cfg)
    params = jax.jit(agg.init)(jax.random.PRNGKey(0), jnp.asarray(images))
    captured = {}
    real_barrier = jax.lax.optimization_barrier
    real_frame_block = jagg.Block.__call__

    def keep(**arrays):
        captured.update({k: np.asarray(v) for k, v in arrays.items()})

    def barrier(x):
        if isinstance(x, tuple):
            jax.debug.callback(lambda m, b: keep(M=m, bias=b), *x)
        return real_barrier(x)

    def frame_block(self, x, *a, **kw):
        out = real_frame_block(self, x, *a, **kw)
        if self.name == "frame_block_0":
            jax.debug.callback(lambda t: keep(x0=t), out)
        return out

    monkeypatch.setattr(jax.lax, "optimization_barrier", barrier)
    monkeypatch.setattr(jagg.Block, "__call__", frame_block)
    last = cfg.agg_depth - 1
    jax.block_until_ready(jax.jit(
        lambda p, x: agg.apply(p, x)[last])(params, jnp.asarray(images)))
    jax.effects_barrier()
    ns = cfg.tokens_per_frame_special
    x0 = torch.from_numpy(captured["x0"])
    dst, src = merge_indices(x0.shape[1] - ns, 4, "cpu")
    M, bias = sim_merge(x0, ns, dst, src, torch.float32)
    np.testing.assert_allclose(M.numpy(), np.asarray(captured["M"]),
                               atol=1e-6)
    np.testing.assert_allclose(bias.numpy(), np.asarray(captured["bias"]),
                               atol=1e-6)


def _tiny_pair(H, W, **overrides):
    # The reference's chunked attention: in f32 the same function as its
    # flash kernels (held to them in test_torch_attention.py), and fast on
    # the CPU.
    jm = JVGGT(JConfig.tiny(**overrides))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((2, 3, H, W)))
    tm = _load(VGGT(VGGTConfig.tiny(**overrides)), params)
    return jm, params, tm


@pytest.mark.parametrize("name,hw,S,bucket,overrides", [
    # The main path's settings at tiny width: 392x518 input, sim-merged
    # K/V, static softmax, a padded bucket, no point head.
    ("main_path_392x518", (392, 518), 2, 3,
     dict(global_kv_stride=8, enable_point_head=False)),
    # Exact attention with the running-max softmax, and the point head.
    ("exact_online_point_head", (56, 70), 3, 4,
     dict(global_kv_stride=1, global_softmax="online")),
])
def test_bucketed_forward_with_unprojection_matches_reference(
        name, hw, S, bucket, overrides):
    jm, params, tm = _tiny_pair(*hw, **overrides)
    images = np.random.default_rng(4).uniform(
        size=(S, 3) + hw).astype(np.float32)
    want = jax_model_fn(jm, params, bucket, as_numpy=True,
                        with_unprojection=True)(images)
    got = make_bucketed_model_fn(tm, bucket, as_numpy=True,
                                 with_unprojection=True,
                                 device="cpu")(images)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        scale = max(1.0, float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], atol=TOL * scale,
                                   rtol=0, err_msg=key)


def test_small_synth_checkpoint_forward_matches_reference():
    """The trained small_synth checkpoint through both forwards: the
    carrier fills every parameter and the outputs agree."""
    path = "warmcache/small_synth/checkpoint.npz"
    kw = dict(global_kv_stride=8, enable_point_head=False)
    tm = VGGT(VGGTConfig.small(dtype=torch.float32, **kw))
    tm.load_state_dict(load_checkpoint(path), strict=True)
    tree = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(data[key])
    jm = JVGGT(JConfig.small(dtype=jnp.float32, **kw))
    images = np.random.default_rng(5).uniform(size=(2, 3, 56, 98)).astype(
        np.float32)
    want = jax_model_fn(jm, tree, 3, as_numpy=True,
                        with_unprojection=True)(images)
    got = make_bucketed_model_fn(tm, 3, as_numpy=True,
                                 with_unprojection=True,
                                 device="cpu")(images)
    for key in want:
        scale = max(1.0, float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], atol=TOL * scale,
                                   rtol=0, err_msg=key)
