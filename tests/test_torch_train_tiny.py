"""The port's trainer (tools/train_tiny.py) and its data (tools/synth3d.py)
against the JAX reference on the CPU.

* The schedule against optax's warmup_cosine_decay_schedule (1e-5
  relative: optax evaluates it in float32).
* The optimizer chain against the reference's optax chain over three
  updates: 1e-6 relative (AdamW's decay and the clip scale round
  differently in torch and optax).
* synth3d.training_batch for two seeds: pose encodings bit-equal; images
  2e-4 and depth 1e-6 relative against the reference's OpenCV resize,
  blur and remap.
* train_tiny end to end on the CPU (log, checkpoints, resume), and its
  refusal to run without a card unless asked.
* `<stem>_opt.npz` across packages both ways on the tiny VGGT's tree:
  moments and the next update equal to 1e-6 relative.
"""
import json

import jax

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vggt_slam_tpu.models.vggt.config import VGGTConfig as JConfig
from vggt_slam_tpu.models.vggt.convert import _flatten
from vggt_slam_tpu.models.vggt.model import VGGT as JVGGT
from vggt_slam_tpu.tools import synth3d as jsynth
from vggt_slam_tpu.tools import train_tiny as jtrain
from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
from vggt_slam_tpu_torch.models.vggt.convert import flax_key_to_torch, \
    load_flax_params
from vggt_slam_tpu_torch.models.vggt.model import VGGT
from vggt_slam_tpu_torch.tools import synth3d, train_tiny


def test_schedule_matches_optax():
    for lr, warmup, steps in ((3e-4, 200, 8000), (1e-3, 3, 10)):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup, max(steps, warmup + 1), lr * 1e-2)
        for c in list(range(0, 2 * warmup + 3)) + [steps - 1, steps,
                                                   steps + 5]:
            assert train_tiny.warmup_cosine(
                c, lr, warmup, max(steps, warmup + 1), lr * 1e-2) \
                == pytest.approx(float(sched(c)), rel=1e-5, abs=1e-12)


def test_optimizer_chain_matches_optax():
    rng = np.random.default_rng(4)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (s * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (3.0, 0.1, 2.0)]
    lr, wd, clip, warmup, steps = 1e-2, 0.01, 1.0, 2, 10
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(steps, warmup + 1), lr * 1e-2)
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(sched, weight_decay=wd))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)

    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    opt, lrs = train_tiny.make_optimizer(module, lr, wd, warmup, steps)
    for i, g in enumerate(grads):
        up, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                              state, jp)
        jp = optax.apply_updates(jp, up)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        train_tiny.clip_by_global_norm(list(module.parameters()), clip)
        opt.step()
        lrs.step()
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} after update {i + 1}")
        if i == 0:   # the first update has lr 0: params unchanged
            for k, p in module.items():
                np.testing.assert_array_equal(p.detach().numpy(), params[k])


@pytest.mark.parametrize("seed", [3, 8])
def test_synth3d_training_batch_matches_reference(seed):
    want = jsynth.training_batch(seed, n_frames=2, image_hw=(48, 64))
    got = synth3d.training_batch(seed, n_frames=2, image_hw=(48, 64))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["pose_enc_gt"], want["pose_enc_gt"])
    np.testing.assert_allclose(got["images"], want["images"], atol=2e-4,
                               rtol=0)
    np.testing.assert_allclose(got["depth_gt"], want["depth_gt"], rtol=1e-6,
                               atol=0)


def _run(out, *extra):
    train_tiny.main(["--out", str(out), "--model_size", "tiny",
                     "--frames", "2", "--image_hw", "28", "42",
                     "--val_every", "1", "--ckpt_every", "1", "--warmup",
                     "1", "--device", "cpu", *extra])


def test_train_tiny_cpu_run_and_resume(tmp_path):
    _run(tmp_path / "a", "--steps", "2")
    log = [json.loads(ln) for ln in
           (tmp_path / "a" / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log if "loss" in r] == [1]
    assert [r["step"] for r in log if "val_loss" in r] == [1, 2]
    for name in ("checkpoint.npz", "last.npz", "last_opt.npz",
                 "checkpoint_meta.json"):
        assert (tmp_path / "a" / name).exists()
    # Resume to step 3 against an uninterrupted 3-step run: the same
    # parameters, so the optimizer moments, the schedule's position and
    # the batch stream all continued.
    _run(tmp_path / "a", "--steps", "3", "--resume",
         str(tmp_path / "a" / "last.npz"))
    _run(tmp_path / "b", "--steps", "3")
    steps_a = [json.loads(ln)["step"] for ln in
               (tmp_path / "a" / "train_log.jsonl").read_text().splitlines()]
    assert steps_a[-1] == 3
    with np.load(tmp_path / "a" / "last_opt.npz") as state:
        assert int(state["step"]) == 3 and int(state["leaf_0"]) == 3
    with np.load(tmp_path / "a" / "last.npz") as a, \
            np.load(tmp_path / "b" / "last.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6,
                                       err_msg=k)


def test_train_tiny_needs_a_card_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_tiny.parser.parse_args(["--out", "x"]).device == "cuda"
    assert train_tiny.parser.parse_args(["--out", "x"]).attn_impl == \
        "flash_grad"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tiny.main(["--out", str(tmp_path / "x"), "--steps", "1"])


@pytest.fixture(scope="module")
def tiny_params():
    jm = JVGGT(JConfig.tiny(enable_point_head=False))
    return jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((2, 3, 28, 42)))


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_optimizer_state_crosses_packages(tmp_path, tiny_params, direction):
    """Two updates on one side, its `_opt.npz` read by the other, then one
    more update on both from the same gradients."""
    lr, wd, clip, warmup, steps = 1e-2, 0.01, 1.0, 1, 10
    params = tiny_params
    flat = _flatten(params)
    rng = np.random.default_rng(11)
    grads = [{k: rng.normal(size=np.shape(v)).astype(np.float32)
              for k, v in flat.items()} for _ in range(3)]
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(steps, warmup + 1), lr * 1e-2)
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(sched, weight_decay=wd))
    update = jax.jit(tx.update)

    def tree(g):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(g["/".join(
                p.key for p in path)]), params)

    def port_model():
        tm = VGGT(VGGTConfig.tiny(enable_point_head=False))
        tm.load_state_dict(load_flax_params(flat), strict=True)
        opt, lrs = train_tiny.make_optimizer(tm, lr, wd, warmup, steps)
        return tm, opt, lrs

    def port_update(tm, opt, lrs, g):
        named = dict(tm.named_parameters())
        for k, v in g.items():
            named[flax_key_to_torch(k)].grad = torch.from_numpy(v.copy())
        train_tiny.clip_by_global_norm(list(tm.parameters()), clip)
        opt.step()
        lrs.step()

    path = str(tmp_path / "last_opt.npz")
    jp, state = params, tx.init(params)
    tm, opt, lrs = port_model()
    if direction == "reference_to_port":
        for g in grads[:2]:
            up, state = update(tree(g), state, jp)
            jp = optax.apply_updates(jp, up)
        jtrain.save_train_state(state, 2, path)
        tm.load_state_dict(load_flax_params(_flatten(jp)), strict=True)
        assert train_tiny.load_train_state(opt, lrs, tm, path) == 2
        assert lrs.last_epoch == 2
    else:
        for g in grads[:2]:
            port_update(tm, opt, lrs, g)
        train_tiny.save_train_state(opt, lrs, tm, 2, path)
        state, step = jtrain.load_train_state(tx.init(params), path)
        assert step == 2
        jp = jax.tree_util.tree_map_with_path(
            lambda p_, _: jnp.asarray(dict(tm.named_parameters())[
                flax_key_to_torch("/".join(k.key for k in p_))]
                .detach().numpy()), params)
    adam = state[1][0]
    assert int(adam.count) == 2 and int(state[1][2].count) == 2
    named = dict(tm.named_parameters())
    for key, mu in _flatten(adam.mu).items():
        st = opt.state[named[flax_key_to_torch(key)]]
        assert int(st["step"]) == 2
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(mu),
                                   rtol=0, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(
            st["exp_avg_sq"].numpy(), np.asarray(_flatten(adam.nu)[key]),
            rtol=0, atol=1e-6, err_msg=key)
    up, state = update(tree(grads[2]), state, jp)
    jp = optax.apply_updates(jp, up)
    port_update(tm, opt, lrs, grads[2])
    for key, want in _flatten(jp).items():
        np.testing.assert_allclose(
            named[flax_key_to_torch(key)].detach().numpy(), np.asarray(want),
            rtol=1e-6, atol=1e-7, err_msg=key)
