"""The port's SLAM layer against the JAX reference on the CPU: the torch
keyframe tracker against keyframe_jax.py (points 1e-3 px; other
interpolation orders, 30 iterations deep) and a tiny-config `run_slam`
against the reference CLI on the same folder and weights (poses 1e-4).
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.slam import keyframe_jax as jkf
from vggt_slam_tpu_torch.slam import keyframe_torch as tkf
from vggt_slam_tpu_torch.slam.keyframe import FrameTracker, bgr_to_gray

jax.config.update("jax_enable_x64", True)


def _texture(seed=0, shape=(200, 320)):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(shape[0] // 13, shape[1] // 13))
    return cv2.resize(base.astype(np.float32), shape[::-1],
                      interpolation=cv2.INTER_CUBIC)


def test_bgr_to_gray_matches_opencv():
    img = np.random.default_rng(1).integers(0, 256, (40, 50, 3), np.uint8)
    np.testing.assert_array_equal(bgr_to_gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


def test_shi_tomasi_matches_reference():
    tex = _texture()
    jp, jv = jkf.shi_tomasi(jnp.asarray(tex), max_corners=300)
    tp, tv = tkf.shi_tomasi(torch.from_numpy(tex), max_corners=300)
    want = np.asarray(jp)[np.asarray(jv)]
    got = tp[tv].numpy()
    assert len(got) == len(want) > 100

    def key(p):
        return p[np.lexsort((p[:, 0], p[:, 1]))]

    np.testing.assert_array_equal(key(got), key(want))


def test_lk_track_matches_reference():
    tex = _texture(2)
    M = np.float32([[1, 0, 6.5], [0, 1, -3.25]])
    tex2 = cv2.warpAffine(tex, M, tex.shape[::-1])
    xs, ys = np.meshgrid(np.arange(30, 290, 24), np.arange(30, 170, 24))
    pts = np.zeros((128, 2), np.float32)
    n = xs.size
    pts[:n] = np.stack([xs.ravel(), ys.ravel()], -1)
    valid = np.arange(128) < n
    jn, js = jkf.lk_track(jnp.asarray(tex), jnp.asarray(tex2),
                          jnp.asarray(pts), jnp.asarray(valid))
    tn, ts = tkf.lk_track(torch.from_numpy(tex), torch.from_numpy(tex2),
                          torch.from_numpy(pts), torch.from_numpy(valid))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tn.numpy()[:n], np.asarray(jn)[:n], atol=1e-3)
    np.testing.assert_allclose(np.median(tn.numpy()[:n] - pts[:n], 0),
                               [6.5, -3.25], atol=0.05)


def _pan_frames(n, step, hw=(56, 518), seed=0):
    """BGR uint8 frames of a viewport panning right over a texture."""
    tex = _texture(seed, (hw[0] + 40, hw[1] + step * n + 40))
    tex = np.clip(tex, 0, 255).astype(np.uint8)
    return [np.repeat(tex[20:20 + hw[0], 20 + i * step:20 + i * step
                          + hw[1], None], 3, axis=2) for i in range(n)]


def test_torch_keyframe_gate_matches_jax_backend():
    from vggt_slam_tpu.slam.keyframe import FrameTracker as JTracker

    frames = _pan_frames(8, 9, hw=(120, 200))
    jt = JTracker(backend="jax", max_corners=200)
    tt = FrameTracker(backend="torch", max_corners=200)
    jd = [jt.compute_disparity(f, 15.0) for f in frames]
    td = [tt.compute_disparity(f, 15.0) for f in frames]
    assert td == jd
    assert 2 <= sum(td) < len(td)


@pytest.mark.slow   # ~55 s: the reference compiles its forward and LM
def test_run_slam_tiny_matches_reference_cli(tmp_path, monkeypatch):
    """Both CLIs' run_slam over one image folder with the same tiny random
    weights, the cv2 keyframe gate and the same RANSAC samples: the
    submaps and every world pose agree."""
    from vggt_slam_tpu import main as jmain
    from vggt_slam_tpu.models.vggt.convert import _flatten
    from vggt_slam_tpu.models.vggt.model import VGGT as JVGGT
    from vggt_slam_tpu.models.vggt.model import \
        make_bucketed_model_fn as jax_model_fn
    from vggt_slam_tpu.ops import homography as jhom
    from vggt_slam_tpu.ops import lie as jlie
    from vggt_slam_tpu.slam import solver as jsolver
    from vggt_slam_tpu_torch import main as tmain
    from vggt_slam_tpu_torch.models.vggt.convert import load_flax_params
    from vggt_slam_tpu_torch.models.vggt.model import VGGT, \
        make_bucketed_model_fn
    from vggt_slam_tpu_torch.ops import homography as thom
    from vggt_slam_tpu_torch.slam import solver as tsolver

    folder = tmp_path / "images"
    folder.mkdir()
    for i, f in enumerate(_pan_frames(6, 60)):
        cv2.imwrite(str(folder / f"{i:04d}.png"), f)
    argv = ["--image_folder", str(folder), "--model_size", "tiny",
            "--submap_size", "2", "--max_loops", "0",
            "--min_disparity", "20", "--keyframe_backend", "cv2"]
    jargs = jmain.parser.parse_args(argv + ["--platform", "cpu"])
    targs = tmain.parser.parse_args(argv)

    from vggt_slam_tpu.models.vggt.config import VGGTConfig as JConfig
    jm = JVGGT(JConfig.tiny(img_size=518, global_kv_stride=8,
                            enable_point_head=False))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 3, 56, 518)))
    tm = VGGT(tmain.make_config(targs))
    tm.load_state_dict(load_flax_params(_flatten(params)), strict=True)
    bucket = 2 + 1 + 0

    samples = {}

    def indices(side, n):
        k = samples.setdefault(side, 0)
        samples[side] = k + 1
        return np.random.default_rng(100 + k).integers(0, n, (300, 5))

    def jax_ransac(X1, X2, weights=None, *, key, threshold=0.01, **_):
        idx = indices("jax", X1.shape[0])
        X1, X2 = X1.astype(jnp.float32), X2.astype(jnp.float32)
        w = (jnp.ones(X1.shape[0]) if weights is None else weights)
        H_ests = jhom.estimate_3d_homography(X1[idx], X2[idx])
        err = jnp.linalg.norm(jlie.apply_homography(H_ests, X1[None])
                              - X2[None], axis=-1)
        inl = ((jnp.where(jnp.isfinite(err), err, jnp.inf) < threshold)
               * w[None]).sum(-1)
        best = jnp.argmax(inl)
        return H_ests[best], inl[best]

    def torch_ransac(X1, X2, weights=None, **kw):
        kw.pop("generator", None)
        idx = torch.from_numpy(indices("torch", X1.shape[0]))
        return thom.ransac_projective(X1, X2, weights, indices=idx, **kw)

    monkeypatch.setattr(jsolver, "ransac_projective", jax_ransac)
    monkeypatch.setattr(tsolver, "ransac_projective", torch_ransac)
    jres = jmain.run_slam(jargs, model_fn=jax_model_fn(
        jm, params, bucket, as_numpy=False, with_unprojection=True))
    tres = tmain.run_slam(targs, model_fn=make_bucketed_model_fn(
        tm, bucket, as_numpy=False, with_unprojection=True, device="cpu"),
        device="cpu")
    jmap, tmap = jres["solver"].map, tres["solver"].map
    assert tmap.get_num_submaps() == jmap.get_num_submaps() >= 2
    assert samples["torch"] == samples["jax"] >= 2
    for js, ts in zip(jmap.ordered_submaps_by_key(),
                      tmap.ordered_submaps_by_key()):
        assert ts.get_frame_ids() == js.get_frame_ids()
        np.testing.assert_allclose(ts.get_reference_homography(),
                                   js.get_reference_homography(), atol=1e-4)
        np.testing.assert_allclose(ts.get_all_poses_world(),
                                   js.get_all_poses_world(), atol=1e-4)
    assert os.listdir(folder)
