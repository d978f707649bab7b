"""Loop closure in the port against the reference on the CPU: the TUM
writer, the trajectory evals (1e-12, the same float64 code), the SLAM
checkpoint both ways (arrays bit-equal, graph nodes 1e-14), and the CLI
with the tiny retrieval backend on a synthetic loop (world poses 1e-3
over a 12-submap loop; the trained small model's ATE 1e-2 m).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fake_vggt import FakeVGGT, circular_trajectory, default_K
from vggt_slam_tpu.models.vggt.config import VGGTConfig as JConfig
from vggt_slam_tpu.models.vggt.model import VGGT as JVGGT
from vggt_slam_tpu.tools import synth3d as J
from vggt_slam_tpu_torch import main as tmain
from vggt_slam_tpu_torch.data.images import read_png
from vggt_slam_tpu_torch.slam import checkpoint
from vggt_slam_tpu_torch.slam.loop_closure import ImageRetrieval
from vggt_slam_tpu_torch.slam.solver import Solver
from vggt_slam_tpu_torch.tools import synth3d as T
from vggt_slam_tpu_torch.tools.synth3d import write_tum_sequence

IMAGE_HW = (28, 42)


# The TUM writer

def _same_sequence(a_dir, b_dir, a_names, b_names):
    import cv2

    with open(os.path.join(a_dir, "groundtruth.txt"), "rb") as f:
        gt = f.read()
    with open(os.path.join(b_dir, "groundtruth.txt"), "rb") as f:
        assert f.read() == gt
    assert [os.path.basename(n) for n in a_names] == \
        [os.path.basename(n) for n in b_names]
    for a, b in zip(a_names, b_names):
        np.testing.assert_array_equal(read_png(b), cv2.imread(a))


def test_tum_writer_matches_reference(tmp_path):
    kw = dict(n_frames=4, seed=3, image_hw=(56, 70), ng=256)
    a = J.write_tum_sequence(str(tmp_path / "ref"), **kw)
    b = T.write_tum_sequence(str(tmp_path / "port"), **kw)
    _same_sequence(str(tmp_path / "ref"), str(tmp_path / "port"), a, b)


def test_tum_writer_at_full_size_with_one_renderer(tmp_path, monkeypatch):
    """At 392x518 the two renderers differ by one level at ~20 of 609,168
    values a frame (OpenCV's sum order); with the port's renderer under both
    writers the PNGs decode alike and the ground truth is byte-equal."""

    monkeypatch.setattr(J, "make_scene", T.make_scene)
    monkeypatch.setattr(J, "render", T.render)
    kw = dict(n_frames=2, seed=4_000_000, image_hw=(392, 518))
    a = J.write_tum_sequence(str(tmp_path / "ref"), **kw)
    b = T.write_tum_sequence(str(tmp_path / "port"), **kw)
    _same_sequence(str(tmp_path / "ref"), str(tmp_path / "port"), a, b)


# Evals

def _trajectories(seed, n=60):
    """A TUM ground truth and a Sim(3)-warped, noisy, re-timed estimate
    with missing rows."""
    from vggt_slam_tpu_torch.tools.synth3d import rotation_rpy

    rng = np.random.default_rng(seed)
    t = 1000.0 + np.arange(n) / 30.0
    xyz = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    gt = np.column_stack([t, xyz, q])
    R = rotation_rpy(*rng.uniform(-1, 1, 3))
    s, off = rng.uniform(0.3, 3.0), rng.normal(size=3)
    est_xyz = s * xyz @ R.T + off + rng.normal(0, 0.01, (n, 3))
    keep = np.sort(rng.choice(n, n - 7, replace=False))
    jitter = rng.uniform(-0.004, 0.004, n)
    est = np.column_stack([t + jitter, est_xyz, q])[keep]
    return gt, est[rng.permutation(len(est))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ate_associate_umeyama_match_reference(seed, tmp_path):
    from vggt_slam_tpu.evals import ate as JA
    from vggt_slam_tpu.slam import alignment as JAL
    from vggt_slam_tpu_torch.evals import ate as TA
    from vggt_slam_tpu_torch.slam import alignment as TAL

    gt, est = _trajectories(seed)
    est_sorted = est[np.argsort(est[:, 0])]
    for a, b in zip(TA.associate(gt[:, 0], est_sorted[:, 0]),
                    JA.associate(gt[:, 0], est_sorted[:, 0])):
        np.testing.assert_array_equal(a, b)
    src, dst = est[:10, 1:4], gt[:10, 1:4]
    for with_scale in (True, False):
        got = TAL.umeyama_sim3_np(src, dst, with_scale)
        want = JAL.umeyama_sim3_np(src, dst, with_scale)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-12)
    for align_scale in (True, False):
        got = TA.ate(gt, est_sorted, align_scale)
        want = JA.ate(gt, est_sorted, align_scale)
        assert got.n_pairs == want.n_pairs >= 40
        for f in ("rmse", "mean", "median", "std", "max", "min", "scale"):
            assert abs(getattr(got, f) - getattr(want, f)) < 1e-12, f
    assert TA.ate(gt, est_sorted).rmse < 0.05     # the Sim(3) warp undone
    np.savetxt(tmp_path / "gt.txt", gt)
    np.savetxt(tmp_path / "est.txt", est)
    files = (str(tmp_path / "gt.txt"), str(tmp_path / "est.txt"))
    assert dataclasses.astuple(TA.ate_from_files(*files)) == \
        dataclasses.astuple(JA.ate_from_files(*files))


# The SLAM-state checkpoint

def cheap_descriptor(frames):
    f = np.asarray(frames).reshape(len(frames), -1)
    d = f @ np.random.default_rng(123).normal(size=(f.shape[1], 16))
    return d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-9)


def _run(frames_range, solver, model, frames):
    subset = []
    for i in frames_range:
        subset.append(i)
        if len(subset) == 4 or i == frames_range[-1]:
            preds = solver.run_predictions(
                np.stack([frames[j] for j in subset]), model, 0,
                names=[f"{j}.png" for j in subset])
            solver.add_points(preds)
            solver.graph.optimize()
            solver.map.update_submap_homographies(solver.graph)
            subset = subset[-1:]


def _ate(solver, w2c):
    from vggt_slam_tpu_torch.slam.alignment import rmse, umeyama_sim3_np

    pred, gt = [], []
    for s in solver.map.ordered_submaps_by_key():
        poses = s.get_all_poses_world(ignore_loop_closure_frames=True)
        for p, fid in zip(poses, s.get_frame_ids()):
            pred.append(p[:3, 3])
            gt.append(np.linalg.inv(w2c[int(fid)])[:3, 3])
    pred, gt = np.stack(pred), np.stack(gt)
    s_, R, t = umeyama_sim3_np(pred, gt)
    return rmse((s_ * (R @ pred.T)).T + t, gt)


def _assert_same_state(a, b):
    subs_a = a.map.ordered_submaps_by_key()
    subs_b = b.map.ordered_submaps_by_key()
    assert [s.get_id() for s in subs_a] == [s.get_id() for s in subs_b]
    for sa, sb in zip(subs_a, subs_b):
        for name in ("H_world_map", "poses", "frames", "vggt_intrinsics",
                     "retrieval_vectors", "colors", "conf", "conf_masks",
                     "pointclouds"):
            np.testing.assert_array_equal(getattr(sa, name),
                                          getattr(sb, name), err_msg=name)
        for name in ("conf_threshold", "last_non_loop_frame_index",
                     "frame_ids", "frame_names", "frame_id_to_name"):
            assert getattr(sa, name) == getattr(sb, name), name
    ga, gb = a.graph, b.graph
    assert ga._key_to_idx == gb._key_to_idx
    # a loader re-normalizes each node to det 1 (add_homography): 1 ulp
    np.testing.assert_allclose(np.stack(ga._values), np.stack(gb._values),
                               rtol=0, atol=1e-14)
    assert len(ga._between) == len(gb._between)
    for x, y in zip(ga._between + ga._priors, gb._between + gb._priors):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert ga.num_loop_closures == gb.num_loop_closures
    np.testing.assert_array_equal(a.prior_pcd, b.prior_pcd)
    np.testing.assert_array_equal(a.prior_conf, b.prior_conf)
    assert (a.first_edge, a.use_sim3, a.use_point_map,
            a.loop_inlier_thresh, list(a._seq_reg_fracs)) == \
        (b.first_edge, b.use_sim3, b.use_point_map, b.loop_inlier_thresh,
         list(b._seq_reg_fracs))


def test_checkpoint_round_trip_and_resume(tmp_path):
    """As tests/test_slam_e2e.py's resume case: run part of the
    trajectory, checkpoint, load, and keep mapping from the loaded state."""

    n = 7
    w2c = circular_trajectory(n)
    model = FakeVGGT(w2c, default_K(IMAGE_HW), image_hw=IMAGE_HW)
    frames = [model.make_image(i) for i in range(n)]
    s1 = Solver(loop_inlier_thresh=0.9,
                retrieval=ImageRetrieval(descriptor_fn=cheap_descriptor))
    _run(range(0, 4), s1, model, frames)
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save_state(s1, ckpt)
    assert sorted(os.listdir(ckpt)) == ["anchor.npz", "graph.npz",
                                        "manifest.json", "submap_0.npz"]
    s2 = checkpoint.load_state(
        ckpt, retrieval=ImageRetrieval(descriptor_fn=cheap_descriptor))
    _assert_same_state(s1, s2)
    model2 = FakeVGGT(w2c, default_K(IMAGE_HW), image_hw=IMAGE_HW)
    model2.calls = 1
    _run(range(3, 7), s2, model2, frames)
    assert s2.map.get_num_submaps() == s1.map.get_num_submaps() + 1
    assert _ate(s2, w2c) < 0.02


def test_checkpoint_crosses_packages(tmp_path):
    """A state the port saves loads in the reference's load_state; the
    reference's save of that state loads in the port's: arrays equal."""
    from vggt_slam_tpu.slam import checkpoint as jckpt

    w2c = circular_trajectory(7)
    model = FakeVGGT(w2c, default_K(IMAGE_HW), image_hw=IMAGE_HW)
    frames = [model.make_image(i) for i in range(7)]
    s1 = Solver(loop_inlier_thresh=0.9,
                retrieval=ImageRetrieval(descriptor_fn=cheap_descriptor))
    _run(range(7), s1, model, frames)
    checkpoint.save_state(s1, str(tmp_path / "port"))
    ref = jckpt.load_state(str(tmp_path / "port"))
    _assert_same_state(s1, ref)
    jckpt.save_state(ref, str(tmp_path / "ref"))
    back = checkpoint.load_state(str(tmp_path / "ref"))
    _assert_same_state(s1, back)
    assert type(back).__module__ == "vggt_slam_tpu_torch.slam.solver"


# The CLI on a synthetic loop

def test_cli_tiny_backend_flags_and_counts(tmp_path):
    """The port's CLI on a short synthetic loop with --retrieval_backend
    tiny: the counts it prints add up (detected = inserted + rejected)."""
    from vggt_slam_tpu_torch import main

    write_tum_sequence(str(tmp_path / "seq"), n_frames=5, seed=4_000_000,
                       image_hw=(56, 518), ng=512)
    args = main.parser.parse_args(
        ["--image_folder", str(tmp_path / "seq" / "rgb"), "--model_size",
         "tiny", "--submap_size", "2", "--max_loops", "2",
         "--min_disparity", "4", "--retrieval_backend", "tiny",
         "--log_results", "--skip_dense_log", "--log_path",
         str(tmp_path / "poses.txt")])
    solver = main.run_slam(args, device="cpu")["solver"]
    assert solver.detected_loop_count == \
        solver.graph.get_num_loops() + solver.rejected_loop_count
    assert solver.image_retrieval.trusted
    vecs = solver.map.get_latest_submap().get_all_retrieval_vectors()
    assert vecs.shape[1] == 256
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-5)
    assert np.loadtxt(tmp_path / "poses.txt").shape[1] == 8


def _same_ransac_samples(monkeypatch):
    """Both solvers' RANSAC on the same hypothesis samples (drawn from one
    seeded numpy stream per side, in call order), as tests/
    test_torch_slam.py does."""

    from vggt_slam_tpu.ops import homography as jhom
    from vggt_slam_tpu.ops import lie as jlie
    from vggt_slam_tpu.slam import solver as jsolver
    from vggt_slam_tpu_torch.ops import homography as thom
    from vggt_slam_tpu_torch.slam import solver as tsolver

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
    return samples


def _both_clis(argv, tmp_path, monkeypatch, model_fns=None):
    """Both packages' run_slam on one argv, the same RANSAC samples, the
    reference's pose graph in f64 as the port's (an f32 solve of random-weight
    SL(4) chains moves poses by 0.1); returns both solvers and TUM logs."""

    from vggt_slam_tpu import main as jmain

    jax.config.update("jax_enable_x64", True)

    samples = _same_ransac_samples(monkeypatch)
    logs = [str(tmp_path / f"{side}.txt") for side in ("ref", "port")]
    jargs = jmain.parser.parse_args(argv + ["--platform", "cpu",
                                            "--log_path", logs[0]])
    targs = tmain.parser.parse_args(argv + ["--device", "cpu",
                                            "--log_path", logs[1]])
    jm, tm = model_fns(targs) if model_fns else (None, None)
    jres = jmain.run_slam(jargs, model_fn=jm)
    tres = tmain.run_slam(targs, model_fn=tm, device="cpu")
    assert samples["torch"] == samples["jax"] >= 2
    return jres["solver"], tres["solver"], logs


def _assert_same_run(js, ts, atol):
    assert ts.map.get_num_submaps() == js.map.get_num_submaps() >= 3
    assert ts.detected_loop_count == ts.graph.get_num_loops() + \
        ts.rejected_loop_count
    assert ts.graph.get_num_loops() == js.graph.get_num_loops()
    assert ts.rejected_loop_count == js.rejected_loop_count
    for a, b in zip(js.map.ordered_submaps_by_key(),
                    ts.map.ordered_submaps_by_key()):
        assert b.get_frame_ids() == a.get_frame_ids()
        assert b.get_last_non_loop_frame_index() == \
            a.get_last_non_loop_frame_index()
        np.testing.assert_allclose(b.get_all_poses_world(),
                                   a.get_all_poses_world(), atol=atol)


@pytest.mark.slow   # ~3 min: the reference compiles its forward and LM
def test_cli_tiny_backend_loop_matches_reference(tmp_path, monkeypatch):
    """Both CLIs with --retrieval_backend tiny on one loop, the same tiny
    weights: the same loops detected, inserted and rejected, world poses within
    1e-3 (12 submaps chained through SL(4); poses and point maps agree to
    1e-5)."""

    from vggt_slam_tpu.models.vggt.convert import _flatten
    from vggt_slam_tpu.models.vggt.model import \
        make_bucketed_model_fn as jax_model_fn
    from vggt_slam_tpu_torch.models.vggt.convert import load_flax_params
    from vggt_slam_tpu_torch.models.vggt.model import VGGT, \
        make_bucketed_model_fn

    write_tum_sequence(str(tmp_path / "seq"), n_frames=24, seed=4_000_000,
                       image_hw=(56, 518), ng=512)
    argv = ["--image_folder", str(tmp_path / "seq" / "rgb"), "--model_size",
            "tiny", "--submap_size", "2", "--max_loops", "2",
            "--min_disparity", "4", "--retrieval_backend", "tiny",
            "--log_results", "--skip_dense_log"]

    def model_fns(targs):
        jm = JVGGT(JConfig.tiny(img_size=518, global_kv_stride=8,
                                enable_point_head=False))
        params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 3, 56, 518)))
        tm = VGGT(tmain.make_config(targs))
        tm.load_state_dict(load_flax_params(_flatten(params)), strict=True)
        bucket = 2 + 1 + 2
        return (jax_model_fn(jm, params, bucket, as_numpy=False,
                             with_unprojection=True),
                make_bucketed_model_fn(tm, bucket, as_numpy=False,
                                       with_unprojection=True, device="cpu"))

    js, ts, _ = _both_clis(argv, tmp_path, monkeypatch, model_fns)
    assert ts.detected_loop_count >= 1
    _assert_same_run(js, ts, 1e-3)


@pytest.mark.slow   # ~20 min on the CPU: 40 frames of the small model
def test_smoke_loop_accuracy_matches_reference(tmp_path, monkeypatch):
    """smoke_loop's sequence and settings with the trained small checkpoint
    through both CLIs in f32 on the same RANSAC samples: the same loops and
    gate fractions, the port's ATE under 0.5 m and within 1e-2 m of the
    reference's (not 1e-3: forwards agree to ~2e-6, but 5-point SL(4) fits land
    up to several % apart and 10 submaps chain them)."""

    from vggt_slam_tpu.evals.ate import ate_from_files as jate
    from vggt_slam_tpu.models.vggt.convert import load_checkpoint
    from vggt_slam_tpu.models.vggt.model import \
        make_bucketed_model_fn as jax_model_fn
    from vggt_slam_tpu_torch.evals import smoke_loop
    from vggt_slam_tpu_torch.evals.ate import ate_from_files
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn

    ckpt = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "warmcache", "small_synth", "checkpoint.npz")
    seq = str(tmp_path / "seq")
    write_tum_sequence(seq, n_frames=40, seed=smoke_loop.SEQ_SEED,
                       image_hw=(392, 518), kind="loop")
    argv = ["--image_folder", os.path.join(seq, "rgb"),
            "--retrieval_backend", "tiny", "--log_results",
            "--skip_dense_log", "--submap_size", "4", "--max_loops", "3",
            "--min_disparity", "8", "--model_size", "small",
            "--checkpoint", ckpt]

    def model_fns(targs):
        jm = JVGGT(JConfig.small(attn_impl="chunked", global_kv_stride=8,
                                 enable_point_head=False, dtype=jnp.float32))
        params = load_checkpoint(ckpt, jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 3, 392, 518))))
        cfg = dataclasses.replace(tmain.make_config(targs),
                                  dtype=torch.float32)
        tm = tmain.build_model(cfg, ckpt, device="cpu")
        bucket = 4 + 1 + 3
        return (jax_model_fn(jm, params, bucket, as_numpy=False,
                             with_unprojection=True),
                make_bucketed_model_fn(tm, bucket, as_numpy=False,
                                       with_unprojection=True, device="cpu"))

    js, ts, logs = _both_clis(argv, tmp_path, monkeypatch, model_fns)
    gt = os.path.join(seq, "groundtruth.txt")
    ref, port = jate(gt, logs[0]), ate_from_files(gt, logs[1])
    factors = [float(np.abs(np.asarray(a[2]) - b[2]).max()
                     / np.abs(b[2]).max())
               for a, b in zip(js.graph._between, ts.graph._between)]
    print(f"ATE RMSE port {port.rmse:.6f} m, reference {ref.rmse:.6f} m; "
          f"between factors {min(factors):.2e} to {max(factors):.2e} "
          f"apart (relative)")
    assert ts.graph.get_num_loops() == js.graph.get_num_loops() >= 1
    assert ts.rejected_loop_count == js.rejected_loop_count
    np.testing.assert_allclose(ts._seq_reg_fracs, js._seq_reg_fracs,
                               atol=1e-9)
    assert port.n_pairs == ref.n_pairs
    assert abs(port.rmse - ref.rmse) < 1e-2
    assert port.rmse < 0.5
