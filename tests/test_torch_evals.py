"""The port's host evals against the reference on the CPU: the native
KD-tree (distances 1e-6, indices exact, against the reference's and
cKDTree), geometry_eval (1e-6), process_logs without pandas (1e-12),
run_eval (helpers equal; one in-process tiny run) and pipeline_overlap's
helpers (equal).
"""
import csv
import os
import types
from argparse import Namespace

import numpy as np
import pytest
from scipy.spatial import cKDTree


def _clouds(seed, n=3000, m=800):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(-1.2, 1.2, (m, 3)).astype(np.float32))


def test_kdtree_matches_reference_and_ckdtree():
    from vggt_slam_tpu.native import kdtree as ref
    from vggt_slam_tpu_torch.native import kdtree
    from vggt_slam_tpu_torch.ops.cuda_build import BUILD_DIR

    assert kdtree.available() and ref.available()
    assert os.path.dirname(kdtree._LIB) == BUILD_DIR
    assert os.path.exists(kdtree._LIB)
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.dirname(kdtree._SRC)))
    pts, q = _clouds(0)
    d, i = kdtree.KDTree(pts).query(q)
    rd, ri = ref.KDTree(pts).query(q)
    sd, si = cKDTree(pts).query(q, k=1)
    assert d.dtype == np.float32 and i.dtype == np.int32
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(i, si)
    np.testing.assert_allclose(d, rd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d, sd, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        kdtree.KDTree(pts[:, :2])


@pytest.mark.parametrize("native", [True, False])
def test_geometry_eval_matches_reference(monkeypatch, native):
    from vggt_slam_tpu.evals import geometry_eval as ref
    from vggt_slam_tpu_torch.evals import geometry_eval as port

    if not native:      # the scipy path, as on a machine without g++
        monkeypatch.setattr(port._native, "available", lambda: False)
        monkeypatch.setattr(ref, "_USE_NATIVE", False)
    a, b = _clouds(1)
    np.testing.assert_allclose(port.nn_distances(a, b),
                               ref.nn_distances(a, b), rtol=0, atol=1e-6)
    cp, cr = port.chamfer(a, b), ref.chamfer(a, b)
    assert cp.keys() == cr.keys()
    for k in cr:
        assert abs(cp[k] - cr[k]) <= 1e-6, k

    rng = np.random.default_rng(2)
    th = 0.05
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    src = a[:1500].astype(np.float64)
    dst = src @ R.T + [0.02, -0.01, 0.03] + rng.normal(0, 1e-3, src.shape)
    T = port.icp_point_to_point(src, dst, max_corr_dist=0.2)
    np.testing.assert_allclose(
        T, ref.icp_point_to_point(src, dst, max_corr_dist=0.2),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(T[:3, :3], R, atol=5e-3)

    depth = rng.uniform(0.5, 12.0, (13, 17))
    depth[0, :3] = [0.0, np.nan, np.inf]
    K = np.array([[20.0, 0, 8.5], [0, 21.0, 6.0], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, :3] = R
    c2w[:3, 3] = [1, 2, 3]
    for stride in (1, 2):
        got = port.backproject_depth(depth, K, c2w, stride=stride)
        np.testing.assert_allclose(
            got, ref.backproject_depth(depth, K, c2w, stride=stride),
            rtol=0, atol=1e-6)
        assert np.isfinite(got).all()


def _write_csv(path, rows):
    keys = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def test_process_logs_matches_pandas(tmp_path):
    import pandas as pd

    from vggt_slam_tpu.evals.process_logs import summarize as ref_summarize
    from vggt_slam_tpu_torch.evals.process_logs import summarize, \
        summary_tables

    rng = np.random.default_rng(3)
    rows = []
    for seq, n in (("fr1_desk", 3), ("fr2_xyz", 4), ("office", 1)):
        for trial in range(n):
            rows.append({"sequence": seq, "trial": trial,
                         "ate_rmse": rng.uniform(0.01, 0.2),
                         "wall_s": rng.uniform(5, 50)})
    rows[1]["ate_rmse"] = ""                      # a failed association
    rows[4]["ate_error"] = "no pairs"
    path = str(tmp_path / "sweep.csv")
    _write_csv(path, rows)
    metrics = ("ate_rmse", "wall_s", "chamfer_rmse")
    want = ref_summarize(path, metrics)
    got = summarize(path, metrics)
    per_seq, per_trial, overall = summary_tables(path, metrics)
    assert list(got) == list(per_seq)
    assert list(got) == list(want.index)
    for seq, ms in got.items():
        assert list(ms) == ["ate_rmse", "wall_s"]
        for m, stats in ms.items():
            for k in ("mean", "std", "count"):
                np.testing.assert_allclose(stats[k], want.loc[seq, (m, k)],
                                           rtol=1e-12, equal_nan=True)
    assert np.isnan(got["office"]["ate_rmse"]["std"])      # one row: ddof 1
    df = pd.read_csv(path)
    trial_means = df.groupby("trial")[["ate_rmse", "wall_s"]].mean()
    assert [int(t) for t in per_trial] == list(trial_means.index)
    for t, ms in per_trial.items():
        for m, v in ms.items():
            np.testing.assert_allclose(v, trial_means.loc[int(t), m],
                                       rtol=1e-12)
    agg = df[["ate_rmse", "wall_s"]].agg(["mean", "std"])
    for m, s in overall.items():
        for k in ("mean", "std"):
            np.testing.assert_allclose(s[k], agg.loc[k, m], rtol=1e-12)


def _eval_args(**kw):
    base = dict(submap_size=16, max_loops=1, min_disparity=50,
                conf_threshold=25, loop_inlier_thresh=None,
                downsample_factor=1, use_sim3=False, checkpoint=None,
                model_size="1b", global_kv_stride=1, global_softmax=None,
                attn_impl=None, keyframe_backend=None,
                retrieval_backend=None, platform=None, device=None)
    base.update(kw)
    return Namespace(**base)


def test_run_eval_helpers_match_reference(tmp_path):
    from vggt_slam_tpu.evals import run_eval as ref
    from vggt_slam_tpu_torch.evals import run_eval as port

    seq = tmp_path / "seq"
    (seq / "images").mkdir(parents=True)
    for fn in ("find_gt_file", "find_image_dir"):
        assert getattr(port, fn)(str(seq)) == getattr(ref, fn)(str(seq))
    (seq / "gt.txt").write_text("")
    (seq / "rgb").mkdir()
    (seq / "groundtruth.txt").write_text("")
    for fn in ("find_gt_file", "find_image_dir"):
        assert getattr(port, fn)(str(seq)) == getattr(ref, fn)(str(seq))
    assert port.find_image_dir(str(tmp_path / "none")) == \
        ref.find_image_dir(str(tmp_path / "none"))
    for kw in ({}, dict(loop_inlier_thresh=0.0, use_sim3=True,
                        checkpoint="w.npz", downsample_factor=2,
                        model_size="tiny", global_kv_stride=8,
                        global_softmax="static", attn_impl="chunked",
                        keyframe_backend="auto", retrieval_backend="tiny")):
        a = _eval_args(**kw)
        assert port._slam_flags("img", a, "p.txt") == \
            ref._slam_flags("img", a, "p.txt")
    # --device takes the place of --platform
    assert port._slam_flags("img", _eval_args(device="cpu"), "p.txt") == \
        ref._slam_flags("img", _eval_args(platform="cpu"), "p.txt")[:-2] \
        + ["--device", "cpu"]


def test_run_eval_in_process_on_cpu(tmp_path, monkeypatch):
    """One in-process trial of the tiny model on a synthetic TUM sequence:
    a CSV row with a finite ATE, summarized by process_logs."""
    from vggt_slam_tpu_torch.evals import run_eval
    from vggt_slam_tpu_torch.evals.process_logs import summarize
    from vggt_slam_tpu_torch.tools.synth3d import write_tum_sequence

    monkeypatch.setattr(run_eval, "_WARM",
                        {"model_fn": None, "retrieval": None})
    write_tum_sequence(str(tmp_path / "data" / "loop"), n_frames=6, seed=3,
                       image_hw=(56, 518), ng=256)
    out = str(tmp_path / "res.csv")
    rows = run_eval.main(
        ["--dataset_root", str(tmp_path / "data"), "--sequences", "loop",
         "missing", "--trials", "1", "--submap_size", "4", "--max_loops",
         "0", "--min_disparity", "0", "--model_size", "tiny",
         "--global_kv_stride", "8", "--retrieval_backend", "tiny",
         "--device", "cpu", "--in_process", "--out", out])
    assert len(rows) == 1 and rows[0]["sequence"] == "loop"
    assert np.isfinite(rows[0]["ate_rmse"]) and rows[0]["ate_pairs"] >= 3
    with open(out) as f:
        assert next(csv.DictReader(f))["ate_rmse"] == str(rows[0]["ate_rmse"])
    assert summarize(out)["loop"]["ate_rmse"]["count"] == 1


def test_pipeline_overlap_helpers_match_reference():
    from vggt_slam_tpu.evals import pipeline_overlap as ref
    from vggt_slam_tpu_torch.evals import pipeline_overlap as port
    from vggt_slam_tpu_torch.utils.profiling import StageTimer

    code = next(c for c in ref.main.__code__.co_consts
                if getattr(c, "co_name", None) == "host_device_split")
    ref_split = types.FunctionType(code, vars(ref))
    rng = np.random.default_rng(4)
    for stages in (port.HOST_STAGES + ("dispatch_predictions", "retrieval"),
                   ("run_predictions", "keyframe_gate", "ap_mask")):
        timer = StageTimer()
        for name in stages:
            timer.totals[name] = float(rng.uniform(0.1, 9.0))
            timer.counts[name] = int(rng.integers(1, 40))
        assert port.stage_table(timer) == ref.stage_table(timer)
        assert port.host_device_split(timer) == ref_split(timer)
