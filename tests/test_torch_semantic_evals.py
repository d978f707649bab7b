"""The port's semantic evals against the JAX package's on the CPU, same
seeded inputs. Exact: the 16-bit PNG reader and writer against cv2 both
ways at every filter, resize_nearest, mask_eval's scenes, scores and
weight-free rows, voxel_eval's results but wall times (in one process:
hash embeddings are salted per process), visualize_results' loaders and
viewer calls. SAM2's rows at tiny_test on the reference's seeded weights:
counts equal, IoUs 0.01 (masks match by IoU). CLIP similarities 1e-5;
dense_7scenes 1e-6 relative (1e-9 absolute for the exact dump's
residues).
"""
import contextlib
import io
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from tests import viser_stub
from vggt_slam_tpu.evals import dense_7scenes as RD
from vggt_slam_tpu.evals import mask_eval as RM
from vggt_slam_tpu.evals import voxel_eval as RV
from vggt_slam_tpu.tools import visualize_results as RVR
from vggt_slam_tpu_torch.data import images as I
from vggt_slam_tpu_torch.evals import dense_7scenes as PD
from vggt_slam_tpu_torch.evals import mask_eval as PM
from vggt_slam_tpu_torch.evals import voxel_eval as PV
from vggt_slam_tpu_torch.tools import visualize_results as PVR


def _quiet():
    return contextlib.redirect_stdout(io.StringIO())


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, None])
@pytest.mark.parametrize("hw", [(48, 64), (7, 1), (1, 9)])
def test_png16_round_trips_cv2(tmp_path, kind, hw):
    """Each filter type forced (None: adaptive, cv2's default)."""
    rng = np.random.default_rng(sum(hw))
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    smooth = (2000 + 500 * np.sin(xx / 7) * np.cos(yy / 5) + 3 * yy * xx
              ).astype(np.uint16)
    smooth[rng.random(hw) < 0.05] = 65535
    path = str(tmp_path / "p.png")
    for img in (smooth, rng.integers(0, 65536, hw, np.uint16)):
        kinds = I.write_png16(path, img, None if kind is None else [kind])
        assert kind is None or set(kinds.tolist()) == {kind}
        got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint16 and np.array_equal(got, img)
        cv2.imwrite(path, img, [] if kind is None else [
            cv2.IMWRITE_PNG_FILTER, getattr(cv2, "IMWRITE_PNG_FILTER_" + (
                "NONE", "SUB", "UP", "AVG", "PAETH")[kind])])
        got = I.read_png_unchanged(path)
        assert got.dtype == np.uint16 and np.array_equal(got, img)
    img = rng.integers(0, 256, (9, 13, 3), np.uint8)    # 8-bit: read_png's
    I.write_png(path, img)
    np.testing.assert_array_equal(I.read_png_unchanged(path), img)


@pytest.mark.parametrize("src,dst", [((480, 640), (392, 518)),
                                     ((37, 53), (20, 71)), ((5, 3), (17, 2)),
                                     ((100, 100), (33, 250))])
def test_resize_nearest_matches_cv2(src, dst):
    rng = np.random.default_rng(1)
    for img in (rng.normal(size=src).astype(np.float32),
                rng.integers(0, 65536, src, np.uint16),
                rng.integers(0, 256, src + (3,), np.uint8)):
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
        got = I.resize_nearest(img, dst[1], dst[0])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,hw,n", [(0, (240, 320), 6), (3, (120, 160), 4),
                                       (7, (31, 45), 9)])
def test_make_shape_scene_bit_equal(seed, hw, n):
    for a, b in zip(PM.make_shape_scene(seed, hw, n),
                    RM.make_shape_scene(seed, hw, n)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mask_quality_and_rows_match_reference():
    from vggt_slam_tpu_torch.semantic.embedder import grid_mask_generator

    img, labels = PM.make_shape_scene(0, hw=(120, 160), n_objects=4)
    assert labels.max() >= 3
    perfect = [{"segmentation": labels == i}
               for i in range(1, labels.max() + 1)]
    q = PM.mask_quality(perfect, labels)
    assert q["mean_best_iou"] == 1.0 and q["recall_at_50"] == 1.0
    rng = np.random.default_rng(2)
    noisy = [{"segmentation": m["segmentation"] ^ (rng.random(labels.shape)
                                                   < 0.2)} for m in perfect]
    for masks in (perfect, noisy, grid_mask_generator(img, 4), []):
        assert PM.mask_quality(masks, labels) == RM.mask_quality(masks,
                                                                 labels)
    rows = PM.evaluate_proposers(n_scenes=4, hw=(120, 160))
    assert rows == RM.evaluate_proposers(n_scenes=4, hw=(120, 160))
    fz, grid = rows
    assert (fz["proposer"], grid["proposer"]) == ("felzenszwalb", "grid8")
    assert fz["mean_best_iou"] > 0.6 > grid["mean_best_iou"]
    assert fz["recall_at_50"] > 0.8 > grid["recall_at_50"]


@pytest.fixture(scope="module")
def sam2_npz(tmp_path_factory):
    """The reference's seeded tiny_test weights (PRNGKey(0)) as an .npz."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from vggt_slam_tpu.models.sam2 import SAM2Config, SAM2ImageModel

    m = SAM2ImageModel(SAM2Config.tiny_test())
    params = jax.jit(lambda k: m.init(
        k, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2)),
        method=SAM2ImageModel.full_init))(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("sam2") / "tiny.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in
                      flatten_dict(params, sep="/").items()})
    return path


def test_sam2_rows_match_reference(tmp_path, monkeypatch, sam2_npz):
    """Both mains (the AMG's thresholds keep no mask of random weights),
    then the generators at zero thresholds."""
    from vggt_slam_tpu.models.sam2 import SAM2Config
    from vggt_slam_tpu.semantic import sam2_amg as RA
    from vggt_slam_tpu_torch.models.sam2 import SAM2Config as PC
    from vggt_slam_tpu_torch.semantic import sam2_amg as PA

    args = ["--scenes", "2", "--height", "120", "--width", "160",
            "--sam2_checkpoint", sam2_npz, "--sam2_config", "tiny_test"]
    with _quiet():
        rows = PM.main(args + ["--out", str(tmp_path / "p.csv"), "--device",
                               "cpu"])
        monkeypatch.setattr(sys, "argv", ["mask_eval"] + args + [
            "--out", str(tmp_path / "r.csv"), "--platform", "cpu"])
        RM.main()
    assert [r["proposer"] for r in rows] == ["felzenszwalb", "grid8", "sam2"]
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "r.csv"
                                                ).read_text()
    kw = dict(pred_iou_thresh=0.0, stability_score_thresh=0.0)
    (g,), (w,) = (M.evaluate_proposers(2, (120, 160), {"sam2": gen})
                  for M, gen in (
        (PM, PA.SAM2MaskGenerator(PA.make_sam2_mask_generator(
            sam2_npz, PC.tiny_test(), device="cpu").model, **kw)),
        (RM, RA.SAM2MaskGenerator(RA.load_params(
            sam2_npz, SAM2Config.tiny_test()), SAM2Config.tiny_test(),
            **kw))))
    assert g["mean_proposals"] == w["mean_proposals"] > 0
    for k in ("mean_best_iou", "recall_at_50"):
        assert abs(g[k] - w[k]) <= 0.01, (g, w)


_T0 = 1305031102.175304         # a TUM stamp, in seconds


def _voxel_dir(path, d):
    """40 voxels, 2 submaps of 3 frames named by TUM stamps: (dir,
    stamps)."""
    from vggt_slam_tpu_torch.semantic import voxel_map as P

    rng = np.random.default_rng(4)
    coords = np.unique(rng.integers(-5, 5, (48, 3)), axis=0)[:40]
    names = {str(s): {f"{float(f)}": f"{_T0 + 0.5 * (3 * s + f):.6f}.png"
                      for f in range(3)} for s in range(2)}
    contributors = [[(int(s), f"{float(f)}") for s, f in
                     zip(rng.integers(0, 2, k), rng.integers(0, 3, k))]
                    for k in rng.integers(1, 4, len(coords))]
    P.SemanticVoxelMap(P.SemanticVoxel(
        0.1, ((coords + 0.5) * 0.1).astype(np.float32),
        rng.normal(size=(len(coords), d)).astype(np.float32), contributors),
        names).save_to_directory(str(path))
    return str(path), [_T0 + 0.5 * i for i in range(6)]


def _jobs(vdir, stamps, clip_dir=None):
    far = [s + 10.0 for s in stamps]
    validity = {"voxel_dir": vdir, "evaluator": "search_validity"}
    return [
        dict(validity, queries={"a chair": stamps, "a table": stamps[:2]},
             clip_model_dir=clip_dir,
             sweep={"top_k": [1, 5], "tolerance_ns": [0.25, 1e-9]}),
        dict(validity, queries={"a chair": far}, tolerance_ns=0.5),
        dict(validity, queries={"a chair": far}),     # the default 5e7
        {"voxel_dir": vdir, "evaluator": "voxel_count"},
        {"voxel_dir": vdir, "evaluator": "perf", "n_repeats": 3}]


def _timeless(out):
    out = json.loads(json.dumps(out))
    for r in out["results"]:
        r.pop("wall_s")
        if r["evaluator"] == "perf":
            r["result"] = sorted(r["result"])
    return out


def test_evaluators_and_grid_match_reference(tmp_path):
    vdir, stamps = _voxel_dir(tmp_path / "vox", 6)
    jobs = _jobs(vdir, stamps)
    for job in jobs:
        grid = PV.expand_job_grid(dict(job))
        assert grid == RV.expand_job_grid(dict(job))
        for j in grid:
            j = dict(j)
            name = j.pop("evaluator")
            a = PV.get_evaluator(name)(**j, device="cpu").run()
            b = RV.get_evaluator(name)(**j).run()
            assert (sorted(a) == sorted(b)) if name == "perf" else a == b
    grid = PV.expand_job_grid(dict(jobs[0]))
    assert len(grid) == 4
    for j in grid[:2]:                                  # tolerance 0.25 s
        assert PV.run_job(j)["result"]["per_query"]["a chair"]["valid"]
    # stamps moved 10 s: invalid at 0.5 s, valid at the default 5e7
    assert [PV.run_job(j)["result"]["validity_rate"] for j in jobs[1:3]] \
        == [0.0, 1.0]
    with pytest.raises(ValueError, match="unknown evaluator"):
        PV.get_evaluator("nope")


def test_run_experiment_matches_reference(tmp_path):
    """One process and the CLI, then a spawn pool of two."""
    vdir, stamps = _voxel_dir(tmp_path / "vox", 6)
    cfg = tmp_path / "jobs.json"
    cfg.write_text(json.dumps({"jobs": _jobs(vdir, stamps)}))
    got = PV.run_experiment(str(cfg), str(tmp_path / "p.json"), "cpu")
    want = _timeless(RV.run_experiment(str(cfg), str(tmp_path / "r.json")))
    assert len(got["results"]) == 8 and _timeless(got) == want
    assert _timeless(json.loads((tmp_path / "p.json").read_text())) == want
    with _quiet() as out:
        cli = PV.main(["--config", str(cfg), "--out", str(tmp_path / "c.json"),
                       "--device", "cpu"])
    assert _timeless(cli) == want
    assert out.getvalue().startswith("search_validity {")
    count = {"voxel_dir": vdir, "evaluator": "voxel_count"}
    cfg.write_text(json.dumps({"jobs": [count, count], "num_workers": 2}))
    got = PV.run_experiment(str(cfg))["results"]
    assert [r["result"] for r in got] == [want["results"][6]["result"]] * 2


def test_search_validity_with_clip_matches_reference(tmp_path, monkeypatch):
    """A tiny CLIP text tower: the same hits, similarities 1e-5."""
    from tests.test_torch_clip import write_checkpoint
    from vggt_slam_tpu_torch.models.clip import CLIPConfig

    cfg = CLIPConfig.tiny_test(vocab_size=524, context_length=16)
    (tmp_path / "clip").mkdir()
    write_checkpoint(str(tmp_path / "clip"), cfg, "bin")
    vdir, stamps = _voxel_dir(tmp_path / "vox", cfg.projection_dim)
    for j in RV.expand_job_grid(_jobs(vdir, stamps, str(tmp_path / "clip"))
                                [0]):
        want = RV.run_job(j)["result"]
        got = PV.run_job(j, device="cpu")["result"]
        assert got["validity_rate"] == want["validity_rate"]
        for q, r in want["per_query"].items():
            assert got["per_query"][q]["hits"] == r["hits"]
            assert abs(got["per_query"][q]["best_similarity"]
                       - r["best_similarity"]) <= 1e-5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PV.run_job(j)


def test_percentile_bbox_crop_matches_reference():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(1000, 3)).astype(np.float32)
    pts[0] = [100, 100, 100]
    cols = rng.integers(0, 256, (1000, 3), np.uint8)
    out, none = PVR.percentile_bbox_crop(pts, None, 0.5, 99.5)
    assert none is None and out.shape[0] < 1000 and np.abs(out).max() < 50
    for a, b in zip(PVR.percentile_bbox_crop(pts, cols, 2, 97),
                    RVR.percentile_bbox_crop(pts, cols, 2, 97)):
        np.testing.assert_array_equal(a, b)


def test_load_pose_file_and_images_match_reference(tmp_path, capsys):
    s = np.sqrt(0.5)
    (tmp_path / "poses.txt").write_text(
        f"# comment\nframe_a 0 0 0 0 0 0 1\nbad 1 2 x 0 0 0 1\n"
        f"frame_b 1 2 3 0 0 {s:.8f} {s:.8f}\nshort 1 2\n")
    extr, ids = PVR.load_pose_file(str(tmp_path / "poses.txt"))
    assert ids == ["frame_a", "frame_b"] and extr.shape == (2, 3, 4)
    assert np.allclose(extr[0], np.eye(4)[:3])
    assert np.allclose(extr[1], [[0, -1, 0, 1], [1, 0, 0, 2], [0, 0, 1, 3]],
                       atol=1e-6)
    r_extr, r_ids = RVR.load_pose_file(str(tmp_path / "poses.txt"))
    assert r_ids == ids
    np.testing.assert_array_equal(extr, r_extr)
    (tmp_path / "empty.txt").write_text("# nothing\n")
    with pytest.raises(ValueError, match="no valid poses"):
        PVR.load_pose_file(str(tmp_path / "empty.txt"))

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i, stem in enumerate(ids):
        I.write_png(str(imgs / f"{stem}.png"),
                    np.full((12, 16, 3), 40 * (i + 1), np.uint8))
    got = PVR.load_matched_images(str(imgs), ids)
    assert got.shape == (2, 3, 12, 16)
    assert np.allclose(got[1], 80 / 255.0, atol=1e-2)
    np.testing.assert_array_equal(got, RVR.load_matched_images(str(imgs),
                                                               ids))
    # another stem, larger: sorted order, a warning, a float resize
    I.write_png(str(imgs / "other.png"), np.random.default_rng(3).integers(
        0, 256, (21, 30, 3), np.uint8))
    (imgs / "notes.txt").write_text("not an image")
    capsys.readouterr()
    got = PVR.load_matched_images(str(imgs), ids + ["frame_c"])
    assert "only 2/3 frame ids" in capsys.readouterr().out
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        want = RVR.load_matched_images(str(imgs), ids + ["frame_c"])
    finally:
        cv2.ipp.setUseIPP(was)
    assert got.shape == (3, 3, 12, 16)
    np.testing.assert_array_equal(got, want)
    assert PVR.load_matched_images(str(tmp_path / "nothing")) is None


def _artifacts(tmp_path):
    """visualize_results' argv over every kind of artifact."""
    from vggt_slam_tpu_torch.data.pcd import write_pcd

    rng = np.random.default_rng(5)
    write_pcd(str(tmp_path / "result.pcd"), rng.normal(size=(3000, 3)),
              rng.integers(0, 256, (3000, 3), np.uint8))
    for d in ("fo", "imgs"):
        (tmp_path / d).mkdir()
    tum, poses = [], []
    for i in range(3):
        T = np.eye(4)[:3]
        T[:, 3] = (0.2 * i, 0.1, -0.05 * i)
        np.savez(str(tmp_path / "fo" / f"{i:06d}.npz"),
                 point_map_world=rng.normal(size=(6, 8, 3)).astype(np.float32),
                 conf_mask=rng.random((6, 8)) > 0.3, extrinsic_world=T)
        tum.append([float(i), *T[:, 3], 0, 0, 0, 1])
        poses.append(f"{i:06d} {T[0, 3]} {T[1, 3]} {T[2, 3]} 0 0 0 1")
        I.write_png(str(tmp_path / "imgs" / f"{i:06d}.png"),
                    rng.integers(0, 256, (12, 16, 3), np.uint8))
    np.savetxt(str(tmp_path / "log.txt"), np.asarray(tum))
    (tmp_path / "poses.txt").write_text("\n".join(poses) + "\n")
    return ["--pcd_path", str(tmp_path / "result.pcd"), "--frame_output_dir",
            str(tmp_path / "fo"), "--pose_log", str(tmp_path / "log.txt"),
            "--poses_path", str(tmp_path / "poses.txt"), "--image_folder",
            str(tmp_path / "imgs"), "--voxel_dir",
            _voxel_dir(tmp_path / "vox", 6)[0], "--side_by_side"]


@pytest.mark.parametrize("extra", [[], ["--voxel_port", "8080",
                                        "--voxel_render_mode", "cubes",
                                        "--stride", "2"]])
def test_visualize_results_main_draws_as_reference(tmp_path, monkeypatch,
                                                   extra):
    """Both mains on the viser stub: the same calls in order, and with
    --headless the same statistics and no call."""
    argv = _artifacts(tmp_path) + extra
    calls = viser_stub.install_with(monkeypatch)
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    recorded, printed = [], []
    for main in (PVR.main, lambda a: (monkeypatch.setattr(
            sys, "argv", ["visualize_results"] + a), RVR.main())):
        for headless in ([], ["--headless"]):
            np.random.seed(11)
            calls.clear()
            with _quiet() as out:
                main(argv + headless)
            recorded.append(list(calls))
            printed.append(out.getvalue())
    got, none, want, ref_none = recorded
    assert printed[:2] == printed[2:] and none == ref_none == []
    assert "side-by-side: offsetting voxels" in printed[0]
    assert [c[0] for c in got] == [c[0] for c in want]
    for (_, a, kw), (_, ra, rkw) in zip(got, want):
        assert len(a) == len(ra) and sorted(kw) == sorted(rkw)
        for x, y in [*zip(a, ra), *((kw[k], rkw[k]) for k in kw)]:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    names = [c[0] for c in got]
    assert names.count("scene.add_camera_frustum") == 3
    assert names.count("scene.add_frame") == 6
    assert names.count("ViserServer") == (1 if extra else 2)


def _seven_scenes_dump(tmp_path, noise=0.0, n=4):
    """tests/test_evals.py's dump by write_png16 and an estimate of the
    same geometry (cloud with `noise`): (seq, estimate, TUM)."""
    from vggt_slam_tpu_torch.evals.geometry_eval import backproject_depth
    from vggt_slam_tpu_torch.ops.lie import rotmat_to_quat

    rng = np.random.default_rng(0)
    seq, est = tmp_path / "seq", tmp_path / "frame_output"
    seq.mkdir()
    est.mkdir()
    K = PD.vggt_resize_K(PD.K_7SCENES)
    H, W = PD.EVAL_HW
    yy, xx = np.meshgrid(np.linspace(0, 1, 480), np.linspace(0, 1, 640),
                         indexing="ij")
    rows = []
    for i in range(n):
        depth = 2.0 + 0.5 * np.sin(3 * xx + i) * np.cos(2 * yy)
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * i, 0.05 * i, 0.0]
        I.write_png16(str(seq / f"frame-{i:06d}.depth.png"),
                      (depth * 1000).astype(np.uint16))
        np.savetxt(str(seq / f"frame-{i:06d}.pose.txt"), c2w)
        pts = backproject_depth(I.resize_nearest(depth.astype(np.float32),
                                                 W, H), K, c2w, 4.0, 4)
        pts = pts + rng.normal(scale=noise, size=pts.shape)
        pm, mask = np.zeros((H * W, 3), np.float32), np.zeros(H * W, bool)
        pm[:len(pts)], mask[:len(pts)] = pts, True
        np.savez(str(est / f"{i:06d}.npz"), point_map_world=pm.reshape(
            H, W, 3), conf_mask=mask.reshape(H, W), extrinsic_world=c2w)
        q = rotmat_to_quat(torch.from_numpy(c2w[:3, :3])).numpy()
        rows.append([float(i), *c2w[:3, 3], q[1], q[2], q[3], q[0]])
    np.savetxt(str(tmp_path / "poses.txt"), np.asarray(rows))
    return str(seq), str(est), str(tmp_path / "poses.txt")


def test_load_7scenes_matches_reference(tmp_path):
    seq, _, _ = _seven_scenes_dump(tmp_path, n=3)
    os.remove(os.path.join(seq, "frame-000001.pose.txt"))
    (pts, rows), (rpts, rrows) = PD.load_7scenes(seq, 1), \
        RD.load_7scenes(seq, 1)
    np.testing.assert_array_equal(pts, rpts)
    assert rows.shape == (2, 8) and rows[:, 0].tolist() == [0.0, 2.0]
    np.testing.assert_allclose(rows, rrows, rtol=0, atol=1e-6)


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_dense_7scenes_matches_reference(tmp_path, noise):
    """The reference's dump test through the port, against the
    reference's metrics; then the CLI on the cloud as a pcd."""
    from vggt_slam_tpu_torch.data.pcd import write_pcd

    seq, est, tum = _seven_scenes_dump(tmp_path, noise)
    m = PD.evaluate_sequence(seq, tum, frame_output_dir=est, gt_stride=1)
    assert m["ate_rmse"] < 1e-6 and m["ate_pairs"] == 4
    assert 0.005 * bool(noise) <= m["rmse_accuracy"] < 0.02 + 2 * noise
    assert m["rmse_completeness"] < 0.02 + 2 * noise
    want = RD.evaluate_sequence(seq, tum, frame_output_dir=est, gt_stride=1)
    assert sorted(m) == sorted(want)
    for k in m:
        np.testing.assert_allclose(m[k], want[k], rtol=1e-6, atol=1e-9)
    if noise:
        return
    pcs, masks, _, _ = PVR.load_frame_outputs(est)
    write_pcd(str(tmp_path / "est.pcd"),
              np.concatenate([p[k] for p, k in zip(pcs, masks)]))
    with _quiet() as out:
        cli = PD.main(["--seq_dir", seq, "--est_tum", tum, "--est_pcd",
                       str(tmp_path / "est.pcd"), "--gt_stride", "1"])
    assert cli["ate_rmse"] < 1e-6 and cli["rmse_accuracy"] < 0.02
    assert "rmse_completeness: " in out.getvalue()
    with pytest.raises(ValueError, match="need frame_output_dir"):
        PD.evaluate_sequence(seq, tum, gt_stride=1)
