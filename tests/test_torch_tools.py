"""The port's tools against the JAX package's on the same inputs:
occupancy's grid, flags, dots and viewer calls equal; align_points' Sim(3)
to 1e-4; undistort's maps and images against OpenCV's within one grey
level on >= 99.9% of pixels (bit-exact here), the centre ray kept; the
entry points need a card unless the CPU is asked for.
"""
import builtins
import importlib
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from vggt_slam_tpu.tools import align_points as JP
from vggt_slam_tpu.tools import occupancy as JO
from vggt_slam_tpu.tools import undistort as JU
from vggt_slam_tpu_torch.data.pcd import write_pcd
from vggt_slam_tpu_torch.tools import align_points as TP
from vggt_slam_tpu_torch.tools import occupancy as TO
from vggt_slam_tpu_torch.tools import undistort as TU


def _cloud(seed, n=6000):
    """A floor and walls, in the dataset frame."""
    rng = np.random.default_rng(seed)
    pts = np.c_[rng.uniform(-2, 2, (n, 2)), rng.normal(0, 0.02, n)]
    wall = rng.random(n) < 0.3
    pts[wall, 2] = rng.uniform(0, 1.5, wall.sum())
    pts[wall, 0] = np.round(pts[wall, 0] * 2) / 2
    pts[:5] = np.nan
    return pts.astype(np.float32)


def _zdown(pts):
    """z-up -> the dataset frame, so the tools' transform gives `pts`."""
    return pts @ JO.get_T_zup_from_xleft_ydown_zin()[:3, :3]


def test_occupancy_grid_matches_reference():
    pts = _cloud(0)
    want = JO.build_occupancy_from_pointcloud(pts, 0.2, 1.0, 0.2)
    got = TO.build_occupancy_from_pointcloud(pts, 0.2, 1.0, 0.2, "cpu")
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert want[1].any() and not want[1].all()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("occ")
    write_pcd(str(d / "c.pcd"), _zdown(_cloud(1)),
              np.random.default_rng(1).integers(0, 255, (6000, 3)))
    rng = np.random.default_rng(2)
    path = np.c_[np.cumsum(rng.uniform(-0.3, 0.5, 30)) - 3,
                 rng.uniform(-1.5, 1.5, 30), np.zeros(30)]
    lines = []
    for i, c in enumerate(_zdown(path)):
        lines.append(f"{i + 1} 1 0 0 0 {-c[0]} {-c[1]} {-c[2]} 1 f{i}.png")
    (d / "images.txt").write_text("\n\n".join(lines) + "\n")
    (d / "path.txt").write_text("".join(f"f{i}.png\n" for i in range(31)))
    return [str(d / n) for n in ("c.pcd", "images.txt", "path.txt")]


@pytest.mark.parametrize("unknown_is_free", [False, True])
def test_navigability_and_overlay_match_reference(scene, unknown_is_free):
    want = JO.compute_navigability(*scene, unknown_is_free=unknown_is_free)
    got = TO.compute_navigability(*scene, unknown_is_free=unknown_is_free,
                                  device="cpu")
    assert (got.details, got.navigability) == (want.details,
                                                want.navigability)
    assert 0 < sum(want.details) < len(want.details)
    s = JO._prepare_scene(*scene, 0.2, 1.0, 0.2, True)
    args = (s["traj_pts"], 0.2, s["blocked_cells"], s["cell_center_z"],
            0.05, unknown_is_free)
    for w, g in zip(JO.segment_sample_overlay(*args),
                    TO.segment_sample_overlay(*args, device="cpu")):
        np.testing.assert_array_equal(g, w)
    p = s["traj_pts"]
    assert [TO.segment_is_navigable(p[i], p[i + 1], 0.2, s["blocked_cells"],
                                    unknown_is_free, "cpu")
            for i in range(6)] == \
        [JO.segment_is_navigable(p[i], p[i + 1], 0.2, s["blocked_cells"],
                                 unknown_is_free) for i in range(6)]


def test_occupancy_viewer_calls_match_reference(scene, monkeypatch):
    sys.path.insert(0, os.path.dirname(__file__))
    import viser_stub

    monkeypatch.setattr(builtins, "input", lambda: "")
    calls = []
    for mod, dev in ((JO, []), (TO, ["--device", "cpu"])):
        calls.append(viser_stub.install_with(monkeypatch))
        monkeypatch.setattr(sys, "argv", ["occupancy", "--pcd_path",
                                          scene[0], "--colmap_images_txt",
                                          scene[1], "--path_txt", scene[2],
                                          "--visualize",
                                          "--show_camera_frames", *dev])
        mod.main()
    assert len(calls[1]) == len(calls[0]) > 60
    for (n0, a0, k0), (n1, a1, k1) in zip(*calls):
        assert n1 == n0 and a1 == a0 and k1.keys() == k0.keys()
        for k in k0:
            np.testing.assert_array_equal(np.asarray(k1[k]),
                                          np.asarray(k0[k]))


def test_align_points_matches_reference_and_recovers_the_sim3():
    rng = np.random.default_rng(3)
    src = (rng.normal(size=(3000, 3)) * [3.0, 1.5, 0.5]).astype(np.float32)
    w = np.array([0.4, -0.3, 0.2])
    R = cv2.Rodrigues(w)[0]
    dst = (1.7 * src @ R.T + [0.5, -1.0, 2.0]).astype(np.float32)
    s0, R0, t0 = JP.register_point_clouds(src, dst)
    s1, R1, t1 = TP.register_point_clouds(src, dst, device="cpu")
    for a, b in ((s1, s0), (R1, R0), (t1, t0), (s1, 1.7), (R1, R)):
        np.testing.assert_allclose(b, a, atol=1e-4)


def _textured(h, w, seed):
    img = np.random.default_rng(seed).uniform(0, 255, (h, w, 3))
    return cv2.GaussianBlur(img.astype(np.uint8), (0, 0), 2)


def _agrees(got, want):
    d = np.abs(got.astype(int) - want)
    assert (d <= 1).mean() >= 0.999, d.max()


@pytest.mark.parametrize("camera", ["left", "right"])
def test_fisheye_undistort_matches_opencv(camera):
    ref = JU.METACAM_LEFT if camera == "left" else JU.METACAM_RIGHT
    port = TU.METACAM_LEFT if camera == "left" else TU.METACAM_RIGHT
    m1, m2, K_new = ref.undistort_maps(320, 90.0)
    p1, p2, K2 = port.undistort_maps(320, 90.0, "cpu")
    assert np.array_equal(K2, K_new)
    assert (p1.numpy() == m1).mean() >= 0.999 and \
        (p2.numpy() == m2).mean() >= 0.999
    f = int(p2[160, 160])
    c = p1[160, 160].numpy() * 32 + [f % 32, f // 32]
    assert np.array_equal(c, np.round(port.K[:2, 2] * 32))   # centre ray
    img = _textured(3000, 3000, 4)
    want = cv2.remap(img, m1, m2, interpolation=cv2.INTER_LINEAR)
    _agrees(TU.remap_linear(img, torch.from_numpy(m1.astype(np.int64)),
                            torch.from_numpy(m2.astype(np.int64))).numpy(),
            want)
    got, _ = port.undistort(img, 320, 90.0, "cpu")
    _agrees(got, want)


def test_radtan_undistort_folder_matches_opencv(tmp_path):
    os.makedirs(tmp_path / "in")
    imgs = [_textured(480, 752, s) for s in (5, 6)]
    for i, img in enumerate(imgs):
        cv2.imwrite(str(tmp_path / "in" / f"{i}.png"), img)
    (tmp_path / "in" / "notes.txt").write_text("not an image")
    assert TU.main(["euroc", "--input_dir", str(tmp_path / "in"),
                    "--output_dir", str(tmp_path / "out"),
                    "--device", "cpu"]) == 2
    for i, img in enumerate(imgs):
        want = cv2.undistort(img, JU.EUROC_CAM0_K, JU.EUROC_CAM0_D)
        _agrees(cv2.imread(str(tmp_path / "out" / f"{i}.png")), want)
    gray = TU.remap_linear(imgs[0][..., 0], *TU.radtan_maps(
        JU.EUROC_CAM0_K, JU.EUROC_CAM0_D, (752, 480), "cpu"))
    _agrees(gray.numpy(), cv2.undistort(imgs[0][..., 0], JU.EUROC_CAM0_K,
                                        JU.EUROC_CAM0_D))


@pytest.mark.parametrize("module,argv", [
    ("evals.retrieval_quality", ["--n_frames", "8"]),
    ("evals.ab_attention", ["--n_sequences", "0"]),
    ("tools.occupancy", ["--pcd_path", "x", "--colmap_images_txt", "x",
                         "--path_txt", "x"]),
    ("tools.align_points", ["--source", "x", "--target", "x"]),
    ("tools.undistort", ["euroc", "--input_dir", "x", "--output_dir", "x"])])
def test_entry_points_need_a_card_unless_asked(module, argv, monkeypatch,
                                               tmp_path):
    """--device cuda by default: without a card it raises (ab_attention
    hands it to run_eval)."""
    mod = importlib.import_module(f"vggt_slam_tpu_torch.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    write_pcd("x", np.zeros((3, 3)))
    if module == "evals.ab_attention":
        seen = []
        monkeypatch.setattr(mod, "run_config", lambda *a: seen.append(
            a[-1].device) or [])
        mod.main(argv + ["--configs", "exact_online", "--seq_root", "s"])
        assert seen == ["cuda"]
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
