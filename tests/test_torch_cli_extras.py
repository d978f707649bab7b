"""The rest of the single-GPU CLI against the reference on the CPU: COLMAP
alignment (T and homographies 1e-9 relative in float64, a known
similarity recovered), its frame names, the parser's flags, and the tiny
CLI with --profile_dir (a trace that parses), --plot_focal_lengths
(refused without matplotlib), --colmap_images_txt and --vis_map on the
viser stub or headless.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from tests import viser_stub
from tests.test_torch_viz import _rotation, synthetic_submaps

jax.config.update("jax_enable_x64", True)


def _quat_wxyz(R):
    from vggt_slam_tpu_torch.tools.synth3d import rotmat_to_quat_np
    return rotmat_to_quat_np(R[None])[0]


def write_images_txt(path, names, centers, seed=0):
    """COLMAP images.txt whose world->cam poses put each named camera at
    its centre (random orientations)."""
    rng = np.random.default_rng(seed)
    lines = ["# Image list with two lines of data per image:"]
    for i, (name, c) in enumerate(zip(names, centers)):
        R_cw = _rotation(rng)
        t = -R_cw @ c
        q = _quat_wxyz(R_cw)
        lines += [f"{i + 1} {q[0]:.17g} {q[1]:.17g} {q[2]:.17g} {q[3]:.17g} "
                  f"{t[0]:.17g} {t[1]:.17g} {t[2]:.17g} 1 {name}", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _maps():
    from vggt_slam_tpu.slam.map import GraphMap as RefMap
    from vggt_slam_tpu.slam.submap import Submap as RefSubmap
    from vggt_slam_tpu_torch.slam.map import GraphMap
    from vggt_slam_tpu_torch.slam.submap import Submap

    out = []
    for map_cls, sub_cls in ((RefMap, RefSubmap), (GraphMap, Submap)):
        m = map_cls()
        for sub in synthetic_submaps(sub_cls):
            m.add_submap(sub)
        out.append(m)
    return out


def test_frame_names_match_reference():
    from vggt_slam_tpu.slam.submap import Submap as RefSubmap
    from vggt_slam_tpu_torch.slam.submap import Submap

    paths = ["/d/rgb/1305031102.175304.png", "rgb/frame_000012.jpg",
             "img7.png"]
    a, b = RefSubmap(0), Submap(0)
    a.set_frame_ids(paths)
    b.set_frame_ids(paths)
    assert (b.frame_ids, b.frame_names, b.frame_id_to_name) == \
        (a.frame_ids, a.frame_names, a.frame_id_to_name)
    for sub in (a, b):
        with pytest.raises(ValueError, match="No number"):
            sub.set_frame_ids(["rgb/frame.png"])


@pytest.mark.parametrize("with_scale", [True, False])
def test_align_scale_to_colmap_matches_reference(tmp_path, with_scale):
    ref, port = _maps()
    names, centers = [], []
    for sub in port.ordered_submaps_by_key():
        poses = sub.get_all_poses_world(ignore_loop_closure_frames=True)
        names += sub.frame_names
        centers += [p[:3, 3] for p in poses]
    rng = np.random.default_rng(5)
    s, R, t = (1.7 if with_scale else 1.0), _rotation(rng), rng.normal(size=3)
    gt = [s * R @ c + t for c in centers]
    txt = str(tmp_path / "images.txt")
    write_images_txt(txt, names, gt)
    before = {k: sub.get_reference_homography().copy()
              for k, sub in port.submaps.items()}
    T_ref = ref.align_scale_to_colmap(txt, with_scale=with_scale)
    T = port.align_scale_to_colmap(txt, with_scale=with_scale)
    np.testing.assert_allclose(T, T_ref, rtol=1e-9, atol=1e-12)
    want = np.eye(4)
    want[:3, :3] = s * R
    want[:3, 3] = t
    np.testing.assert_allclose(T, want, rtol=1e-9, atol=1e-9)
    for k, sub in port.submaps.items():
        H = sub.get_reference_homography()
        assert H.dtype == np.float64
        np.testing.assert_allclose(
            H, ref.get_submap(k).get_reference_homography(),
            rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(H, T @ before[k], rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="4x4"):
        port.apply_similarity_transform(np.eye(3))


def test_align_needs_three_matched_frames(tmp_path):
    ref, port = _maps()
    txt = str(tmp_path / "images.txt")
    names = port.get_submap(0).frame_names[:2]
    write_images_txt(txt, names, np.zeros((2, 3)))
    for m in (ref, port):
        with pytest.raises(RuntimeError, match="got 2"):
            m.align_scale_to_colmap(txt)


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_parser_has_the_reference_flags():
    from vggt_slam_tpu import main as ref
    from vggt_slam_tpu_torch import main as port

    multi_device = {"--shard", "--seq_parallel"}
    assert _options(ref.parser) - _options(port.parser) == \
        multi_device | {"--platform"}
    assert _options(port.parser) - _options(ref.parser) == \
        {"--device", "--seed"}


def _frames():
    rng = np.random.default_rng(0)
    coarse = rng.uniform(0, 255, (8, 60)).astype(np.float32)
    tex = torch.nn.functional.interpolate(
        torch.from_numpy(coarse)[None, None], size=(96, 900),
        mode="bicubic", align_corners=False)[0, 0].clamp(0, 255).numpy()
    tex = np.repeat(tex.astype(np.uint8)[..., None], 3, axis=2)
    return [np.ascontiguousarray(tex[20:76, 20 + 40 * i:538 + 40 * i])
            for i in range(5)]


def _tiny_args(*extra):
    from vggt_slam_tpu_torch import main
    return main.parser.parse_args(
        ["--model_size", "tiny", "--submap_size", "3", "--max_loops", "0",
         "--min_disparity", "20", *extra])


def test_plot_focal_lengths_refused_without_matplotlib(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit):
        _tiny_args("--plot_focal_lengths")
    assert "needs matplotlib" in capsys.readouterr().err
    assert _tiny_args().plot_focal_lengths is False


def test_cli_extras_on_cpu(tmp_path, monkeypatch, capsys):
    """A tiny run with --plot_focal_lengths, --colmap_images_txt and
    --vis_map on the viser stub."""
    from vggt_slam_tpu_torch import main

    calls = viser_stub.install_with(monkeypatch)
    monkeypatch.chdir(tmp_path)
    txt = str(tmp_path / "images.txt")
    write_images_txt(txt, [f"{i:06d}.png" for i in range(5)],
                     np.random.default_rng(3).normal(size=(5, 3)))
    args = _tiny_args("--plot_focal_lengths", "--colmap_images_txt", txt,
                      "--vis_map", "--vis_stride", "2", "--vis_flow")
    res = main.run_slam(args, frames=_frames(), device="cpu")
    solver = res["solver"]
    n_sub = solver.map.get_num_submaps()
    assert n_sub == 2
    assert (tmp_path / "focal_lengths.png").read_bytes()[:4] == b"\x89PNG"
    assert "[align] matched frames: 6" in capsys.readouterr().out  # 4 + 2
    # every homography is one T times the pose graph's
    Ts = [sub.get_reference_homography()
          @ np.linalg.inv(solver.graph.get_homography(k))
          for k, sub in solver.map.submaps.items()]
    np.testing.assert_allclose(Ts[1], Ts[0], rtol=1e-9, atol=1e-9)
    assert not np.allclose(Ts[0], np.eye(4))
    names = [c[0] for c in calls]
    assert names.count("scene.add_point_cloud") == n_sub
    frames = sum(len(s.get_all_poses_world())
                 for s in solver.map.get_submaps())
    assert names.count("scene.add_frame") == frames
    assert names.count("scene.add_camera_frustum") == frames
    pcs = [c[2] for c in calls if c[0] == "scene.add_point_cloud"]
    assert pcs[0]["point_size"] == args.vis_point_size
    assert len(pcs[0]["points"]) == len(
        solver.map.get_submap(0).get_points_in_world_frame(stride=2))


def test_cli_headless_without_viser_with_a_trace(tmp_path, monkeypatch,
                                                 capsys):
    """--vis_map and --keep_alive without viser run headless; --profile_dir
    writes a Chrome trace that parses (three frames, one submap: the
    profiler records every op of the pose-graph solve)."""
    from vggt_slam_tpu_torch import main

    viser_stub.install_with(monkeypatch, present=False)
    args = _tiny_args("--vis_map", "--keep_alive", "--log_results",
                      "--skip_dense_log", "--log_path",
                      str(tmp_path / "poses.txt"), "--profile_dir",
                      str(tmp_path / "prof"))
    res = main.run_slam(args, frames=_frames()[:3], device="cpu")
    assert "viser not installed; continuing headless" in \
        capsys.readouterr().out
    assert res["solver"].viewer is None
    assert res["solver"].map.get_num_submaps() == 1
    assert os.path.getsize(tmp_path / "poses.txt") > 0
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
