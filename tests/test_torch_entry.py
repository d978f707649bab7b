"""The port's boundary and entry points: no module imports JAX, flax,
OpenCV, regex, transformers, safetensors, sentencepiece or the JAX
package (the viewer on tests/viser_stub.py); entry points refuse to run
without a card unless the CPU is asked for; chip_smoke.py exits non-zero
without a card and outside the repository; the tiny SLAM loop runs on the
CPU from in-memory frames.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import vggt_slam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
want = dict(
    scripts="bench_attention bench_matmul_shapes",
    models="retrieval vggt.convert clip clip_tokenizer sam2 siglip "
           "siglip_tokenizer",
    evals="ate smoke_loop geometry_eval run_eval process_logs "
          "pipeline_overlap mask_eval voxel_eval dense_7scenes "
          "retrieval_quality ab_attention",
    slam="alignment checkpoint", viz="glb viser_viewer",
    native="kdtree felzenszwalb", ops="voxel",
    semantic="voxel_map embedder sam2_amg",
    tools="synth3d query_voxelmap visualize_results occupancy align_points "
          "undistort")
assert all("vggt_slam_tpu_torch." + p + "." + m in names
           for p, ms in want.items() for m in ms.split())
viewer = "vggt_slam_tpu_torch.viz.viser_viewer"   # needs viser: the stub
for name in names:
    if name != viewer:
        importlib.import_module(name)
import chip_smoke
chip_smoke.load_viser_stub().install(sys.modules)
importlib.import_module(viewer)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "regex",
                                    "transformers", "safetensors",
                                    "sentencepiece")
             or m == "vggt_slam_tpu" or m.startswith("vggt_slam_tpu."))
print(len(names), bad)
"""


def test_port_imports_no_jax_flax_cv2_or_reference_package():
    """Nor regex, transformers, safetensors or sentencepiece, which the
    card's machine lacks (the tokenizers and checkpoint reader do without
    them)."""
    out = subprocess.run([sys.executable, "-c", _GUARD.format(repo=REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 79
    assert bad == "[]"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, where):
    if where == "alone":
        with open(os.path.join(REPO, "chip_smoke.py")) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        cwd = str(tmp_path)
    else:
        cwd = REPO
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_default_to_the_card(monkeypatch):
    from vggt_slam_tpu_torch import main
    from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = main.parser.parse_args(["--model_size", "tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main.build_model(VGGTConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main.build_model_fn(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main.run_slam(args, frames=[])
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_bucketed_model_fn(torch.nn.Linear(1, 1), 3)
    assert main.parser.parse_args([]).device == "cuda"
    model = main.build_model(VGGTConfig.tiny(), device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_keyframe_auto_is_the_cv2_tracker_on_the_cpu():
    """The CLI's default gate, auto, resolves on the solver's device: cv2
    on the CPU, as the reference's auto (torch on a CUDA device,
    tests/test_torch_gpu.py)."""
    from vggt_slam_tpu_torch import main
    from vggt_slam_tpu_torch.slam.solver import Solver

    args = main.parser.parse_args(["--device", "cpu"])
    assert args.keyframe_backend == "auto"
    solver = Solver(keyframe_backend=args.keyframe_backend, device=args.device)
    assert solver.flow_tracker.backend == "cv2"


def test_run_slam_tiny_from_memory_frames_on_cpu(tmp_path):
    """Panned synthetic frames through the keyframe gate (torch backend),
    bucketed forwards, SL(4) RANSAC and the pose graph: at least two
    submaps with finite poses and homographies."""
    from vggt_slam_tpu_torch import main
    from vggt_slam_tpu_torch.ops import attention

    rng = np.random.default_rng(0)
    coarse = rng.uniform(0, 255, (8, 60)).astype(np.float32)
    tex = torch.nn.functional.interpolate(
        torch.from_numpy(coarse)[None, None], size=(96, 900),
        mode="bicubic", align_corners=False)[0, 0].clamp(0, 255).numpy()
    tex = np.repeat(tex.astype(np.uint8)[..., None], 3, axis=2)
    frames = [np.ascontiguousarray(tex[20:76, 20 + 40 * i:538 + 40 * i])
              for i in range(5)]
    args = main.parser.parse_args(
        ["--model_size", "tiny", "--submap_size", "3", "--max_loops", "0",
         "--min_disparity", "20", "--keyframe_backend", "torch",
         "--timing", "--save_path", str(tmp_path / "out"), "--log_results",
         "--log_path", str(tmp_path / "poses.txt")])
    before = dict(attention.LAUNCHES)
    res = main.run_slam(args, frames=frames, device="cpu")
    solver = res["solver"]
    assert res["n_frames"] == 5
    assert solver.map.get_num_submaps() == 2
    assert len(solver.graph.initialized_nodes) == 2
    for s in solver.map.ordered_submaps_by_key():
        poses = s.get_all_poses_world()
        assert poses.shape == (len(s.get_frame_ids()), 4, 4)
        assert np.isfinite(poses).all()
        assert np.isfinite(s.get_reference_homography()).all()
    assert "graph_optimize" in res["timer"].summary()
    poses = np.loadtxt(tmp_path / "poses.txt")
    assert poses.shape == (6, 8) and np.isfinite(poses).all()  # 4 + 2
    assert (tmp_path / "out" / "result.pcd").stat().st_size > 0
    assert len(os.listdir(tmp_path / "out" / "frame_output")) == 5
    assert len(os.listdir(tmp_path / "poses_logs")) == 5
    assert attention.LAUNCHES == before     # CPU: plain versions only


def test_run_slam_tiny_from_png_folder_on_cpu(tmp_path):
    """The CLI's own folder path: PNG frames decoded by the in-repo reader
    and resized without OpenCV (48x444 -> 56x518, INTER_LINEAR), with
    --qk_int8 given, through the tiny model on the CPU."""
    import cv2

    from vggt_slam_tpu_torch import main

    rng = np.random.default_rng(1)
    coarse = rng.uniform(0, 255, (6, 50)).astype(np.float32)
    tex = torch.nn.functional.interpolate(
        torch.from_numpy(coarse)[None, None], size=(80, 800),
        mode="bicubic", align_corners=False)[0, 0].clamp(0, 255).numpy()
    tex = np.repeat(tex.astype(np.uint8)[..., None], 3, axis=2)
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i in range(5):
        cv2.imwrite(str(folder / f"{i:03d}.png"),
                    np.ascontiguousarray(tex[16:64, 16 + 36 * i:460 + 36 * i]))
    args = main.parser.parse_args(
        ["--image_folder", str(folder), "--model_size", "tiny",
         "--submap_size", "3", "--max_loops", "0", "--min_disparity", "20",
         "--keyframe_backend", "torch", "--qk_int8", "--log_results",
         "--skip_dense_log", "--log_path", str(tmp_path / "poses.txt")])
    res = main.run_slam(args, device="cpu")
    solver = res["solver"]
    assert res["n_frames"] == 5 and solver.map.get_num_submaps() == 2
    for s in solver.map.ordered_submaps_by_key():
        assert np.isfinite(s.get_all_poses_world()).all()
    poses = np.loadtxt(tmp_path / "poses.txt")
    assert poses.shape == (6, 8) and np.isfinite(poses).all()
