"""Gradio demo: a zip of images -> SLAM on the card -> a .glb scene
(counterpart of the root app.py). `gradio` is optional: without it
`run_slam()` still serves programmatic use.

    python -m vggt_slam_tpu_torch.app      # the UI (needs gradio)
"""
from __future__ import annotations

import os
import tempfile
import zipfile


def run_slam(zip_path: str, submap_size: int = 16, max_loops: int = 1,
             min_disparity: float = 50.0, conf_threshold: float = 25.0,
             model_size: str = "tiny", checkpoint: str | None = None,
             device="cuda", seed: int = 0) -> str:
    """Run SLAM over a zip of images; returns the path of an exported .glb.
    The model takes the CLI's defaults (main.parser) for every other flag."""
    from vggt_slam_tpu_torch.data.images import list_image_folder, load_image
    from vggt_slam_tpu_torch.main import build_model_fn, parser
    from vggt_slam_tpu_torch.slam.solver import Solver
    from vggt_slam_tpu_torch.utils.device import resolve_device
    from vggt_slam_tpu_torch.viz.glb import GLBExporter

    device = resolve_device(device)
    workdir = tempfile.mkdtemp(prefix="vggt_slam_")
    img_dir = os.path.join(workdir, "images")
    os.makedirs(img_dir, exist_ok=True)
    with zipfile.ZipFile(zip_path) as zf:
        for name in zf.namelist():
            base = os.path.basename(name)
            if base and base.lower().endswith((".jpg", ".jpeg", ".png")):
                with open(os.path.join(img_dir, base), "wb") as f:
                    f.write(zf.read(name))

    names = list_image_folder(img_dir)
    if not names:
        raise ValueError("no images found in the uploaded zip")

    args = parser.parse_args(
        ["--model_size", model_size, "--submap_size", str(submap_size),
         "--max_loops", str(max_loops), "--seed", str(seed)]
        + (["--checkpoint", checkpoint] if checkpoint else []))
    model_fn = build_model_fn(args, device)
    solver = Solver(init_conf_threshold=conf_threshold, seed=seed,
                    device=device)

    subset = []
    for name in names:
        if solver.flow_tracker.compute_disparity(load_image(name),
                                                 min_disparity):
            subset.append(name)
        if len(subset) == submap_size + 1 or (name == names[-1]
                                              and len(subset) > 1):
            preds = solver.run_predictions(subset, model_fn, max_loops)
            solver.add_points(preds)
            solver.graph.optimize()
            solver.map.update_submap_homographies(solver.graph)
            subset = subset[-1:]

    exporter = GLBExporter()
    for submap in solver.map.ordered_submaps_by_key():
        exporter.add_point_cloud(
            submap.get_points_in_world_frame(stride=2),
            submap.get_points_colors(stride=2))
        for pose in submap.get_all_poses_world(ignore_loop_closure_frames=True):
            exporter.add_camera_pose(pose)
    out = os.path.join(workdir, "scene.glb")
    exporter.export(out)
    return out


def build_demo():
    import gradio as gr

    with gr.Blocks(title="VGGT-SLAM (PyTorch/CUDA)") as demo:
        gr.Markdown("# VGGT-SLAM (PyTorch/CUDA)\nUpload a zip of images; "
                    "get a 3D scene.")
        with gr.Row():
            zip_in = gr.File(label="images.zip", type="filepath")
            glb_out = gr.Model3D(label="Reconstruction")
        with gr.Row():
            submap = gr.Slider(4, 32, value=16, step=1, label="submap size")
            loops = gr.Slider(0, 5, value=1, step=1, label="max loops")
            disp = gr.Slider(0, 150, value=50, label="min disparity (px)")
            conf = gr.Slider(0, 90, value=25, label="conf percentile")
        btn = gr.Button("Run SLAM")
        btn.click(lambda z, s, l, d, c: run_slam(z, int(s), int(l), d, c),
                  inputs=[zip_in, submap, loops, disp, conf],
                  outputs=[glb_out])
    return demo


if __name__ == "__main__":
    try:
        import gradio  # noqa: F401
    except ImportError:
        raise SystemExit("gradio is not installed; use run_slam() directly or "
                         "the CLI (python -m vggt_slam_tpu_torch.main)")
    build_demo().launch(server_name="0.0.0.0")
