"""VGGT-SLAM CLI on PyTorch (counterpart of vggt_slam_tpu/main.py): dense
SLAM over an image folder with the reference's artifacts, the semantic
voxel map, COLMAP alignment, the focal-length plot, a torch.profiler
trace and the viser viewer, on the card unless --device cpu.

Run:  python -m vggt_slam_tpu_torch.main --image_folder <dir> [flags]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from vggt_slam_tpu_torch.utils.device import resolve_device


class _NeedsMatplotlib(argparse.Action):
    """A store_true flag refused at parse time where matplotlib is absent
    (the reference imports it only after the run)."""

    def __init__(self, option_strings, dest, **kw):
        super().__init__(option_strings, dest, nargs=0, default=False, **kw)

    def __call__(self, parser, namespace, values, option_string=None):
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            parser.error(f"{option_string} needs matplotlib, which is not "
                         f"installed")
        setattr(namespace, self.dest, True)


parser = argparse.ArgumentParser(description="VGGT-SLAM on PyTorch/CUDA")
parser.add_argument("--image_folder", type=str,
                    default="examples/kitchen/images/")
parser.add_argument("--vis_map", action="store_true",
                    help="visualize the map incrementally (requires viser)")
parser.add_argument("--vis_flow", action="store_true",
                    help="accepted and ignored, as in the reference")
parser.add_argument("--log_results", action="store_true")
parser.add_argument("--skip_dense_log", action="store_true")
parser.add_argument("--log_path", type=str, default="poses.txt")
parser.add_argument("--use_sim3", action="store_true")
parser.add_argument("--plot_focal_lengths", action=_NeedsMatplotlib,
                    help="write focal_lengths.png (requires matplotlib)")
parser.add_argument("--submap_size", type=int, default=16)
parser.add_argument("--overlapping_window_size", type=int, default=1,
                    help="ONLY DEFAULT OF 1 SUPPORTED RIGHT NOW")
parser.add_argument("--downsample_factor", type=int, default=1)
parser.add_argument("--max_loops", type=int, default=1)
parser.add_argument("--min_disparity", type=float, default=50)
parser.add_argument("--loop_inlier_thresh", type=float, default=0.9,
                    help="geometric loop gate: reject a loop whose RANSAC "
                         "inlier fraction is below this fraction of the "
                         "running median of the sequential registrations' "
                         "(0 = no gate)")
parser.add_argument("--keyframe_backend", default="auto",
                    choices=["auto", "cv2", "torch"],
                    help="keyframe disparity gate: host OpenCV LK, or the "
                         "torch tracker on the solver's device "
                         "(slam/keyframe_torch.py). auto = torch on a CUDA "
                         "device (the card's machine has no OpenCV), cv2 on "
                         "the CPU, as the reference's auto")
parser.add_argument("--use_point_map", action="store_true")
parser.add_argument("--conf_threshold", type=float, default=25.0)
parser.add_argument("--vis_stride", type=int, default=1)
parser.add_argument("--vis_point_size", type=float, default=0.003)
parser.add_argument("--save_path", type=str, default=None)
parser.add_argument("--keep_alive", action="store_true")
parser.add_argument("--semantic_emb_dir", type=str, default=None,
                    help="per-frame embeddings {stem}.npz (key "
                         "'embedding', (h, w, d)), as semantic/embedder.py "
                         "writes them")
parser.add_argument("--get_voxel", action="store_true",
                    help="with --semantic_emb_dir: build the semantic voxel "
                         "map after the run")
parser.add_argument("--voxel_size", type=float, default=0.05)
parser.add_argument("--voxel_save_dir", type=str, default=None)
parser.add_argument("--voxel_port", type=int, default=8081,
                    help="parsed and unused, as in the reference")
parser.add_argument("--voxel_point_size", type=float, default=0.01,
                    help="parsed and unused, as in the reference")
parser.add_argument("--colmap_images_txt", type=str, default=None)
parser.add_argument("--align_no_scale", action="store_true")
parser.add_argument("--checkpoint", type=str, default=None,
                    help="flat npz of VGGT weights keyed by flax path; "
                         "seeded random weights when absent")
parser.add_argument("--retrieval_checkpoint", type=str, default=None,
                    help="converted SALAD weights (flat npz, models/"
                         "retrieval.convert_torch_checkpoint); loop closure "
                         "is DISABLED without them (random descriptors "
                         "would insert bogus loop factors)")
parser.add_argument("--retrieval_backend", default="salad",
                    choices=["salad", "tiny"],
                    help="place-recognition descriptors: the SALAD network "
                         "on --device (needs --retrieval_checkpoint) or the "
                         "weight-free tiny-image descriptor (models/"
                         "retrieval.tiny_image_descriptor_fn), which enables "
                         "loop closure with no weights")
parser.add_argument("--model_size", type=str, default="1b",
                    choices=["1b", "small", "small64", "small256", "tiny"])
parser.add_argument("--global_kv_stride", type=int, default=None,
                    help="global-attention K/V merging stride (1 = exact); "
                         "default 16 for agg_dim > 128, else 8")
parser.add_argument("--global_merge", type=str, default="sim",
                    choices=["sim", "stride"])
parser.add_argument("--global_softmax", type=str, default=None,
                    choices=["online", "static"])
parser.add_argument("--qk_int8", action="store_true",
                    help="run global-attention QK^T on the int8 kernels "
                         "(per-(batch, head) scales, s32 accumulation; "
                         "max |err| ~1e-3 vs f32 instead of ~2e-4 - see "
                         "config.global_qk_int8)")
parser.add_argument("--attn_impl", type=str, default="flash",
                    choices=["flash", "chunked"],
                    help="flash = the CUDA kernels (their plain versions on "
                         "the CPU); chunked = the plain reference")
parser.add_argument("--profile_dir", type=str, default=None,
                    help="write a torch.profiler Chrome trace of the SLAM "
                         "loop here")
parser.add_argument("--no_pipeline", action="store_true",
                    help="serial flow: forward, integrate, repeat")
parser.add_argument("--timing", action="store_true",
                    help="print per-stage wall times")
parser.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of RANSAC")
parser.add_argument("--device", type=str, default="cuda",
                    help="torch device of the model and the solver")

_AGG_DIM = {"tiny": 32, "small": 128, "small64": 128, "small256": 256}


def make_config(args):
    from vggt_slam_tpu_torch.models.vggt.config import VGGTConfig
    stride = args.global_kv_stride
    if stride is None:
        stride = 16 if _AGG_DIM.get(args.model_size, 1024) > 128 else 8
    kw = dict(attn_impl=args.attn_impl, global_kv_stride=stride,
              global_merge=args.global_merge,
              global_qk_int8=bool(args.qk_int8),
              enable_point_head=bool(args.use_point_map))
    if args.global_softmax:
        kw["global_softmax"] = args.global_softmax
    if args.model_size == "tiny":
        return VGGTConfig.tiny(img_size=518, **kw)
    if args.model_size in ("small", "small64", "small256"):
        return getattr(VGGTConfig, args.model_size)(**kw)
    return VGGTConfig.vggt_1b(**kw)


def build_model(cfg, checkpoint=None, seed: int = 0, device="cuda"):
    """VGGT with checkpoint weights or seeded random weights drawn on
    `device`."""
    from vggt_slam_tpu_torch.models.vggt.convert import init_params, \
        load_checkpoint
    from vggt_slam_tpu_torch.models.vggt.model import VGGT
    device = resolve_device(device)
    if checkpoint:
        sd = load_checkpoint(checkpoint, device)
    else:
        sd = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device)
    with torch.device("meta"):
        model = VGGT(cfg)
    model.load_state_dict(sd, assign=True)
    return model.eval()


def build_model_fn(args, device="cuda"):
    """Build VGGT and return the bucketed prediction callable."""
    from vggt_slam_tpu_torch.models.vggt.model import make_bucketed_model_fn
    t0 = time.time()
    model = build_model(make_config(args), args.checkpoint, args.seed,
                        device)
    if not args.checkpoint:
        print("WARNING: no --checkpoint given; running with RANDOM weights "
              "(pipeline check only, geometry will be meaningless)")
    print(f"model ready in {time.time() - t0:.1f}s")
    bucket = args.submap_size + args.overlapping_window_size + args.max_loops
    return make_bucketed_model_fn(model, bucket, as_numpy=args.no_pipeline,
                                  with_unprojection=not args.use_point_map,
                                  device=device)


def run_slam(args, *, frames=None, model_fn=None, retrieval=None,
             device="cuda"):
    """The SLAM loop over `args.image_folder`, or over `frames` (decoded (H, W,
    3) uint8 BGR images). Returns {"solver", "n_frames", "wall_s", "fps",
    "timer", "voxel_map"} (None without --get_voxel)."""
    from vggt_slam_tpu_torch.data.images import downsample_images, \
        list_image_folder, load_image, preprocess_frames
    from vggt_slam_tpu_torch.models.retrieval import \
        tiny_image_descriptor_fn
    from vggt_slam_tpu_torch.slam.loop_closure import ImageRetrieval
    from vggt_slam_tpu_torch.slam.solver import Solver
    from vggt_slam_tpu_torch.utils.profiling import StageTimer

    device = resolve_device(device)
    viewer = None
    if args.vis_map or args.keep_alive:
        try:
            from vggt_slam_tpu_torch.viz.viser_viewer import ViserViewer
            viewer = ViserViewer(rng=np.random.RandomState(args.seed))
        except ImportError:
            print("viser not installed; continuing headless")
    if retrieval is None:
        retrieval = ImageRetrieval(
            descriptor_fn=(tiny_image_descriptor_fn()
                           if args.retrieval_backend == "tiny" else None),
            batch_bucket=args.submap_size + args.overlapping_window_size,
            checkpoint=args.retrieval_checkpoint, device=device)
    solver = Solver(init_conf_threshold=args.conf_threshold,
                    use_point_map=args.use_point_map, use_sim3=args.use_sim3,
                    viewer=viewer, retrieval=retrieval,
                    vis_stride=args.vis_stride,
                    vis_point_size=args.vis_point_size, seed=args.seed,
                    keyframe_backend=args.keyframe_backend,
                    loop_inlier_thresh=args.loop_inlier_thresh,
                    device=device)
    if model_fn is None:
        model_fn = build_model_fn(args, device)

    if frames is None:
        items = downsample_images(list_image_folder(args.image_folder),
                                  args.downsample_factor)
        names = items
    else:
        items = downsample_images(list(frames), args.downsample_factor)
        names = [f"{i:06d}.png" for i in range(len(items))]
    print(f"Found {len(items)} images")
    if not items:
        sys.exit(f"no images in {args.image_folder}")

    profiler = None
    if args.profile_dir:    # started after the model's build, as the reference
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    focal_data = []
    timer = StageTimer() if args.timing else None
    solver.timer = timer

    def stage(name):
        return timer.stage(name) if timer else contextlib.nullcontext()

    def load_semantics(sub_names):
        if args.semantic_emb_dir is None:
            return None
        embs = []
        for name in sub_names:
            stem = os.path.splitext(os.path.basename(name))[0]
            path = os.path.join(args.semantic_emb_dir, f"{stem}.npz")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"Missing semantic embedding for {name}: {path}")
            embs.append(np.load(path)["embedding"])
        return np.stack(embs, axis=0)

    def integrate(predictions):
        if "outputs" in predictions:
            with stage("collect_predictions"):
                predictions = solver.collect_predictions(predictions)
        focal_data.append(predictions["intrinsic"][:, 0, 0])
        with stage("add_points"), solver.side_stream():
            solver.add_points(predictions)
        with stage("graph_optimize"), solver.side_stream():
            solver.graph.optimize()
            solver.map.update_submap_homographies(solver.graph)
        if args.vis_map:
            if len(predictions["detected_loops"]) > 0:
                solver.update_all_submap_vis()
            else:
                solver.update_latest_submap_vis()

    # Dispatch-ahead: submap k+1's forward is queued before submap k is
    # integrated, so the host work overlaps the device forward.
    t_start = time.time()
    pending = None
    next_id = 0
    subset: list[int] = []
    decoded = {}      # index -> the decoded keyframes of `subset`
    for i, item in enumerate(items):
        with stage("keyframe_gate"), solver.side_stream():
            img = load_image(item) if frames is None else item
            is_kf = solver.flow_tracker.compute_disparity(
                img, args.min_disparity, args.vis_flow)
        if is_kf:
            subset.append(i)
            decoded[i] = img
        is_last = i == len(items) - 1
        if len(subset) == args.submap_size + args.overlapping_window_size \
                or (is_last and len(subset) > 1):
            images = preprocess_frames([decoded[j] for j in subset])
            sub_names = [names[j] for j in subset]
            semantic_embeddings = load_semantics(sub_names)
            if not args.no_pipeline:
                with stage("dispatch_predictions"):
                    new_pending = solver.dispatch_predictions(
                        images, model_fn, args.max_loops,
                        semantic_embeddings=semantic_embeddings,
                        names=sub_names, new_id=next_id,
                        previous_in_map=pending is None)
                if pending is not None:
                    integrate(pending)
                pending = new_pending
            else:
                with stage("run_predictions"):
                    preds = solver.run_predictions(
                        images, model_fn, args.max_loops,
                        semantic_embeddings=semantic_embeddings,
                        names=sub_names)
                integrate(preds)
            next_id += 1
            subset = subset[-args.overlapping_window_size:]
            decoded = {j: decoded[j] for j in subset}
    if pending is not None:
        integrate(pending)

    n_frames = len(items)
    dt = time.time() - t_start
    print(f"Total number of submaps in map {solver.map.get_num_submaps()}")
    print(f"Total number of loop closures in map "
          f"{solver.graph.get_num_loops()}")
    print(f"Loop closures detected {solver.detected_loop_count}, rejected "
          f"by the geometric gate {solver.rejected_loop_count}")
    print(f"Processed {n_frames} frames in {dt:.1f}s "
          f"({n_frames / dt:.2f} FPS end-to-end)")
    if timer is not None:
        print("Per-stage timing:")
        print(timer.report())
    if profiler is not None:
        profiler.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, "trace.json")
        profiler.export_chrome_trace(trace)
        print(f"Wrote the torch.profiler trace {trace}")
    if args.colmap_images_txt is not None:
        print(f"Aligning map to COLMAP poses: {args.colmap_images_txt}")
        solver.map.align_scale_to_colmap(args.colmap_images_txt,
                                         with_scale=not args.align_no_scale)
    if not args.vis_map and viewer is not None:
        solver.update_all_submap_vis()
    if args.save_path:
        os.makedirs(args.save_path, exist_ok=True)
        solver.map.write_points_to_file(
            os.path.join(args.save_path, "result.pcd"))
        solver.map.save_frame_outputs(
            os.path.join(args.save_path, "frame_output"),
            ignore_loop_closure_frames=True)
    if args.log_results:
        solver.map.write_poses_to_file(args.log_path)
        if not args.skip_dense_log:
            solver.map.save_framewise_pointclouds(
                args.log_path.replace(".txt", "_logs"))
    vm = None
    if args.get_voxel and args.semantic_emb_dir:
        with stage("semantic_voxel_map"):
            vm = solver.map.build_semantic_voxel_map(
                voxel_size=args.voxel_size, device=device)
        print(f"Semantic voxel map: {len(vm.get_centers_world())} voxels")
        if args.voxel_save_dir:
            vm.save_to_directory(args.voxel_save_dir)
            print(f"Saved semantic voxel map to {args.voxel_save_dir}")
    if args.plot_focal_lengths:
        plot_focal_lengths(focal_data)
    if args.keep_alive and viewer is not None:
        print("\nViser server is running. Press Enter to exit...")
        try:
            input()
        except (KeyboardInterrupt, EOFError):
            pass
    return {"solver": solver, "n_frames": n_frames, "wall_s": dt,
            "fps": n_frames / dt, "timer": timer, "voxel_map": vm}


def plot_focal_lengths(focal_data, path="focal_lengths.png"):
    """Each submap's focal lengths against its index (matplotlib, Agg)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    colors = plt.cm.viridis(np.linspace(0, 1, len(focal_data)))
    plt.figure(figsize=(8, 6))
    for i, values in enumerate(focal_data):
        plt.scatter([i] * len(values), values, color=colors[i])
    plt.xlabel("poses")
    plt.ylabel("Focal lengths")
    plt.grid()
    plt.savefig(path)
    plt.close()
    print(f"Saved {path}")


def main():
    args = parser.parse_args()
    run_slam(args, device=args.device)


if __name__ == "__main__":
    main()
