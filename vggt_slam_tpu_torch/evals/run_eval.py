"""Dataset evaluation runner for TUM / 7-Scenes / EuRoC sweeps (counterpart
of vggt_slam_tpu/evals/run_eval.py): each sequence and trial runs the
port's CLI with --log_results (a subprocess, or with --in_process one
model and retrieval for the sweep), scores the Sim(3)-aligned ATE against
the ground truth and appends a CSV row; --device goes to the CLI.

  python -m vggt_slam_tpu_torch.evals.run_eval --dataset_root DIR \
      --sequences SEQ ... --trials 5 --submap_size 16 --out results.csv
"""
from __future__ import annotations

import argparse
import csv
import os
import subprocess
import sys
import tempfile
import time


def find_gt_file(seq_dir: str) -> str | None:
    for cand in ("groundtruth.txt", "gt.txt", "pose.txt"):
        p = os.path.join(seq_dir, cand)
        if os.path.exists(p):
            return p
    return None


def find_image_dir(seq_dir: str) -> str:
    for cand in ("rgb", "images", "cam0/data", "."):
        p = os.path.join(seq_dir, cand)
        if os.path.isdir(p):
            return p
    return seq_dir


_WARM = {"model_fn": None, "retrieval": None}


def _slam_flags(image_dir: str, args, log_path: str) -> list[str]:
    flags = ["--image_folder", image_dir,
             "--log_results", "--skip_dense_log",
             "--log_path", log_path,
             "--submap_size", str(args.submap_size),
             "--max_loops", str(args.max_loops),
             "--min_disparity", str(args.min_disparity),
             "--conf_threshold", str(args.conf_threshold)]
    if args.loop_inlier_thresh is not None:
        flags += ["--loop_inlier_thresh", str(args.loop_inlier_thresh)]
    if args.use_sim3:
        flags.append("--use_sim3")
    if args.checkpoint:
        flags += ["--checkpoint", args.checkpoint]
    if args.downsample_factor > 1:
        flags += ["--downsample_factor", str(args.downsample_factor)]
    if args.model_size != "1b":
        flags += ["--model_size", args.model_size]
    # always pass the stride: the CLI's default is the merged one, which
    # would override a stride-1 (exact attention) request from here
    flags += ["--global_kv_stride", str(args.global_kv_stride)]
    if args.global_softmax:
        flags += ["--global_softmax", args.global_softmax]
    if args.attn_impl:
        flags += ["--attn_impl", args.attn_impl]
    if args.keyframe_backend:
        flags += ["--keyframe_backend", args.keyframe_backend]
    if args.retrieval_backend:
        flags += ["--retrieval_backend", args.retrieval_backend]
    if args.device:
        flags += ["--device", args.device]
    return flags


def run_sequence(seq_dir: str, args, trial: int, log_path: str) -> dict:
    image_dir = find_image_dir(seq_dir)
    flags = _slam_flags(image_dir, args, log_path)
    if args.in_process:
        # The model and the retrieval are built once, outside the timed
        # window, and reused by every trial (the sweep's knobs that change
        # the model are fixed per sweep).
        from vggt_slam_tpu_torch import main as slam_main
        from vggt_slam_tpu_torch.models.retrieval import \
            tiny_image_descriptor_fn
        from vggt_slam_tpu_torch.slam.loop_closure import ImageRetrieval
        run_args = slam_main.parser.parse_args(flags)
        if _WARM["model_fn"] is None:
            _WARM["model_fn"] = slam_main.build_model_fn(run_args,
                                                         run_args.device)
            _WARM["retrieval"] = ImageRetrieval(
                descriptor_fn=(tiny_image_descriptor_fn()
                               if run_args.retrieval_backend == "tiny"
                               else None),
                batch_bucket=(run_args.submap_size
                              + run_args.overlapping_window_size),
                checkpoint=run_args.retrieval_checkpoint,
                device=run_args.device)
        t0 = time.time()
        slam_main.run_slam(run_args, model_fn=_WARM["model_fn"],
                           retrieval=_WARM["retrieval"],
                           device=run_args.device)
    else:
        t0 = time.time()
        cmd = [sys.executable, "-m", "vggt_slam_tpu_torch.main"] + flags
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-2000:])
            raise RuntimeError(f"SLAM run failed on {seq_dir}")
    wall = time.time() - t0
    row = {"sequence": os.path.basename(seq_dir), "trial": trial,
           "wall_s": round(wall, 1)}

    gt = find_gt_file(seq_dir)
    if gt:
        from vggt_slam_tpu_torch.evals.ate import ate_from_files
        try:
            r = ate_from_files(gt, log_path, align_scale=True,
                               max_diff=args.max_assoc_diff)
            row.update(ate_rmse=round(r.rmse, 6), ate_pairs=r.n_pairs,
                       ate_scale=round(r.scale, 4))
        except ValueError as e:
            row.update(ate_rmse=float("nan"), ate_error=str(e))
    return row


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SLAM dataset eval sweep")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--sequences", nargs="+", required=True)
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--submap_size", type=int, default=16)
    p.add_argument("--max_loops", type=int, default=1)
    p.add_argument("--min_disparity", type=float, default=50)
    p.add_argument("--conf_threshold", type=float, default=25)
    p.add_argument("--loop_inlier_thresh", type=float, default=None,
                   help="forwarded to the CLI (None = its default gate)")
    p.add_argument("--downsample_factor", type=int, default=1)
    p.add_argument("--use_sim3", action="store_true")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model_size", default="1b",
                   choices=["1b", "small", "small64", "small256", "tiny"])
    p.add_argument("--global_kv_stride", type=int, default=1)
    p.add_argument("--global_softmax", default=None,
                   choices=[None, "online", "static"])
    p.add_argument("--attn_impl", default=None,
                   choices=[None, "flash", "chunked"])
    p.add_argument("--keyframe_backend", default=None,
                   choices=[None, "auto", "cv2", "torch"])
    p.add_argument("--retrieval_backend", default=None,
                   choices=[None, "salad", "tiny"])
    p.add_argument("--device", default=None,
                   help="forwarded to the CLI (None = its default, cuda)")
    p.add_argument("--max_assoc_diff", type=float, default=0.02)
    p.add_argument("--in_process", action="store_true",
                   help="run the trials in this process on one model "
                        "(a subprocess per trial otherwise)")
    p.add_argument("--out", default="eval_results.csv")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    rows = []
    for seq in args.sequences:
        seq_dir = os.path.join(args.dataset_root, seq)
        if not os.path.isdir(seq_dir):
            print(f"skip missing sequence {seq_dir}")
            continue
        for trial in range(args.trials):
            with tempfile.TemporaryDirectory() as td:
                log_path = os.path.join(td, "poses.txt")
                row = run_sequence(seq_dir, args, trial, log_path)
            rows.append(row)
            print(row)

    if rows:
        keys = sorted({k for r in rows for k in r})
        write_header = not os.path.exists(args.out)
        with open(args.out, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            if write_header:
                w.writeheader()
            w.writerows(rows)
        print(f"wrote {len(rows)} rows to {args.out}")
    return rows


if __name__ == "__main__":
    main()
