"""CLI-level loop-closure smoke run (counterpart of
vggt_slam_tpu/evals/smoke_loop.py): a synthetic sequence whose path closes
on its start (synth3d kind="loop") through the port's CLI in a subprocess
with the tiny retrieval backend; passes (exit 0) when the run writes the
TUM log, at least one loop closure lands in the graph, and with
--checkpoint the Sim3-aligned ATE RMSE is under --max_ate.

    python -m vggt_slam_tpu_torch.evals.smoke_loop [--device cpu] \
        [--checkpoint warmcache/small_synth/checkpoint.npz --model_size small]
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

SEQ_SEED = 4_000_000  # disjoint from train (1..steps) / val (1M+) / A/B (5M+)


def main() -> int:
    p = argparse.ArgumentParser(description="loop-closure smoke acceptance")
    p.add_argument("--checkpoint", default=None,
                   help="VGGT weights (flat npz); ATE is only asserted when "
                        "given (random weights give meaningless geometry)")
    p.add_argument("--model_size", default="small")
    p.add_argument("--n_frames", type=int, default=40)
    p.add_argument("--image_hw", type=int, nargs=2, default=(392, 518))
    p.add_argument("--submap_size", type=int, default=4)
    p.add_argument("--max_loops", type=int, default=3)
    p.add_argument("--min_disparity", type=float, default=8)
    p.add_argument("--max_ate", type=float, default=0.5,
                   help="Sim3-aligned ATE RMSE bound (m), asserted only "
                        "with --checkpoint")
    p.add_argument("--seq_dir", default=None,
                   help="reuse/keep the sequence here (tempdir otherwise)")
    p.add_argument("--device", default="cuda",
                   help="forwarded to the CLI (cpu runs without a card)")
    p.add_argument("--loop_inlier_thresh", default=None,
                   help="forwarded to the CLI where given (0 = no "
                        "geometric loop gate); the CLI's default otherwise")
    args = p.parse_args()

    from vggt_slam_tpu_torch.tools.synth3d import write_tum_sequence

    with tempfile.TemporaryDirectory() as td:
        seq_dir = args.seq_dir or os.path.join(td, "loop_seq")
        if not os.path.exists(os.path.join(seq_dir, "groundtruth.txt")):
            write_tum_sequence(seq_dir, n_frames=args.n_frames,
                               seed=SEQ_SEED, image_hw=tuple(args.image_hw),
                               kind="loop")
        log_path = os.path.join(td, "poses.txt")
        cmd = [sys.executable, "-m", "vggt_slam_tpu_torch.main",
               "--image_folder", os.path.join(seq_dir, "rgb"),
               "--retrieval_backend", "tiny",
               "--log_results", "--skip_dense_log",
               "--log_path", log_path,
               "--submap_size", str(args.submap_size),
               "--max_loops", str(args.max_loops),
               "--min_disparity", str(args.min_disparity),
               "--model_size", args.model_size,
               "--device", args.device]
        if args.checkpoint:
            cmd += ["--checkpoint", args.checkpoint]
        if args.loop_inlier_thresh is not None:
            cmd += ["--loop_inlier_thresh", args.loop_inlier_thresh]
        print("RUN:", " ".join(cmd), flush=True)
        proc = subprocess.run(cmd, text=True, capture_output=True)
        sys.stdout.write(proc.stdout[-3000:])
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-3000:])
            print("SMOKE FAIL: CLI exited nonzero")
            return 1

        m = re.search(r"Total number of loop closures in map (\d+)",
                      proc.stdout)
        n_loops = int(m.group(1)) if m else -1
        if n_loops < 1:
            print(f"SMOKE FAIL: expected >=1 loop closure, got {n_loops}")
            return 1
        if not os.path.exists(log_path):
            print("SMOKE FAIL: trajectory log missing")
            return 1

        msg = f"{n_loops} loop closure(s)"
        if args.checkpoint:
            from vggt_slam_tpu_torch.evals.ate import ate_from_files
            r = ate_from_files(os.path.join(seq_dir, "groundtruth.txt"),
                               log_path, align_scale=True)
            msg += f", ATE RMSE {r.rmse:.4f} m over {r.n_pairs} poses"
            if r.rmse > args.max_ate:
                print(f"SMOKE FAIL: ATE {r.rmse:.4f} > bound {args.max_ate}")
                return 1
        print(f"SMOKE PASS: {msg}")
        return 0


if __name__ == "__main__":
    sys.exit(main())
