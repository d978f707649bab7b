"""How much host work the dispatch-ahead pipeline hides (counterpart of
vggt_slam_tpu/evals/pipeline_overlap.py): the real CLI loop (main.run_slam)
on a synthetic TUM sequence, in one process on one model, as a warm-up on
the first frames (discarded), the serial flow (--no_pipeline) and the
pipelined flow (the default). It reports both runs' FPS, stage tables and
host/forward splits, and a JSON line of them last. Serial wall ~= host
stages + blocking forward; the pipelined wall is nearer max(host, device)
per submap.

  python -m vggt_slam_tpu_torch.evals.pipeline_overlap [--frames 320] \
      [--device cuda] [--out pipeline_overlap.txt]
"""
from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import time
from contextlib import redirect_stdout

HOST_STAGES = ("keyframe_gate", "collect_predictions", "add_points",
               "graph_optimize", "ap_ransac", "ap_loop_ransac", "ap_gate_ref",
               "ap_submap_store")


def stage_table(timer) -> str:
    rows = ["    stage                    total_s  calls  mean_ms"]
    for name in sorted(timer.totals):
        t, c = timer.totals[name], timer.counts[name]
        rows.append(f"    {name:<24} {t:7.2f} {c:6d} {1e3 * t / c:8.1f}")
    return "\n".join(rows)


def host_device_split(timer) -> tuple[float, float]:
    """(host stage seconds, forward dispatch or run seconds)."""
    host = sum(timer.totals.get(k, 0.0) for k in HOST_STAGES)
    fwd = (timer.totals.get("dispatch_predictions", 0.0)
           + timer.totals.get("run_predictions", 0.0))
    return host, fwd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=320)
    p.add_argument("--seq_dir", default=os.path.join(
        tempfile.gettempdir(), "pipeline_overlap_seq"))
    p.add_argument("--image_hw", type=int, nargs=2, default=(392, 518))
    p.add_argument("--model_size", default="1b")
    p.add_argument("--submap_size", type=int, default=32)
    # the synthetic path moves a few px a frame at 392x518: the CLI's
    # default disparity (50) would keyframe almost nothing
    p.add_argument("--min_disparity", type=float, default=5.0)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default="cuda")
    # >= 3 submaps, so the warm-up also runs the registration path
    p.add_argument("--warmup_frames", type=int, default=150)
    p.add_argument("--out", default="pipeline_overlap.txt")
    args = p.parse_args(argv)

    import torch

    from vggt_slam_tpu_torch import main as slam_main
    from vggt_slam_tpu_torch.tools.synth3d import write_tum_sequence
    from vggt_slam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if not os.path.exists(os.path.join(args.seq_dir, "groundtruth.txt")):
        print(f"rendering {args.frames} frames to {args.seq_dir} ...",
              flush=True)
        t0 = time.time()
        write_tum_sequence(args.seq_dir, n_frames=args.frames,
                           seed=8_000_000, image_hw=tuple(args.image_hw),
                           kind="loop")
        print(f"rendered in {time.time() - t0:.0f}s", flush=True)

    base_flags = ["--image_folder", os.path.join(args.seq_dir, "rgb"),
                  "--timing", "--submap_size", str(args.submap_size),
                  "--max_loops", "1",
                  "--min_disparity", str(args.min_disparity),
                  "--model_size", args.model_size,
                  "--retrieval_backend", "tiny", "--device", args.device]
    if args.checkpoint:
        base_flags += ["--checkpoint", args.checkpoint]
    run_args = slam_main.parser.parse_args(base_flags)
    model_fn = slam_main.build_model_fn(run_args, device)

    def one_run(extra, label, image_folder=None):
        flags = list(base_flags) + extra
        if image_folder:
            flags[1] = image_folder
        a = slam_main.parser.parse_args(flags)
        print(f"=== {label} ...", flush=True)
        with redirect_stdout(io.StringIO()):
            res = slam_main.run_slam(a, model_fn=model_fn, device=device)
        print(f"=== {label}: {res['fps']:.2f} FPS "
              f"({res['n_frames']} frames / {res['wall_s']:.1f}s)",
              flush=True)
        return res

    # The warm-up takes the first frames through hard links, so that its
    # first-call costs stay out of the two timed runs.
    rgb = os.path.join(args.seq_dir, "rgb")
    warm_sub = os.path.join(args.seq_dir, "warmup_rgb")
    os.makedirs(warm_sub, exist_ok=True)
    for n in sorted(os.listdir(rgb))[: args.warmup_frames]:
        dst = os.path.join(warm_sub, n)
        if not os.path.exists(dst):
            os.link(os.path.join(rgb, n), dst)
    one_run([], "warmup", image_folder=warm_sub)
    # serial first: a cost that leaked past the warm-up lands there, against
    # the overlap
    ser = one_run(["--no_pipeline"], "serial (--no_pipeline)")
    pip = one_run([], "pipelined (default)")

    ph, pf = host_device_split(pip["timer"])
    sh, sf = host_device_split(ser["timer"])
    hidden = ser["wall_s"] - pip["wall_s"]
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    def head(name, r):
        return (f"{name}: {r['fps']:.2f} FPS end-to-end ({r['n_frames']} "
                f"frames / {r['wall_s']:.1f} s); submaps="
                f"{r['solver'].map.get_num_submaps()} "
                f"loops={r['solver'].graph.get_num_loops()}")

    lines = [
        "Pipeline-overlap measurement (sustained synthetic run)",
        f"device={kind} model={args.model_size} submap={args.submap_size} "
        f"frames={args.frames} image_hw={tuple(args.image_hw)} "
        f"stride={run_args.global_kv_stride or 'default'} retrieval=tiny",
        "", head("PIPELINED (default)", pip), stage_table(pip["timer"]),
        "", head("SERIAL (--no_pipeline)", ser), stage_table(ser["timer"]),
        "", "Accounting:",
        f"  serial wall {ser['wall_s']:.1f} s ~= host stages {sh:.1f} s "
        f"+ blocking forward {sf:.1f} s",
        f"  pipelined wall {pip['wall_s']:.1f} s with host stages "
        f"{ph:.1f} s and dispatch {pf:.1f} s",
        f"  -> the pipeline hides {hidden:.1f} s "
        f"({1e3 * hidden / max(pip['n_frames'], 1):.1f} ms/frame); "
        f"speedup x{ser['wall_s'] / pip['wall_s']:.2f}",
        "  note: in the pipelined run a stage that waits on the device "
        "(collect_predictions, and the host reads of add_points) includes "
        "time queued behind the dispatched forward, so the stage walls sum "
        "past the wall.",
    ]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"\nwrote {args.out}")
    summary = {"device": kind}
    for name, r, (h, fwd) in (("serial", ser, (sh, sf)),
                              ("pipelined", pip, (ph, pf))):
        summary[name] = {"fps": r["fps"], "wall_s": r["wall_s"],
                         "frames": r["n_frames"], "host_s": h,
                         "forward_s": fwd,
                         "submaps": r["solver"].map.get_num_submaps()}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
