"""Merged-vs-exact global-attention ATE A/B (counterpart of
vggt_slam_tpu/evals/ab_attention.py): run_eval `--in_process` on synth3d
loops in a subprocess a config, on --device; means and paired deltas.

    python -m vggt_slam_tpu_torch.evals.ab_attention \
        --checkpoint warmcache/small_synth/checkpoint.npz [--n_sequences 3]
"""
from __future__ import annotations

import argparse
import csv
import os
import subprocess
import sys
import tempfile

import numpy as np

# (name, global_kv_stride, global_softmax, attn_impl); None: the CLI's flash
CONFIGS = [
    ("exact_online", 1, "online", None),
    ("exact_static", 1, "static", None),
    ("merged_online", 4, "online", None),
    ("merged_static", 4, "static", None),
    ("merged8_online", 8, "online", None),
    ("merged8_static", 8, "static", None),
    ("exact_chunked", 1, "online", "chunked"),
    ("merged8_chunked", 8, "online", "chunked"),
    ("merged16_chunked", 16, "online", "chunked"),
    ("merged8_flash_full", 8, "static", "flash"),
    ("merged16_flash_full", 16, "static", "flash"),
    ("merged16_online", 16, "online", None),
    ("merged16_static", 16, "static", None),
]

SEQ_SEED_BASE = 5_000_000      # disjoint from train_tiny's seeds


def generate_sequences(root: str, n: int, n_frames: int,
                       image_hw: tuple[int, int]) -> list[str]:
    from vggt_slam_tpu_torch.tools.synth3d import write_tum_sequence
    dirs = []
    for i in range(n):
        d = os.path.join(root, f"seq{i:03d}")
        if not os.path.exists(os.path.join(d, "groundtruth.txt")):
            write_tum_sequence(d, n_frames=n_frames,
                               seed=SEQ_SEED_BASE + i, image_hw=image_hw,
                               kind="loop")
        dirs.append(d)
    return dirs


def run_config(name: str, stride: int, softmax: str, impl, seq_root: str,
               seqs: list[str], args) -> list[dict]:
    """One config's rows: `<out>_rows/<name>.csv` where a run finished,
    else run_eval's in a subprocess."""
    rows_dir = (args.out[:-4] if args.out.endswith(".csv")
                else args.out) + "_rows"
    os.makedirs(rows_dir, exist_ok=True)
    out_csv = os.path.join(rows_dir, f"{name}.csv")
    expected = len(seqs) * args.trials
    rows = []
    if os.path.exists(out_csv):
        with open(out_csv) as f:
            rows = list(csv.DictReader(f))
        if len(rows) >= expected:
            print(f"[{name}] cached: {len(rows)} rows from {out_csv}",
                  flush=True)
        else:
            print(f"[{name}] stale cache ({len(rows)}/{expected} rows); "
                  "re-running", flush=True)
            rows = []
    if not rows:
        cmd = [sys.executable, "-m", "vggt_slam_tpu_torch.evals.run_eval",
               "--dataset_root", seq_root,
               "--sequences", *[os.path.basename(s) for s in seqs],
               "--trials", str(args.trials),
               "--submap_size", str(args.submap_size),
               "--min_disparity", str(args.min_disparity),
               "--conf_threshold", str(args.conf_threshold),
               "--model_size", args.model_size,
               "--global_kv_stride", str(stride),
               "--global_softmax", softmax,
               "--retrieval_backend", "tiny",
               "--in_process",
               "--out", out_csv, "--device", args.device]
        if args.loop_inlier_thresh is not None:
            cmd += ["--loop_inlier_thresh", str(args.loop_inlier_thresh)]
        if args.checkpoint:
            cmd += ["--checkpoint", args.checkpoint]
        if impl or args.attn_impl:
            cmd += ["--attn_impl", impl or args.attn_impl]
        print(f"[{name}] {' '.join(cmd)}", flush=True)
        proc = subprocess.run(cmd, text=True, capture_output=True)
        sys.stdout.write(proc.stdout[-4000:])
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise RuntimeError(f"config {name} failed ({proc.returncode})")
        with open(out_csv) as f:
            rows = list(csv.DictReader(f))
    for r in rows:
        r["config"] = name
        r["global_kv_stride"] = stride
        r["global_softmax"] = softmax
        r["attn_impl"] = impl or args.attn_impl or "default"
    return rows


def summarize(rows: list[dict]) -> list[dict]:
    out = []
    for name, stride, softmax, _impl in CONFIGS:
        ates = [float(r["ate_rmse"]) for r in rows
                if r["config"] == name and r.get("ate_rmse") not in (None, "")]
        if not ates:
            continue
        scales = [float(r["ate_scale"]) for r in rows
                  if r["config"] == name and r.get("ate_scale")]
        out.append({"config": name, "global_kv_stride": stride,
                    "global_softmax": softmax, "n": len(ates),
                    "ate_rmse_mean": round(float(np.mean(ates)), 6),
                    "ate_rmse_max": round(float(np.max(ates)), 6),
                    "ate_scale_mean": round(float(np.mean(scales)), 4)
                    if scales else ""})
    return out


def paired_deltas(rows: list[dict], base: str, n_boot: int = 20000,
                  seed: int = 0) -> list[dict]:
    """Per-sequence paired (config - base) ATE deltas: mean, bootstrap 95%
    CI, p90, max, the worst sequence."""
    by = {}
    for r in rows:
        if r.get("ate_rmse") in (None, ""):
            continue
        by.setdefault(r["config"], {})[
            (r["sequence"], r.get("trial", "0"))] = float(r["ate_rmse"])
    if base not in by:
        return []
    out = []
    rng = np.random.default_rng(seed)
    for name in by:
        if name == base:
            continue
        keys = sorted(set(by[name]) & set(by[base]))
        if not keys:
            continue
        d = np.array([by[name][k] - by[base][k] for k in keys])
        boots = rng.choice(d, size=(n_boot, len(d)), replace=True).mean(1)
        lo, hi = np.percentile(boots, [2.5, 97.5])
        out.append({"config": name, "base": base, "n_pairs": len(d),
                    "delta_mean_m": round(float(d.mean()), 6),
                    "delta_ci95_lo_m": round(float(lo), 6),
                    "delta_ci95_hi_m": round(float(hi), 6),
                    "delta_p90_m": round(float(np.percentile(d, 90)), 6),
                    "delta_max_m": round(float(d.max()), 6),
                    "worst_sequence": keys[int(np.argmax(d))][0],
                    "frac_sequences_worse": round(float((d > 0).mean()), 3)})
    return out


def _write(path, rows, keys):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {path}")


def main(argv=None):
    p = argparse.ArgumentParser(description="merged-vs-exact attention A/B")
    p.add_argument("--checkpoint",
                   default="warmcache/small_synth/checkpoint.npz")
    p.add_argument("--model_size", default="small")
    p.add_argument("--seq_root",
                   default=os.path.join(tempfile.gettempdir(), "ab_synth3d"))
    for name, kind, v in (("n_sequences", int, 3), ("n_frames", int, 60),
                          ("trials", int, 1), ("submap_size", int, 8),
                          ("min_disparity", float, 20),
                          ("conf_threshold", float, 25)):
        p.add_argument(f"--{name}", type=kind, default=v)
    p.add_argument("--image_hw", type=int, nargs=2, default=(392, 518))
    p.add_argument("--loop_inlier_thresh", type=float, default=None,
                   help="forwarded to run_eval (None: the CLI's gate)")
    p.add_argument("--configs", nargs="+", default=None,
                   help="subset of config names to run")
    p.add_argument("--attn_impl", default=None,
                   choices=[None, "flash", "chunked"],
                   help="attention implementation for every config")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="evals/results/ab_attention.csv")
    args = p.parse_args(argv)

    os.makedirs(args.seq_root, exist_ok=True)
    seqs = generate_sequences(args.seq_root, args.n_sequences,
                              args.n_frames, tuple(args.image_hw))
    print(f"{len(seqs)} sequences under {args.seq_root}", flush=True)
    rows = []
    for name, stride, softmax, impl in CONFIGS:
        if not args.configs or name in args.configs:
            rows += run_config(name, stride, softmax, impl, args.seq_root,
                               seqs, args)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    _write(args.out, rows, sorted({k for r in rows for k in r}))
    summary = summarize(rows)
    for s in summary:
        print(s)
    _write(args.out.replace(".csv", "_summary.csv"), summary,
           list(summary[0]) if summary else ["config"])
    pairs = []
    for base in ("exact_online", "exact_static", "exact_chunked"):
        pairs += paired_deltas(rows, base)
    for r in pairs:
        print(f"{r['config']} - {r['base']}: {r['delta_mean_m']:+.4f} m "
              f"[95% CI {r['delta_ci95_lo_m']:+.4f}, "
              f"{r['delta_ci95_hi_m']:+.4f}] n={r['n_pairs']}")
    if pairs:
        _write(args.out.replace(".csv", "_paired.csv"), pairs,
               list(pairs[0]))
    return rows, summary, pairs


if __name__ == "__main__":
    main()
