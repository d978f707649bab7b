"""Aggregate eval CSV logs without pandas (counterpart of
vggt_slam_tpu/evals/process_logs.py): per sequence each metric's mean,
std and count, the per-trial means, the overall mean and std, as pandas
(empty or non-numeric cells NaN and skipped, std ddof 1, groups sorted).

  python -m vggt_slam_tpu_torch.evals.process_logs results.csv
"""
from __future__ import annotations

import argparse
import csv

import numpy as np


def _num(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def _stats(values) -> dict:
    x = np.array([_num(v) for v in values], np.float64)
    x = x[~np.isnan(x)]
    return {"mean": float(x.mean()) if x.size else float("nan"),
            "std": float(x.std(ddof=1)) if x.size > 1 else float("nan"),
            "count": int(x.size)}


def _key(v):
    f = _num(v)
    return (0, f, "") if f == f else (1, 0.0, v)


def summary_tables(csv_path: str, metrics=("ate_rmse",)):
    """(per sequence {seq: {metric: {mean, std, count}}}, per trial
    {trial: {metric: mean}}, overall {metric: {mean, std}})."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        present = [m for m in metrics if m in (reader.fieldnames or [])]

    def grouped(col):
        keys = sorted({r[col] for r in rows}, key=_key)
        return {k: [r for r in rows if r[col] == k] for k in keys}

    per_seq = {s: {m: _stats(r[m] for r in rs) for m in present}
               for s, rs in grouped("sequence").items()}
    per_trial = {t: {m: _stats(r[m] for r in rs)["mean"] for m in present}
                 for t, rs in grouped("trial").items()}
    overall = {m: {k: v for k, v in _stats(r[m] for r in rows).items()
                   if k != "count"} for m in present}
    return per_seq, per_trial, overall


def summarize(csv_path: str, metrics=("ate_rmse",)) -> dict:
    per_seq, per_trial, overall = summary_tables(csv_path, metrics)
    print("== per-sequence ==")
    for seq, ms in per_seq.items():
        print(seq, "  ".join(f"{m} mean {s['mean']:.6f} std {s['std']:.6f} "
                             f"count {s['count']}" for m, s in ms.items()))
    print("\n== per-trial means ==")
    for trial, ms in per_trial.items():
        print(trial, "  ".join(f"{m} {v:.6f}" for m, v in ms.items()))
    print("\n== overall ==")
    for m, s in overall.items():
        print(f"{m} mean {s['mean']:.6f} std {s['std']:.6f}")
    return per_seq


def main():
    p = argparse.ArgumentParser()
    p.add_argument("csv")
    p.add_argument("--metrics", nargs="+",
                   default=["ate_rmse", "wall_s", "rmse_accuracy",
                            "rmse_completeness", "chamfer_rmse"])
    args = p.parse_args()
    summarize(args.csv, args.metrics)


if __name__ == "__main__":
    main()
