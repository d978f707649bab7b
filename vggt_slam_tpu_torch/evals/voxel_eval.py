"""Semantic voxel map evaluation over a job grid (counterpart of
vggt_slam_tpu/evals/voxel_eval.py): search_validity (a text query -> the
top voxels -> each one's latest contributing frame, valid when the first
number in its name lies within `tolerance_ns` of a ground-truth stamp:
TUM names give seconds, so pass the tolerance in their units; the text
tower runs on the job's `device`, by default --device), voxel_count and
perf (the host query's wall time).

    python -m vggt_slam_tpu_torch.evals.voxel_eval --config JOBS.json \
        [--out OUT.json] [--device cuda|cpu]

JOBS.json: {"jobs": [{"voxel_dir": ..., "evaluator": "search_validity",
"queries": {"a chair": [stamp, ...]}, "tolerance_ns": 5e7, "sweep":
{"top_k": [1, 5]}}], "num_workers": 1}; lists under "sweep" are axes.
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import re
import time
from typing import Any, Dict

import numpy as np


def _load(voxel_dir):
    from vggt_slam_tpu_torch.semantic.voxel_map import SemanticVoxelMap
    return SemanticVoxelMap.load_from_directory(voxel_dir)


class SearchValidityEvaluator:
    def __init__(self, voxel_dir: str, queries: Dict[str, list],
                 tolerance_ns: float = 5e7, clip_model_dir: str | None = None,
                 top_k: int = 1, clip_backend: str = "auto",
                 device="cuda"):
        self.vm = _load(voxel_dir)
        self.queries = queries
        self.tolerance_ns = float(tolerance_ns)
        self.clip_model_dir = clip_model_dir
        self.clip_backend = clip_backend
        self.top_k = top_k
        self.device = device

    def _embed(self, text: str) -> np.ndarray:
        from vggt_slam_tpu_torch.tools.query_voxelmap import text_embedding
        return text_embedding(text, self.vm.get_features().shape[-1],
                              self.clip_model_dir, self.clip_backend,
                              self.device)

    @staticmethod
    def _timestamp_of(frame_name: str) -> float:
        m = re.search(r"\d+(?:\.\d+)?", frame_name)
        return float(m.group()) if m else float("nan")

    def run(self) -> Dict[str, Any]:
        results = {}
        n_valid = 0
        for text, gt_timestamps in self.queries.items():
            idx, _, sims = self.vm.query_with_embedding(self._embed(text),
                                                        top_k=self.top_k)
            hits = []
            for i in idx:
                name, sid, fid = self.vm.get_latest_frame_at_voxel(i)
                ts = self._timestamp_of(str(name))
                ok = any(abs(ts - float(g)) <= self.tolerance_ns
                         for g in gt_timestamps)
                hits.append({"frame": name, "timestamp": ts, "valid": ok})
            valid = any(h["valid"] for h in hits)
            n_valid += int(valid)
            results[text] = {"valid": valid, "hits": hits,
                             "best_similarity": sims[0] if sims else None}
        return {"per_query": results,
                "validity_rate": n_valid / max(len(self.queries), 1)}


class VoxelCountEvaluator:
    def __init__(self, voxel_dir: str, **_):
        self.vm = _load(voxel_dir)

    def run(self) -> Dict[str, Any]:
        centers = self.vm.get_centers_world()
        return {"num_voxels": int(centers.shape[0]),
                "feature_dim": int(self.vm.get_features().shape[-1]),
                "voxel_size": self.vm.get_voxel_size(),
                "bbox": None if centers.shape[0] == 0 else
                np.ptp(centers, axis=0).tolist()}


class PerfEvaluator:
    def __init__(self, voxel_dir: str, queries=None, n_repeats: int = 20, **_):
        self.vm = _load(voxel_dir)
        self.n_repeats = n_repeats

    def run(self) -> Dict[str, Any]:
        d = self.vm.get_features().shape[-1]
        q = np.random.default_rng(0).normal(size=d).astype(np.float32)
        t0 = time.time()
        for _ in range(self.n_repeats):
            self.vm.query_with_embedding(q, top_k=5)
        dt = (time.time() - t0) / self.n_repeats
        return {"query_latency_ms": round(dt * 1e3, 3),
                "queries_per_sec": round(1.0 / dt, 1)}


_EVALUATORS = {
    "search_validity": SearchValidityEvaluator,
    "voxel_count": VoxelCountEvaluator,
    "perf": PerfEvaluator,
}


def get_evaluator(name: str):
    if name not in _EVALUATORS:
        raise ValueError(f"unknown evaluator {name!r}; have "
                         f"{list(_EVALUATORS)}")
    return _EVALUATORS[name]


def expand_job_grid(job: Dict[str, Any]):
    """One job for each combination of the lists under job["sweep"] (which
    is popped)."""
    sweep = job.pop("sweep", None)
    if not sweep:
        return [job]
    keys = sorted(sweep)
    out = []
    for combo in itertools.product(*(sweep[k] for k in keys)):
        j = dict(job)
        j.update(dict(zip(keys, combo)))
        out.append(j)
    return out


def run_job(job: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The job's evaluator on `device` unless the job names its own; the
    record's params are the job's as given."""
    job = dict(job)
    name = job.pop("evaluator")
    ev = get_evaluator(name)(**{"device": device, **job})
    t0 = time.time()
    res = ev.run()
    return {"evaluator": name, "params": job, "result": res,
            "wall_s": round(time.time() - t0, 2)}


def run_experiment(config_path: str, out_path: str | None = None,
                   device="cuda"):
    with open(config_path) as f:
        cfg = json.load(f)
    jobs = [g for j in cfg["jobs"] for g in expand_job_grid(j)]
    num_workers = int(cfg.get("num_workers", 1))
    run = functools.partial(run_job, device=device)
    if num_workers > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(num_workers) as pool:
            results = pool.map(run, jobs)
    else:
        results = [run(j) for j in jobs]
    out = {"config": config_path, "results": results}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Voxel map evaluation grid")
    p.add_argument("--config", required=True)
    p.add_argument("--out", default="voxel_eval_results.json")
    p.add_argument("--device", default="cuda",
                   help="where the text tower runs (cuda, or cpu)")
    args = p.parse_args(argv)
    out = run_experiment(args.config, args.out, args.device)
    for r in out["results"]:
        print(r["evaluator"], json.dumps(r["result"])[:200])
    return out


if __name__ == "__main__":
    main()
