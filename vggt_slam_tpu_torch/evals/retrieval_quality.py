"""Loop-closure retrieval precision and recall on synth3d loops
(counterpart of vggt_slam_tpu/evals/retrieval_quality.py): backends `tiny`
and `salad_random` (full width on the card, SALADConfig.tiny() on the
CPU), --geometric_gate by ops/homography.ransac_projective, on --device.

    python -m vggt_slam_tpu_torch.evals.retrieval_quality \
        [--backends tiny salad_random] [--device cpu] [--out CSV]
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch
import torch.nn.functional as F

from vggt_slam_tpu_torch.utils.device import resolve_device


def render_sequence(seed: int, n_frames: int, image_hw: tuple[int, int]):
    """(frames (S, 3, H, W) in [0, 1], centers, world->cam rotations,
    depths (S, H, W), K) of a synth3d loop."""
    from vggt_slam_tpu_torch.tools import synth3d
    H, W = image_hw
    scene = synth3d.make_scene(seed=seed)
    centers, rots = synth3d.camera_path(n_frames, seed=seed, kind="loop")
    K = synth3d.camera_intrinsics(H, W)
    frames = np.empty((n_frames, 3, H, W), np.float32)
    depths = np.empty((n_frames, H, W), np.float32)
    for i in range(n_frames):
        rgb, depths[i], _ = synth3d.render(scene, centers[i], rots[i], K,
                                           (H, W))
        frames[i] = rgb.transpose(2, 0, 1)
    return frames, centers, rots, depths, K


def make_gate_fn(depths: np.ndarray, K: np.ndarray, stride: int = 4,
                 depth_noise: float = 0.02, seed: int = 0,
                 ransac_threshold: float = 0.01, device="cuda"):
    """The Solver's loop gate on noisy GT depth: a pair's RANSAC inlier
    fraction over same-frame pairs' median; a generator a pair, seeded as
    the reference's key."""
    from vggt_slam_tpu_torch.ops.homography import ransac_projective

    dev = resolve_device(device)
    S, H, W = depths.shape
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    rays = np.linalg.inv(K) @ np.stack(
        [u, v, np.ones_like(u)], 0).reshape(3, -1)
    rays = rays.reshape(3, H, W)[:, ::stride, ::stride].reshape(3, -1)
    rng = np.random.default_rng(seed)

    def cloud(i: int) -> torch.Tensor:
        d = depths[i, ::stride, ::stride].reshape(-1)
        d = d * (1.0 + depth_noise * rng.standard_normal(d.shape))
        return torch.from_numpy((rays * d).T.astype(np.float32)).to(dev)

    def frac(qi: int, mi: int, salt: int = 0) -> float:
        X1, X2 = cloud(qi), cloud(mi)
        gen = torch.Generator(device=dev).manual_seed(int(qi * S + mi + salt))
        _, count = ransac_projective(X1, X2, generator=gen,
                                     threshold=ransac_threshold)
        return float(count) / X1.shape[0]

    ref = float(np.median([frac(i, i, salt=9999)
                           for i in range(S // 6, S, max(S // 3, 1))]))
    return lambda qi, mi: frac(qi, mi) / max(ref, 1e-9)


def make_backend(name: str, device="cuda"):
    """(S, 3, H, W) frames in [0, 1] -> (S, D) numpy descriptors."""
    from vggt_slam_tpu_torch.data.images import _area_matrix
    from vggt_slam_tpu_torch.models import retrieval as R

    dev = resolve_device(device)
    if name == "tiny":
        def run(frames, grid=16):   # tiny_image_descriptor_fn on `dev`
            g = torch.as_tensor(np.asarray(frames, np.float32),
                                device=dev).mean(1).double()
            ah, aw = (torch.as_tensor(_area_matrix(n, grid), device=dev)
                      for n in g.shape[1:])
            t = (ah @ g @ aw.T).reshape(len(g), -1).float()
            t = t - t.mean(1, keepdim=True)
            t = t / (torch.linalg.vector_norm(t, dim=1, keepdim=True) + 1e-8)
            return t.cpu().numpy()
        return run
    if name == "salad_random":      # the floor the trusted gate rests on
        cfg = R.SALADConfig() if dev.type == "cuda" else R.SALADConfig.tiny()
        with torch.device("meta"):
            model = R.SALAD(cfg)
        model.load_state_dict(R.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev),
            assign=True)

        @torch.no_grad()
        def run(frames):
            x = torch.as_tensor(np.asarray(frames, np.float32), device=dev)
            x = F.interpolate(x, size=(224, 224), mode="bilinear",
                              align_corners=False, antialias=True)
            return model.eval()(x).float().cpu().numpy()
        return run
    raise ValueError(f"unknown backend {name!r}")


def _ratio(a, b):
    return round(a / b, 4) if b else ""


def score_sequence(desc: np.ndarray, centers: np.ndarray, rots: np.ndarray,
                   submap_size: int, accept_thresh: float,
                   dist_thresh: float, ang_thresh_deg: float,
                   gate_fn=None, gate_thresh: float = 0.9) -> dict:
    """Apply the reference matching rule and score against pose truth."""
    S = desc.shape[0]
    sub_of = np.arange(S) // submap_size
    axes = np.einsum("nij->nji", rots)[:, :, 2]    # optical axes in world
    cos_thr = np.cos(np.radians(ang_thresh_deg))

    def is_revisit(i, j) -> bool:
        return (np.linalg.norm(centers[i] - centers[j]) < dist_thresh
                and float(axes[i] @ axes[j]) > cos_thr)

    queries = accepted = true_accepted = gt_pos = 0
    top1_accepted = top1_true = 0
    gate_rows: list[tuple[bool, float]] = []
    for q in range(2, int(sub_of.max()) + 1):
        eligible = np.flatnonzero(sub_of <= q - 2)
        best_q = None  # (score, query, match)
        for qi in np.flatnonzero(sub_of == q):
            queries += 1
            gt_pos += any(is_revisit(qi, j) for j in eligible)
            d = np.linalg.norm(desc[eligible] - desc[qi], axis=1)
            best, score = int(eligible[np.argmin(d)]), float(d.min())
            if score < accept_thresh:
                accepted += 1
                true_accepted += is_revisit(qi, best)
                if best_q is None or score < best_q[0]:
                    best_q = (score, qi, best)
        if best_q is not None:      # the max_loops=1 operating point
            top1_accepted += 1
            tru = is_revisit(best_q[1], best_q[2])
            top1_true += tru
            if gate_fn is not None:
                gate_rows.append((bool(tru), gate_fn(best_q[1], best_q[2])))
    out = {"queries": queries, "gt_revisit_queries": gt_pos,
           "accepted": accepted, "true_accepted": true_accepted,
           "precision": _ratio(true_accepted, accepted),
           "recall": _ratio(true_accepted, gt_pos),
           "accept_rate": _ratio(accepted, queries),
           "top1_accepted": top1_accepted, "top1_true": top1_true,
           "top1_precision": _ratio(top1_true, top1_accepted)}
    if gate_fn is not None:
        kept = [t for t, f in gate_rows if f >= gate_thresh]
        tf = [f for t, f in gate_rows if t]
        ff = [f for t, f in gate_rows if not t]
        out.update({
            "gate_kept": len(kept),
            "gate_precision": _ratio(sum(kept), len(kept)),
            "gate_recall_of_true": _ratio(sum(kept), len(tf)),
            "gate_true_frac_median": round(float(np.median(tf)), 4)
            if tf else "",
            "gate_false_frac_median": round(float(np.median(ff)), 4)
            if ff else "",
            "gate_fracs": ";".join(f"{int(t)}:{f:.3f}"
                                   for t, f in gate_rows)})
    return out


def run(backends, n_sequences=3, n_frames=80, image_hw=(196, 256),
        submap_size=8, accept_thresh=0.80, dist_thresh=0.15,
        ang_thresh_deg=15.0, seed_base=7_000_000, geometric_gate=False,
        gate_thresh=0.9, device="cuda"):
    rows = []
    for b in backends:
        fn = make_backend(b, device)
        for s in range(n_sequences):
            frames, centers, rots, depths, K = render_sequence(
                seed_base + s, n_frames, image_hw)
            gate_fn = (make_gate_fn(depths, K, seed=seed_base + s,
                                    device=device)
                       if geometric_gate else None)
            row = {"backend": b, "sequence": s,
                   **score_sequence(np.asarray(fn(frames)), centers, rots,
                                    submap_size, accept_thresh, dist_thresh,
                                    ang_thresh_deg, gate_fn=gate_fn,
                                    gate_thresh=gate_thresh)}
            rows.append(row)
            print({k: v for k, v in row.items() if k != "gate_fracs"},
                  flush=True)
    return rows


def summarize(rows, gate_thresh: float = 0.9):
    out = []
    for b in sorted({r["backend"] for r in rows}):
        sub = [r for r in rows if r["backend"] == b]
        acc, tru, gtp, t1a, t1t = (sum(r[k] for r in sub) for k in (
            "accepted", "true_accepted", "gt_revisit_queries",
            "top1_accepted", "top1_true"))
        row = {"backend": b, "n_sequences": len(sub),
               "queries": sum(r["queries"] for r in sub), "accepted": acc,
               "precision": _ratio(tru, acc), "recall": _ratio(tru, gtp),
               "top1_precision": _ratio(t1t, t1a)}
        fracs = [(i.split(":")[0] == "1", float(i.split(":")[1]))
                 for r in sub for i in str(r.get("gate_fracs", "")).split(";")
                 if ":" in i]
        if fracs:
            kept = [t for t, f in fracs if f >= gate_thresh]
            row.update({"gate_precision": _ratio(sum(kept), len(kept)),
                        "gate_recall_of_true": _ratio(
                            sum(kept), sum(t for t, _ in fracs))})
        out.append(row)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backends", nargs="+",
                   default=["tiny", "salad_random"])
    for name, v in (("n_sequences", 3), ("n_frames", 80), ("submap_size", 8),
                    ("accept_thresh", 0.80), ("dist_thresh", 0.15),
                    ("ang_thresh_deg", 15.0), ("gate_thresh", 0.9)):
        p.add_argument(f"--{name}", type=type(v), default=v)
    p.add_argument("--image_hw", type=int, nargs=2, default=(196, 256))
    p.add_argument("--geometric_gate", action="store_true",
                   help="also gate each top-1 match by registration RANSAC")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="evals/results/retrieval_quality.csv")
    args = p.parse_args(argv)
    rows = run(args.backends, args.n_sequences, args.n_frames,
               tuple(args.image_hw), args.submap_size, args.accept_thresh,
               args.dist_thresh, args.ang_thresh_deg,
               geometric_gate=args.geometric_gate,
               gate_thresh=args.gate_thresh, device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}")
    summary = summarize(rows, gate_thresh=args.gate_thresh)
    for s in summary:
        print(s)
    return rows, summary


if __name__ == "__main__":
    main()
