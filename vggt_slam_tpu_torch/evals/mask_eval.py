"""Mask-proposer quality on synthetic shape scenes with exact labels
(counterpart of vggt_slam_tpu/evals/mask_eval.py): each object's best
IoU over the proposals, averaged (mean best IoU), the share at IoU >= 0.5
and the proposal count, for the embedder's felzenszwalb and grid8 and,
with --sam2_checkpoint (.pt, the reference's .npz, or `random`), SAM2's
AMG on --device.

    python -m vggt_slam_tpu_torch.evals.mask_eval [--scenes 20] \
        [--sam2_checkpoint PT [--sam2_config base_plus]] [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np


def make_shape_scene(seed: int, hw=(240, 320), n_objects: int = 6):
    """(image uint8 (H, W, 3), labels int32 (H, W)): axis-aligned ellipses
    and rectangles of distinct hues (later ones occlude earlier ones; label
    0 the background) under an illumination gradient and pixel noise."""
    rng = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    base = np.array([90, 95, 100], np.float32)
    img = np.tile(base, (H, W, 1))
    img *= (0.8 + 0.4 * (xx / W + yy / H)[..., None] / 2.0)
    labels = np.zeros((H, W), np.int32)

    hues = rng.permutation(n_objects)
    for i in range(n_objects):
        cy = rng.uniform(0.15, 0.85) * H
        cx = rng.uniform(0.15, 0.85) * W
        ry = rng.uniform(0.08, 0.2) * H
        rx = rng.uniform(0.08, 0.2) * W
        ang = hues[i] / n_objects * 2 * np.pi
        color = 128 + 100 * np.array(
            [np.cos(ang), np.cos(ang + 2.1), np.cos(ang + 4.2)], np.float32)
        if rng.uniform() < 0.5:
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        else:
            mask = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
        img[mask] = color
        labels[mask] = i + 1

    img += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8), labels


def mask_quality(masks: list, labels: np.ndarray) -> dict:
    """Score proposals against a label map (0 = background)."""
    n_obj = int(labels.max())
    best = np.zeros(n_obj, np.float64)
    segs = [np.asarray(m["segmentation"], bool) for m in masks]
    areas = [s.sum() for s in segs]
    for i in range(1, n_obj + 1):
        gt = labels == i
        ga = gt.sum()
        if ga == 0:
            best[i - 1] = np.nan
            continue
        for s, sa in zip(segs, areas):
            inter = np.logical_and(gt, s).sum()
            if inter == 0:
                continue
            iou = inter / (ga + sa - inter)
            if iou > best[i - 1]:
                best[i - 1] = iou
    best = best[~np.isnan(best)]
    return {"mean_best_iou": float(np.mean(best)) if best.size else 0.0,
            "recall_at_50": float(np.mean(best >= 0.5)) if best.size else 0.0,
            "n_proposals": len(masks)}


def default_proposers() -> dict:
    """Name -> callable(image_rgb) -> masks: the embedder's weight-free
    proposers."""
    from vggt_slam_tpu_torch.semantic.embedder import (
        felzenszwalb_mask_generator, grid_mask_generator)
    return {
        "felzenszwalb": felzenszwalb_mask_generator,
        "grid8": lambda im: grid_mask_generator(im, grid=8),
    }


def evaluate_proposers(n_scenes: int = 20, hw=(240, 320),
                       proposers: dict | None = None) -> list[dict]:
    proposers = proposers or default_proposers()
    scenes = [make_shape_scene(s, hw) for s in range(n_scenes)]
    rows = []
    for name, fn in proposers.items():
        per = [mask_quality(fn(img), labels) for img, labels in scenes]
        rows.append({
            "proposer": name,
            "scenes": n_scenes,
            "mean_best_iou": round(float(np.mean(
                [p["mean_best_iou"] for p in per])), 4),
            "recall_at_50": round(float(np.mean(
                [p["recall_at_50"] for p in per])), 4),
            "mean_proposals": round(float(np.mean(
                [p["n_proposals"] for p in per])), 1),
        })
    return rows


def main(argv=None):
    """Returns the rows it writes."""
    p = argparse.ArgumentParser(description="mask-proposer quality eval")
    p.add_argument("--scenes", type=int, default=20)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--out", default="mask_quality.csv")
    p.add_argument("--sam2_checkpoint", default=None,
                   help="also score SAM2's AMG with this .pt or .npz, or "
                        "'random' for seeded weights")
    p.add_argument("--sam2_config", default="base_plus",
                   choices=["base_plus", "tiny_test"])
    p.add_argument("--device", default="cuda",
                   help="where SAM2 runs (cuda, or cpu)")
    args = p.parse_args(argv)
    proposers = default_proposers()
    if args.sam2_checkpoint:
        from vggt_slam_tpu_torch.models.sam2 import SAM2Config
        from vggt_slam_tpu_torch.semantic.sam2_amg import \
            make_sam2_mask_generator
        ckpt = (None if args.sam2_checkpoint == "random"
                else args.sam2_checkpoint)
        cfg = getattr(SAM2Config, args.sam2_config)()
        proposers["sam2" + ("_random" if ckpt is None else "")] = \
            make_sam2_mask_generator(checkpoint=ckpt, cfg=cfg,
                                     device=args.device)
    rows = evaluate_proposers(args.scenes, (args.height, args.width),
                              proposers=proposers)
    for r in rows:
        print(r)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
