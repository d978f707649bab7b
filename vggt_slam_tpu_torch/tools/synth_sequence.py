"""Synthetic image sequences for smoke runs and the demo app (counterpart
of vggt_slam_tpu/tools/synth_sequence.py, without OpenCV): a viewport
panning, or looping back to its start, over a procedural texture. Its
cv2 calls are tools/synth3d's numpy versions (the uint8 blur bit-exact;
the cubic resize within one grey level); PNGs are data/images.write_png's.

    python -m vggt_slam_tpu_torch.tools.synth_sequence --out_dir /tmp/seq \
        [--n_frames 60] [--no_loop] [--size 640 480] [--tum_layout]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from vggt_slam_tpu_torch.data.images import write_png
from vggt_slam_tpu_torch.tools.synth3d import (fill_circle, fill_rect,
                                               gaussian_blur, resize_cubic)


def make_texture(height: int, width: int, seed: int = 0,
                 blur_sigma: float = 3.0) -> np.ndarray:
    """(height, width, 3) uint8: a smooth colour field, sparse large
    shapes and light noise, so that LK tracks the true displacement."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (9, 9, 3)).astype(np.uint8)
    tex = np.clip(np.rint(resize_cubic(coarse, width, height)), 0,
                  255).astype(np.uint8)
    for _ in range(max(40, (height * width) // 40000)):
        c = tuple(int(v) for v in rng.uniform((0, 0), (width, height)))
        color = tuple(int(v) for v in rng.uniform(0, 255, 3))
        r = int(rng.uniform(18, 70))
        if rng.uniform() < 0.5:
            fill_circle(tex, c, r, color)
        else:
            fill_rect(tex, (c[0] - r, c[1] - r), (c[0] + r, c[1] + r), color)
    noise = rng.normal(0, 18, (height, width, 3))
    tex = np.clip(tex.astype(np.float32) + noise, 0, 255).astype(np.uint8)
    return gaussian_blur(tex, max(blur_sigma * 0.5, 0.8))


def camera_path(n_frames: int, span_x: float, span_y: float,
                loop: bool) -> np.ndarray:
    """(N, 2) pixel offsets of the viewport. `loop` returns to the start."""
    t = np.linspace(0.0, 1.0, n_frames)
    if loop:
        ang = 2 * np.pi * t
        xs = 0.5 * span_x * (1 - np.cos(ang))
        ys = 0.5 * span_y * np.sin(ang)
    else:
        xs = span_x * t
        ys = span_y * t
    return np.stack([xs, ys], axis=1)


def generate_sequence(out_dir: str, n_frames: int = 60,
                      size: tuple[int, int] = (640, 480), loop: bool = True,
                      seed: int = 0, step_px: float = 18.0,
                      tum_layout: bool = False) -> list[str]:
    """Write the frames; returns their paths. `tum_layout`: rgb/<stamp>.png
    and groundtruth.txt (identity rotations, the pan as translation)."""
    w, h = size
    span = step_px * n_frames
    span_y = span * 0.15
    tex = make_texture(h + int(span_y) + 200, w + int(span) + 200, seed=seed)
    path = camera_path(n_frames, span_x=span * (0.5 if loop else 1.0),
                       span_y=span_y, loop=loop)
    # signed y indexes the texture, so the ground truth is the motion
    y_bias = int(np.ceil(max(0.0, -path[:, 1].min())))
    img_dir = os.path.join(out_dir, "rgb") if tum_layout else out_dir
    os.makedirs(img_dir, exist_ok=True)
    names, gt_rows = [], []
    for i, (x, y) in enumerate(path):
        x0, y0 = int(100 + x), int(100 + y_bias + y)
        stamp = 1000.0 + i / 30.0
        name = os.path.join(img_dir, f"{stamp:.6f}.png" if tum_layout
                            else f"{i:04d}.png")
        write_png(name, tex[y0:y0 + h, x0:x0 + w])
        names.append(name)
        gt_rows.append(f"{stamp:.6f} {x / 100.0:.6f} {y / 100.0:.6f} 0.0 "
                       "0.0 0.0 0.0 1.0")
    if tum_layout:
        with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
            f.write("# timestamp tx ty tz qx qy qz qw\n")
            f.write("\n".join(gt_rows) + "\n")
    return names


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate a synthetic sequence")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_frames", type=int, default=60)
    p.add_argument("--size", type=int, nargs=2, default=(640, 480),
                   metavar=("W", "H"))
    p.add_argument("--no_loop", action="store_true",
                   help="straight pan instead of a loop trajectory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tum_layout", action="store_true",
                   help="write rgb/<timestamp>.png + groundtruth.txt")
    args = p.parse_args(argv)
    names = generate_sequence(args.out_dir, n_frames=args.n_frames,
                              size=tuple(args.size), loop=not args.no_loop,
                              seed=args.seed, tum_layout=args.tum_layout)
    print(f"wrote {len(names)} frames to {args.out_dir}")
    return names


if __name__ == "__main__":
    main()
