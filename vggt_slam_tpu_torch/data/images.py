"""Image loading and preprocessing for the VGGT input pipeline (a copy of
vggt_slam_tpu/data/images.py): resize to width 518 with the height rounded
to the 14-px patch, values in [0, 1], (S, 3, H, W) float32. OpenCV is
imported only to decode or to resize; frames already at the target size
need neither."""
from __future__ import annotations

import glob
import os
import re

import numpy as np

TARGET_WIDTH = 518
PATCH = 14


def preprocessed_hw(orig_h: int, orig_w: int,
                    target_width: int = TARGET_WIDTH) -> tuple[int, int]:
    new_h = int(round(orig_h * target_width / orig_w / PATCH)) * PATCH
    return max(PATCH, min(new_h, target_width)), target_width


def load_image(path: str) -> np.ndarray:
    """Decode one image file -> (H, W, 3) uint8 BGR."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return img


def preprocess_array(img_rgb: np.ndarray,
                     target_width: int = TARGET_WIDTH) -> np.ndarray:
    """(H, W, 3) uint8/float RGB -> (3, h, w) float32 in [0, 1]."""
    H, W = img_rgb.shape[:2]
    new_h, new_w = preprocessed_hw(H, W, target_width)
    interim_h = int(round(H * new_w / W))
    if (H, W) == (new_h, new_w):
        resized = img_rgb
    else:
        import cv2
        resized = cv2.resize(img_rgb, (new_w, interim_h),
                             interpolation=cv2.INTER_AREA if interim_h < H
                             else cv2.INTER_LINEAR)
        if interim_h > new_h:
            top = (interim_h - new_h) // 2
            resized = resized[top:top + new_h]
        elif interim_h < new_h:
            resized = cv2.resize(img_rgb, (new_w, new_h),
                                 interpolation=cv2.INTER_LINEAR)
    out = resized.astype(np.float32)
    if img_rgb.dtype == np.uint8:
        out /= 255.0
    return np.transpose(out, (2, 0, 1))


def preprocess_frames(frames_bgr, target_width: int = TARGET_WIDTH):
    """Decoded (H, W, 3) uint8 BGR frames -> (S, 3, H, W) float32 batch."""
    imgs = [preprocess_array(np.ascontiguousarray(f[..., ::-1]),
                             target_width) for f in frames_bgr]
    if len({im.shape for im in imgs}) != 1:
        raise ValueError("mixed image shapes after preprocess")
    return np.stack(imgs, axis=0)


def load_and_preprocess_images(paths, target_width: int = TARGET_WIDTH):
    """Image paths -> (S, 3, H, W) float32 batch (uniform shape)."""
    return preprocess_frames([load_image(p) for p in paths], target_width)


def sort_images_by_number(image_paths):
    def extract(path):
        m = re.search(r"\d+(?:\.\d+)?", os.path.basename(path))
        return float(m.group()) if m else float("inf")
    return sorted(image_paths, key=extract)


def downsample_images(image_names, factor: int):
    return image_names[::factor]


def list_image_folder(folder: str):
    """Glob, drop depth/txt/json/db files, numeric sort."""
    names = [f for f in glob.glob(os.path.join(folder, "*"))
             if not any(t in os.path.basename(f).lower()
                        for t in ("depth", "txt", "json", "db"))]
    return sort_images_by_number(names)
